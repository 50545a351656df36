#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (e2_tts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase; needs one CUDA card

Phases, each printing its lines; any failure ends the run with a non-zero
exit code and no result line:

1. device  — the card's name and power limit (nvidia-smi) and torch's name.
2. build   — nvcc compiles every kernel from e2_tts_tpu_torch/csrc (sm_90a).
3. kernels — the sixteen kernels and the probe, each against its plain
   PyTorch version on the card: K1 (packed flash attention) and its
   backward K2 with K2's delta pre-pass K10 (gated: it also writes the
   gated output grad K2 reads), K8 / K9 (the same attention on
   (b, h, n, dh) operands, for heads K1 does not take; dim_head 8 to 256,
   and 12, zero-padded), K3 / K5
   (hyper-connection width connection, depth-fused and plain) and their
   adjoints K4 / K5b (also at 2, 3 and 8 streams and widths 32 to 2048; the
   Hopper designs at 4 bf16 streams also at widths 1 to 4840 with a zero row,
   a ragged M of 16819 with two calls bit for bit, and M = 1; there K3s /
   K5s's outputs must equal K3 / K5's bit for bit, and a forward case beyond
   its tolerance takes `alpha_tol` only where its line shows alpha rounding
   flips), the save-state variants K3s / K5s (outputs bit for bit K3 / K5's,
   and the saved tanh and rms reciprocal) and K4s / K5bs (against K4 / K5b
   at 1e-5 where both run one template; at bf16 and 4 streams, where the
   saved tanh and the recomputed one are sums in two orders, K4s / K5bs and
   K4 / K5b each against the f64 reference of
   hyper_conn_kernel.width_backward_reference: the bf16 input grads at one
   bf16 ulp of it or of an alternative rounding of a point that f32 sums
   may land on either side of, each f32 parameter grad at its limit, and two
   planted faults that must fail; the Hopper K4s / K5bs also at widths 1
   to 4840 with a zero row, a ragged M of 1923 with two calls bit for bit,
   M = 1, and a row of rms 1e-7, whose saved inv must be exactly the clamp's
   1e6 and whose stream grads are held against K4 / K5b's at one ulp),
   K6 (GEGLU) and its backward K7 (also at the paper's and DiT's training
   widths, 2752 / 1408 and 3072 / 1536, and on both designs of
   csrc/geglu.cu: the vector design at every width of the repo, the scalar
   one at inner 100 and on views one element into their storage; each
   label names the design), K11 (the fused log-mel frontend on split-TF32
   tensor-core products; also at 160 mels and n_fft 1000, at n_fft 1002
   (4-byte frame copies, a part-filled last k8 step) and on the tone prompt:
   a 220-Hz tone, noise and a digitally silent last 30%, the wave of
   tests/test_torch_mel_design.py, on which a build of csrc/mel.cu with one
   TF32 product a product, started beside the main build, must fail the
   check that the kernel passes), one LASER `attention`, and the
   probe (K8's Hopper kernel with the softmax's pieces compiled out, modes
   0-2). Forward kernels at the sampler's shapes (B=1; K11
   at a 3-s prompt), at the duration predictor's (B=1, the prompt's 282
   frames + 32 registers) and at the trainer's (B=16), the flagship's and
   DiT-XL's (16 heads x 72, widths 1152 / 576); backward kernels at the
   trainers'; each with ragged, dropout, softclamp (K1, K2, K8, K9), dim_head
   8 to 128 (K8, K9), power / window (K11) and f32 cases. K11 at the prompt
   is also run and timed unsplit (each block walking every frequency tile
   of its 32 rows), the design its frequency split replaced. A check whose
   plain version leaves out a feature (K1 / K2 / K8 / K9 without the
   softclamp, K11 at power 1 against the power-2 kernel) or has a fault (K1 /
   K8 across a few tokens with the softmax scale 5% off) must fail. The
   first case of each kernel is timed:
   device time per call (100 calls captured in one CUDA graph, timed with
   CUDA events, so host dispatch is left out), its plain version's device
   time (the same way), the one PyTorch call that computes the same
   function where there is one (K10: einsum), the wall time of one eager
   call of the wrapper, and the bound. The forward kernels are timed at the
   training shapes as well; K11 also beside `MelSpec(mode='dft')`; K8 / K9
   also at the flagship's training shape and at the E2-TTS paper's heads
   (16 x 64), each beside K1 / K2 on the same work; K9 also as its launch
   alone (`kernel_only_ms`, without the wrapper's delta, dq fill and cast);
   the probe in each mode at both training shapes; K1 / K2 gated at the
   paper's heads beside the ungated pair. The attention kernels' `kernel`
   lines (not their records in the `kernels` line) also give
   `sfu_floor_ms`: the softclamp's two transcendentals a score (one without
   it) at the special-function units' 16 a clock per SM (the card's highest
   SM clock). That is the floor of this implementation, which evaluates
   them there, not of the function (polynomials on the FMA pipes could
   share the work), so `bound_ms` stays bytes against tensor-core products.
   The build's `ptxas` lines give the registers and spills of the Hopper
   designs (csrc/flash_attention_sm90.cuh: bf16 K1 / K2 and K8 / K9;
   csrc/hyper_conn_bwd_sm90.cuh: bf16 K4 / K5b and K4s / K5bs at 4
   streams, built in hyper_conn_bwd.cu and hyper_conn_bwd_save.cu;
   csrc/hyper_conn_sm90.cuh: bf16 K3 / K5 and K3s / K5s at 4 streams, built
   in hyper_conn.cu and hyper_conn_save.cu; csrc/geglu.cu: K6 / K7, both
   designs; csrc/mel.cu: K11's two geometries and its summing pass;
   csrc/flash_probe.cu: the probe), and `sass` lines the SASS
   instructions of each K6 / K7 kernel (cuobjdump; per element for the
   vector design). K3 / K5 and K4 / K5b
   are timed at the flagship's, the paper's and DiT's training widths (512,
   1024, 1152). Then
   `hc save A/B` lines: the hyper-connection forward and adjoint,
   recomputing and saving, and the pairs' sums, at the training shape for widths 512, 1024 and 1152; and
   the `yardstick` line: K8 / K9 without softclamp and dropout beside
   PyTorch's scaled_dot_product_attention (flash backend) at the DiT
   training shape, which is not the same function; and the `probe floor`
   lines: at the flagship's (16, 8, 1056, 64) and DiT's (16, 16, 1056, 72)
   training heads, K8 without softclamp and dropout beside the probe's
   three modes (products only; + exp; + the tile's max and sum) and the
   products' bound, with whether mode 0 is at or under K8. K11's bound is
   three TF32 products at 495 TFLOP/s (165 TFLOP/s at f32 grade).
4. main    — the flagship E2TTS (dim 512, depth 8, 8 heads x 64, bf16) with
   seeded random weights, each perturbed by 0.02 * randn so no branch is
   dead: one CFG evaluation on the card against the same model in f32 on the
   CPU, then `sample` (B=1, 1024 frames, NFE 32 midpoint, CFG 1.0,
   sequential), with the launch counters checked against the counts the
   model's structure gives; then one CFG evaluation under torch.profiler
   (device-busy share, device time by kernel; the trace goes to
   build/profile/cfg_eval_trace.json).
5. serve   — zero-shot serving from a raw waveform: the flagship with the
   duration predictor (dim 512, depth 8, HL-Gauss classification head),
   the fused log-mel frontend (K11) and the Vocos vocoder, bf16. One
   duration-predictor evaluation on the card against the f32 CPU model, one
   Vocos decode on the card against the CPU (f32), the request's parts
   timed alone (mel frontend, duration predictor, vocoder), then a timed
   `sample` of a 3-s prompt wave with no duration (NFE 32 midpoint, CFG 1.0
   sequential): predicted duration, waveform length, seconds, RTF with the
   vocoder, and the launch counters against the model's structure; then
   the request again at 2 ODE steps with ``save_to_filename`` under
   build/serve/, the WAV read back (`load_wav`): its length and its samples
   within 1/32767 of the returned audio.
6. train   — one train step's loss and full grad vector at the flagship
   widths (depth 2, B=2, dropout 0, the same weights and draws): the card in
   f32 and in bf16 against the CPU in f32, and the f32 loss from a raw-wave
   batch (K11 on the card) against the loss from the plain frontend's mels,
   with K10 launched once per K2. Then the flagship with dropout 0.1
   in bf16 under `E2Trainer` (ADOPT, clip 1.0, EMA): `train` over an
   in-memory dataset of 32 random (100, 1024) mels, B=16 (two steps, also
   the warm-up), then timed `train_step`s with and without text, with the
   launch counters checked against the model's structure; then one step
   under torch.profiler (trace: build/profile/train_step_trace.json). Each
   profiled train step (here, in dit and in paper) also prints the GEGLU
   kernels' device time (K6 + K7).
7. trainer — examples/train_example.py's run at its widths: the E2TTS 512 x
   12 and the 512 x 8 duration predictor, trained, bf16 (the trainer's
   ``dtype``), through `HFDataset` over 24 seeded rows of audio at 16-48 kHz
   (two outside 0.3-20 s, skipped; resampled on the host, the log-mel on
   the card) and `E2Trainer.train`: one epoch at batch 4 with two prefetch
   workers, accumulation 2, a checkpoint every 2 steps (build/trainer/),
   TensorBoard when it imports, a profiler window (steps 2-4). Checks:
   finite losses, every parameter moved (the predictor's text stream, which
   its text-free loss never reaches, excepted by its zero ADOPT v), the
   launch counts against the model's and the predictor's structure, the
   trace file. Then one more micro-step (timed) leaves half a mean in the
   accumulator and is saved (size, seconds); a trainer built from other
   weights resumes (seconds) to that state bit for bit (model, ADOPT, EMA
   weights and counters, predictor and its ADOPT, accumulator, generator);
   one more step on the original and the resumed trainer gives equal
   losses and parameters whose gap is at most 0.1 of the step in L2 norm
   (`RESUME_STEP_TOL`); a trainer resumed without its ADOPT state must fail
   that check.
8. dit     — the E2TTS at DiT-XL/2's widths (dim 1152, 16 heads x 72: every
   attention on K8 / K9; text stream 576) in bf16 with seeded random
   weights: one CFG evaluation at depth 2 against the CPU in f32; `sample`
   at depth 28 (B=1, 1024 frames, NFE 32 midpoint, CFG 1.0 sequential) with
   its launch counters; one train step at depth 2 (card f32 / bf16 against
   the CPU) and remat on against off (f32, dropout 0.1); then `E2Trainer`
   at depth 28, B=16 x 1024, dropout 0.1, remat, timed steps with and
   without text, with the launch counters (the recompute runs every
   forward kernel twice); one CFG evaluation and one train step at depth 28
   under torch.profiler (traces: build/profile/dit_*.json).
9. tiny    — the JAX package's test geometry (dim 64, text 32, 2 heads of 16,
   2 streams, depth 4): one CFG evaluation bf16 on the card against f32 on
   the CPU and one train step f32 against the CPU, with the launch counts of
   K3 / K5 at 2 streams and K8 / K9 at dim_head 16.
10. paper  — the E2-TTS paper's configuration (dim 1024, 16 heads of 64,
   text 512; 600.7 M parameters) in bf16: at depth 2 one CFG evaluation and
   one train step (f32, bf16) against the CPU, and hc_save_state on against
   off (f32); `sample` at depth 24 with hc_save_state=True (the save
   counters stay 0 without a backward); then `E2Trainer` at depth 24, B=16 x
   1024, dropout 0.1, remat, timed steps with and without text, with
   hc_save_state off and then on (launch counters, peak memory); one CFG
   evaluation and one with-text train step each with hc_save_state off and
   on at depth 24 under torch.profiler, with the hyper-connection adjoints'
   device time both ways (traces: build/profile/paper_*.json).
11. adaptive — the adaptive ODE solvers on the flagship (sequential CFG):
   dopri5, bosh3, fehlberg2 and adaptive_heun at atol = rtol = 1e-5 (f32,
   depth 2, 256 frames, the 32-point grid) against a 256-step rk4 on the
   card at `ADAPTIVE_CHECK_TOL`, and dopri5 with one b weight off by 1e-2,
   which must fail it; dopri5's NFE at depth 2 in bf16 at the model's
   defaults (1024 frames), which projects the depth-8 run; then one dopri5
   `sample` at depth 8 in bf16 (at 1e-3 when the projection passes
   `ADAPTIVE_FULL_DEPTH_S`): NFE, accepted and rejected trial steps,
   seconds, RTF, launch counts; a NaN fails.
12. options — the flagship widths with every option on: num_freq_tokens=2
   (the frequency attention on K1 / K2 / K10), concat_cond,
   interpolated_text, the FANformer input map and selective remat
   ('dots_with_no_batch_dims_saveable'): at depth 2 one CFG evaluation bf16
   against the CPU in f32, one train step f32 against the CPU, the policy
   and remat=True against remat off; at depth 8 one midpoint sample (RTF,
   launch counts) and timed `E2Trainer` steps at B=16 x 1024 with remat
   off, True and the policy (ms a step, peak memory, launch counts).
   The kernels phase holds K1 / K2 / K10 across 2 and 4 frequency tokens
   (bf16 and f32, a ragged batch), times them at the flagship's frequency
   training shape (16,896 sequences of 2 tokens) beside PyTorch's flash
   attention, and holds K1 / K2 / K10 / K8 / K9 at 66,048 sequences, past
   gridDim.z's 65,535, on both designs.
13. distributed — data parallelism (e2_tts_tpu_torch/parallel; the kernels'
   row offset ``hash_b0`` is held in phase 14 (a)): `E2Trainer` over a real
   NCCL process group of one rank (the card is one GPU, and NCCL takes one rank a device),
   started by `maybe_initialize_distributed` from a file rendezvous under
   build/: `param_sharding='replicated'` (DDP) and 'fsdp' (FSDP2) two steps
   at depth 2 in f32 against the single-device trainer (`DIST_LOSS_TOL`,
   `DIST_PARAM_TOL`), then at the flagship's width (bf16, dropout 0.1, B=16
   x 1024, with text) ms a step and peak memory, one device against DDP
   against FSDP2, with the launch counters checked; the group is stopped at
   the end.
14. tensor_parallel — tensor parallelism (e2_tts_tpu_torch/parallel/tp.py):
   (a) the dropout offsets: K1 / K2 (8 x 64, gated) and K8 / K9 (16 x 72),
   bf16 and f32, dropout 0.1, a key mask, softclamp 50, on rows [2, 4) of a
   4 x 1056 batch at hash_b0 = 2 and, for T = 1, 2 and 4, each rank's heads
   [h0, h0 + H/T) at hash_h0 = h0 of hash_heads = H, against those rows
   and heads of one launch of all of them: out, lse, dk, dv (and K2's gate
   grad) bit for bit, dq (atomics) at the backward tolerance, each launch
   against its plain version; the planted hash_b0 = 0 and hash_h0 = 0 must
   fail; K6 / K7 at inner 2752 and 3072 on each rank's value and gate
   columns under `fold_column_offset`, bit for bit, the planted unfolded
   seed must fail; (b) one attention and one
   feedforward at the paper's widths (1024, 16 x 64, GEGLU 2752) and DiT's
   (1152, 16 x 72, GEGLU 3072), B = 16 x 1056, dropout 0.1, f32 and bf16,
   cut in T = 2 and 4 shards run one after another on the card and summed,
   against the whole layers (`TP_LAYER_TOL`); (c) `E2Trainer` on a model
   sharded by `shard_module_tp` over (data 1, model 2): two gloo ranks on
   the one card (rank 1 is this script with ``--tp-rank 1``; NCCL takes one
   rank a GPU), the flagship at depth 2 in f32, dropout 0.1, two steps and
   a 4-step midpoint sample against one device (`TP_LOSS_TOL`,
   `TP_PARAM_TOL`, `TP_PARAM_ABS_TOL`, `TP_SAMPLE_TOL`), the ranks' samples
   bit for bit, and the planted fault (the shared grads unsummed) must
   exceed `TP_PARAM_ABS_TOL`; then over NCCL at world 1 the flagship at its
   full depth, bf16, B = 16 x 1024 with text: one device, DDP, the TP
   trainer at mesh (1, 1) and the same without its model-axis collectives,
   `TP_COST_ROUNDS` rounds in turns: ms a step, host ms, synchronizing
   calls, memory, the launch counters checked, and a profiled step a side.
15. sequence_parallel — sequence parallelism (e2_tts_tpu_torch/parallel/sp.py):
   (a) the ring in one process (`sp.Loopback`, the distributed ring's block
   code) at the flagship's training attention (B = 16, 1056 rows, 8 x 64,
   gated: K1 / K2 a block) and DiT's (16 x 72: K8 / K9), bf16, dropout 0.1,
   softclamp 50, a ragged mask with a row whose last shard is wholly masked,
   P = 2 and 4, against one launch over the whole sequence: out and the
   grads at the kernels' limits; the keep bits of every block launched at
   its hash_r0 / hash_c0 bit for bit the whole launch's on every key;
   three planted faults (offsets 0, the combine without its rescale, dk /
   dv kept by the rank that computed them) must fail; (b)
   `E2Trainer(sequence_parallel=2)` on two gloo ranks of the one card (rank
   1 is this script with ``--sp-rank 1``, started with the phase), the
   flagship at depth 2 in f32, dropout 0.1, two steps against one device
   (`SP_LOSS_TOL`, `SP_PARAM_ABS_TOL`), and a planted conv without its halo
   must exceed them; (c) the ring's cost, forward and backward,
   against one launch at the flagship's training shape, P = 2 and 4: the
   device ms of one call queued behind a sleep, its kernels back to back
   (all P shards, and one rank's share, / P), and the host-inclusive ms a
   call (recorded, no limit).

The line before the last is the `nvidia-smi` name/power-limit line; before
it, one JSON object with a record per kernel. The last line is the result.
"""

from __future__ import annotations

import copy
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

# the flagship configuration (JAX package: bench.py flagship backbone)
FLAGSHIP = dict(dim=512, depth=8, heads=8, dim_head=64)
# DiT-XL/2's widths (Peebles & Xie 2023, Table 1; facebookresearch/DiT
# models.py DiT_XL_2): 28 layers, hidden 1152, 16 heads of 72, which only
# K8 / K9 take; every other setting the port's default
DIT = dict(dim=1152, depth=28, heads=16, dim_head=72)
DIT_TRAIN_STEPS_TIMED = 5
# the E2-TTS paper's configuration (Chen et al. 2024, arXiv 2406.18009, 4.1;
# SWivid/F5-TTS configs/E2TTS_Base.yaml): 24 layers, dim 1024, 16 heads of 64;
# every other setting the port's default (text 512, 32 registers, 4 streams)
PAPER = dict(dim=1024, depth=24, heads=16, dim_head=64)
PAPER_TRAIN_STEPS_TIMED = 5
# the JAX package's own test geometry (tests/test_models.py SMALL_TF) in the
# port's arguments: speech width 64, text 32, 2 heads of 16, 2 streams
TINY = dict(dim=64, depth=4, heads=2, dim_head=16, ff_mult=2, num_registers=4,
            max_seq_len=256, kernel_size=7, dropout=0.0, num_residual_streams=2)
TINY_FRAMES = 200
FRAMES = 1024
PROMPT_FRAMES = 256
STEPS = 32
TEXT = 'the quick brown fox jumps over the lazy dog ' * 3
FRAMES_PER_SECOND = 24_000 / 256      # mel hop 256 at 24 kHz
# the JAX package's training bench (bench.py bench_train): B=16 x 1024
# frames, dropout 0.1, the 0.75 / 0.25 mix of the text-kept / dropped steps
TRAIN_BATCH = 16
TRAIN_STEPS_TIMED = 10
TEXT_DROP_PROB = 0.25
HOP = 256
PROMPT_SAMPLES = 72_000            # a 3-s voice prompt at 24 kHz: 282 frames
TRAIN_WAVE_SAMPLES = (FRAMES - 1) * HOP   # 1024 frames per training wave
# the serving configuration: the flagship with examples/sample_example.py's
# duration predictor, but an HL-Gauss classification head over [0, 2048]
# (with random weights the regression head predicts under one frame; the
# expectation over near-uniform bins lands near 1024 frames)
SERVE_E2TTS = dict(
    duration_predictor=dict(transformer=dict(dim=512, depth=8, heads=8, dim_head=64),
                            hl_gauss_loss=dict(min_value=0.0, max_value=2048.0, num_bins=128),
                            use_regression=False, mel_spec_kwargs=dict(mode='pallas')),
    mel_spec_kwargs=dict(mode='pallas'), use_vocos=True)
# the predictor's sequence at the 3-s prompt: 282 frames + 32 registers
PREDICTOR_N = 1 + PROMPT_SAMPLES // HOP + 32

# examples/train_example.py: E2TTS 512 x 12 in bf16 with a 512 x 8 side
# duration predictor, here trained; batch 4 in two micro-batches a step
TRAIN_EXAMPLE = dict(dim=512, depth=12)
TRAIN_EXAMPLE_DP = dict(dim=512, depth=8)
TRAINER_ROWS = 24
TRAINER_BATCH = 4
TRAINER_ACCUM = 2
TRAINER_RATES = (16_000, 22_050, 24_000, 48_000)
TRAINER_DIR = os.path.join('build', 'trainer')      # gitignored
# a resumed trainer's next step against the original's: the forward is the
# same (equal losses), but K2 sums dq by atomics in a run-dependent order,
# so a bf16 grad element may round the other way. ADOPT's bounded atan2 turns
# a small grad change into a small step change, except where a grad near 0
# meets a second moment near 0: there its sign picks +-pi/2, and one element
# can move by up to lr x 0.1 x pi, the step's own size (on the H100 at the
# train_example widths the largest element gap read 0.19 of the step's
# largest move). So the limit is on the whole step: the L2 norm of the gap
# between the two trainers' parameters over the L2 norm of the step (the
# original's move), at most 0.1. A trainer that lost its ADOPT state takes
# ADOPT's first step, which moves nothing: ratio 1.
RESUME_STEP_TOL = 0.1

# H100 SXM peaks, dense (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# f32-grade products as three TF32 tensor-core products (K11's split
# precision): the card's TF32 rate over three
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12

OUT_DIR = os.path.join('build', 'profile')      # gitignored


def log(msg):
    print(msg, flush=True)


# K11's planted precision fault: csrc/mel.cu with the split's two cross
# products taken out, so each product is one TF32 product (hi hi)
MEL_ONE_TF32 = (('  mma(d, al, bh[0], bh[1]);\n  mma(d, ah, bl[0], bl[1]);\n', ''),)


def start_mel_variant(_cuda, name: str, subs):
    """Start nvcc on csrc/mel.cu with each ``(old, new)`` of ``subs``
    replaced (each ``old`` must occur once), into build/mel_variants/.
    Returns a function that waits for the build and returns the loaded
    library (``e2_mel_fwd`` typed as the port's) and nvcc's output."""
    src = (_cuda.CSRC / 'mel.cu').read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise AssertionError(f'mel variant {name}: {old!r} occurs {src.count(old)} times')
        src = src.replace(old, new)
    out_dir = os.path.abspath(os.path.join('build', 'mel_variants'))
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, f'{name}.cu'), os.path.join(out_dir, f'{name}.so')
    with open(cu, 'w') as f:
        f.write(src)
    proc = subprocess.Popen([_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.NVCC_FLAGS, '-I',
                             str(_cuda.CSRC), '-shared', cu, '-o', so],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc, mel variant {name}:\n{out[-3000:]}')
        lib = ctypes.CDLL(so)
        lib.e2_mel_fwd.argtypes = _cuda._SIGNATURES['e2_mel_fwd']
        lib.e2_mel_fwd.restype = ctypes.c_int
        return lib, out
    return finish


def tone_prompt(samples: int = PROMPT_SAMPLES):
    """A 3-s prompt at 24 kHz as numpy f32, (1, samples): a 220-Hz tone at
    0.3, noise at 0.05 (numpy seed 0) and the last 30% zeros, as in
    tests/test_torch_mel_design.py. Around a strong tone the DFT's sums
    cancel, and the log amplifies the quiet frames' errors: one TF32
    product a product fails K11's limit here, not on white noise."""
    import numpy as np
    t = np.arange(samples) / 24000
    wave = (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * np.random.default_rng(0).standard_normal(samples))
    wave[int(0.7 * samples):] = 0.0
    return wave.astype(np.float32)[None]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def eager_ms(fn, iters: int, warmup: int = 5) -> float:
    """Wall time of one eager call of ``fn``, from CUDA events around
    ``iters`` back-to-back calls: host dispatch included."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed between two CUDA events. The host work of a call
    (argument checks, allocation, the ctypes call) is not in the time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations')


def sfu_rate(torch, dev) -> float:
    """Transcendentals a second: 16 a clock per SM at the highest SM clock."""
    mhz = float(subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                                '--format=csv,noheader,nounits'], check=True,
                               capture_output=True, text=True, timeout=60).stdout.split()[0])
    return 16 * torch.cuda.get_device_properties(dev).multi_processor_count * mhz * 1e6


def compare(out, ref, atol, rtol, scaled=False):
    """(max abs error, worst |err| / (atol + rtol |ref|)) over a tuple; with
    ``scaled`` the absolute term is ``atol`` times each tensor's max |ref|
    (grads are sums over many rows, far from unit scale); ``scaled='joint'``:
    times the largest max |ref| of the tuple (a grad that is rounding alone,
    as dq and dk of a softmax over one key)."""
    import torch
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    if len(outs) != len(refs):
        raise AssertionError(f'{len(outs)} outputs against {len(refs)} references')
    max_err, worst = 0.0, 0.0
    joint = max(float(r.float().abs().max()) for r in refs)
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        if o.shape != r.shape:
            raise AssertionError(f'shape {tuple(o.shape)} against {tuple(r.shape)}')
        if not torch.isfinite(o).all():
            raise AssertionError('kernel output is not finite')
        err = (o - r).abs()
        a = atol * (joint if scaled == 'joint' else float(r.abs().max())) if scaled else atol
        max_err = max(max_err, float(err.max()))
        worst = max(worst, float((err / (a + rtol * r.abs() + 1e-30)).max()))
    return max_err, worst


# the parameter grads of K5b / K4 (the last six outputs), in order
HC_PARAM_GRADS = ('static_alpha', 'static_beta', 'dyn_alpha_w', 'dyn_alpha_scale',
                  'dyn_beta_w', 'dyn_beta_scale')
# K5b / K4 / K5bs / K4s at bf16 and 4 streams against the f64 reference
# (hyper_conn_kernel.width_backward_reference), each parameter grad on its
# own. The static grads sum ga = gm . r (f32 sums, no bf16 rounding point):
# only f32 summation error, held at 1e-5 max|ref| + 1e-5|ref|. The dynamic
# weights sum n^T gp over every row, and a few tens of gp a case round the
# other way in f32 (each moves a column by |n| ulp(gp), ~3e-5 of max|ref|);
# the scales sum ga ta, where a recomputing kernel's inv that rounds the
# other way moves a row's ta: both at 3e-4 max|ref|, where a few such flips
# that happen to add read about a third of the limit (PERF.md §6); a lower
# limit would leave too little margin over them.
HC_GP_GRAD_LIMIT = 3e-4


def hc_param_xcheck(got, ref):
    """(text, ok, worst) of the six parameter grads ``got`` against ``ref``
    (f64) at the limits above; the text gives each grad's worst |err| over
    its limit."""
    ratios = []
    for name, o, r in zip(HC_PARAM_GRADS, got[-6:], ref[-6:]):
        o, r = o.double(), r.double()
        err, amax = (o - r).abs(), float(r.abs().max())
        if name.startswith('static'):
            ratios.append(float((err / (1e-5 * amax + 1e-5 * r.abs() + 1e-300)).max()))
        else:
            ratios.append(float(err.max()) / (HC_GP_GRAD_LIMIT * amax + 1e-300))
    text = ', '.join(f'{n} {x:.3f}' for n, x in zip(HC_PARAM_GRADS, ratios))
    return text, max(ratios) <= 1.0, max(ratios)


def hc_f64_check(hck, fused, args, got, state):
    """(text, ok, worst) of one K5b / K4 / K5bs / K4s output ``got`` against
    the f64 reference of ``args``: its input grads at one bf16 ulp of the
    reference or of one of its alternatives (a rounding point that f32 sums
    may land on either side of; `hck.reference_ratios`), its parameter
    grads at `hc_param_xcheck`'s limits."""
    n_in = 3 if fused else 1
    ref, alts = hck.width_backward_reference(fused, *args, state=state)
    stream = hck.reference_ratios(got[:n_in], ref[:n_in], alts)
    ptext, pok, pworst = hc_param_xcheck(got, ref)
    names = ('g_carried', 'g_branch', 'g_beta') if fused else ('g_residuals',)
    text = (', '.join(f'{n} {x:.3f}' for n, x in zip(names, stream)) + f' ({len(alts)} '
            f'alternatives); {ptext}')
    return text, pok and max(stream) <= 1.0, max(max(stream), pworst)


# -- phase 3: kernels -----------------------------------------------------------

def kernel_cases(torch, dev, mel_one_tf32):
    """One dict per check: the kernel's wrapper (``run``), its plain version
    (``plain``), the tolerance, and the bytes and operations of the work for
    the bound. A case may carry ``against``: a description and a plain
    version that leaves out a feature of the kernel (K1 / K2: the softclamp;
    K11: power 2), which the kernel must not match. ``train`` marks a forward case at the trainer's shape,
    timed on its own row. ``library`` is the one PyTorch call that computes
    the same function, where there is one. Inputs come from a seeded
    generator on the card. ``mel_one_tf32``: the library of K11's planted
    precision fault (`MEL_ONE_TF32`)."""
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.ops import attention as attention_op
    from e2_tts_tpu_torch.ops import flash_attention as fa
    from e2_tts_tpu_torch.ops import geglu_kernel as gk
    from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck
    from e2_tts_tpu_torch.ops import mel_kernel as mk
    from e2_tts_tpu_torch.ops.mel import MelSpec, frame_signal

    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sfu = sfu_rate(torch, dev)
    # the attention kernels' transcendentals: tanh and exp2 a score with the
    # softclamp (the backward recomputes both), exp2 alone without it; at the
    # special-function units' rate they give `sfu_floor_ms`, not `bound_ms`
    transcendentals = lambda b, heads, n, softclamp: (2 if softclamp else 1) * b * heads * n * n
    randn = lambda *shape, dtype=torch.bfloat16, scale=1.0: (
        torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    bf16, f32 = torch.bfloat16, torch.float32
    esize = lambda dtype: torch.tensor([], dtype=dtype).element_size()
    # bf16: the kernels and the plain versions round at the same points but
    # sum in other orders, so outputs differ by about one bf16 ulp (2**-8 of
    # |ref|); f32: summation order only
    tol = {bf16: (1e-2, 1e-2), f32: (1e-4, 1e-4)}
    # K1's bf16 outputs are near 0.03 (softmax over ~1000 keys, gated), so its
    # absolute term is ten times smaller than the other kernels'
    attn_tol = {bf16: (1e-3, 1e-2), f32: (1e-4, 1e-4)}
    cases = []
    drop_none = lambda outs: tuple(t for t in outs if t is not None)

    def attn_inputs(b, n, heads, dh, dtype, lens, gated, qk_scale, misaligned=False):
        D = heads * dh
        # q/k/v as strided views of one (b, n, 3D) projection, as the model has
        # them (misaligned: of a (b, n, 3D + 1) one, one element in)
        qkv = torch.randn(b, n, 3 * D + misaligned, generator=g, device=dev)
        qkv[..., :2 * D + misaligned] *= qk_scale
        qkv = qkv.to(dtype)[..., int(misaligned):]
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        mask = None
        if lens is not None:
            mask = torch.arange(n, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        gate = randn(b, n, heads, dtype=dtype, scale=2.0) if gated else None
        return q, k, v, mask, gate

    def sdpa_views(heads, dh, *ts):
        """(b, h, n, dh) views of packed (b, n, h*dh) tensors, as PyTorch's
        scaled_dot_product_attention takes them."""
        return [t.unflatten(-1, (heads, dh)).transpose(1, 2) for t in ts]

    # across a few (frequency) tokens the outputs are means of a few value
    # rows of order 1, not ~0.03 as over 1056 keys: bf16 K8 rounds each
    # probability before the product (2**-9 max |v|) and the output after it
    # (half a bf16 ulp, up to 2**-8 |o|). At max |v| <= 6 that is at most
    # 0.56 of this limit (0.012 at |o| = 0); so does K1's tiled design from
    # N_SHORT + 1 to 63 tokens. Up to N_SHORT tokens K1 runs the few-token
    # design (f32 probabilities, the output rounded once) and keeps
    # `attn_tol`. A plain version with its softmax scale 5% off must fail
    # either limit (`scale_fault`)
    few_tokens_tol = {bf16: (2e-2, 1e-2), f32: (1e-4, 1e-4)}
    scale_fault = 'with its softmax scale 5% off'

    def any_view(fn):
        """``fn`` with the wrappers' 16-byte operand check stood aside: the
        tiled designs read 16-byte chunks, so the wrappers refuse other
        views; the few-token design reads any view (element loads)."""
        def call():
            check = fa._check_operand
            fa._check_operand = lambda t, name, shape, device, dtype, vec: \
                _cuda.check_cuda_tensor(t, name, device, dtype)
            try:
                return fn()
            finally:
                fa._check_operand = check
        return call

    def attn_case(label, b, n, heads, dh, dtype, lens=None, rate=0.0, gated=True,
                  softclamp=50.0, qk_scale=1.0, train=False, timed=False, library=False,
                  hash_kw=None, misaligned=False):
        """``library``: time PyTorch's scaled_dot_product_attention beside it
        (the same function only without mask, softclamp, gate and dropout).
        ``hash_kw``: the dropout hash's offsets; ``misaligned``: q, k, v one
        element into their projection (through `any_view`)."""
        q, k, v, mask, gate = attn_inputs(b, n, heads, dh, dtype, lens, gated, qk_scale,
                                          misaligned)
        D, es = heads * dh, esize(dtype)
        kw = dict(heads=heads, dropout_rate=rate, dropout_seed=1234, gate_logits=gate,
                  **(hash_kw or {}))
        scale = dh ** -0.5
        run = lambda: fa.flash_attention_packed(q, k, v, mask, return_lse=True,
                                                softclamp_value=softclamp, **kw)
        case = dict(
            kernel='K1', label=label, train=train, timed=timed,
            run=any_view(run) if misaligned else run,
            plain=lambda: fa.flash_attention_packed_plain(q, k, v, mask, scale=scale,
                                                          softclamp_value=softclamp, **kw),
            # the tiled bf16 design rounds each probability before p v: below
            # one 64-key tile its outputs are means of a few rows (as K8's)
            tol=(few_tokens_tol if n_short() < n < 64 else attn_tol)[dtype],
            # q, k, v read, o written, lse (+ gate, mask)
            nbytes=4 * b * n * D * es + b * n * heads * ((es if gated else 0) + 4)
            + (b * n if lens else 0),
            flops=4 * b * heads * n * n * dh,
            peak=PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS,
            sfu=transcendentals(b, heads, n, softclamp), sfu_rate=sfu)
        if softclamp is not None and (qk_scale != 1.0 or softclamp != 50.0):
            case['against'] = ('without softclamp', lambda: fa.flash_attention_packed_plain(
                q, k, v, mask, scale=scale, softclamp_value=None, **kw)[0])
        elif 1 < n < 8:     # (a softmax over one key does not see its scale)
            case['against'] = (scale_fault, lambda: fa.flash_attention_packed_plain(
                q, k, v, mask, scale=1.05 * scale, softclamp_value=softclamp, **kw)[0])
        if library:
            q4, k4, v4 = sdpa_views(heads, dh, q, k, v)
            case['library'] = lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=scale)
        cases.append(case)

    def sdpa_backward(heads, dh, q, k, v, dout, scale):
        """One call of PyTorch's flash-attention backward on (b, h, n, dh)
        views, from its own forward's output and lse (None where this
        PyTorch does not have the op)."""
        try:
            q4, k4, v4, do4 = sdpa_views(heads, dh, q, k, v, dout)
            o4, lse4, cq, ck, mq, mk, seed, offset, _ = \
                torch.ops.aten._scaled_dot_product_flash_attention(q4, k4, v4, scale=scale)
            call = lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, False, seed, offset,
                scale=scale)
            call()
            return call
        except (RuntimeError, AttributeError) as e:
            log(f'library: PyTorch\'s flash-attention backward not timed ({e})')
            return None

    def attn_bwd_case(label, b, n, heads, dh, dtype, lens=None, rate=0.0, gated=True,
                      softclamp=50.0, qk_scale=1.0, timed=False, library=False, hash_kw=None,
                      misaligned=False):
        """As `attn_case`; timed, also K2's launch alone (`kernel_only`). At
        n = 1 every grad takes the largest |ref| of them all for its absolute
        term: dq and dk are rounding alone (a softmax over one key has no
        logit gradient)."""
        q, k, v, mask, gate = attn_inputs(b, n, heads, dh, dtype, lens, gated, qk_scale,
                                          misaligned)
        D, es = heads * dh, esize(dtype)
        kw = dict(heads=heads, dropout_rate=rate, dropout_seed=4321, gate_logits=gate,
                  **(hash_kw or {}))
        scale = dh ** -0.5
        fwd = lambda: fa.flash_attention_packed(q, k, v, mask, return_lse=True,
                                                softclamp_value=softclamp, **kw)
        out, lse = any_view(fwd)() if misaligned else fwd()
        dout = randn(b, n, D, dtype=dtype)
        bwd = lambda sc: drop_none(fa.flash_attention_packed_backward_plain(
            q, k, v, mask, out, lse, dout, scale=scale, softclamp_value=sc, **kw))
        run = lambda: drop_none(fa.flash_attention_packed_backward(
            q, k, v, mask, out, lse, dout, softclamp_value=softclamp, **kw))
        case = dict(
            kernel='K2', label=label, scaled='joint' if n == 1 else True, timed=timed,
            run=any_view(run) if misaligned else run,
            plain=lambda: bwd(softclamp),
            tol=tol[dtype],
            # reads q, k, v, do, o, lse (+ gate, mask); writes dq, dk, dv (+ d gate)
            nbytes=8 * b * n * D * es + b * heads * n * 4 + (2 * b * n * heads * es if gated
                                                              else 0)
            + (b * n if lens else 0),
            flops=10 * b * heads * n * n * dh,     # five n x n x dh products
            peak=PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS,
            sfu=transcendentals(b, heads, n, softclamp), sfu_rate=sfu)
        if softclamp is not None and (qk_scale != 1.0 or softclamp != 50.0):
            case['against'] = ('without softclamp', lambda: bwd(None))
        if library:
            call = sdpa_backward(heads, dh, q, k, v, dout, scale)
            if call is not None:
                case['library'] = call
        if timed:
            # K2's launch alone: the wrapper's K10, dq fill and cast left out
            delta, do_g = fa.flash_delta(out, dout, heads=heads, gate_logits=gate)
            dq = torch.zeros((b, n, D), dtype=torch.float32, device=dev)
            dk, dv = torch.empty_like(dout), torch.empty_like(dout)
            case['kernel_only'] = lambda: fa.launch_bwd(
                q, k, v, do_g, mask, lse, delta, dq, dk, dv, heads, scale, softclamp, rate, 4321)
        cases.append(case)

    def hc_params(s, d):
        return (torch.eye(s, s + 1, device=dev).roll(1, dims=1)
                + randn(s, s + 1, dtype=f32, scale=0.1),
                1.0 + randn(s, dtype=f32, scale=0.1),
                randn(d, s + 1, dtype=f32, scale=0.05),
                torch.tensor(0.5, device=dev),
                randn(d, dtype=f32, scale=0.05),
                torch.tensor(0.5, device=dev))

    def alpha_tol(ins, dtype):
        """bf16: besides the output's own rounding (1e-2 + 1e-2 |ref|), an
        alpha may round to the neighbouring bf16 value (its tanh comes from a
        d-term f32 sum taken in another order): one ulp of an alpha near 1
        (2**-7) times the largest |stream| value. At widths 1024-2048 and 8
        streams that happens within the 16896 x 4 rows of the training shape."""
        if dtype != bf16:
            return tol[dtype]
        return (1e-2 + 2 ** -7 * max(float(t.abs().max()) for t in ins), 1e-2)

    def hc_case(label, s, m, d, dtype, fused, train=False, timed=False, any_width=False,
                zero_row=False, bit_equal=False):
        """K3 / K5 against the plain version. ``zero_row`` puts row 5's rms
        statistic on its clamp; ``bit_equal`` also holds two calls bit for
        bit. At bf16 and 4 streams (the Hopper design) K5s / K3s's outputs
        must equal K5 / K3's bit for bit, and a case beyond the tolerance
        may take `alpha_tol` only where it shows alpha rounding flips: the
        alphas from the kernel's saved tanh against the plain version's."""
        params = hc_params(s, d)
        es = esize(dtype)
        out_bytes = ((s + 1) * m * d + s * m) * es
        if zero_row:
            ins = hc_inputs(s, m, d, dtype, fused)
        elif fused:
            ins = (randn(s, m, d, dtype=dtype), randn(m, d, dtype=dtype),
                   randn(s, m, dtype=dtype, scale=0.5))
        else:
            ins = (randn(s, m, d, dtype=dtype),)
        fn = hck.width_connection_fused if fused else hck.width_connection
        fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
        plain_fn = hck.width_connection_fused_plain if fused else hck.width_connection_plain
        in_bytes = (((s + 1) * m * d + s * m) if fused else s * m * d) * es
        case = dict(
            kernel='K3' if fused else 'K5', label=label, run=lambda: fn(*ins, *params),
            plain=lambda: plain_fn(*ins, *params), train=train, timed=timed,
            tol=alpha_tol(ins[:2], dtype) if any_width else tol[dtype],
            nbytes=in_bytes + out_bytes,
            flops=m * s * (2 * d + 2 * d * (s + 2) + 2 * d) + 2 * m * d * s * (s + 1),
            peak=PEAK_F32_FLOPS)        # the kernel's arithmetic is f32 FMA
        if dtype == bf16 and s == 4:
            def flips():
                _, (ta, _) = fwd(*ins, *params, save_state=True)
                _, (pta, _) = plain_fn(*ins, *params, save_state=True)
                affine = lambda t: (t[..., :s + 1] * params[3] + params[0][:, None]).to(bf16)
                return int((affine(ta) != affine(pta)).sum())

            def extra():
                out = fn(*ins, *params)
                saved = all(torch.equal(a, b)
                            for a, b in zip(fwd(*ins, *params, save_state=True)[0], out))
                again = all(torch.equal(a, b) for a, b in zip(fn(*ins, *params), out))
                text = f'; {"K3s" if fused else "K5s"} outputs bit-equal: {saved}'
                if bit_equal:
                    text += f'; two calls bit-equal: {again}'
                return text, saved and (again or not bit_equal)
            case.update(extra=extra, flips=flips, flip_tol=alpha_tol(ins[:2], dtype))
        cases.append(case)

    def hc_bwd_case(label, s, m, d, dtype, fused, timed=False, zero_row=False, bit_equal=False):
        """K4 / K5b against the plain adjoint; ``zero_row`` puts the rms
        statistic of row 5 on its clamp, ``bit_equal`` also holds two calls
        bit for bit."""
        params = hc_params(s, d)
        es = esize(dtype)
        grads = (randn(m, d, dtype=dtype), randn(s, m, d, dtype=dtype), randn(s, m, dtype=dtype))
        zeros = hc_inputs(s, m, d, dtype, fused) if zero_row else None
        param_bytes = ((s + 2) * d + s * (s + 2) + 2) * 4 * 2      # read and written
        grad_in_bytes = ((s + 1) * m * d + s * m) * es
        # per row and stream: rms stat, projection, mix adjoint, back-projection,
        # weight grad, rms adjoint, residual grad
        flops = m * s * d * (4 + 6 * (s + 2) + 4 * (s + 1) + 6)
        if fused:
            args = zeros or (randn(s, m, d, dtype=dtype), randn(m, d, dtype=dtype),
                             randn(s, m, dtype=dtype, scale=0.5))
            run = lambda: hck.width_connection_fused_backward(*args, *params, *grads)
            plain = lambda: hck.width_connection_fused_backward_plain(*args, *params, *grads)
            io_bytes = 2 * ((s + 1) * m * d + s * m) * es      # inputs, and their grads
            flops += 6 * m * s * d
        else:
            res = zeros[0] if zeros else randn(s, m, d, dtype=dtype)
            run = lambda: hck.width_connection_backward(res, *params, *grads)
            plain = lambda: hck.width_connection_backward_plain(res, *params, *grads)
            io_bytes = 2 * s * m * d * es
        case = dict(
            kernel='K4' if fused else 'K5b', label=label, run=run, plain=plain, scaled=True,
            timed=timed,
            tol=tol[dtype], nbytes=io_bytes + grad_in_bytes + param_bytes, flops=flops,
            peak=PEAK_F32_FLOPS)
        if bit_equal:
            def extra():
                same = all(torch.equal(a, b) for a, b in zip(run(), run()))
                return f'; two calls bit-equal: {same}', same
            case['extra'] = extra
        cases.append(case)

    def hc_inputs(s, m, d, dtype, fused):
        """Streams with a zero row (row 5: the rms statistic on its clamp)."""
        if fused:
            ins = (randn(s, m, d, dtype=dtype), randn(m, d, dtype=dtype),
                   randn(s, m, dtype=dtype, scale=0.5))
            ins[0][:, 5] = 0
            ins[1][5] = 0
        else:
            ins = (randn(s, m, d, dtype=dtype),)
            ins[0][:, 5] = 0
        return ins

    def hc_save_case(label, s, m, d, dtype, fused, timed=False):
        """K5s / K3s: the public outputs and the state (ta, inv) against the
        plain version; beside it, the outputs must equal K5 / K3's bit for
        bit and the state the plain state: inv to 1e-6 relative, ta (tanh of
        a d-term f32 sum in another order) to 1e-5 absolute in f32 and 1e-2
        in bf16, where a normed value may round the other way."""
        params, es = hc_params(s, d), esize(dtype)
        ins = hc_inputs(s, m, d, dtype, fused)
        fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
        plain = hck.width_connection_fused_plain if fused else hck.width_connection_plain
        flat = lambda out: (*out[0], *out[1])

        def extra():
            out = fwd(*ins, *params, save_state=True)
            bitwise = all(torch.equal(a, b) for a, b in zip(out[0], fwd(*ins, *params)))
            _, (pta, pinv) = plain(*ins, *params, save_state=True)
            ta, inv = out[1]
            inv_rel = float(((inv - pinv).abs() / pinv.abs()).max())
            ta_err = float((ta - pta).abs().max())
            ta_lim = 1e-5 if dtype == f32 else 1e-2
            ok = bitwise and inv_rel <= 1e-6 and ta_err <= ta_lim
            return (f'; outputs bitwise equal to {"K3" if fused else "K5"}: {bitwise}; '
                    f'inv max rel err {inv_rel:.3e} (<= 1e-6), ta max abs err {ta_err:.3e} '
                    f'(<= {ta_lim:g})'), ok

        in_bytes = (((s + 1) * m * d + s * m) if fused else s * m * d) * es
        cases.append(dict(
            kernel='K3s' if fused else 'K5s', label=label, timed=timed,
            run=lambda: flat(fwd(*ins, *params, save_state=True)),
            plain=lambda: flat(plain(*ins, *params, save_state=True)),
            extra=extra, tol=alpha_tol(ins[:2], dtype),
            nbytes=in_bytes + ((s + 1) * m * d + s * m) * es + s * m * (s + 3) * 4,
            flops=m * s * (2 * d + 2 * d * (s + 2) + 2 * d) + 2 * m * d * s * (s + 1),
            peak=PEAK_F32_FLOPS))

    def hc_bwd_save_case(label, s, m, d, dtype, fused, timed=False, zero_row=False,
                         bit_equal=False, tiny_row=False):
        """K5bs / K4s from K5s / K3s's state against the plain save adjoint
        (K4 / K5b's limits); beside it, at bf16 and 4 streams (the saved ta
        comes from the forward's tensor-core sums, the recomputed one from
        f32 FMAs: two summation orders), K5bs / K4s and K5b / K4 each
        against the f64 reference (`hc_f64_check`), with two planted faults
        that must fail it, and the direct comparison of the two printed;
        elsewhere (one template) K5bs / K4s against K5b / K4 at 1e-5
        max|ref| + 1e-5|ref|. ``zero_row`` puts row 5's rms statistic on its
        clamp, ``bit_equal`` also holds two calls bit for bit; ``tiny_row``
        makes row 7's streams of rms ~1e-7 (a variance under the clamp, the
        streams not zero): there the saved inv must be exactly the clamp's
        1e6, so that the save path's test inv < 1e6 agrees with the
        recomputing var > 1e-12, and the stream grads (g_residuals; K4s's
        g_carried and g_branch) are held against K5b / K4's at one bf16 ulp
        (1e-5 max|ref| + 2**-7|ref|). K4s's g_beta, a d-term sum that one
        gp rounded the other way moves by more than an ulp, is printed
        beside them: the f64 check holds it through its alternatives."""
        params, es = hc_params(s, d), esize(dtype)
        if zero_row:
            ins = hc_inputs(s, m, d, dtype, fused)
        elif fused:
            ins = (randn(s, m, d, dtype=dtype), randn(m, d, dtype=dtype),
                   randn(s, m, dtype=dtype, scale=0.5))
        else:
            ins = (randn(s, m, d, dtype=dtype),)
        if tiny_row:
            for t in ins[:2]:
                t[..., 7, :] = randn(*t[..., 7, :].shape, dtype=dtype, scale=1e-7)
        grads = (randn(m, d, dtype=dtype), randn(s, m, d, dtype=dtype), randn(s, m, dtype=dtype))
        fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
        bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
        bplain = (hck.width_connection_fused_backward_plain if fused
                  else hck.width_connection_backward_plain)
        _, state = fwd(*ins, *params, save_state=True)

        def extra():
            got, rec = bwd(*ins, *params, *grads, state=state), bwd(*ins, *params, *grads)
            text, ok = '', True
            if bit_equal:
                same = all(torch.equal(a, b)
                           for a, b in zip(got, bwd(*ins, *params, *grads, state=state)))
                text, ok = f'; two calls bit-equal: {same}', same
            if tiny_row:
                clamped = [7] + ([5] if zero_row else [])
                inv_c = state[1][:, clamped]
                exact = bool((inv_c == 1e6).all())
                n_stream = 2 if fused else 1
                _, w_tiny = compare(got[:n_stream], rec[:n_stream], 1e-5, 2 ** -7, scaled=True)
                text += (f'; rows {clamped} clamped: saved inv exactly 1e6 {exact} (min '
                         f'{float(inv_c.min())!r}, max {float(inv_c.max())!r}); stream grads '
                         f'against {"K4" if fused else "K5b"}: worst ratio {w_tiny:.3f} of one '
                         f'ulp')
                if fused:
                    _, w_gb = compare(got[2:3], rec[2:3], 1e-5, 2 ** -7, scaled=True)
                    text += f' (g_beta, unchecked: {w_gb:.3f})'
                ok = ok and exact and w_tiny <= 1.0
            if dtype == bf16 and s == 4:
                # planted faults, each must fail: row 0 left out (the
                # kernel run with row 0's incoming grads zero) and
                # dyn_beta_scale's grad x0.7
                drop = tuple(g.clone() for g in grads)
                drop[0][0], drop[1][:, 0], drop[2][:, 0] = 0, 0, 0
                args = (*ins, *params, *grads)
                for name, out, st in ((('K4s' if fused else 'K5bs'), got, state),
                                      (('K4' if fused else 'K5b'), rec, None)):
                    t_ok, ok_k, _ = hc_f64_check(hck, fused, args, out, st)
                    t_drop, ok_drop, w_drop = hc_f64_check(
                        hck, fused, args, bwd(*ins, *params, *drop, state=st), st)
                    _, ok_scale, w_scale = hc_f64_check(hck, fused, args,
                                                        (*out[:-1], out[-1] * 0.7), st)
                    text += (f'; {name} against f64: {t_ok}; planted faults fail: row 0 '
                             f'left out {not ok_drop} (worst ratio {w_drop:.3f}: {t_drop}), '
                             f'dyn_beta_scale grad x0.7 {not ok_scale} (worst ratio '
                             f'{w_scale:.3f})')
                    ok = ok and ok_k and not ok_drop and not ok_scale
                # the two designs directly, printed only: they sum in other orders
                t_dir, _, _ = hc_param_xcheck(got, rec)
                _, w_dir = compare(got[:-6], rec[:-6], 1e-5, 2 ** -7, scaled=True)
                return (text + f'; {"K4s" if fused else "K5bs"} against '
                        f'{"K4" if fused else "K5b"} (unchecked): stream grads {w_dir:.3f} of '
                        f'one ulp, {t_dir}'), ok
            _, worst = compare(got, rec, 1e-5, 1e-5, scaled=True)
            return (text + f'; against {"K4" if fused else "K5b"}: worst ratio {worst:.3f} '
                    f'(|err| <= 1e-5 max|ref| + 1e-5|ref|)'), ok and worst <= 1.0

        param_bytes = ((s + 2) * d + s * (s + 2) + 2) * 4 * 2
        io_bytes = 2 * ((((s + 1) * m * d + s * m) if fused else s * m * d) * es)
        cases.append(dict(
            kernel='K4s' if fused else 'K5bs', label=label, scaled=True, timed=timed,
            run=lambda: bwd(*ins, *params, *grads, state=state),
            plain=lambda: bplain(*ins, *params, *grads, state=state),
            extra=extra, tol=tol[dtype],
            nbytes=io_bytes + ((s + 1) * m * d + s * m) * es + param_bytes
            + s * m * (s + 3) * 4,
            # the adjoint without the rms statistic and the projection
            flops=m * s * d * (2 + 4 * (s + 2) + 4 * (s + 1) + 6) + (6 * m * s * d if fused else 0),
            peak=PEAK_F32_FLOPS))

    def geglu_operand(shape, dtype, offset):
        """Random values of ``shape``; with ``offset`` a contiguous view one
        element into its storage, whose data pointer is not 16-byte aligned."""
        t = randn(math.prod(shape) + int(offset), dtype=dtype)[int(offset):].view(shape)
        assert (t.data_ptr() % 16 != 0) == offset
        return t

    def geglu_design(inner, dtype, *operands):
        """The design csrc/geglu.cu's entry points choose for these operands
        (the outputs come from torch.empty: aligned)."""
        vector = (inner % (16 // esize(dtype)) == 0
                  and all(t.data_ptr() % 16 == 0 for t in operands))
        return 'vector' if vector else 'scalar'

    def geglu_case(label, b, n, inner, dtype, rate=0.0, train=False, timed=False,
                   offset=False):
        h2 = geglu_operand((b, n, 2 * inner), dtype, offset)
        design = geglu_design(inner, dtype, h2)
        case = dict(
            kernel='K6', label=f'{label} [{design} design]',
            run=lambda: gk.geglu_dropout(h2, 77, rate), train=train, timed=timed,
            plain=lambda: gk.geglu_dropout_plain(h2, 77, rate), tol=tol[dtype],
            nbytes=3 * b * n * inner * esize(dtype), flops=20 * b * n * inner,
            peak=PEAK_F32_FLOPS)
        if offset:      # the same values through the vector design: printed, unchecked
            aligned = lambda: gk.geglu_dropout(h2.clone(), 77, rate)
            case['extra'] = lambda: (f'; bit-equal to the vector design on an aligned copy: '
                                     f'{torch.equal(case["run"](), aligned())}', True)
        cases.append(case)

    def geglu_bwd_case(label, b, n, inner, dtype, rate=0.0, timed=False, offset=False):
        h2 = geglu_operand((b, n, 2 * inner), dtype, offset)
        gout = geglu_operand((b, n, inner), dtype, offset)
        design = geglu_design(inner, dtype, h2, gout)
        case = dict(
            kernel='K7', label=f'{label} [{design} design]', timed=timed,
            run=lambda: gk.geglu_dropout_backward(h2, gout, 77, rate),
            plain=lambda: gk.geglu_dropout_backward_plain(h2, gout, 77, rate), tol=tol[dtype],
            nbytes=5 * b * n * inner * esize(dtype), flops=30 * b * n * inner,
            peak=PEAK_F32_FLOPS)
        if offset:      # the same values through the vector design: printed, unchecked
            aligned = lambda: gk.geglu_dropout_backward(h2.clone(), gout.clone(), 77, rate)
            case['extra'] = lambda: (f'; bit-equal to the vector design on an aligned copy: '
                                     f'{torch.equal(case["run"](), aligned())}', True)
        cases.append(case)

    def mel_direct(lib, frames, dft_cos, dft_sin, fbanks, power, nsplit):
        """K11's C entry point of ``lib`` with ``nsplit`` splits. Not the
        wrapper, so it counts no launch."""
        b, t, n_fft = frames.shape
        n_freqs, n_mels = fbanks.shape
        out = torch.empty((b, t, n_mels), dtype=f32, device=dev)
        partial = (torch.empty((nsplit, b * t, n_mels), dtype=f32, device=dev)
                   if nsplit > 1 else None)
        err = lib.e2_mel_fwd(
            frames.data_ptr(), frames.stride(0), frames.stride(1), t, b * t, n_fft,
            dft_cos.data_ptr(), dft_sin.data_ptr(), n_freqs, fbanks.data_ptr(), n_mels,
            out.data_ptr(), partial.data_ptr() if partial is not None else None, nsplit,
            float(power), _cuda.stream_ptr(dev))
        _cuda.check(err, 'mel_fwd direct')
        return out

    def mel_case(label, b, nw, power=1.0, win=1024, train=False, against_power=None,
                 unsplit=False, n_fft=1024, n_mels=100, timed=False, tone=False):
        kw = dict(power=power, win_length=win, filter_length=n_fft, n_mel_channels=n_mels)
        spec = MelSpec(mode='pallas', **kw).to(dev)
        dft_spec = MelSpec(**kw).to(dev)
        wave = (torch.from_numpy(tone_prompt(nw)).to(dev) if tone
                else torch.randn(b, nw, generator=g, device=dev) * 0.1)
        frames = frame_signal(wave, n_fft, HOP, center=True)     # a view of the padded wave
        tables = (spec.dft_cos, spec.dft_sin, spec.fbanks)
        rows, n_freqs, n_mels = b * frames.shape[1], spec.fbanks.shape[0], spec.fbanks.shape[1]
        if unsplit and mk.frequency_splits(rows, n_freqs, sms) == 1:
            raise AssertionError(f'{label}: the wrapper does not split at {rows} rows')
        case = dict(
            kernel='K11', label=label, train=train, timed=timed,
            run=lambda: mk.fused_log_mel(frames, *tables, power),
            plain=lambda: mk.fused_log_mel_plain(frames, *tables, power),
            dft=lambda: dft_spec(wave),
            tol=(2e-3, 1e-3),
            # the padded wave, the two bases and the filterbank read once; log-mel written
            nbytes=4 * (b * (nw + n_fft) + 2 * n_fft * n_freqs + n_freqs * n_mels
                        + rows * n_mels),
            flops=rows * (4 * n_fft * n_freqs + 2 * n_freqs * n_mels),
            peak=PEAK_TF32X3_FLOPS)
        if against_power is not None:
            case['against'] = (f'at power {against_power:g}', lambda: mk.fused_log_mel_plain(
                frames, *tables, against_power))
        if unsplit:     # each block walks every frequency tile of its rows
            case['unsplit'] = lambda: mel_direct(_cuda.lib(), frames, *tables, power, 1)
        if tone:        # the planted fault, split as the wrapper splits
            def one_tf32():
                nsplit = mk.frequency_splits(rows, n_freqs, sms)
                bad = mel_direct(mel_one_tf32, frames, *tables, power, nsplit)
                err, worst = compare(bad, case['plain'](), *case['tol'], False)
                return (f'; one TF32 product a product (csrc/mel.cu without the cross '
                        f'products): max_abs_err={err:.3e}, worst ratio {worst:.3f} '
                        f'(must be > 1)'), worst > 1.0
            case['extra'] = one_tf32
        cases.append(case)

    def delta_case(label, b, n, heads, dh, dtype, gated=False, timed=False):
        o, do = randn(b, n, heads * dh, dtype=dtype), randn(b, n, heads * dh, dtype=dtype)
        gate = randn(b, n, heads, dtype=dtype, scale=2.0) if gated else None
        # K2's caller finds o and do in device memory, not in the 50 MB L2: each
        # call takes the next of four equal copies (4 x 35 MB at the training shape)
        pairs = [(o, do)] + [(o.clone(), do.clone()) for _ in range(3)]
        calls = [0]

        def rotating(fn):
            def call():
                calls[0] += 1
                return fn(*pairs[calls[0] % len(pairs)])
            return call

        split = lambda t: t.view(b, n, heads, dh)
        es = esize(dtype)
        case = dict(
            kernel='K10', label=label, scaled=True, timed=timed,
            run=rotating(lambda o, do: fa.flash_delta(o, do, heads=heads, gate_logits=gate)[0]),
            plain=rotating(lambda o, do: fa.flash_delta_plain(o, do, heads, gate)[0]),
            # f32 sums of dh products in other orders
            tol=(1e-5, 1e-5),
            # o, do (+ the gate) read; delta (+ do_g) written
            nbytes=(3 if gated else 2) * b * n * heads * dh * es + b * n * heads * 4
            + (b * n * heads * es if gated else 0),
            flops=(3 if gated else 2) * b * n * heads * dh, peak=PEAK_F32_FLOPS)
        if gated:
            def extra():
                # do_g within one ulp of the dtype: the kernel's expf and
                # torch's sigmoid may differ in the last bit before the rounding
                got = fa.flash_delta(o, do, heads=heads, gate_logits=gate)[1].float()
                ref = fa.flash_delta_plain(o, do, heads, gate)[1].float()
                ulp = 2.0 ** -7 if dtype == bf16 else 2.0 ** -22
                worst_do_g = float(((got - ref).abs() / (ulp * ref.abs() + 1e-30)).max())
                return (f'; do_g against the plain version: worst |err| / (one ulp of |ref|) '
                        f'{worst_do_g:.3f} (<= 1)'), worst_do_g <= 1.0
            case['extra'] = extra
        else:
            case['library'] = rotating(
                lambda o, do: torch.einsum('bnhd,bnhd->bnh', split(o), split(do)))
        cases.append(case)

    def keep_bits_case(label, b, n, heads, dh, dtype, hash_kw):
        """K1 / K2's keep bits against `dropout_keep_mask` at ``hash_kw``, bit
        for bit: q = k = 0 makes every probability 1 / n, each head's v
        (forward) and do (backward) the first n columns of the identity, so
        o and dv are positive exactly where a key is kept (gated: sigmoid(0)
        = 1/2). The outputs are also held to the plain version."""
        rate, seed = 0.25, 1234
        zeros = torch.zeros(b, n, heads * dh, device=dev, dtype=dtype)
        eye = torch.eye(n, dh, device=dev, dtype=dtype).repeat(b, 1, heads).contiguous()
        gate = torch.zeros(b, n, heads, device=dev, dtype=dtype)
        kw = dict(heads=heads, dropout_rate=rate, dropout_seed=seed, gate_logits=gate, **hash_kw)
        keep = fa.dropout_keep_mask(seed, b * heads, n, rate, device=dev, heads=heads,
                                    **hash_kw).view(b, heads, n, n)
        heads_of = lambda t: t.view(b, n, heads, dh).transpose(1, 2)[..., :n]

        def extra():
            out, lse = fa.flash_attention_packed(zeros, zeros, eye, return_lse=True, **kw)
            dv = fa.flash_attention_packed_backward(zeros, zeros, eye, None, out, lse, eye,
                                                    **kw)[2]
            ok = (torch.equal(heads_of(out) > 0, keep)
                  and torch.equal(heads_of(dv) > 0, keep.transpose(-1, -2)))
            return f'; keep bits of o and dv equal to dropout_keep_mask: {ok}', ok
        cases.append(dict(
            kernel='K1', label=label,
            run=lambda: fa.flash_attention_packed(zeros, zeros, eye, return_lse=True, **kw),
            plain=lambda: fa.flash_attention_packed_plain(zeros, zeros, eye, scale=dh ** -0.5,
                                                          **kw),
            tol=attn_tol[dtype], extra=extra))

    def ring_few_case(label, b, n, heads, dh, dtype, P):
        """The ring (`sp.Loopback`, P shards) over n tokens, K1 / K2 blocks of
        n / P tokens at their hash_r0 / hash_c0, against one launch over the
        n: a wholly masked shard, softclamp 50, dropout 0.1, hash_b0 1. K1:
        the outputs, at `tol` (the ring combines its blocks' bf16 outputs,
        each rounded once, of order 1 over a few keys, and a block's can
        exceed the whole's); K2: the q, k, v grads."""
        from e2_tts_tpu_torch.parallel import sp
        q, k, v, do = (randn(b, n, heads * dh, dtype=dtype) for _ in range(4))
        mask = torch.ones(b, n, dtype=torch.bool, device=dev)
        mask[1, n // P:] = False
        kw = dict(heads=heads, softclamp_value=50.0, dropout_rate=0.1, dropout_seed=77,
                  hash_b0=1)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves)
            out.backward(do)
            return out.detach(), tuple(t.grad for t in leaves)
        ring = lambda: grads(lambda *l: sp.ring_attention(*l, mask, mesh=sp.Loopback(P), **kw))
        one = lambda: grads(lambda *l: fa.flash_attention_packed(*l, mask, **kw))
        cases.append(dict(kernel='K1', label=label, run=lambda: ring()[0],
                          plain=lambda: one()[0], tol=tol[dtype]))
        cases.append(dict(kernel='K2', label=label, scaled=True, run=lambda: ring()[1],
                          plain=lambda: one()[1], tol=tol[dtype]))

    def bhnd_inputs(b, n, heads, dh, dtype, lens, qk_scale):
        # (b, h, n, dh) views of one (b, n, 3 h dh) projection, as the model hands them to K8
        q, k, v, mask, _ = attn_inputs(b, n, heads, dh, dtype, lens, False, qk_scale)
        to_bhnd = lambda t: t.unflatten(-1, (heads, dh)).transpose(1, 2)
        return to_bhnd(q), to_bhnd(k), to_bhnd(v), mask

    def bhnd_case(label, b, n, heads, dh, dtype, lens=None, rate=0.0, softclamp=50.0,
                  qk_scale=1.0, train=False, timed=False):
        q, k, v, mask = bhnd_inputs(b, n, heads, dh, dtype, lens, qk_scale)
        es = esize(dtype)
        kw = dict(dropout_rate=rate, dropout_seed=1234)
        case = dict(
            kernel='K8', label=label, train=train, timed=timed,
            run=lambda: fa.flash_attention(q, k, v, mask, return_lse=True,
                                           softclamp_value=softclamp, **kw),
            plain=lambda: fa.flash_attention_plain(q, k, v, mask, scale=dh ** -0.5,
                                                   softclamp_value=softclamp, **kw),
            tol=(few_tokens_tol if n < 8 else attn_tol)[dtype],
            # q, k, v read, o written (the useful dh columns), lse (+ mask)
            nbytes=4 * b * heads * n * dh * es + b * heads * n * 4 + (b * n if lens else 0),
            flops=4 * b * heads * n * n * dh,
            peak=PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS,
            sfu=transcendentals(b, heads, n, softclamp), sfu_rate=sfu)
        if softclamp is not None and (qk_scale != 1.0 or softclamp != 50.0):
            case['against'] = ('without softclamp', lambda: fa.flash_attention_plain(
                q, k, v, mask, scale=dh ** -0.5, softclamp_value=None, **kw)[0])
        elif n < 8:
            case['against'] = (scale_fault, lambda: fa.flash_attention_plain(
                q, k, v, mask, scale=1.05 * dh ** -0.5, softclamp_value=softclamp, **kw)[0])
        cases.append(case)

    def bhnd_bwd_case(label, b, n, heads, dh, dtype, lens=None, rate=0.0, softclamp=50.0,
                      qk_scale=1.0, timed=False):
        q, k, v, mask = bhnd_inputs(b, n, heads, dh, dtype, lens, qk_scale)
        es = esize(dtype)
        kw = dict(dropout_rate=rate, dropout_seed=4321)
        out, lse = fa.flash_attention(q, k, v, mask, return_lse=True, softclamp_value=softclamp,
                                      **kw)
        dout = randn(b, heads, n, dh, dtype=dtype)
        bwd = lambda sc: fa.flash_attention_backward_plain(
            q, k, v, mask, out, lse, dout, scale=dh ** -0.5, softclamp_value=sc, **kw)
        case = dict(
            kernel='K9', label=label, scaled=True, timed=timed,
            run=lambda: fa.flash_attention_backward(q, k, v, mask, out, lse, dout,
                                                    softclamp_value=softclamp, **kw),
            plain=lambda: bwd(softclamp),
            tol=tol[dtype],
            # reads q, k, v, o, do, lse (+ mask); writes dq, dk, dv
            nbytes=8 * b * heads * n * dh * es + b * heads * n * 4 + (b * n if lens else 0),
            flops=10 * b * heads * n * n * dh,     # five n x n x dh products
            peak=PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS,
            sfu=transcendentals(b, heads, n, softclamp), sfu_rate=sfu)
        if softclamp is not None and (qk_scale != 1.0 or softclamp != 50.0):
            case['against'] = ('without softclamp', lambda: bwd(None))
        if timed or not any(c['kernel'] == 'K9' for c in cases):
            # K9's launch alone: the wrapper's delta, dq fill and dq cast left out
            delta = (dout.float() * out.float()).sum(-1)
            dq = torch.zeros((b, n, heads, dh), dtype=torch.float32, device=dev).transpose(1, 2)
            dk, dv = torch.empty_like(dq, dtype=dtype), torch.empty_like(dq, dtype=dtype)
            case['kernel_only'] = lambda: fa.launch_bwd_bhnd(
                q, k, v, dout, mask, lse, delta, dq, dk, dv, dh ** -0.5, softclamp, rate, 4321)
        cases.append(case)

    def laser_case(label, b, n, heads, dh, dtype, lens=None):
        q, k, v, mask = bhnd_inputs(b, n, heads, dh, dtype, lens, 1.0)
        laser_v = torch.exp(attention_op.softclamp(v.float(), 15.0)).to(dtype)
        cases.append(dict(
            kernel='K8', label=label,
            run=lambda: attention_op.attention(q, k, v, mask, laser=True),
            plain=lambda: torch.log(fa.flash_attention_plain(
                q, k, laser_v, mask, scale=dh ** -0.5, softclamp_value=50.0)[0].float()
                .clamp(min=1e-20)).to(dtype),
            # the log turns one bf16 ulp of out (2**-8 relative) into 4e-3, and
            # its result of order 1 is rounded to bf16 again
            tol=(2e-2, 1e-2), nbytes=0, flops=0, peak=PEAK_BF16_FLOPS))

    def probe_case(label, b, heads, n, dh, mode, timed=False):
        x = randn(b, heads, n, dh, scale=0.25)
        cases.append(dict(
            kernel='probe', label=label, timed=timed, scaled=True,
            run=lambda: fa.flash_probe(x, mode), plain=lambda: fa.flash_probe_plain(x, mode),
            # mode 2 rounds s - (max + sum) (magnitude ~70) to bf16: a max or sum
            # summed in another order moves it by an ulp of that; 1e-2 of max|ref|
            tol=tol[bf16],
            nbytes=2 * b * heads * n * dh * 2, flops=4 * b * heads * n * n * dh,
            peak=PEAK_BF16_FLOPS))

    n = FRAMES + 32          # 1024 frames + 32 registers
    B = TRAIN_BATCH
    # the first case of each kernel is the main path's shape: it is the one timed
    attn_case('speech+text (1,1056,8x64) bf16 gated', 1, n, 8, 64, bf16)
    attn_case('ragged B=2 lens 1056/700 bf16', 2, n, 8, 64, bf16, lens=[n, 700])
    attn_case('dropout 0.1 bf16', 1, n, 8, 64, bf16, rate=0.1)
    # scores ~N(0, 1) barely reach a softclamp of 50; these two put it to work
    attn_case('softclamp 2 (1,1056,8x64) bf16 gated', 1, n, 8, 64, bf16, softclamp=2.0)
    attn_case('f32 n=300 4x32 ungated, q/k x4 (scores ~N(0, 16^2), softclamp 50)',
              1, 300, 4, 32, f32, lens=[250], gated=False, qk_scale=4.0)
    attn_case(f'duration predictor (1,{PREDICTOR_N},8x64) bf16 gated', 1, PREDICTOR_N, 8, 64,
              bf16)
    attn_case(f'train ({B},1056,8x64) bf16 gated dropout 0.1', B, n, 8, 64, bf16, rate=0.1,
              train=True)
    attn_bwd_case(f'train ({B},1056,8x64) bf16 gated dropout 0.1', B, n, 8, 64, bf16, rate=0.1)
    attn_bwd_case('ragged B=2 lens 1056/700 bf16 gated dropout 0.1', 2, n, 8, 64, bf16,
                  lens=[n, 700], rate=0.1)
    attn_bwd_case('softclamp 2 (2,1056,8x64) bf16 gated', 2, n, 8, 64, bf16, softclamp=2.0)
    attn_bwd_case('f32 n=300 4x32 ragged, q/k x4, dropout 0.1', 2, 300, 4, 32, f32,
                  lens=[300, 250], rate=0.1, qk_scale=4.0)
    M = B * n                # 16,896 rows at the training shape
    for fused in (True, False):
        tag = 'fused' if fused else 'plain'
        hc_case(f'{tag} speech (4,1056,512) bf16', 4, n, 512, bf16, fused)
        hc_case(f'{tag} text (4,1056,256) bf16', 4, n, 256, bf16, fused)
        hc_case(f'{tag} ragged M=1756 d=512 bf16', 4, n + 700, 512, bf16, fused)
        hc_case(f'{tag} f32 M=333 d=256', 4, 333, 256, f32, fused)
        hc_case(f'{tag} duration predictor speech (4,{PREDICTOR_N},512) bf16', 4, PREDICTOR_N,
                512, bf16, fused)
        hc_case(f'{tag} duration predictor text (4,{PREDICTOR_N},256) bf16', 4, PREDICTOR_N,
                256, bf16, fused)
        hc_case(f'{tag} train (4,{M},512) bf16', 4, M, 512, bf16, fused, train=True)
        hc_case(f'{tag} paper train (4,{M},1024) bf16', 4, M, 1024, bf16, fused, timed=True)
        hc_case(f'{tag} DiT train (4,{M},1152) bf16', 4, M, 1152, bf16, fused, timed=True)
        hc_bwd_case(f'{tag} train speech (4,{M},512) bf16', 4, M, 512, bf16, fused)
        hc_bwd_case(f'{tag} train text (4,{M},256) bf16', 4, M, 256, bf16, fused)
        hc_bwd_case(f'{tag} ragged M={M - 77} d=512 bf16', 4, M - 77, 512, bf16, fused)
        hc_bwd_case(f'{tag} f32 M=333 d=256', 4, 333, 256, f32, fused)
        # DiT-XL's speech and text widths
        hc_case(f'{tag} DiT speech (4,1056,1152) bf16', 4, n, 1152, bf16, fused, timed=True)
        hc_case(f'{tag} DiT text (4,1056,576) bf16', 4, n, 576, bf16, fused)
        hc_bwd_case(f'{tag} DiT train speech (4,{M},1152) bf16', 4, M, 1152, bf16, fused,
                    timed=True)
        hc_bwd_case(f'{tag} paper train speech (4,{M},1024) bf16', 4, M, 1024, bf16, fused,
                    timed=True)
        hc_bwd_case(f'{tag} DiT train text (4,{M},576) bf16', 4, M, 576, bf16, fused)
        hc_bwd_case(f'{tag} f32 M=333 d=1152', 4, 333, 1152, f32, fused)
    # the Hopper K5 / K3 and K5b / K4 (bf16, 4 streams) at every width from
    # 1 to max_dim(4) with a zero row, a ragged M (and two calls bit for
    # bit), M = 1
    for fused in (False, True):
        tag = 'fused' if fused else 'plain'
        for d in (1, 7, 100, 250, 1000, 2048, 4840):
            hc_case(f'{tag} M=2000 d={d} bf16 zero row', 4, 2000, d, bf16, fused, zero_row=True)
        for d in (1024, 1152):
            hc_case(f'{tag} ragged M={M - 77} d={d} bf16 zero row', 4, M - 77, d, bf16, fused,
                    zero_row=True, bit_equal=True)
        for d in (7, 1024, 4840):
            hc_case(f'{tag} M=1 d={d} bf16', 4, 1, d, bf16, fused)
        for d in (1, 7, 256, 512, 576, 1000, 1024, 1152, 2048, 4840):
            hc_bwd_case(f'{tag} M=2000 d={d} bf16 zero row', 4, 2000, d, bf16, fused,
                        zero_row=True)
        for d in (1024, 1152):
            hc_bwd_case(f'{tag} ragged M={M - 77} d={d} bf16 zero row', 4, M - 77, d, bf16, fused,
                        zero_row=True, bit_equal=True)
        for d in (7, 1024, 4840):
            hc_bwd_case(f'{tag} M=1 d={d} bf16', 4, 1, d, bf16, fused)
    # the save-state variants: first (timed, the JSON line's) at the E2-TTS
    # paper's training shape, speech width 1024; the flagship's and DiT's
    # widths timed too; small cases at other stream counts, f32, a ragged M
    for fused in (False, True):
        tag = 'fused' if fused else 'plain'
        for d in (1024, 512, 1152):
            hc_save_case(f'{tag} train (4,{M},{d}) bf16', 4, M, d, bf16, fused, timed=True)
            hc_bwd_save_case(f'{tag} train (4,{M},{d}) bf16 zero row', 4, M, d, bf16, fused,
                             timed=True, zero_row=True)
        for s_, d, dt, label in ((4, 1024, f32, 'f32'), (2, 64, bf16, 'bf16'),
                                 (3, 100, f32, 'f32'), (8, 2048, bf16, 'bf16')):
            hc_save_case(f'{tag} s={s_} M=2000 d={d} {label}', s_, 2000, d, dt, fused)
            hc_bwd_save_case(f'{tag} s={s_} M=1999 d={d} {label} zero row', s_, 1999, d, dt,
                             fused, zero_row=True)
    # the Hopper K5bs / K4s (bf16, 4 streams) where the Hopper K5b / K4 are
    # held, at M <= 2000: every width from 1 to max_dim(4) with a zero row, a
    # ragged M with two calls bit for bit, M = 1; and a row of rms 1e-7 (the
    # clamp with nonzero streams) beside a zero row
    for fused in (False, True):
        tag = 'fused' if fused else 'plain'
        for d in (1, 7, 100, 250, 1000, 2048, 4840):
            hc_bwd_save_case(f'{tag} M=2000 d={d} bf16 zero row', 4, 2000, d, bf16, fused,
                             zero_row=True)
        for d in (1024, 1152):
            hc_bwd_save_case(f'{tag} ragged M=1923 d={d} bf16 zero row', 4, 1923, d, bf16,
                             fused, zero_row=True, bit_equal=True)
        for d in (7, 1024, 4840):
            hc_bwd_save_case(f'{tag} M=1 d={d} bf16', 4, 1, d, bf16, fused)
        hc_bwd_save_case(f'{tag} M=2000 d=1024 bf16 tiny row (rms 1e-7) and zero row', 4, 2000,
                         1024, bf16, fused, zero_row=True, tiny_row=True)
    # the Hopper K5b / K4 at widths that copy 8-byte (100) and 4-byte (250)
    # pieces, each ending in a part chunk
    for fused in (False, True):
        for d in (100, 250):
            hc_bwd_case(f'{"fused" if fused else "plain"} M=2000 d={d} bf16 zero row', 4, 2000, d,
                        bf16, fused, zero_row=True)
    # any stream count and width (the JAX kernels take any)
    for s_ in (2, 3, 8):
        for d in (32, 64, 100, 768, 1024):
            for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
                for fused in (False, True):
                    tag = 'fused' if fused else 'plain'
                    hc_case(f'{tag} s={s_} M=2000 d={d} {label}', s_, 2000, d, dt, fused,
                            any_width=True)
                    hc_bwd_case(f'{tag} s={s_} M=2000 d={d} {label}', s_, 2000, d, dt, fused)
    for d in (1024, 2048):
        for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
            for fused in (False, True):
                tag = 'fused' if fused else 'plain'
                hc_case(f'{tag} s=4 M=2000 d={d} {label}', 4, 2000, d, dt, fused,
                        any_width=True)
                hc_bwd_case(f'{tag} s=4 M=2000 d={d} {label}', 4, 2000, d, dt, fused)
    geglu_case('speech (1,1056,2x1408) bf16', 1, n, 1408, bf16)
    geglu_case('text (1,1056,2x704) bf16', 1, n, 704, bf16)
    geglu_case('ragged B=2 (2,1056,2x1408) bf16', 2, n, 1408, bf16)
    geglu_case('dropout 0.1 speech bf16', 1, n, 1408, bf16, rate=0.1)
    geglu_case('dropout 0.1 text bf16', 1, n, 704, bf16, rate=0.1)
    geglu_case('f32 (1,77,2x96)', 1, 77, 96, f32, rate=0.1)
    geglu_case(f'duration predictor speech (1,{PREDICTOR_N},2x1408) bf16', 1, PREDICTOR_N,
               1408, bf16)
    geglu_case(f'duration predictor text (1,{PREDICTOR_N},2x704) bf16', 1, PREDICTOR_N, 704,
               bf16)
    geglu_case(f'train ({B},1056,2x1408) bf16 dropout 0.1', B, n, 1408, bf16, rate=0.1,
               train=True)
    geglu_bwd_case(f'train speech ({B},1056,2x1408) bf16 dropout 0.1', B, n, 1408, bf16,
                   rate=0.1)
    geglu_bwd_case(f'train text ({B},1056,2x704) bf16 dropout 0.1', B, n, 704, bf16, rate=0.1,
                   timed=True)
    geglu_bwd_case('f32 (2,77,2x96) dropout 0.1', 2, 77, 96, f32, rate=0.1)
    geglu_case('DiT speech (1,1056,2x3072) bf16', 1, n, 3072, bf16, timed=True)
    geglu_bwd_case(f'DiT train speech ({B},1056,2x3072) bf16 dropout 0.1', B, n, 3072, bf16,
                   rate=0.1, timed=True)
    # the widths the paper's and DiT's training steps run (speech 2752 / 3072,
    # text 1408 / 1536) and the flagship's text width at the training shape
    geglu_case(f'paper train speech ({B},1056,2x2752) bf16 dropout 0.1', B, n, 2752, bf16,
               rate=0.1, timed=True)
    geglu_bwd_case(f'paper train speech ({B},1056,2x2752) bf16 dropout 0.1', B, n, 2752, bf16,
                   rate=0.1, timed=True)
    geglu_case(f'DiT train speech ({B},1056,2x3072) bf16 dropout 0.1', B, n, 3072, bf16,
               rate=0.1, timed=True)
    geglu_case(f'DiT train text ({B},1056,2x1536) bf16 dropout 0.1', B, n, 1536, bf16,
               rate=0.1, timed=True)
    geglu_bwd_case(f'DiT train text ({B},1056,2x1536) bf16 dropout 0.1', B, n, 1536, bf16,
                   rate=0.1, timed=True)
    geglu_case(f'train text ({B},1056,2x704) bf16 dropout 0.1', B, n, 704, bf16, rate=0.1,
               timed=True)
    # the scalar design: an inner that is not a multiple of the vector width,
    # and views one element into their storage (a batch slice such as h2[1:]
    # stays 16-byte aligned at these widths)
    geglu_case('inner 100 (2,1056,2x100) bf16 dropout 0.1', 2, n, 100, bf16, rate=0.1)
    geglu_bwd_case('inner 100 (2,1056,2x100) bf16 dropout 0.1', 2, n, 100, bf16, rate=0.1)
    geglu_case('offset view (2,1056,2x1408) bf16 dropout 0.1', 2, n, 1408, bf16, rate=0.1,
               offset=True)
    geglu_bwd_case('offset view (2,1056,2x1408) bf16 dropout 0.1', 2, n, 1408, bf16, rate=0.1,
                   offset=True)
    geglu_case('offset view f32 (2,77,2x96) dropout 0.1', 2, 77, 96, f32, rate=0.1, offset=True)
    geglu_bwd_case('offset view f32 (2,77,2x96) dropout 0.1', 2, 77, 96, f32, rate=0.1,
                   offset=True)
    mel_case(f'prompt (1,{PROMPT_SAMPLES}) = 282 frames power 1', 1, PROMPT_SAMPLES,
             unsplit=True)
    mel_case(f'train ({B},{TRAIN_WAVE_SAMPLES}) = {B}x1024 frames power 1', B,
             TRAIN_WAVE_SAMPLES, train=True)
    mel_case('power 2 prompt', 1, PROMPT_SAMPLES, power=2.0, against_power=1.0)
    mel_case('power 0.7 prompt', 1, PROMPT_SAMPLES, power=0.7)
    mel_case('tone prompt (220 Hz + noise, last 30% zeros)', 1, PROMPT_SAMPLES, tone=True)
    mel_case('n_fft 1002 prompt (4-byte frame copies, a part-filled k8 step)', 1,
             PROMPT_SAMPLES, win=1002, n_fft=1002)
    mel_case('win_length 800 prompt', 1, PROMPT_SAMPLES, win=800)
    mel_case('ragged 300 rows (2,38144)', 2, 149 * HOP)
    mel_case(f'160 mels n_fft 1000 prompt (1,{PROMPT_SAMPLES})', 1, PROMPT_SAMPLES, win=1000,
             n_fft=1000, n_mels=160, timed=True)
    # the main path's K10 is gated (the flagship's value-head gates), so the
    # gated case, which also writes do_g and has no one-call library
    # yardstick, is K10's record in the `kernels` line; the ungated case
    # beside it, timed with its torch.einsum yardstick, is the one to hold
    # against records that predate the gated K10
    delta_case(f'train ({B},1056,8x64) bf16 gated (writes do_g)', B, n, 8, 64, bf16, gated=True)
    delta_case(f'train ({B},1056,8x64) bf16 ungated', B, n, 8, 64, bf16, timed=True)
    delta_case('ragged n (3,777,8x64) bf16 gated', 3, 777, 8, 64, bf16, gated=True)
    delta_case('ragged n (3,777,8x64) bf16', 3, 777, 8, 64, bf16)
    delta_case('f32 (2,300,4x32) gated', 2, 300, 4, 32, f32, gated=True)
    delta_case('f32 (2,300,4x32)', 2, 300, 4, 32, f32)
    H, DH = DIT['heads'], DIT['dim_head']
    bhnd_case(f'DiT sampler (1,{H},1056,{DH}) bf16', 1, n, H, DH, bf16)
    bhnd_case(f'DiT train ({B},{H},1056,{DH}) bf16 dropout 0.1 softclamp 50', B, n, H, DH, bf16,
              rate=0.1, train=True)
    bhnd_case(f'flagship train shape ({B},8,1056,64) bf16 dropout 0.1 (K1 on the same work: '
              f'its train row)', B, n, 8, 64, bf16, rate=0.1, timed=True)
    bhnd_case(f'ragged n=777 B=2 lens 777/500 ({H}x{DH}) bf16 dropout 0.1', 2, 777, H, DH, bf16,
              lens=[777, 500], rate=0.1)
    bhnd_case(f'softclamp 2 (1,{H},1056,{DH}) bf16', 1, n, H, DH, bf16, softclamp=2.0)
    for dh in (8, 16, 48, 96, 128):
        bhnd_case(f'dh={dh} (2,4,300) bf16 ragged dropout 0.1', 2, 300, 4, dh, bf16,
                  lens=[300, 211], rate=0.1)
    bhnd_case(f'f32 (1,4,300,{DH}) q/k x4 (scores ~N(0, 16^2), softclamp 50)', 1, 300, 4, DH,
              f32, lens=[250], qk_scale=4.0)
    # any dim_head: 12 (zero-padded to 16 by the wrapper), 136 and 256 (two
    # column chunks), ragged n = 777
    for dh in (12, 136, 256):
        for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
            bhnd_case(f'dh={dh} ragged n=777 B=2 lens 777/500 (2,4) {label} dropout 0.1', 2, 777,
                      4, dh, dt, lens=[777, 500], rate=0.1, timed=dh == 256 and dt == bf16)
    bhnd_bwd_case(f'DiT train ({B},{H},1056,{DH}) bf16 dropout 0.1', B, n, H, DH, bf16, rate=0.1)
    bhnd_bwd_case(f'flagship train shape ({B},8,1056,64) bf16 dropout 0.1 (K2 on the same work)',
                  B, n, 8, 64, bf16, rate=0.1, timed=True)
    bhnd_bwd_case(f'ragged n=777 B=2 lens 777/500 ({H}x{DH}) bf16 dropout 0.1', 2, 777, H, DH,
                  bf16, lens=[777, 500], rate=0.1)
    bhnd_bwd_case(f'softclamp 2 (2,{H},1056,{DH}) bf16', 2, n, H, DH, bf16, softclamp=2.0)
    for dh in (8, 16, 48, 96, 128):
        bhnd_bwd_case(f'dh={dh} (2,4,300) bf16 ragged dropout 0.1', 2, 300, 4, dh, bf16,
                      lens=[300, 211], rate=0.1)
    bhnd_bwd_case(f'f32 (2,4,300,{DH}) ragged q/k x4 dropout 0.1', 2, 300, 4, DH, f32,
                  lens=[300, 250], rate=0.1, qk_scale=4.0)
    for dh in (12, 136, 256):
        for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
            bhnd_bwd_case(f'dh={dh} ragged n=777 B=2 lens 777/500 (2,4) {label} dropout 0.1', 2,
                          777, 4, dh, dt, lens=[777, 500], rate=0.1,
                          timed=dh == 256 and dt == bf16)
    laser_case(f'LASER attention (2,{H},1056,{DH}) bf16 ragged', 2, n, H, DH, bf16,
               lens=[n, 700])
    # K8 / K9 at the E2-TTS paper's heads (16 x 64) beside K1 / K2 on the same
    # work (ungated), and K1 / K2 gated as the paper's layers run them
    PH, PDH = PAPER['heads'], PAPER['dim_head']
    bhnd_case(f'paper heads ({B},{PH},1056,{PDH}) bf16 dropout 0.1', B, n, PH, PDH, bf16,
              rate=0.1, timed=True)
    bhnd_bwd_case(f'paper heads ({B},{PH},1056,{PDH}) bf16 dropout 0.1', B, n, PH, PDH, bf16,
                  rate=0.1, timed=True)
    attn_case(f'paper heads ({B},1056,{PH}x{PDH}) bf16 ungated dropout 0.1 (K8 on the same '
              f'work)', B, n, PH, PDH, bf16, rate=0.1, gated=False, timed=True)
    attn_bwd_case(f'paper heads ({B},1056,{PH}x{PDH}) bf16 ungated dropout 0.1 (K9 on the '
                  f'same work)', B, n, PH, PDH, bf16, rate=0.1, gated=False, timed=True)
    attn_case(f'paper heads ({B},1056,{PH}x{PDH}) bf16 gated dropout 0.1', B, n, PH, PDH, bf16,
              rate=0.1, timed=True)
    attn_bwd_case(f'paper heads ({B},1056,{PH}x{PDH}) bf16 gated dropout 0.1', B, n, PH, PDH,
                  bf16, rate=0.1, timed=True)
    for mode in fa.PROBE_MODES:
        probe_case(f'mode {mode} ({B},8,1056,64) bf16', B, 8, n, 64, mode, timed=True)
        probe_case(f'mode {mode} DiT train ({B},{H},1056,{DH}) bf16', B, H, n, DH, mode,
                   timed=True)
    freq_cases(attn_case, attn_bwd_case, delta_case, bhnd_case, bhnd_bwd_case, keep_bits_case,
               ring_few_case)
    return cases


# the frequency attention: each speech layer of a model with num_freq_tokens
# f attends across the f tokens of every frame, a batch of b (n + registers)
# sequences of f tokens (no mask, softclamp, gate or dropout; q, k and v
# strided views of its projection). At the flagship's training batch, 16 x
# 1056 = 16,896 sequences; at B = 16 and N = 4096 frames, 16 x 4128 = 66,048,
# past CUDA's 65,535 blocks in gridDim.z, which the launchers split.
FREQ_TRAIN_BATCH = TRAIN_BATCH * (FRAMES + 32)
FREQ_BIG_BATCH = TRAIN_BATCH * (4096 + 32)


def n_short() -> int:
    """The largest n K1 / K2 run on their few-token design, read off
    csrc/flash_attention_short.cuh (the tiled designs above it)."""
    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)), 'e2_tts_tpu_torch',
                            'csrc', 'flash_attention_short.cuh')).read()
    return int(re.search(r'constexpr int N_SHORT = (\d+);', src).group(1))


# the dropout hash's place of a launch away from the origin on every axis
FEW_HASH = dict(hash_b0=3, hash_h0=2, hash_heads=12, hash_r0=5, hash_c0=7)


def freq_cases(attn_case, attn_bwd_case, delta_case, bhnd_case, bhnd_bwd_case, keep_bits_case,
               ring_few_case):
    """K1 / K2 / K10 at f = 2 and 4 (bf16 and f32, ragged batches), timed at
    the flagship's freq training shape and the sampler's (1,056 sequences,
    2,112 with batched CFG) beside PyTorch's flash attention (the same
    function here), and K1 / K2 / K10 / K8 / K9 at 66,048 sequences; K1 /
    K2 at n = 1 ... N_SHORT + 1 with every feature (both designs, the
    boundary), their keep bits, on misaligned views (the few-token design's
    scalar path) and as ring blocks of a few tokens."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    fb = FREQ_TRAIN_BATCH
    free = dict(gated=False, softclamp=None)
    attn_case(f'freq f=2 train ({fb},2,8x64) bf16', fb, 2, 8, 64, bf16, timed=True,
              library=True, **free)
    attn_bwd_case(f'freq f=2 train ({fb},2,8x64) bf16', fb, 2, 8, 64, bf16, timed=True,
                  library=True, **free)
    delta_case(f'freq f=2 train ({fb},2,8x64) bf16', fb, 2, 8, 64, bf16, timed=True)
    for sb, what in ((FRAMES + 32, 'sample'), (2 * (FRAMES + 32), 'sample batched CFG')):
        attn_case(f'freq f=2 {what} ({sb},2,8x64) bf16', sb, 2, 8, 64, bf16, timed=True,
                  library=True, **free)
    for f in (2, 4):
        for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
            attn_case(f'freq f={f} ragged (1037,{f},8x64) {label}', 1037, f, 8, 64, dt, **free)
            attn_bwd_case(f'freq f={f} ragged (1037,{f},8x64) {label}', 1037, f, 8, 64, dt,
                          **free)
            delta_case(f'freq f={f} ragged (1037,{f},8x64) {label}', 1037, f, 8, 64, dt)
    # every feature at a few tokens: a ragged key mask (row 0 whole, row 1 one
    # key), softclamp 50, the gate, dropout 0.1 at non-zero offsets
    ns = n_short()
    for f in sorted({1, 2, 3, 4, 8, 16, ns, ns + 1}):
        lens = [f, 1] + [1 + (7 * i) % f for i in range(35)]
        for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
            design = 'few-token' if f <= ns else 'tiled'
            what = f'few tokens f={f} ({design}) (37,{f},4x64) {label} all features'
            attn_case(what, 37, f, 4, 64, dt, lens=lens, rate=0.1, hash_kw=FEW_HASH)
            attn_bwd_case(what, 37, f, 4, 64, dt, lens=lens, rate=0.1, hash_kw=FEW_HASH)
    for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
        for f in (2, 3, ns):
            keep_bits_case(f'few tokens keep bits f={f} (5,{f},3x32) {label} dropout 0.25 '
                           f'offsets', 5, f, 3, 32, dt, FEW_HASH)
        for P in (2, 4):
            ring_few_case(f'few tokens ring of {P} blocks (1037,8,8x64) {label}', 1037, 8, 8, 64,
                          dt, P)
        what = f'few tokens misaligned views (scalar path) (23,3,8x64) {label} all features'
        lens = [3, 1] + [1 + i % 3 for i in range(21)]
        attn_case(what, 23, 3, 8, 64, dt, lens=lens, rate=0.1, hash_kw=FEW_HASH,
                  misaligned=True)
        attn_bwd_case(what, 23, 3, 8, 64, dt, lens=lens, rate=0.1, hash_kw=FEW_HASH,
                      misaligned=True)
    big = FREQ_BIG_BATCH
    for dt, label in ((bf16, 'bf16'), (f32, 'f32')):
        attn_case(f'batch past gridDim.z ({big},2,8x64) {label}', big, 2, 8, 64, dt, **free)
        attn_bwd_case(f'batch past gridDim.z ({big},2,8x64) {label}', big, 2, 8, 64, dt,
                      **free)
        delta_case(f'batch past gridDim.z ({big},2,8x64) {label}', big, 2, 8, 64, dt)
        # freq_dim_head 8 (K8 / K9's route); 136 runs the wide template's two column chunks
        for heads, dh in ((8, 8), (1, 136)):
            bhnd_case(f'batch past gridDim.z ({big},{heads},2,{dh}) {label}', big, 2, heads,
                      dh, dt, softclamp=None)
            bhnd_bwd_case(f'batch past gridDim.z ({big},{heads},2,{dh}) {label}', big, 2,
                          heads, dh, dt, softclamp=None)


KERNEL_INFO = {
    'K1': dict(name='flash_fwd', route='cuda',
               source='e2_tts_tpu_torch/csrc/flash_attention.cu',
               replaces='e2_tts_tpu/ops/flash_attention.py:819'),
    'K3': dict(name='hc_width_fused', route='cuda',
               source='e2_tts_tpu_torch/csrc/hyper_conn.cu',
               replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:199'),
    'K5': dict(name='hc_width', route='cuda',
               source='e2_tts_tpu_torch/csrc/hyper_conn.cu',
               replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:169'),
    'K6': dict(name='geglu_fwd', route='cuda',
               source='e2_tts_tpu_torch/csrc/geglu.cu',
               replaces='e2_tts_tpu/ops/geglu_kernel.py:78'),
    'K2': dict(name='flash_bwd', route='cuda',
               source='e2_tts_tpu_torch/csrc/flash_attention_bwd.cu',
               replaces='e2_tts_tpu/ops/flash_attention.py:1041'),
    'K4': dict(name='hc_width_fused_bwd', route='cuda',
               source='e2_tts_tpu_torch/csrc/hyper_conn_bwd.cu',
               replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:603'),
    'K5b': dict(name='hc_width_bwd', route='cuda',
                source='e2_tts_tpu_torch/csrc/hyper_conn_bwd.cu',
                replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:562'),
    'K7': dict(name='geglu_bwd', route='cuda',
               source='e2_tts_tpu_torch/csrc/geglu.cu',
               replaces='e2_tts_tpu/ops/geglu_kernel.py:90'),
    'K11': dict(name='mel_fwd', route='cuda',
                source='e2_tts_tpu_torch/csrc/mel.cu',
                replaces='e2_tts_tpu/ops/mel_kernel.py:27'),
    'K10': dict(name='flash_delta', route='cuda',
                source='e2_tts_tpu_torch/csrc/flash_attention_bwd.cu',
                replaces='e2_tts_tpu/ops/flash_attention.py:1198'),
    'K8': dict(name='flash_fwd_bhnd', route='cuda',
               source='e2_tts_tpu_torch/csrc/flash_attention_bhnd.cu',
               replaces='e2_tts_tpu/ops/flash_attention.py:161'),
    'K9': dict(name='flash_bwd_bhnd', route='cuda',
               source='e2_tts_tpu_torch/csrc/flash_attention_bhnd.cu',
               replaces='e2_tts_tpu/ops/flash_attention.py:421'),
    'probe': dict(name='flash_probe', route='cuda',
                  source='e2_tts_tpu_torch/csrc/flash_probe.cu',
                  replaces='scripts/_kernel_floor.py:18'),
    'K5s': dict(name='hc_width_save', route='cuda',
                source='e2_tts_tpu_torch/csrc/hyper_conn_save.cu',
                replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:176'),
    'K3s': dict(name='hc_width_fused_save', route='cuda',
                source='e2_tts_tpu_torch/csrc/hyper_conn_save.cu',
                replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:207'),
    'K5bs': dict(name='hc_width_bwd_save', route='cuda',
                 source='e2_tts_tpu_torch/csrc/hyper_conn_bwd_save.cu',
                 replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:573'),
    'K4s': dict(name='hc_width_fused_bwd_save', route='cuda',
                source='e2_tts_tpu_torch/csrc/hyper_conn_bwd_save.cu',
                replaces='e2_tts_tpu/ops/hyper_conn_kernel.py:619'),
}
# the kernels whose launches the JSON line takes from the sampling run, the
# serving run, the DiT sampling run and the DiT train steps; the rest from the
# flagship train steps. The probe is on no path: its count is the flagship
# train steps' 0.
SAMPLE_KERNELS = ('K1', 'K3', 'K5', 'K6')
SERVE_KERNELS = ('K11',)
DIT_SAMPLE_KERNELS = ('K8',)
DIT_TRAIN_KERNELS = ('K9',)
PAPER_SAVE_KERNELS = ('K5s', 'K3s', 'K5bs', 'K4s')    # the paper's train steps, saving


def time_case(case):
    bms, by = bound_ms(case['nbytes'], case['flops'], case['peak'])
    timed = dict(ms=graph_ms(case['run'], 100), plain_ms=graph_ms(case['plain'], 50),
                 library_ms=graph_ms(case['library'], 100) if 'library' in case else None,
                 eager_ms=eager_ms(case['run'], 100), bound_ms=bms, bound_by=by)
    if 'sfu' in case:
        timed['sfu_floor_ms'] = case['sfu'] / case['sfu_rate'] * 1e3
    if 'dft' in case:
        timed['dft_ms'] = graph_ms(case['dft'], 50)
    if 'unsplit' in case:
        timed['unsplit_ms'] = graph_ms(case['unsplit'], 100)
    if 'kernel_only' in case:
        timed['kernel_only_ms'] = graph_ms(case['kernel_only'], 100)
    return timed


def phase_kernels(torch, dev, mel_one_tf32):
    """Returns ``{kernel: record}`` (the first case's times, the worst error)
    and ``{kernel: record}`` of the forward kernels at the training shape."""
    records, train_records = {}, {}
    for case in kernel_cases(torch, dev, mel_one_tf32):
        kname, label, (atol, rtol) = case['kernel'], case['label'], case['tol']
        scaled = case.get('scaled', False)
        out = case['run']()
        torch.cuda.synchronize()
        ref_out = case['plain']()
        err, worst = compare(out, ref_out, atol, rtol, scaled)
        rec = records.setdefault(kname, dict(max_abs_err=0.0))
        rec['max_abs_err'] = max(rec['max_abs_err'], err)
        abs_term = f'{atol:g} max|ref|' if scaled else f'{atol:g}'
        line = (f'kernel {kname} {label}: max_abs_err={err:.3e} '
                f'(tolerance |err| <= {abs_term} + {rtol:g}|ref|, worst ratio {worst:.3f})')
        if worst > 1.0 and 'flips' in case:
            n_flips = case['flips']()
            if n_flips:
                atol, rtol = case['flip_tol']
                _, worst = compare(out, ref_out, atol, rtol, scaled)
                line += (f'; {n_flips} alpha rounding flips (the kernel\'s saved tanh against '
                         f'the plain version\'s): alpha_tol |err| <= {atol:.4g} + {rtol:g}|ref|, '
                         f'worst ratio {worst:.3f}')
        separated = True
        if 'against' in case:
            what, against = case['against']
            err_nc, worst_nc = compare(out[0] if kname in ('K1', 'K8') else out, against(),
                                       atol, rtol, scaled)
            separated = worst_nc > 1.0
            line += (f'; against the plain version {what}: '
                     f'max_abs_err={err_nc:.3e}, worst ratio {worst_nc:.3f} (must be > 1)')
        if 'unsplit' in case:
            err_u, worst_u = compare(case['unsplit'](), case['plain'](), atol, rtol, scaled)
            worst = max(worst, worst_u)
            line += f'; unsplit: max_abs_err={err_u:.3e}, worst ratio {worst_u:.3f}'
        extra_ok = True
        if 'extra' in case:
            suffix, extra_ok = case['extra']()
            line += suffix
        timed = None
        if case.get('train'):
            timed = train_records[kname] = time_case(case)
        elif case.get('timed') or 'ms' not in rec:
            timed = time_case(case)
            if 'ms' not in rec:
                rec.update(timed)
        if timed:
            line += (f' ms={timed["ms"]:.5f} plain_ms={timed["plain_ms"]:.5f} '
                     f'eager_call_ms={timed["eager_ms"]:.5f} bound_ms={timed["bound_ms"]:.5f} '
                     f'({timed["bound_by"]})')
            if timed['library_ms'] is not None:
                line += f' library_ms={timed["library_ms"]:.5f}'
            if 'sfu_floor_ms' in timed:
                line += f' sfu_floor_ms={timed["sfu_floor_ms"]:.5f}'
            if 'dft_ms' in timed:
                line += f' melspec_dft_ms={timed["dft_ms"]:.5f}'
            if 'unsplit_ms' in timed:
                line += f' unsplit_ms={timed["unsplit_ms"]:.5f}'
            if 'kernel_only_ms' in timed:
                line += f' kernel_only_ms={timed["kernel_only_ms"]:.5f}'
        log(line)
        del out, ref_out
        if worst > 1.0:
            raise AssertionError(f'{kname} {label}: kernel disagrees with its plain version')
        if not extra_ok:
            raise AssertionError(f'{kname} {label}: a check beside the plain version failed')
        if not separated:
            raise AssertionError(f'{kname} {label}: the check cannot tell the kernel from '
                                 f'the plain version {case["against"][0]}')
    torch.cuda.empty_cache()
    return records, train_records


def time_hc_save_pairs(torch, dev, smi):
    """The hyper-connection save-state A/B at the training shape (4 streams,
    B=16 x 1056 rows, bf16): each forward and adjoint alone, recomputing
    (K5 + K5b, K3 + K4) and saving (K5s + K5bs, K3s + K4s), and the pairs'
    sums, device time in CUDA graphs, each beside its bound."""
    from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck
    g = torch.Generator(device=dev).manual_seed(9)
    randn = lambda *shape, scale=1.0: (torch.randn(shape, generator=g, device=dev)
                                       * scale).to(torch.bfloat16)
    s, m = 4, TRAIN_BATCH * (FRAMES + 32)
    for d in (512, 1024, 1152):
        params = (torch.eye(s, s + 1, device=dev).roll(1, dims=1),
                  torch.ones(s, device=dev), randn(d, s + 1, scale=0.05).float(),
                  torch.tensor(0.5, device=dev), randn(d, scale=0.05).float(),
                  torch.tensor(0.5, device=dev))
        grads = (randn(m, d), randn(s, m, d), randn(s, m))
        for fused in (False, True):
            ins = ((randn(s, m, d), randn(m, d), randn(s, m, scale=0.5)) if fused
                   else (randn(s, m, d),))
            fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
            bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
            _, state = fwd(*ins, *params, save_state=True)
            row = ((s + 1) * d + s) if fused else s * d          # stream values read per row
            out_row = (s + 1) * d + s
            st_row = s * (s + 3) * 4                              # ta and inv, f32 bytes
            nbytes = dict(fwd=m * (row + out_row) * 2, bwd=m * (2 * row + out_row) * 2)
            ms = dict(
                fwd=graph_ms(lambda: fwd(*ins, *params), 100),
                fwd_save=graph_ms(lambda: fwd(*ins, *params, save_state=True), 100),
                bwd=graph_ms(lambda: bwd(*ins, *params, *grads), 50),
                bwd_save=graph_ms(lambda: bwd(*ins, *params, *grads, state=state), 50))
            bound = dict(fwd=nbytes['fwd'] / PEAK_BYTES * 1e3,
                         fwd_save=(nbytes['fwd'] + m * st_row) / PEAK_BYTES * 1e3,
                         bwd=nbytes['bwd'] / PEAK_BYTES * 1e3,
                         bwd_save=(nbytes['bwd'] + m * st_row) / PEAK_BYTES * 1e3)
            names = ('K3', 'K4', 'K3s', 'K4s') if fused else ('K5', 'K5b', 'K5s', 'K5bs')
            log(f'hc save A/B (4,{m},{d}) bf16 {"fused" if fused else "plain"}: '
                f'{names[0]}_ms={ms["fwd"]:.5f} {names[1]}_ms={ms["bwd"]:.5f} '
                f'pair_ms={ms["fwd"] + ms["bwd"]:.5f} (bound {bound["fwd"] + bound["bwd"]:.5f}); '
                f'{names[2]}_ms={ms["fwd_save"]:.5f} {names[3]}_ms={ms["bwd_save"]:.5f} '
                f'pair_ms={ms["fwd_save"] + ms["bwd_save"]:.5f} '
                f'(bound {bound["fwd_save"] + bound["bwd_save"]:.5f}); bounds_ms '
                f'{json.dumps({k: round(v, 5) for k, v in bound.items()})} [{smi}]')
            del ins, state
        del grads
    torch.cuda.empty_cache()


def time_sdpa_yardstick(torch, dev, smi):
    """K8 / K9 without the softclamp and dropout beside PyTorch's
    scaled_dot_product_attention (flash backend) at the DiT training shape:
    a yardstick of the products alone, not the same function (no softclamp,
    no counter-hash dropout). Forwards as device time in CUDA graphs; the
    backwards as eager time over 20 back-to-back calls (SDPA's through
    autograd), both sides the same way."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from e2_tts_tpu_torch.ops import flash_attention as fa
    b, h, n, dh = TRAIN_BATCH, DIT['heads'], FRAMES + 32, DIT['dim_head']
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn(b, h, n, dh, generator=g, device=dev).to(torch.bfloat16)
                     for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        sdpa_fwd = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
                            100)
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
        sdpa_bwd = eager_ms(lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout,
                                                        retain_graph=True), 20)
    k8 = graph_ms(lambda: fa.flash_attention(q, k, v), 100)
    k9 = eager_ms(lambda: fa.flash_attention_backward(q, k, v, None, out, lse, dout), 20)
    log(f'yardstick ({b},{h},{n},{dh}) bf16, no softclamp, no dropout (not the same function): '
        f'sdpa_flash_fwd_ms={sdpa_fwd:.5f} K8_ms={k8:.5f}; sdpa_flash_bwd_eager_ms='
        f'{sdpa_bwd:.5f} K9_eager_ms={k9:.5f} [{smi}]')
    del q, k, v, dout, out, lse, qg, kg, vg, sdpa_out
    torch.cuda.empty_cache()


def time_probe_floor(torch, dev, smi):
    """The `probe floor` lines: at the flagship's and DiT's training heads,
    K8 without softclamp and dropout beside the probe's three modes (the
    same kernel with the softmax's pieces compiled out: products only, +
    exp, + the tile's max and sum), device time in CUDA graphs, and the
    products' bound. Mode 0 at or under K8 says the probe floors it."""
    from e2_tts_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(11)
    n = FRAMES + 32
    for heads, dh in ((8, 64), (DIT['heads'], DIT['dim_head'])):
        b = TRAIN_BATCH
        x = (torch.randn(b, heads, n, dh, generator=g, device=dev) * 0.25).to(torch.bfloat16)
        k8 = graph_ms(lambda: fa.flash_attention(x, x, x), 100)
        modes = [graph_ms(lambda mode=mode: fa.flash_probe(x, mode), 100)
                 for mode in fa.PROBE_MODES]
        bms, by = bound_ms(2 * b * heads * n * dh * 2, 4 * b * heads * n * n * dh,
                           PEAK_BF16_FLOPS)
        log(f'probe floor ({b},{heads},{n},{dh}) bf16: K8_no_softclamp_no_dropout_ms={k8:.5f} '
            + ' '.join(f'mode{mode}_ms={ms:.5f}' for mode, ms in zip(fa.PROBE_MODES, modes))
            + f' bound_ms={bms:.5f} ({by}) mode0_at_or_under_K8={modes[0] <= k8} [{smi}]')
        del x
    torch.cuda.empty_cache()


# -- phase 4: main path (sample) --------------------------------------------------

def build_e2tts(torch, device, dtype, e2tts=None, config=FLAGSHIP, **transformer):
    """The E2TTS of ``config`` (the flagship unless given; with the keyword
    arguments ``e2tts``) with weights from seed 0, each perturbed by 0.02 *
    randn (so zero-initialised branches are live), built on the CPU and moved:
    equal seeds give equal weights on every device. A Vocos (outside the
    parameters) is seeded on its own and follows the mels to their device
    when it decodes."""
    from e2_tts_tpu_torch import E2TTS
    gen = torch.Generator().manual_seed(0)
    model = E2TTS(transformer=dict(config, **transformer), dtype=dtype, generator=gen,
                  device='cpu', **(e2tts or {}))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model.to(device)


def attention_kernels(dim_head: int) -> tuple:
    """The forward and backward kernels' counters of an attention with
    ``dim_head``: K1 / K2 where K1 takes the head, else K8 / K9."""
    return (('flash_fwd', 'flash_bwd') if dim_head in (32, 64, 128) else
            ('flash_fwd_bhnd', 'flash_bwd_bhnd'))


def expected_launches(model, steps: int, attention='flash_fwd', evals=None) -> dict:
    """Launches of one `sample` with sequential CFG, from the model's
    structure: per speech layer K5 once (the conv branch starts a chain),
    K3 twice (attention, feedforward chained), the attention kernel once (K1,
    or K8 for heads K1 does not take), K6 once; per text layer the same again.
    The null pass runs no text stream. Midpoint makes two evaluations per
    interval, each a cond and a null pass (``evals``: the count of
    evaluations, for a solver that sets its own). With the frequency axis
    each speech layer also runs the frequency attention (K1 or K8 by its
    head) behind one more chained connection (K3)."""
    tf = model.transformer
    cond_layers = tf.depth + tf.text_depth
    null_layers = tf.depth
    per_eval = cond_layers + null_layers
    evals = (steps - 1) * 2 if evals is None else evals
    counts = {attention: per_eval * evals, 'geglu_fwd': per_eval * evals,
              'hc_width': per_eval * evals, 'hc_width_fused': 2 * per_eval * evals}
    if tf.has_freq_axis:
        freq = 2 * tf.depth * evals
        key = attention_kernels(tf.freq_dim_head)[0]
        counts[key] = counts.get(key, 0) + freq
        counts['hc_width_fused'] += freq
    return counts


def check_cfg_eval(torch, dev, model, cpu_model, label, frames=FRAMES,
                   prompt_frames=PROMPT_FRAMES):
    """One sequential-CFG evaluation (B=1, 1024 frames, a 256-frame prompt,
    the text) of ``model`` (bf16, on the card) against ``cpu_model`` (the
    same weights, f32 on the CPU). Returns the generator of its inputs, to
    draw the prompt from."""
    g = torch.Generator().manual_seed(1)
    text_ids = torch.as_tensor(model.tokenizer([TEXT]), dtype=torch.long)
    x = torch.randn(1, frames, 100, generator=g)
    cond = torch.zeros(1, frames, 100)
    cond[:, :prompt_frames] = torch.randn(1, prompt_frames, 100, generator=g)
    times = torch.tensor([0.5])
    mask = torch.ones(1, frames, dtype=torch.bool)
    kw = dict(cfg_strength=1.0, batched_cfg=False)
    with torch.no_grad():
        out = model.cfg_transformer_with_pred_head(
            x.to(dev, torch.bfloat16), cond.to(dev, torch.bfloat16), times.to(dev),
            text=text_ids.to(dev), mask=mask.to(dev), **kw).float().cpu()
        ref = cpu_model.cfg_transformer_with_pred_head(x, cond, times, text=text_ids,
                                                       mask=mask, **kw)
    rel_l2 = float((out - ref).norm() / ref.norm())
    rel_max = float((out - ref).abs().max() / ref.abs().max())
    log(f'{label} cfg eval bf16 card vs f32 cpu: rel_l2={rel_l2:.3e} rel_max={rel_max:.3e} '
        f'(tolerance rel_l2 <= 5e-2: bf16 keeps 8 mantissa bits; the flagship in bf16 on '
        f'the CPU lands near 2e-2 at depth 8)')
    if not (torch.isfinite(out).all() and rel_l2 <= 5e-2):
        raise AssertionError(f'{label}: the card disagrees with the f32 CPU reference')
    return g


def phase_main(torch, dev, smi):
    from e2_tts_tpu_torch.ops import _cuda

    model = build_e2tts(torch, dev, torch.bfloat16).eval()
    cpu_model = build_e2tts(torch, 'cpu', None).eval()     # same weights, f32 compute
    n_params = sum(p.numel() for p in model.parameters())
    g = check_cfg_eval(torch, dev, model, cpu_model, 'main')
    del cpu_model

    prompt = torch.randn(1, PROMPT_FRAMES, 100, generator=g).to(dev, torch.bfloat16)
    sample_kw = dict(text=[TEXT], duration=FRAMES, cfg_strength=1.0,
                     generator=torch.Generator(device=dev).manual_seed(2))
    model.sample(prompt, steps=2, **sample_kw)          # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    mel = model.sample(prompt, steps=STEPS, **sample_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)

    if tuple(mel.shape) != (1, FRAMES, 100) or not torch.isfinite(mel).all():
        raise AssertionError(f'sample output bad: shape {tuple(mel.shape)}')
    expected = dict.fromkeys(_cuda.KERNELS, 0)
    expected.update(expected_launches(model, STEPS))
    audio_s = FRAMES / FRAMES_PER_SECOND
    log(f'main sample B=1 frames={FRAMES} NFE={2 * (STEPS - 1)} midpoint cfg=1.0 sequential: '
        f'seconds={seconds:.4f} rtf={seconds / audio_s:.5f} params={n_params} '
        f'launches={json.dumps(counts, sort_keys=True)} [{smi}]')
    if counts != expected:
        raise AssertionError(f'launch counts {counts} != expected {expected}')
    return counts, model


# -- phase 5: serve from a raw waveform ---------------------------------------------

def predictor_launches(predictor) -> dict:
    """Launches of one duration-predictor evaluation with text: per speech
    and per text layer K5 once, K3 twice, K1 and K6 once."""
    tf = predictor.transformer
    layers = tf.depth + tf.text_depth
    return dict(flash_fwd=layers, hc_width=layers, hc_width_fused=2 * layers, geglu_fwd=layers)


# duration: the predicted frame count is an expectation over 128 bins of a
# softmax whose logits carry bf16 rounding through 16 layers; the card read
# 1.3e-3 against the f32 CPU model in three runs, and 1e-2 is ~7x that. It
# has to be tight: with random weights near-uniform bins put any answer near
# 1024, only ~5% from the CPU's ~972, so a kernel fault that pushed the
# logits towards uniform would pass a 5e-2 limit. The vocoder runs in f32 on
# both sides (TF32 off), so only summation order separates them.
SERVE_TOL = dict(duration=1e-2, vocos=1e-4)


def phase_serve(torch, dev, smi):
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.ops.mel import db_to_amplitude

    model = build_e2tts(torch, dev, torch.bfloat16, e2tts=SERVE_E2TTS).eval()
    cpu_model = build_e2tts(torch, 'cpu', None, e2tts=SERVE_E2TTS).eval()
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator().manual_seed(4)
    wave = torch.randn(1, PROMPT_SAMPLES, generator=g) * 0.1
    prompt = wave.to(dev)
    with torch.no_grad():
        # as `sample` runs it: the model's frontend (K11 on the card, its
        # plain version on the CPU), then the predictor on the mel
        prompt_mel = model._as_mel(prompt)
        pred = float(model.duration_predictor(prompt_mel, text=[TEXT], return_loss=False)[0])
        ref = float(cpu_model.duration_predictor(cpu_model._as_mel(wave), text=[TEXT],
                                                 return_loss=False)[0])
    rel = abs(pred - ref) / abs(ref)
    log(f'serve duration predictor bf16 card vs f32 cpu (prompt {PROMPT_SAMPLES} samples '
        f'through the model\'s frontend, text {len(TEXT)} chars): frames={pred:.4f} '
        f'cpu_frames={ref:.4f} rel_err={rel:.3e} (<= {SERVE_TOL["duration"]:g})')
    if not rel <= SERVE_TOL['duration']:
        raise AssertionError('the duration predictor on the card disagrees with the CPU')

    mel = torch.randn(1, FRAMES, 100, generator=g) * 2.0 - 4.0
    amp = db_to_amplitude(mel, 1.0, 0.5)
    with torch.no_grad():
        wav = model.vocos.to(dev).decode(amp.to(dev)).cpu()
        wav_ref = cpu_model.vocos.decode(amp)
    rel_l2 = float((wav - wav_ref).norm() / wav_ref.norm())
    log(f'serve vocos decode f32 card vs cpu ({FRAMES} frames -> {wav.shape[-1]} samples): '
        f'rel_l2={rel_l2:.3e} (<= {SERVE_TOL["vocos"]:g})')
    if not (wav.shape == wav_ref.shape and torch.isfinite(wav).all()
            and rel_l2 <= SERVE_TOL['vocos']):
        raise AssertionError('the vocoder on the card disagrees with the CPU')
    del cpu_model

    sample_kw = dict(text=[TEXT], cfg_strength=1.0,
                     generator=torch.Generator(device=dev).manual_seed(5))
    model.sample(prompt, steps=2, **sample_kw)            # warm-up
    torch.cuda.synchronize()
    # the parts of a request apart from the sampler's ODE loop, each alone
    amp_card = amp[:, :int(pred)].to(dev)
    with torch.no_grad():
        parts_ms = dict(
            mel_frontend=eager_ms(lambda: model.mel_spec(prompt), 20),
            duration_predictor=eager_ms(lambda: model.duration_predictor(
                prompt_mel, text=[TEXT], return_loss=False), 5),
            vocoder=eager_ms(lambda: model.vocos.decode(amp_card), 5))
    log(f'serve parts alone (wall ms per call, eager): '
        f'{json.dumps({k: round(v, 4) for k, v in parts_ms.items()})} [{smi}]')
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    audio = model.sample(prompt, steps=STEPS, **sample_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)

    prompt_frames = 1 + PROMPT_SAMPLES // HOP
    samples = audio[0].shape[-1]
    duration = samples // HOP + 1
    audio_s = samples / 24_000
    log(f'serve sample B=1 prompt_samples={PROMPT_SAMPLES} ({prompt_frames} frames) no duration '
        f'NFE={2 * (STEPS - 1)} midpoint cfg=1.0 sequential vocos: predicted_frames={duration} '
        f'waveform_samples={samples} seconds={seconds:.4f} rtf_with_vocoder={seconds / audio_s:.5f} '
        f'params={n_params} launches={json.dumps(counts, sort_keys=True)} [{smi}]')
    # `sample` sets the duration to max(max(prompt, text) + 1, int(prediction));
    # the prediction it makes itself may round to the neighbouring integer
    want = max(max(prompt_frames, len(TEXT.encode())) + 1, int(pred))
    if (len(audio) != 1 or samples != (duration - 1) * HOP or abs(duration - want) > 1
            or not torch.isfinite(audio[0]).all()):
        raise AssertionError(f'serve output bad: {len(audio)} waveforms of {samples} samples, '
                             f'expected about {(want - 1) * HOP}')
    expected = dict.fromkeys(_cuda.KERNELS, 0)
    expected.update(expected_launches(model, STEPS))
    for name, n in predictor_launches(model.duration_predictor).items():
        expected[name] += n
    expected['mel_fwd'] = 1
    if counts != expected:
        raise AssertionError(f'serve launch counts {counts} != expected {expected}')

    # the request again (2 ODE steps), its audio written as WAV files
    from e2_tts_tpu_torch.utils.audio_io import load_wav
    target = os.path.join('build', 'serve', 'serve.wav')
    audio = model.sample(prompt, steps=2, save_to_filename=target, **sample_kw)[0].float().cpu()
    back, sr = load_wav(os.path.join('build', 'serve', '1.serve.wav'))
    clipped = int((audio.abs() > 1).sum())
    err = float((torch.from_numpy(back) - audio.clamp(-1, 1)).abs().max())
    log(f'serve save_to_filename: {len(back)} samples at {sr} Hz read back, returned '
        f'{audio.shape[-1]}; max |file - audio| = {err:.3e} (<= 1/32767 = {1 / 32767:.3e}; '
        f'{clipped} samples beyond [-1, 1] compared clipped)')
    if not (len(back) == audio.shape[-1] and sr == model.sampling_rate and err <= 1 / 32767):
        raise AssertionError('the WAV file does not hold the returned audio')
    return counts


class ProfileAverage:
    """One record of `profile_averages`: the fields of a
    ``prof.key_averages()`` entry that this script reads (times in us)."""

    def __init__(self, key, device_type, is_user_annotation):
        self.key, self.device_type = key, device_type
        self.is_user_annotation = is_user_annotation
        self.count = 0
        self.cpu_time_total = self.self_cpu_time_total = self.self_device_time_total = 0.0


def profile_averages(prof) -> list:
    """``prof.key_averages()`` summed straight from the profiler's raw
    events: the same records (grouped by name, device type and user
    annotation; a device activity's self time its duration, an operator's
    inclusive time and its self time less its nested operators', async
    events none) without an event object per raw event, whose building took
    seconds a profiled train step."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    events = []
    for e in result.events():
        name = e.name()
        if _filter_name(name) or getattr(e, 'is_hidden_event', lambda: False)():
            continue
        start, end = (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3
        events.append((name, e.device_type(), e.is_user_annotation(),
                       e.is_async() or e.start_thread_id() != e.end_thread_id(),
                       e.start_thread_id(), start, end, e.correlation_id(),
                       e.linked_correlation_id()))
    # a runtime call linked to an operator (cudaLaunchKernel) nests on that
    # operator's thread
    op_thread = {ev[7]: ev[4] for ev in events
                 if ev[8] == 0 and ev[1] == DeviceType.CPU and not ev[3]}
    by_thread = {}
    for i, ev in enumerate(events):
        if ev[1] == DeviceType.CPU and not ev[3]:
            thread = op_thread.get(ev[8], ev[4]) if ev[8] > 0 else ev[4]
            by_thread.setdefault(thread, []).append(i)
    order = lambda i: (events[i][5], -events[i][6])
    parent, kids = {}, {}
    for idx in by_thread.values():
        idx.sort(key=order)
        stack = []
        for i in idx:
            kids[i] = []
            while stack:
                up = stack[-1]
                if events[i][5] >= events[up][6] or events[i][6] > events[up][6]:
                    stack.pop()
                else:
                    kids[up].append(i)
                    parent[i] = up
                    break
            stack.append(i)
    # an operator that is its same-named parent's only child folds into it
    dropped, nodes = set(), sorted(kids, key=order)
    while True:
        fold = set()
        for i in nodes:
            up = parent.get(i)
            if up is not None and events[up][0] == events[i][0] and len(kids[up]) == 1:
                kids[up] = kids[i]
                for child in kids[i]:
                    parent[child] = up
                fold.add(i)
        if not fold:
            break
        dropped |= fold
        nodes = [i for i in nodes if i not in fold]
    averages = {}
    for i, (name, device, annotation, is_async, _, start, end, _, _) in enumerate(events):
        if i in dropped:
            continue
        if name.startswith('ProfilerStep#'):
            name = 'ProfilerStep*'
        rec = averages.get((name, device, annotation))
        if rec is None:
            rec = averages[name, device, annotation] = ProfileAverage(name, device, annotation)
        rec.count += 1
        if device == DeviceType.CPU:
            rec.cpu_time_total += end - start
            if not is_async:
                rec.self_cpu_time_total += end - start - sum(
                    events[c][6] - events[c][5] for c in kids[i])
        elif not is_async:
            rec.self_device_time_total += end - start
    return list(averages.values())


def profile_run(torch, run, trace_name):
    """Trace one call of ``run``; print the device-busy share, device time
    by kernel and host time by operator (inclusive). Returns the
    hyper-connection and GEGLU kernels' ``{name: (calls, device ms)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, trace_name))
    averages = profile_averages(prof)
    # device activity (kernels, copies, sets) only: an operator's own entry
    # repeats the device time of the kernels it launched, and a user range
    # (the optimizer's step) spans its kernels and the gaps between them
    on_device = [e for e in averages if e.device_type == DeviceType.CUDA]
    ranges = [e for e in on_device if getattr(e, 'is_user_annotation', False)]
    events = [e for e in on_device if e not in ranges]
    device_us = sum(e.self_device_time_total for e in events)
    host_ops = sum(e.count for e in averages if e.key.startswith('aten::'))
    launches = sum(e.count for e in averages if e.key == 'cudaLaunchKernel')
    log(f'  wall_ms={wall * 1e3:.3f} device_busy_ms={device_us / 1e3:.3f} '
        f'busy_share={device_us / 1e3 / (wall * 1e3):.3f} device_activities='
        f'{sum(e.count for e in events)} aten_ops={host_ops} cudaLaunchKernel={launches}')
    for e in ranges:
        log(f'  range  {e.key[:60]:60s} calls={e.count:5d} '
            f'device_span_ms={e.self_device_time_total / 1e3:.3f}')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f'  device {e.key[:60]:60s} calls={e.count:5d} '
            f'device_ms={e.self_device_time_total / 1e3:.3f}')
    # the hyper-connection kernels (K3 / K5, K4 / K5b, their save variants
    # and the adjoints' partial-row sum) and the GEGLU kernels (K6 / K7),
    # whatever their rank
    kernels = {}
    for e in sorted(events, key=lambda e: -e.self_device_time_total):
        for tag, marker in (('hc', '::hc_'), ('geglu', '::geglu_')):
            if marker in e.key:
                kernels[e.key] = (e.count, e.self_device_time_total / 1e3)
                log(f'  {tag:6s} {e.key[:80]:80s} calls={e.count:5d} '
                    f'device_ms={e.self_device_time_total / 1e3:.3f}')
    aten = [e for e in averages if e.key.startswith('aten::')]
    for e in sorted(aten, key=lambda e: -e.cpu_time_total)[:8]:
        log(f'  host   {e.key[:60]:60s} calls={e.count:5d} '
            f'cpu_ms_inclusive={e.cpu_time_total / 1e3:.3f}')
    return kernels


def log_geglu_profile(label, kernels, smi):
    """The GEGLU kernels' device time in a profiled step (K6 + K7, both
    designs), from ``profile_run``'s kernels."""
    geglu = [(key, v) for key, v in kernels.items() if '::geglu_' in key]
    fwd = [v for key, v in geglu if 'geglu_fwd' in key]
    bwd = [v for key, v in geglu if 'geglu_bwd' in key]
    log(f'{label}, GEGLU (K6 + K7) device_ms={sum(ms for _, ms in fwd + bwd):.3f} '
        f'(K6 {sum(ms for _, ms in fwd):.3f} in {sum(c for c, _ in fwd)} calls, K7 '
        f'{sum(ms for _, ms in bwd):.3f} in {sum(c for c, _ in bwd)} calls) [{smi}]')


def phase_profile(torch, model, tag=''):
    """One sequential-CFG evaluation under the profiler."""
    dev = model.device
    x = torch.randn(1, FRAMES, 100, device=dev, dtype=torch.bfloat16)
    text = torch.as_tensor(model.tokenizer([TEXT]), dtype=torch.long, device=dev)
    times = torch.full((1,), 0.5, device=dev)
    log(f'profile one {tag}cfg eval:')
    with torch.no_grad():
        profile_run(torch, lambda: model.cfg_transformer_with_pred_head(
            x, x, times, text=text, batched_cfg=False), f'{tag}cfg_eval_trace.json')


# -- phase 6: train ---------------------------------------------------------------

def step_loss_and_grads(torch, model, batch, generator=None):
    """One loss + backward on ``batch`` (with its draws; ``generator`` draws
    the dropout seeds); returns the loss and every parameter's grad as one
    f32 vector on the CPU."""
    model.zero_grad(set_to_none=True)
    dev = model.device
    out = model(batch['mel'].to(dev), text=batch['text'].to(dev), lens=batch['lens'].to(dev),
                drop_text_cond=False, times=batch['times'], noise=batch['noise'],
                rand_span_mask=batch['span'], generator=generator)
    out.loss.backward()
    grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten().cpu()
             for p in model.parameters()]
    return float(out.loss.detach()), torch.cat(grads)


def train_check_batch(torch, model, frames=512):
    """B=2 mels with ragged lengths, texts, and the loss's draws."""
    g = torch.Generator().manual_seed(3)
    lens = torch.tensor([frames, frames - 112])
    span = torch.zeros(2, frames, dtype=torch.bool)
    at = lambda i: frames * i // 512          # 100:400 and 50:350 at 512 frames
    span[0, at(100):at(400)] = True
    span[1, at(50):at(350)] = True
    return dict(mel=torch.randn(2, frames, 100, generator=g),
                text=torch.as_tensor(model.tokenizer([TEXT, TEXT[:60]]), dtype=torch.long),
                lens=lens, span=span, times=torch.rand(2, generator=g),
                noise=torch.randn(2, frames, 100, generator=g))


# the card against the CPU's f32 step at depth 2, B=2, 512 frames. A CPU
# rehearsal of the same comparison (tests/test_torch_training.py) gives, for
# bf16 against f32, loss 9.4e-5 and grads 9.5e-3 (limits ~10x and ~3x that);
# for f32 summed in another order (1 thread against 8), 7.4e-8 and 1.5e-7:
# f32 on the card sums in other orders and tiles again, within 1e-5 and 1e-4
TRAIN_CHECK_TOL = {'f32': dict(loss=1e-5, grad=1e-4), 'bf16': dict(loss=1e-3, grad=3e-2)}


# a raw-wave batch against its plain-frontend mels: K11 and the plain version
# differ by ~1e-5 in log-mel (f32 sums in other orders), which moves the loss
# by far less than this
WAVE_LOSS_TOL = 1e-4


def check_train_vs_cpu(torch, dev, label, config, kinds=('f32', 'bf16'), depth=2, frames=512,
                       e2tts=None):
    """One step's loss and grads of ``config`` (with the E2TTS keyword
    arguments ``e2tts``) at ``depth`` on the card, in f32 and in bf16
    (``kinds``), against the CPU's f32 step on the same weights and draws
    (B=2, ``frames`` frames, dropout 0); returns the batch."""
    small = dict(depth=depth, dropout=0.0)
    cpu_model = build_e2tts(torch, 'cpu', None, e2tts, config=config, **small).train()
    batch = train_check_batch(torch, cpu_model, frames)
    ref_loss, ref_grad = step_loss_and_grads(torch, cpu_model, batch)
    del cpu_model
    for kind in kinds:
        dtype = torch.bfloat16 if kind == 'bf16' else None
        model = build_e2tts(torch, dev, dtype, e2tts, config=config, **small).train()
        loss, grad = step_loss_and_grads(torch, model, batch)
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        grad_rel = float((grad - ref_grad).norm() / ref_grad.norm())
        lim = TRAIN_CHECK_TOL[kind]
        log(f'{label} check card {kind} vs cpu f32 (depth {depth}, B=2, {frames} frames, '
            f'dropout 0, same weights and draws): loss={loss:.6f} cpu_loss={ref_loss:.6f} '
            f'loss_rel={loss_rel:.3e} (<= {lim["loss"]:g}) grad_rel_l2={grad_rel:.3e} '
            f'(<= {lim["grad"]:g}) over {grad.numel()} grads')
        if not (torch.isfinite(grad).all() and loss_rel <= lim['loss']
                and grad_rel <= lim['grad']):
            raise AssertionError(f'{label}: train step on the card ({kind}) disagrees with '
                                 f'the CPU')
        del model
    return batch


def phase_train_check(torch, dev):
    """One step's loss and grads on the card, in f32 and in bf16, against
    the CPU's f32 step on the same weights and draws; then one f32 step from
    a raw-wave batch (K11 on the card) against the step from the mels of the
    plain frontend, with the launch counts of K11, K2 and K10."""
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.ops.mel import MelSpec

    small = dict(depth=2, dropout=0.0)
    batch = check_train_vs_cpu(torch, dev, 'train', FLAGSHIP)

    model = build_e2tts(torch, dev, None, e2tts=dict(mel_spec_kwargs=dict(mode='pallas')),
                        **small).train()
    g = torch.Generator().manual_seed(6)
    wave = torch.randn(2, (512 - 1) * HOP, generator=g) * 0.1           # 512 frames each
    mel = MelSpec()(wave).transpose(1, 2)                               # plain frontend, CPU
    _cuda.reset_launch_counts()
    wave_loss, _ = step_loss_and_grads(torch, model, dict(batch, mel=wave))
    torch.cuda.synchronize()
    counts = dict(_cuda.launch_counts)
    mel_loss, _ = step_loss_and_grads(torch, model, dict(batch, mel=mel))
    rel = abs(wave_loss - mel_loss) / abs(mel_loss)
    log(f'train check raw wave (2, {wave.shape[1]}) f32 card vs the plain frontend\'s mels: '
        f'loss={wave_loss:.6f} mel_loss={mel_loss:.6f} rel={rel:.3e} (<= {WAVE_LOSS_TOL:g}) '
        f'launches mel_fwd={counts["mel_fwd"]} flash_bwd={counts["flash_bwd"]} '
        f'flash_delta={counts["flash_delta"]}')
    if not (rel <= WAVE_LOSS_TOL and counts['mel_fwd'] == 1
            and counts['flash_delta'] == counts['flash_bwd'] > 0):
        raise AssertionError('raw-wave train step: loss or launch counts wrong')
    del model
    torch.cuda.empty_cache()


# the hyper-connection kernels and their save-state variants
SAVE_VARIANT = {'hc_width': 'hc_width_save', 'hc_width_fused': 'hc_width_fused_save',
                'hc_width_bwd': 'hc_width_bwd_save',
                'hc_width_fused_bwd': 'hc_width_fused_bwd_save'}


def expected_train_launches(model, with_text: bool, save_state: bool = False) -> dict:
    """Launches of one train step on mels, from the model's structure: per
    layer of a stream that runs, K5 / K5b once, K3 / K4 twice, K1 / K2 / K10
    (or K8 / K9 for heads K1 does not take) and K6 / K7 once. Without text
    the text stream does not run. With per-layer remat every forward kernel
    runs again in the backward's recompute, and with ``scan_layers`` those
    of every layer in a scan group of the plan. With ``save_state`` the
    hyper-connection kernels are their save-state variants (K5s, K3s, K5bs,
    K4s; remat's first forward runs with grad on, so it saves too)."""
    tf = model.transformer
    layers = tf.depth + (tf.text_depth if with_text else 0)
    # forward runs of each layer: two under remat and in a scan_layers group
    runs = [2 if tf.remat or ind in tf.scanned else 1 for ind in range(tf.depth)]
    speech_fwd = sum(runs)
    fwd = speech_fwd + (sum(runs[:tf.text_depth]) if with_text else 0)
    counts = dict(hc_width=fwd, hc_width_fused=2 * fwd, geglu_fwd=fwd, hc_width_bwd=layers,
                  hc_width_fused_bwd=2 * layers, geglu_bwd=layers)
    # the attention of every layer that runs; with the frequency axis, the
    # frequency attention of every speech layer and its chained connection
    attentions = [(tf.dim_head, layers, fwd)]
    if tf.has_freq_axis:
        attentions.append((tf.freq_dim_head, tf.depth, speech_fwd))
        counts['hc_width_fused'] += speech_fwd
        counts['hc_width_fused_bwd'] += tf.depth
    for dim_head, n, n_fwd in attentions:
        fwd_key, bwd_key = attention_kernels(dim_head)
        counts[fwd_key] = counts.get(fwd_key, 0) + n_fwd
        counts[bwd_key] = counts.get(bwd_key, 0) + n
        if fwd_key == 'flash_fwd':
            counts['flash_delta'] = counts.get('flash_delta', 0) + n
    if save_state:
        counts = {SAVE_VARIANT.get(k, k): n for k, n in counts.items()}
    return counts


def phase_train(torch, dev, smi):
    import numpy as np

    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches

    model = build_e2tts(torch, dev, torch.bfloat16, dropout=0.1)
    # the JAX training bench's optimizer: ADOPT at a constant 7.5e-5, clip 1.0
    trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0, total_steps=10_000,
                        seed=0)
    rng = np.random.default_rng(0)
    words = TEXT.split()
    dataset = ArrayDataset(
        [rng.standard_normal((100, FRAMES)).astype(np.float32) for _ in range(32)],
        [' '.join(rng.choice(words, size=12)) for _ in range(32)])

    before = [p.detach().clone() for p in model.parameters()]
    history = trainer.train(dataset, epochs=1, batch_size=TRAIN_BATCH, save_step=10 ** 9)
    torch.cuda.synchronize()
    moved = sum(bool((a != p.detach()).any()) for a, p in zip(before, model.parameters()))
    log(f'train E2Trainer.train 1 epoch over 32 x (100, {FRAMES}) mels, B={TRAIN_BATCH}: '
        f'losses={[round(loss, 5) for _, loss in history]} '
        f'parameter tensors moved={moved}/{len(before)}')
    if (len(history) != len(dataset) // TRAIN_BATCH
            or not all(np.isfinite(loss) for _, loss in history)):
        raise AssertionError(f'train() history bad: {history}')
    if moved < len(before):
        raise AssertionError('not every parameter moved after two steps')
    del before

    batch = trainer.prepare_batch(next(iter_batches(dataset, TRAIN_BATCH, seed=1)))
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    ms, losses = {}, []
    for drop in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS_TIMED):
            loss, _, _ = trainer.train_step(*batch, drop_text_cond=drop)
            losses.append(loss)
        torch.cuda.synchronize()
        ms[drop] = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS_TIMED
    counts = dict(_cuda.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    mix_ms = (1 - TEXT_DROP_PROB) * ms[False] + TEXT_DROP_PROB * ms[True]
    frames_s = TRAIN_BATCH * FRAMES / (mix_ms / 1e3)
    log(f'train steps B={TRAIN_BATCH} frames={FRAMES} dropout 0.1 bf16, {TRAIN_STEPS_TIMED} each: '
        f'ms_per_step_with_text={ms[False]:.3f} ms_per_step_text_dropped={ms[True]:.3f} '
        f'ms_per_step_mix_0.75_0.25={mix_ms:.3f} mel_frames_per_s={frames_s:.1f} '
        f'max_memory_allocated_gib={peak_gib:.3f} loss_finite={finite} '
        f'last_loss={float(losses[-1]):.5f} launches={json.dumps(counts, sort_keys=True)} [{smi}]')
    with_text, dropped = (expected_train_launches(model, t) for t in (True, False))
    expected = {k: TRAIN_STEPS_TIMED * (with_text.get(k, 0) + dropped.get(k, 0))
                for k in _cuda.KERNELS}
    if counts != expected:
        raise AssertionError(f'train launch counts {counts} != expected {expected}')
    if not finite:
        raise AssertionError('train loss is not finite')

    log('profile one train step (with text):')
    kernels = profile_run(torch, lambda: trainer.train_step(*batch, drop_text_cond=False),
                          'train_step_trace.json')
    log_geglu_profile('flagship profiled with-text step', kernels, smi)
    return counts


# -- phase 7: train_example.py's run through E2Trainer.train -------------------------

def trainer_rows():
    """``TRAINER_ROWS`` rows as a dataset of audio gives them: a noisy tone
    of 0.3-8 s at 16, 22.05, 24 and 48 kHz with a transcript, two of them
    outside 0.3-20 s (0.1 and 0.2 s), which `HFDataset` skips. Numpy seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    words = TEXT.split()
    too_short = {5: 0.1, 16: 0.2}
    rows = []
    for i in range(TRAINER_ROWS):
        sr = TRAINER_RATES[i % len(TRAINER_RATES)]
        seconds = too_short.get(i) or rng.uniform(0.3, 8.0)
        t = np.arange(int(seconds * sr)) / sr
        wave = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) + 0.05 * rng.standard_normal(
            t.shape)
        rows.append(dict(audio=dict(array=wave.astype(np.float32), sampling_rate=sr),
                         transcript=' '.join(rng.choice(words, size=int(rng.integers(3, 12))))))
    return rows


def build_trainer(torch, dev, seed, path, **kw):
    """`E2Trainer` over the train_example widths with weights from ``seed``
    (perturbed as `build_e2tts` does): the 512 x 12 E2TTS and the trained
    512 x 8 predictor, bf16 compute for both (the trainer's ``dtype``),
    ADOPT at 7.5e-5 (no warmup, as the JAX training bench), accumulation 2."""
    from e2_tts_tpu_torch import DurationPredictor, E2TTS, E2Trainer
    gen = torch.Generator().manual_seed(seed)
    model = E2TTS(transformer=dict(TRAIN_EXAMPLE), generator=gen, device='cpu')
    dp = DurationPredictor(transformer=dict(TRAIN_EXAMPLE_DP), generator=gen, device='cpu')
    with torch.no_grad():
        for module in (model, dp):
            for p in module.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return E2Trainer(model.to(dev), duration_predictor=dp.to(dev), train_duration_predictor=True,
                     dtype=torch.bfloat16, learning_rate=7.5e-5, num_warmup_steps=0,
                     total_steps=10_000, grad_accumulation_steps=TRAINER_ACCUM,
                     checkpoint_path=path, seed=0, **kw)


def trainer_state_diff(torch, a, b) -> list:
    """What of ``b``'s state is not bit-equal to ``a``'s: the model, ADOPT,
    the EMA's weights and counters, the predictor and its ADOPT, the
    accumulator, the generator."""
    diff = []

    def tensors(label, x, y):
        diff.extend(f'{label} {n}' for n in x if not torch.equal(x[n], y[n]))

    def adopt(label, oa, ob):
        sa, sb = oa.state_dict()['state'], ob.state_dict()['state']
        if sa.keys() != sb.keys():
            diff.append(f'{label} state keys')
        for i in sa.keys() & sb.keys():
            if sa[i]['step'] != sb[i]['step']:
                diff.append(f'{label} {i} step')
            tensors(f'{label} {i}', {k: sa[i][k] for k in 'mv'}, {k: sb[i][k] for k in 'mv'})

    tensors('model', a.model.state_dict(), b.model.state_dict())
    adopt('adopt', a.optimizer, b.optimizer)
    tensors('ema', a.ema.ema_model.state_dict(), b.ema.ema_model.state_dict())
    if (a.ema.step, a.ema.initted) != (b.ema.step, b.ema.initted):
        diff.append('ema counters')
    tensors('dp', a.duration_predictor.state_dict(), b.duration_predictor.state_dict())
    adopt('dp adopt', a.dp_optimizer, b.dp_optimizer)
    if a.accumulator.mini_step != b.accumulator.mini_step:
        diff.append('accumulator mini_step')
    tensors('accumulator', dict(enumerate(a.accumulator.grads)),
            dict(enumerate(b.accumulator.grads)))
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        diff.append('generator')
    return diff


def phase_trainer(torch, dev, smi):
    """examples/train_example.py's run at its widths through the entry
    points a user calls: `HFDataset` over rows of audio (resampled, the
    log-mel on the card), `E2Trainer.train` with prefetch workers, gradient
    accumulation, the trained side predictor, checkpoints every 2 steps,
    TensorBoard when it imports, and a profiler window; then resume checks
    from a checkpoint written mid-accumulation."""
    import random
    import shutil

    import numpy as np

    from e2_tts_tpu_torch import native
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.training.data import HFDataset, iter_batches

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    ckpt, profile_dir = os.path.join(TRAINER_DIR, 'ckpt'), os.path.join(TRAINER_DIR, 'profile')
    try:
        import tensorboard  # noqa: F401
        use_tb = True
    except ImportError:
        use_tb = False
    rows = trainer_rows()
    dataset = HFDataset(rows, device=dev)
    log(f'trainer dataset: {len(rows)} rows at {sorted(set(TRAINER_RATES))} Hz, '
        f'{sum(1 for r in rows if not 0.3 <= len(r["audio"]["array"]) / r["audio"]["sampling_rate"] <= 20)} '
        f'outside 0.3-20 s; resampling: {"native" if native.load() is not None else "scipy"}; '
        f'tensorboard: {"on" if use_tb else "off (does not import)"}')

    a = build_trainer(torch, dev, 1, ckpt, use_tensorboard=use_tb,
                      tensorboard_log_dir=os.path.join(TRAINER_DIR, 'tb'),
                      profile_dir=profile_dir, profile_steps=(2, 4), log_step=1)
    model, dp = a.model, a.duration_predictor
    before = [p.detach().clone() for p in (*model.parameters(), *dp.parameters())]
    steps = len(dataset) // TRAINER_BATCH
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    history = a.train(dataset, epochs=1, batch_size=TRAINER_BATCH, num_workers=2, save_step=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)

    rng = random.Random(0)          # the trainer's text-drop coins, seed 0
    with_text = [rng.random() >= model.cond_drop_prob for _ in range(steps)]
    expected = dict.fromkeys(_cuda.KERNELS, 0)
    for kept in with_text:
        for name, n in expected_train_launches(model, kept).items():
            expected[name] += n
        for name, n in expected_train_launches(dp, False).items():
            expected[name] += n
    moved = [bool((b != p.detach()).any()) for b, p in
             zip(before, (*model.parameters(), *dp.parameters()))]
    n_model = len(list(model.parameters()))
    # the predictor's loss takes no text, so its text stream gets zero grads
    # (as in JAX): ADOPT's v of such a tensor stays 0
    unreached = [bool((a.dp_optimizer.state[p]['v'] == 0).all()) for p in dp.parameters()]
    log(f'trainer E2Trainer.train 1 epoch, {len(dataset)} rows, B={TRAINER_BATCH}, '
        f'accumulation {TRAINER_ACCUM}, {steps} micro-steps (with text: {with_text}): '
        f'seconds={seconds:.3f} losses={[round(loss, 5) for _, loss in history]} '
        f'model tensors moved={sum(moved[:n_model])}/{n_model} predictor tensors moved='
        f'{sum(moved[n_model:])}/{len(moved) - n_model} (of the rest, {sum(unreached)} of its '
        f'text stream, which the text-free loss never reaches, had only zero grads) '
        f'launches={json.dumps(counts, sort_keys=True)} [{smi}]')
    if len(history) != steps or not all(np.isfinite(loss) for _, loss in history):
        raise AssertionError(f'train() history bad: {history}')
    if not (all(moved[:n_model]) and all(m != u for m, u in zip(moved[n_model:], unreached))):
        raise AssertionError('a parameter with a grad did not move, or one without moved')
    if counts != expected:
        raise AssertionError(f'trainer launch counts {counts} != expected {expected}')
    traces = os.listdir(profile_dir)
    if traces != ['steps_2-4.trace.json']:
        raise AssertionError(f'profiler window wrote {traces}')
    if use_tb and not os.listdir(os.path.join(TRAINER_DIR, 'tb')):
        raise AssertionError('no TensorBoard events written')
    del before

    # one more micro-step leaves half a mean in the accumulator; save there
    batch = a.prepare_batch(next(iter_batches(dataset, TRAINER_BATCH, seed=7)))
    batch = (torch.as_tensor(batch[0]).to(dev), torch.as_tensor(batch[1]).to(dev), batch[2])

    def step(trainer):
        dur = trainer.duration_step(batch[0], batch[1])
        loss, _, _ = trainer.train_step(*batch, drop_text_cond=False)
        return float(loss), float(dur)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(a)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    target = a.save_checkpoint(steps + 1)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(target)
    if a.accumulator.mini_step != 1:
        raise AssertionError('the checkpoint is not mid-accumulation')

    b = build_trainer(torch, dev, 2, ckpt)
    fresh = trainer_state_diff(torch, a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = b.resume()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    diff = trainer_state_diff(torch, a, b)
    log(f'trainer checkpoint: {size} bytes ({size / 2 ** 30:.3f} GiB) save_s={save_s:.3f} '
        f'load_s={load_s:.3f} (resume) step_ms={step_ms:.3f} (one micro-step: the predictor\'s '
        f'and the model\'s, B={TRAINER_BATCH}) [{smi}]')
    log(f'trainer resume: start step {start}, a fresh trainer differed in {len(fresh)} '
        f'tensors and counters, the resumed one in {len(diff)} {diff[:5]}')
    if start != steps + 1 or not fresh or diff:
        raise AssertionError('the resumed trainer is not bit for bit the saved one')

    # one more step on both (the accumulated update) and on a trainer
    # resumed without its ADOPT state
    c = build_trainer(torch, dev, 3, ckpt)
    c.resume()
    c.optimizer.state.clear()
    p0 = [p.detach().clone() for p in a.model.parameters()]
    losses = {label: step(t) for label, t in (('original', a), ('resumed', b),
                                              ('adopt dropped', c))}

    def gaps(t):
        """||a - t|| / ||a's move||, both over every model parameter; the
        largest element gap over the largest move; the elements that differ."""
        pairs = list(zip(a.model.parameters(), t.model.parameters(), p0))
        sq = lambda x: float(x.double().square().sum())
        gap = math.sqrt(sum(sq(p.detach() - q.detach()) for p, q, _ in pairs))
        move = math.sqrt(sum(sq(p.detach() - r) for p, _, r in pairs))
        gap_max = max(float((p.detach() - q.detach()).abs().max()) for p, q, _ in pairs)
        move_max = max(float((p.detach() - r).abs().max()) for p, _, r in pairs)
        differ = sum(int((p.detach() != q.detach()).sum()) for p, q, _ in pairs)
        return gap / move, gap_max / move_max, differ

    numel = sum(p.numel() for p in p0)
    (r_b, rmax_b, n_b), (r_c, rmax_c, n_c) = gaps(b), gaps(c)
    log(f'trainer one more step, original vs resumed: losses {losses["original"]} / '
        f'{losses["resumed"]}; ||param gap|| / ||step|| = {r_b:.3e} (<= {RESUME_STEP_TOL}), '
        f'largest element gap {rmax_b:.3e} of the largest move, {n_b} of {numel} elements '
        f'differ; resumed without ADOPT\'s state (planted fault, must fail): losses '
        f'{losses["adopt dropped"]}, ratio {r_c:.3e}, largest {rmax_c:.3e}, {n_c} differ')
    if losses['resumed'] != losses['original'] or not r_b <= RESUME_STEP_TOL:
        raise AssertionError('the resumed trainer does not continue the original run')
    if r_c <= RESUME_STEP_TOL:
        raise AssertionError('the check passed a trainer that lost its ADOPT state')
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    return counts


# remat on against off, f32 on the card at dropout 0.1: the forward runs the
# same kernels on the same inputs (equal losses); K9 adds dq over key tiles
# by atomics in a run-dependent order, f32 summation noise (the flagship's
# f32 card-vs-CPU grads, all summation orders together, read ~6e-7), far
# under this limit
DIT_REMAT_GRAD_TOL = 1e-5


def phase_dit(torch, dev, smi):
    """The DiT-width E2TTS (16 heads of 72: K8 / K9) in bf16: one CFG
    evaluation at depth 2 against the CPU; `sample` at depth 28; the train
    step at depth 2 against the CPU and remat on against off; then timed
    `E2Trainer` steps at depth 28, B=16 x 1024, dropout 0.1, remat.
    Returns the launch counts of the sample and of the train steps."""
    import numpy as np

    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches

    model = build_e2tts(torch, dev, torch.bfloat16, config=DIT, depth=2).eval()
    cpu_model = build_e2tts(torch, 'cpu', None, config=DIT, depth=2).eval()
    check_cfg_eval(torch, dev, model, cpu_model, 'dit (depth 2)')
    del model, cpu_model

    t0 = time.perf_counter()
    model = build_e2tts(torch, dev, torch.bfloat16, config=DIT, dropout=0.1, remat=True).eval()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator().manual_seed(1)
    prompt = torch.randn(1, PROMPT_FRAMES, 100, generator=g).to(dev, torch.bfloat16)
    sample_kw = dict(text=[TEXT], duration=FRAMES, cfg_strength=1.0,
                     generator=torch.Generator(device=dev).manual_seed(2))
    model.sample(prompt, steps=2, **sample_kw)          # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    mel = model.sample(prompt, steps=STEPS, **sample_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sample_counts = dict(_cuda.launch_counts)
    if tuple(mel.shape) != (1, FRAMES, 100) or not torch.isfinite(mel).all():
        raise AssertionError(f'dit sample output bad: shape {tuple(mel.shape)}')
    expected = dict.fromkeys(_cuda.KERNELS, 0)
    expected.update(expected_launches(model, STEPS, attention='flash_fwd_bhnd'))
    log(f'dit sample depth {DIT["depth"]} B=1 frames={FRAMES} NFE={2 * (STEPS - 1)} midpoint '
        f'cfg=1.0 sequential: seconds={seconds:.4f} rtf={seconds / (FRAMES / FRAMES_PER_SECOND):.5f} '
        f'params={n_params} build_s={build_s:.1f} '
        f'launches={json.dumps(sample_counts, sort_keys=True)} [{smi}]')
    if sample_counts != expected:
        raise AssertionError(f'dit launch counts {sample_counts} != expected {expected}')
    del mel
    phase_profile(torch, model, tag='dit_')

    check_train_vs_cpu(torch, dev, 'dit (depth 2)', DIT)
    batch = None
    results = {}
    for remat in (True, False):
        small = build_e2tts(torch, dev, None, config=DIT, depth=2, dropout=0.1,
                            remat=remat).train()
        batch = batch or train_check_batch(torch, small)
        _cuda.reset_launch_counts()
        results[remat] = step_loss_and_grads(torch, small, batch,
                                             generator=torch.Generator().manual_seed(7))
        results[remat] += (_cuda.launch_counts['flash_fwd_bhnd'],)
        del small
    (loss_on, grad_on, fwd_on), (loss_off, grad_off, fwd_off) = results[True], results[False]
    grad_rel = float((grad_on - grad_off).norm() / grad_off.norm())
    log(f'dit (depth 2) remat on vs off, f32 card, dropout 0.1, same weights, draws and '
        f'generator: loss={loss_on:.7f} loss_off={loss_off:.7f} grad_rel_l2={grad_rel:.3e} '
        f'(<= {DIT_REMAT_GRAD_TOL:g}) flash_fwd_bhnd launches {fwd_on} / {fwd_off}')
    if not (loss_on == loss_off and grad_rel <= DIT_REMAT_GRAD_TOL and fwd_on == 2 * fwd_off):
        raise AssertionError('remat changes the train step')
    torch.cuda.empty_cache()

    model.train()
    trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0, total_steps=10_000,
                        seed=0)
    rng = np.random.default_rng(0)
    words = TEXT.split()
    dataset = ArrayDataset(
        [rng.standard_normal((100, FRAMES)).astype(np.float32) for _ in range(TRAIN_BATCH)],
        [' '.join(rng.choice(words, size=12)) for _ in range(TRAIN_BATCH)])
    batch = trainer.prepare_batch(next(iter_batches(dataset, TRAIN_BATCH, seed=1)))
    for drop in (False, True):                          # warm-up: optimizer state, allocator
        trainer.train_step(*batch, drop_text_cond=drop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    ms, losses = {}, []
    for drop in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIT_TRAIN_STEPS_TIMED):
            loss, _, _ = trainer.train_step(*batch, drop_text_cond=drop)
            losses.append(loss)
        torch.cuda.synchronize()
        ms[drop] = (time.perf_counter() - t0) * 1e3 / DIT_TRAIN_STEPS_TIMED
    train_counts = dict(_cuda.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    mix_ms = (1 - TEXT_DROP_PROB) * ms[False] + TEXT_DROP_PROB * ms[True]
    log(f'dit train steps depth {DIT["depth"]} B={TRAIN_BATCH} frames={FRAMES} dropout 0.1 '
        f'remat bf16, {DIT_TRAIN_STEPS_TIMED} each: ms_per_step_with_text={ms[False]:.3f} '
        f'ms_per_step_text_dropped={ms[True]:.3f} ms_per_step_mix_0.75_0.25={mix_ms:.3f} '
        f'mel_frames_per_s={TRAIN_BATCH * FRAMES / (mix_ms / 1e3):.1f} '
        f'max_memory_allocated_gib={peak_gib:.3f} loss_finite={finite} '
        f'last_loss={float(losses[-1]):.5f} launches={json.dumps(train_counts, sort_keys=True)} '
        f'[{smi}]')
    with_text, dropped = (expected_train_launches(model, t) for t in (True, False))
    expected = {k: DIT_TRAIN_STEPS_TIMED * (with_text.get(k, 0) + dropped.get(k, 0))
                for k in _cuda.KERNELS}
    if train_counts != expected:
        raise AssertionError(f'dit train launch counts {train_counts} != expected {expected}')
    if not finite:
        raise AssertionError('dit train loss is not finite')
    log('profile one dit train step (with text):')
    kernels = profile_run(torch, lambda: trainer.train_step(*batch, drop_text_cond=False),
                          'dit_train_step_trace.json')
    log_geglu_profile('dit profiled with-text step', kernels, smi)
    return sample_counts, train_counts


def phase_tiny(torch, dev):
    """The JAX package's test geometry (2 streams at widths 64 and 32, heads
    of 16: K3 / K5 at s = 2, K8 / K9 at dh 16) with seeded random weights:
    one CFG evaluation (200 frames) bf16 on the card against f32 on the CPU,
    and one train step f32 on the card against the CPU at its depth 4."""
    from e2_tts_tpu_torch.ops import _cuda
    model = build_e2tts(torch, dev, torch.bfloat16, config=TINY).eval()
    cpu_model = build_e2tts(torch, 'cpu', None, config=TINY).eval()
    _cuda.reset_launch_counts()
    check_cfg_eval(torch, dev, model, cpu_model, 'tiny', frames=TINY_FRAMES, prompt_frames=64)
    fwd = dict(_cuda.launch_counts)
    del model, cpu_model
    _cuda.reset_launch_counts()
    check_train_vs_cpu(torch, dev, 'tiny', TINY, kinds=('f32',), depth=TINY['depth'],
                       frames=TINY_FRAMES)
    bwd = dict(_cuda.launch_counts)
    used = ('hc_width', 'hc_width_fused', 'flash_fwd_bhnd')
    used_bwd = ('hc_width_bwd', 'hc_width_fused_bwd', 'flash_bwd_bhnd')
    log(f'tiny launches: cfg eval {json.dumps({k: fwd[k] for k in used})} train step '
        f'{json.dumps({k: bwd[k] for k in used + used_bwd})}')
    if not (all(fwd[k] > 0 for k in used) and all(bwd[k] > 0 for k in used + used_bwd)):
        raise AssertionError('tiny: the 2-stream, 16-wide-head path did not run its kernels')
    torch.cuda.empty_cache()


def set_hc_save_state(model, on: bool):
    """Switch every hyper-connection of ``model`` to (or from) the
    save-state kernels."""
    from e2_tts_tpu_torch.models.hyper_connections import HyperConnection
    for m in model.modules():
        if isinstance(m, HyperConnection):
            m.save_state = on


# the save path against the recomputing path, f32 on the card at dropout
# 0.1: the forward is bit for bit the same (equal losses); the adjoints read
# the same tanh and inv (recomputed by the same instructions), and K2 sums dq
# by atomics in a run-dependent order: f32 summation noise, far under this
PAPER_SAVE_GRAD_TOL = 1e-5


def phase_paper(torch, dev, smi):
    """The E2-TTS paper's configuration (dim 1024, 16 heads of 64, text 512)
    in bf16 with seeded random weights: at depth 2 one CFG evaluation and
    one train step (f32 and bf16) against the CPU, and ``hc_save_state`` on
    against off (f32); `sample` at depth 24 with ``hc_save_state=True`` (no
    grad: the save counters stay 0); then `E2Trainer` at depth 24, B=16 x
    1024, dropout 0.1, remat, timed steps with ``hc_save_state`` off and
    then on. Returns the launch counts of the sample and of the two sets of
    train steps."""
    import numpy as np

    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches

    model = build_e2tts(torch, dev, torch.bfloat16, config=PAPER, depth=2).eval()
    cpu_model = build_e2tts(torch, 'cpu', None, config=PAPER, depth=2).eval()
    check_cfg_eval(torch, dev, model, cpu_model, 'paper (depth 2)')
    del model, cpu_model
    check_train_vs_cpu(torch, dev, 'paper (depth 2)', PAPER)
    batch, results = None, {}
    for save in (False, True):
        small = build_e2tts(torch, dev, None, config=PAPER, depth=2, dropout=0.1,
                            hc_save_state=save).train()
        batch = batch or train_check_batch(torch, small)
        _cuda.reset_launch_counts()
        loss, grad = step_loss_and_grads(torch, small, batch,
                                         generator=torch.Generator().manual_seed(7))
        results[save] = (loss, grad, sum(_cuda.launch_counts[k] for k in SAVE_VARIANT.values()))
        del small
    (loss_on, grad_on, n_on), (loss_off, grad_off, n_off) = results[True], results[False]
    grad_rel = float((grad_on - grad_off).norm() / grad_off.norm())
    log(f'paper (depth 2) hc_save_state on vs off, f32 card, dropout 0.1, same weights, draws '
        f'and generator: loss={loss_on:.7f} loss_off={loss_off:.7f} grad_rel_l2={grad_rel:.3e} '
        f'(<= {PAPER_SAVE_GRAD_TOL:g}) save-variant launches {n_on} / {n_off}')
    if not (loss_on == loss_off and grad_rel <= PAPER_SAVE_GRAD_TOL and n_on > 0 and n_off == 0):
        raise AssertionError('hc_save_state changes the train step')
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = build_e2tts(torch, dev, torch.bfloat16, config=PAPER, dropout=0.1, remat=True,
                        hc_save_state=True).eval()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator().manual_seed(1)
    prompt = torch.randn(1, PROMPT_FRAMES, 100, generator=g).to(dev, torch.bfloat16)
    sample_kw = dict(text=[TEXT], duration=FRAMES, cfg_strength=1.0,
                     generator=torch.Generator(device=dev).manual_seed(2))
    model.sample(prompt, steps=2, **sample_kw)          # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    mel = model.sample(prompt, steps=STEPS, **sample_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sample_counts = dict(_cuda.launch_counts)
    if tuple(mel.shape) != (1, FRAMES, 100) or not torch.isfinite(mel).all():
        raise AssertionError(f'paper sample output bad: shape {tuple(mel.shape)}')
    expected = dict.fromkeys(_cuda.KERNELS, 0)
    expected.update(expected_launches(model, STEPS))
    log(f'paper sample depth {PAPER["depth"]} hc_save_state=True B=1 frames={FRAMES} '
        f'NFE={2 * (STEPS - 1)} midpoint cfg=1.0 sequential: seconds={seconds:.4f} '
        f'rtf={seconds / (FRAMES / FRAMES_PER_SECOND):.5f} params={n_params} '
        f'build_s={build_s:.1f} launches={json.dumps(sample_counts, sort_keys=True)} [{smi}]')
    if sample_counts != expected:
        raise AssertionError(f'paper launch counts {sample_counts} != expected {expected}')
    del mel
    phase_profile(torch, model, tag='paper_')

    model.train()
    trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0, total_steps=10_000,
                        seed=0)
    rng = np.random.default_rng(0)
    words = TEXT.split()
    dataset = ArrayDataset(
        [rng.standard_normal((100, FRAMES)).astype(np.float32) for _ in range(TRAIN_BATCH)],
        [' '.join(rng.choice(words, size=12)) for _ in range(TRAIN_BATCH)])
    batch = trainer.prepare_batch(next(iter_batches(dataset, TRAIN_BATCH, seed=1)))
    train_counts = {}
    for save in (False, True):
        set_hc_save_state(model, save)
        for drop in (False, True):                      # warm-up: optimizer state, allocator
            trainer.train_step(*batch, drop_text_cond=drop)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        ms, losses = {}, []
        for drop in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PAPER_TRAIN_STEPS_TIMED):
                loss, _, _ = trainer.train_step(*batch, drop_text_cond=drop)
                losses.append(loss)
            torch.cuda.synchronize()
            ms[drop] = (time.perf_counter() - t0) * 1e3 / PAPER_TRAIN_STEPS_TIMED
        counts = train_counts[save] = dict(_cuda.launch_counts)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = bool(torch.isfinite(torch.stack(losses)).all())
        mix_ms = (1 - TEXT_DROP_PROB) * ms[False] + TEXT_DROP_PROB * ms[True]
        log(f'paper train steps depth {PAPER["depth"]} hc_save_state={save} B={TRAIN_BATCH} '
            f'frames={FRAMES} dropout 0.1 remat bf16, {PAPER_TRAIN_STEPS_TIMED} each: '
            f'ms_per_step_with_text={ms[False]:.3f} ms_per_step_text_dropped={ms[True]:.3f} '
            f'ms_per_step_mix_0.75_0.25={mix_ms:.3f} '
            f'mel_frames_per_s={TRAIN_BATCH * FRAMES / (mix_ms / 1e3):.1f} '
            f'max_memory_allocated_gib={peak_gib:.3f} loss_finite={finite} '
            f'last_loss={float(losses[-1]):.5f} launches={json.dumps(counts, sort_keys=True)} '
            f'[{smi}]')
        with_text, dropped = (expected_train_launches(model, t, save) for t in (True, False))
        expected = {k: PAPER_TRAIN_STEPS_TIMED * (with_text.get(k, 0) + dropped.get(k, 0))
                    for k in _cuda.KERNELS}
        if counts != expected:
            raise AssertionError(f'paper train launch counts {counts} != expected {expected}')
        if not finite:
            raise AssertionError('paper train loss is not finite')
    adjoints = {}
    for save in (False, True):
        set_hc_save_state(model, save)
        log(f'profile one paper train step (with text, hc_save_state {"on" if save else "off"}):')
        hc = profile_run(torch, lambda: trainer.train_step(*batch, drop_text_cond=False),
                         f'paper_train_step{"_save" if save else ""}_trace.json')
        adj = [v for k, v in hc.items() if 'hc_bwd_sm90_kernel' in k]
        adjoints[save] = (sum(n for n, _ in adj), sum(ms for _, ms in adj))
        log_geglu_profile(f'paper profiled with-text step (hc_save_state '
                          f'{"on" if save else "off"})', hc, smi)
    set_hc_save_state(model, False)
    (n_off, ms_off), (n_on, ms_on) = adjoints[False], adjoints[True]
    log(f'paper profiled with-text step, HC adjoints (hc_bwd_sm90_kernel): hc_save_state off '
        f'(K4 + K5b) device_ms={ms_off:.3f} calls={n_off}; on (K4s + K5bs) '
        f'device_ms={ms_on:.3f} calls={n_on} [{smi}]')
    del trainer, model
    torch.cuda.empty_cache()
    return sample_counts, train_counts[False], train_counts[True]


def log_geglu_sass(_cuda):
    """The SASS instructions (NOPs left out) of each K6 / K7 kernel in the
    built library, from cuobjdump; for the vector design also per element
    of a thread's UNROLL vectors. A vector kernel holds one path (dropout is
    a template flag, erff's two ranges are selects), so that is what a
    thread with a full share of work issues."""
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
    if not os.path.exists(tool):
        log(f'sass geglu.cu: {tool} not found, not counted')
        return
    dump = subprocess.run([tool, '-sass', str(_cuda.BUILD_DIR / _cuda.LIB_NAME)],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    unroll = int(re.findall(r'constexpr int UNROLL = (\d+);',
                            (_cuda.CSRC / 'geglu.cu').read_text())[0])
    name = None
    counts = {}
    for line in dump.splitlines():
        head = re.search(r'Function : (\S+)', line)
        if head:
            name = head.group(1) if 'geglu' in head.group(1) else None
            continue
        op = re.search(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)', line)
        if name and op and op.group(1) != 'NOP':
            counts[name] = counts.get(name, 0) + 1
    for name, count in sorted(counts.items()):
        line = f'sass geglu.cu {name}: {count} instructions'
        if 'vec_kernel' in name:       # the dropout flag is in the name: Lb1 on, Lb0 off
            elements = unroll * (8 if 'bfloat16' in name else 4)
            line += f', {count / elements:.1f} an element ({elements} elements a thread)'
        log(line)


# -- phase 11: the adaptive ODE solvers ---------------------------------------------

ADAPTIVE_METHODS = ('dopri5', 'bosh3', 'fehlberg2', 'adaptive_heun')
ADAPTIVE_CHECK_FRAMES = 256
ADAPTIVE_REF_STEPS = 256
# rel-L2 of each method (atol = rtol = 1e-5, f32) against a 256-step rk4 over
# the generated frames, set before the first card run from a CPU rehearsal of
# the same check at 256 frames: the worst method, fehlberg2, read 6.7e-5, the
# planted fault (one dopri5 b weight off by 1e-2) 7.8e-3; the limit sits
# ~10x from each (PERF.md section 6)
ADAPTIVE_CHECK_TOL = 7e-4
# the full-depth run at the model's atol = rtol = 1e-5 when the depth-2
# evaluations project it within this many seconds, else at 1e-3
ADAPTIVE_FULL_DEPTH_S = 120.0
ADAPTIVE_FALLBACK_TOL = 1e-3
# the depth-2 count runs to t = 1 (on the H100: 1,519 evaluations, 7 trial
# steps of 7 evaluations an interval, in 36.5 s) and stops early only past
# this many seconds, three times its projection limit
ADAPTIVE_DEPTH_RATIO = FLAGSHIP['depth'] / 2
ADAPTIVE_PROBE_STOP_S = 3 * ADAPTIVE_FULL_DEPTH_S / ADAPTIVE_DEPTH_RATIO
ADAPTIVE_STAGES = dict(dopri5=7, bosh3=4, fehlberg2=3, adaptive_heun=2)


class _Stopped(Exception):
    """A counted sample ran past its seconds."""


def step_counts(times, stages):
    """(accepted, rejected) trial steps of an adaptive solve from the times
    of its evaluations: a trial evaluates every stage, the first at the
    trial's start, and a trial was rejected when the next starts where it
    started. Only whole trials count."""
    starts = times[:len(times) - len(times) % stages:stages]
    rejected = sum(a == b for a, b in zip(starts[:-1], starts[1:]))
    return len(starts) - rejected, rejected


def counted_sample(torch, model, prompt, stop_s=None, **kw):
    """``model.sample(prompt, **kw)`` timed to its end (``cuda.synchronize``),
    with the times of its vector-field evaluations (one CFG evaluation
    each; their count is the NFE), taken by wrapping the field `sample`
    hands to `odeint`. Past ``stop_s`` seconds it stops at the next
    evaluation and returns None for the output."""
    from e2_tts_tpu_torch.models import e2tts as e2tts_module
    times, odeint = [], e2tts_module.odeint

    def counted_odeint(fn, *args, **kwargs):
        def counted(t, x):
            if stop_s is not None and time.perf_counter() - t0 > stop_s:
                raise _Stopped()
            times.append(float(t))
            return fn(t, x)
        return odeint(counted, *args, **kwargs)

    e2tts_module.odeint = counted_odeint
    out = None
    synchronize = torch.cuda.synchronize if model.device.type == 'cuda' else (lambda: None)
    try:
        synchronize()
        t0 = time.perf_counter()
        try:
            out = model.sample(prompt, **kw)
        except _Stopped:
            pass
        synchronize()
        seconds = time.perf_counter() - t0
    finally:
        e2tts_module.odeint = odeint
    return out, times, seconds


def planted_dopri5_fault():
    """dopri5's first b weight off by 1e-2, for as long as the context lasts."""
    import contextlib

    import numpy as np

    from e2_tts_tpu_torch.ops import ode

    @contextlib.contextmanager
    def planted():
        real = ode._ADAPTIVE_TABLEAUS['dopri5']

        def faulty():
            tab = real()
            tab.b[0] = np.float32(tab.b[0] + 1e-2)
            return tab
        ode._ADAPTIVE_TABLEAUS['dopri5'] = faulty
        try:
            yield
        finally:
            ode._ADAPTIVE_TABLEAUS['dopri5'] = real
    return planted()


def adaptive_check(torch, dev, frames=ADAPTIVE_CHECK_FRAMES, ref_steps=ADAPTIVE_REF_STEPS):
    """The four methods at atol = rtol = 1e-5 (f32, depth 2, ``frames``
    frames, the model's 32-point grid) against a ``ref_steps``-step rk4 on
    the same device, weights and noise, and the planted dopri5 fault, which
    must fail the limit."""
    model = build_e2tts(torch, dev, None, depth=2, dropout=0.0).eval()
    g = torch.Generator().manual_seed(11)
    prompt_frames = frames // 4
    prompt = torch.randn(1, prompt_frames, 100, generator=g).to(dev)
    kw = dict(text=[TEXT], duration=frames, cfg_strength=1.0,
              noise=torch.randn(1, frames, 100, generator=g).to(dev))
    model.odeint_kwargs = dict(method='rk4')
    ref, times, seconds = counted_sample(torch, model, prompt, steps=ref_steps, **kw)
    ref = ref[:, prompt_frames:].float()
    log(f'adaptive check reference: rk4 {ref_steps} steps, f32 depth 2, {frames} frames: '
        f'NFE={len(times)} seconds={seconds:.3f}')
    rel = lambda out: float((out[:, prompt_frames:].float() - ref).norm() / ref.norm())
    results = {}
    for method in ADAPTIVE_METHODS + ('dopri5 planted fault',):
        model.odeint_kwargs = dict(method=method.split()[0], atol=1e-5, rtol=1e-5)
        if method == 'dopri5 planted fault':
            with planted_dopri5_fault():
                out, times, seconds = counted_sample(torch, model, prompt, **kw)
        else:
            out, times, seconds = counted_sample(torch, model, prompt, **kw)
        results[method] = rel(out)
        log(f'adaptive check {method} atol=rtol=1e-5 f32 depth 2: '
            f'{trial_counts(method.split()[0], times)} seconds={seconds:.3f} '
            f'rel_l2 vs rk4={results[method]:.3e} (limit {ADAPTIVE_CHECK_TOL:g}; '
            f'{"must fail" if "fault" in method else "must pass"})')
    return results


def trial_counts(method, times):
    accepted, rejected = step_counts(times, ADAPTIVE_STAGES[method])
    return f'NFE={len(times)} accepted={accepted} rejected={rejected}'


def phase_adaptive(torch, dev, smi):
    """The adaptive solvers on the flagship (sequential CFG): the depth-2
    check against rk4; dopri5's NFE at depth 2 in bf16 at the model's
    defaults (atol = rtol = 1e-5, 32 grid points, 1024 frames), which
    projects the full-depth run; then one dopri5 `sample` at depth 8 in bf16
    (at 1e-3 if the projection passes `ADAPTIVE_FULL_DEPTH_S`) with its NFE,
    trial steps, seconds, RTF and launch counts."""
    from e2_tts_tpu_torch.ops import _cuda

    results = adaptive_check(torch, dev)
    bad = [m for m, r in results.items() if (r > ADAPTIVE_CHECK_TOL) != ('fault' in m)
           or not math.isfinite(r)]
    if bad:
        raise AssertionError(f'adaptive check failed for {bad}: {results}')

    g = torch.Generator().manual_seed(1)
    prompt = torch.randn(1, PROMPT_FRAMES, 100, generator=g).to(dev, torch.bfloat16)
    sample_kw = dict(text=[TEXT], duration=FRAMES, cfg_strength=1.0, steps=STEPS,
                     generator=torch.Generator(device=dev).manual_seed(2))
    defaults = dict(method='dopri5', atol=1e-5, rtol=1e-5)
    warm_up = lambda m: m.sample(prompt, **dict(sample_kw, steps=2))  # allocator, cuBLAS
    small = build_e2tts(torch, dev, torch.bfloat16, depth=2).eval()     # midpoint
    warm_up(small)
    small.odeint_kwargs = defaults
    out, times, seconds = counted_sample(torch, small, prompt, stop_s=ADAPTIVE_PROBE_STOP_S,
                                         **sample_kw)
    del small
    projected = seconds * ADAPTIVE_DEPTH_RATIO              # host-bound: time ~ layers
    stopped = out is None
    more = f' or more (stopped at t={max(times):.4f})' if stopped else ''
    log(f'adaptive dopri5 NFE at depth 2 bf16, atol=rtol=1e-5, {STEPS} grid points, '
        f'{FRAMES} frames: {trial_counts("dopri5", times)}{more} '
        f'seconds={seconds:.3f} projected depth-{FLAGSHIP["depth"]} seconds={projected:.1f}'
        f'{" or more" if stopped else ""} (limit {ADAPTIVE_FULL_DEPTH_S:g}) [{smi}]')
    tol = 1e-5 if (not stopped and projected <= ADAPTIVE_FULL_DEPTH_S) else ADAPTIVE_FALLBACK_TOL

    model = build_e2tts(torch, dev, torch.bfloat16).eval()
    warm_up(model)
    model.odeint_kwargs = dict(defaults, atol=tol, rtol=tol)
    _cuda.reset_launch_counts()
    mel, times, seconds = counted_sample(torch, model, prompt, **sample_kw)
    counts = dict(_cuda.launch_counts)
    expected = dict.fromkeys(_cuda.KERNELS, 0)
    expected.update(expected_launches(model, STEPS, evals=len(times)))
    log(f'adaptive dopri5 sample depth {FLAGSHIP["depth"]} bf16 B=1 frames={FRAMES} '
        f'atol=rtol={tol:g} cfg=1.0 sequential: {trial_counts("dopri5", times)} '
        f'seconds={seconds:.4f} '
        f'rtf={seconds / (FRAMES / FRAMES_PER_SECOND):.5f} '
        f'nan={bool(torch.isnan(mel).any())} launches={json.dumps(counts, sort_keys=True)} '
        f'[{smi}]')
    if tuple(mel.shape) != (1, FRAMES, 100) or not torch.isfinite(mel).all():
        raise AssertionError('the adaptive sample saturated (NaN) or has a bad shape')
    if counts != expected:
        raise AssertionError(f'adaptive launch counts {counts} != expected {expected}')
    del model, mel
    torch.cuda.empty_cache()


# -- phase 12: every backbone and model option at once ------------------------------

OPTIONS_E2TTS = dict(num_freq_tokens=2, concat_cond=True, interpolated_text=True)
OPTIONS_TF = dict(attn_fourier_embed_input=True, remat='dots_with_no_batch_dims_saveable')
OPTIONS_REMAT_GRAD_TOL = 1e-5
OPTIONS_TRAIN_STEPS_TIMED = 3


def phase_options(torch, dev, smi):
    """The flagship widths with every option on: the frequency axis (f = 2:
    K1 / K2 / K10 also across frequency tokens), concat_cond, interpolated
    text, the FANformer input map and selective remat. At depth 2: one CFG
    evaluation bf16 against the CPU in f32, one train step f32 against the
    CPU, and remat 'dots_with_no_batch_dims_saveable' against off and
    against True (f32, dropout 0.1). At depth 8: one midpoint sample with
    its RTF and launch counts, then timed `E2Trainer` steps at B=16 x 1024
    with remat off, True and the policy: ms a step, peak memory, launch
    counts. Returns the sample's and the policy's train steps' launch
    counts."""
    import numpy as np

    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches

    model = build_e2tts(torch, dev, torch.bfloat16, OPTIONS_E2TTS, depth=2, **OPTIONS_TF).eval()
    cpu_model = build_e2tts(torch, 'cpu', None, OPTIONS_E2TTS, depth=2, **OPTIONS_TF).eval()
    check_cfg_eval(torch, dev, model, cpu_model, 'options (depth 2)')
    del model, cpu_model
    batch = check_train_vs_cpu(torch, dev, 'options (depth 2)', dict(FLAGSHIP, **OPTIONS_TF),
                               kinds=('f32',), e2tts=OPTIONS_E2TTS)

    results = {}
    for remat in (False, True, OPTIONS_TF['remat']):
        small = build_e2tts(torch, dev, None, OPTIONS_E2TTS, depth=2, dropout=0.1,
                            **dict(OPTIONS_TF, remat=remat)).train()
        _cuda.reset_launch_counts()
        loss, grad = step_loss_and_grads(torch, small, batch,
                                         generator=torch.Generator().manual_seed(7))
        results[remat] = (loss, grad, _cuda.launch_counts['flash_fwd'])
        del small
    loss_off, grad_off, fwd_off = results[False]
    for remat in (True, OPTIONS_TF['remat']):
        loss, grad, fwd = results[remat]
        grad_rel = float((grad - grad_off).norm() / grad_off.norm())
        log(f'options (depth 2) remat={remat!r} vs off, f32 card, dropout 0.1, same weights, '
            f'draws and generator: loss={loss:.7f} loss_off={loss_off:.7f} '
            f'grad_rel_l2={grad_rel:.3e} (<= {OPTIONS_REMAT_GRAD_TOL:g}) flash_fwd launches '
            f'{fwd} / {fwd_off}')
        if not (loss == loss_off and grad_rel <= OPTIONS_REMAT_GRAD_TOL and fwd == 2 * fwd_off):
            raise AssertionError(f'remat={remat!r} changes the train step')
    torch.cuda.empty_cache()

    model = build_e2tts(torch, dev, torch.bfloat16, OPTIONS_E2TTS, **OPTIONS_TF).eval()
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator().manual_seed(1)
    prompt = torch.randn(1, PROMPT_FRAMES, 100, generator=g).to(dev, torch.bfloat16)
    sample_kw = dict(text=[TEXT], duration=FRAMES, cfg_strength=1.0,
                     generator=torch.Generator(device=dev).manual_seed(2))
    model.sample(prompt, steps=2, **sample_kw)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    mel = model.sample(prompt, steps=STEPS, **sample_kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sample_counts = dict(_cuda.launch_counts)
    expected = dict.fromkeys(_cuda.KERNELS, 0)
    expected.update(expected_launches(model, STEPS))
    log(f'options sample depth {FLAGSHIP["depth"]} bf16 B=1 frames={FRAMES} '
        f'NFE={2 * (STEPS - 1)} midpoint cfg=1.0 sequential: seconds={seconds:.4f} '
        f'rtf={seconds / (FRAMES / FRAMES_PER_SECOND):.5f} params={n_params} '
        f'launches={json.dumps(sample_counts, sort_keys=True)} [{smi}]')
    if tuple(mel.shape) != (1, FRAMES, 100) or not torch.isfinite(mel).all():
        raise AssertionError(f'options sample output bad: shape {tuple(mel.shape)}')
    if sample_counts != expected:
        raise AssertionError(f'options launch counts {sample_counts} != expected {expected}')
    del model, mel
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    words = TEXT.split()
    dataset = ArrayDataset(
        [rng.standard_normal((100, FRAMES)).astype(np.float32) for _ in range(TRAIN_BATCH)],
        [' '.join(rng.choice(words, size=12)) for _ in range(TRAIN_BATCH)])
    train_counts = None
    for remat in (False, True, OPTIONS_TF['remat']):
        model = build_e2tts(torch, dev, torch.bfloat16, OPTIONS_E2TTS, dropout=0.1,
                            **dict(OPTIONS_TF, remat=remat))
        trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0,
                            total_steps=10_000, seed=0)
        step_batch = trainer.prepare_batch(next(iter_batches(dataset, TRAIN_BATCH, seed=1)))
        trainer.train_step(*step_batch, drop_text_cond=False)    # warm-up: optimizer state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [trainer.train_step(*step_batch, drop_text_cond=False)[0]
                  for _ in range(OPTIONS_TRAIN_STEPS_TIMED)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / OPTIONS_TRAIN_STEPS_TIMED
        counts = dict(_cuda.launch_counts)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = bool(torch.isfinite(torch.stack(losses)).all())
        log(f'options train steps remat={remat!r} depth {FLAGSHIP["depth"]} B={TRAIN_BATCH} '
            f'frames={FRAMES} dropout 0.1 bf16 with text, {OPTIONS_TRAIN_STEPS_TIMED} steps: '
            f'ms_per_step={ms:.3f} max_memory_allocated_gib={peak_gib:.3f} '
            f'loss_finite={finite} last_loss={float(losses[-1]):.5f} '
            f'launches={json.dumps(counts, sort_keys=True)} [{smi}]')
        expected = {k: OPTIONS_TRAIN_STEPS_TIMED * n
                    for k, n in expected_train_launches(model, True).items()}
        expected = {k: expected.get(k, 0) for k in _cuda.KERNELS}
        if counts != expected:
            raise AssertionError(f'options train launch counts {counts} != expected {expected}')
        if not finite:
            raise AssertionError('options train loss is not finite')
        train_counts = counts
        del model, trainer, step_batch
        torch.cuda.empty_cache()
    return sample_counts, train_counts


# -- phase 13: distributed ---------------------------------------------------------

# the train-correctness limits of PERF.md section 2: one step's loss, and the
# parameters after two steps (relative L2 over all of them)
DIST_LOSS_TOL = 1e-5
DIST_PARAM_TOL = 1e-4
DIST_TRAIN_STEPS_TIMED = 5


def dist_params(torch, model):
    """Every parameter of ``model`` (FSDP-sharded or not) as one f32 vector
    on the CPU."""
    from e2_tts_tpu_torch.parallel.fsdp import gather_full
    return torch.cat([gather_full(p.detach()).float().flatten().cpu()
                      for p in model.parameters()])


def phase_distributed(torch, dev, smi):
    """`E2Trainer` over a real NCCL process group of one rank (the card is one GPU, and NCCL takes one rank a device),
    started by `maybe_initialize_distributed` from a file rendezvous under
    build/: at depth 2 in f32 (dropout 0.1, B=8 x 512 ragged, the same
    weights and generator) `param_sharding='replicated'` (DDP) and 'fsdp'
    (FSDP2) two steps (with text, text dropped) against the single-device
    trainer at `DIST_LOSS_TOL` / `DIST_PARAM_TOL`; then at the flagship's
    full width (bf16, dropout 0.1, B=16 x 1024) ms a step, single device
    against DDP against FSDP2, and peak memory, with the launch counts of
    the timed steps. The process group is stopped at the end. Returns the
    FSDP2 steps' launch counts."""
    import numpy as np
    import torch.distributed as dist

    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.parallel.mesh import make_mesh
    from e2_tts_tpu_torch.parallel.multihost import maybe_initialize_distributed
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches

    store = os.path.abspath(os.path.join('build', 'dist_store'))
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    if not maybe_initialize_distributed(init_method=f'file://{store}', world_size=1, rank=0,
                                        timeout=120):
        raise AssertionError('no process group')
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'backend {dist.get_backend()}, not NCCL')
        mesh = make_mesh()
        rng = np.random.default_rng(3)
        words = TEXT.split()

        def dataset(count, frames, ragged):
            lengths = rng.integers(frames // 2, frames + 1, count) if ragged else [frames] * count
            return ArrayDataset([rng.standard_normal((100, f)).astype(np.float32)
                                 for f in lengths],
                                [' '.join(rng.choice(words, size=12)) for _ in range(count)])

        check_set = dataset(8, 512, ragged=True)
        runs = {}
        for sharding in (None, 'replicated', 'fsdp'):
            model = build_e2tts(torch, dev, None, depth=2, dropout=0.1)
            trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0,
                                total_steps=10_000, seed=0,
                                **(dict(mesh=mesh, param_sharding=sharding) if sharding
                                   else {}))
            batch = trainer.prepare_batch(next(iter_batches(check_set, 8, seed=1)))
            losses = [float(trainer.train_step(*batch, drop_text_cond=drop)[0])
                      for drop in (False, True)]
            runs[sharding] = (losses, dist_params(torch, model))
            del model, trainer
            torch.cuda.empty_cache()
        ref_losses, ref_params = runs[None]
        for sharding in ('replicated', 'fsdp'):
            losses, params = runs[sharding]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
            param_rel = float((params - ref_params).norm() / ref_params.norm())
            log(f'distributed check {sharding} (NCCL, world 1) vs one device: depth 2 f32 '
                f'dropout 0.1 B=8 x <=512 ragged, with text then text dropped: losses={losses} '
                f'single={ref_losses} loss_rel={loss_rel:.3e} (<= {DIST_LOSS_TOL:g}) '
                f'param_rel_l2 after two steps={param_rel:.3e} (<= {DIST_PARAM_TOL:g})')
            if not (loss_rel <= DIST_LOSS_TOL and param_rel <= DIST_PARAM_TOL):
                raise AssertionError(f'{sharding} trainer disagrees with the single device')
        del runs

        train_set = dataset(TRAIN_BATCH, FRAMES, ragged=False)
        ms, fsdp_counts = {}, None
        for sharding in (None, 'replicated', 'fsdp'):
            model = build_e2tts(torch, dev, torch.bfloat16, dropout=0.1)
            trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0,
                                total_steps=10_000, seed=0,
                                **(dict(mesh=mesh, param_sharding=sharding) if sharding
                                   else {}))
            batch = trainer.prepare_batch(next(iter_batches(train_set, TRAIN_BATCH, seed=1)))
            trainer.train_step(*batch, drop_text_cond=False)      # warm-up: optimizer state
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            losses = [trainer.train_step(*batch, drop_text_cond=False)[0]
                      for _ in range(DIST_TRAIN_STEPS_TIMED)]
            torch.cuda.synchronize()
            ms[sharding] = (time.perf_counter() - t0) * 1e3 / DIST_TRAIN_STEPS_TIMED
            counts = dict(_cuda.launch_counts)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            finite = bool(torch.isfinite(torch.stack(losses)).all())
            name = sharding or 'one device'
            log(f'distributed train steps {name} (world 1) flagship depth '
                f'{FLAGSHIP["depth"]} bf16 B={TRAIN_BATCH} frames={FRAMES} dropout 0.1 with '
                f'text, {DIST_TRAIN_STEPS_TIMED} steps: ms_per_step={ms[sharding]:.3f} '
                f'max_memory_allocated_gib={peak_gib:.3f} loss_finite={finite} '
                f'last_loss={float(losses[-1]):.5f} '
                f'launches={json.dumps(counts, sort_keys=True)} [{smi}]')
            expected = {k: DIST_TRAIN_STEPS_TIMED * n
                        for k, n in expected_train_launches(model, True).items()}
            expected = {k: expected.get(k, 0) for k in _cuda.KERNELS}
            if counts != expected or not finite:
                raise AssertionError(f'{name} train steps: launch counts {counts} != '
                                     f'{expected}, or a loss not finite')
            if sharding == 'fsdp':
                fsdp_counts = counts
            del model, trainer, batch
            torch.cuda.empty_cache()
        log(f'distributed world-1 step cost: ddp/one_device={ms["replicated"] / ms[None]:.4f} '
            f'fsdp/one_device={ms["fsdp"] / ms[None]:.4f} [{smi}]')
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return fsdp_counts


# -- phase 14: tensor_parallel -------------------------------------------------------

# (a) of the tensor_parallel phase, the dropout offsets a rank draws at: a
# launch of rows [B, 2B) and heads [h0, h0 + H/T) with hash_b0 = B and
# hash_h0 = h0 of hash_heads = H against those rows and heads of one launch
# of all 2B rows and H heads (T = 1: every head). out, lse, dk, dv and K2's
# gate grad are the same arithmetic on the same inputs (bit for bit); dq is
# summed by atomics in an order that changes between launches, so it takes
# the kernels' backward tolerance (`compare(..., scaled=True)`). Each rank's
# launch is also held against its plain version at the same offsets. The
# planted faults (hash_b0 = 0; hash_h0 = 0 past the first head) must lose
# the bits and exceed the forward tolerance. K6 / K7 on a rank's value and
# gate columns under the folded seed against those columns of one launch:
# bit for bit; the planted unfolded seed (c0 = 0) must fail likewise
OFFSET_CASES = (('K1 / K2', True, 8, 64), ('K8 / K9', False, 16, 72))
OFFSET_SPLITS = (1, 2, 4)
OFFSET_GEGLU_INNER = (2752, 3072)

# (b) one attention and one feedforward cut in T shards, each run alone on
# the card and summed, against the whole layer: the output and the input
# grad at these relative L2 limits (f32: sums over the inner width in T
# parts; bf16: section 2's bf16 grad limit)
TP_LAYER_TOL = {'f32': 1e-5, 'bf16': TRAIN_CHECK_TOL['bf16']['grad']}
TP_LAYER_CASES = (('paper', 1024, 16, 64), ('DiT', 1152, 16, 72))
TP_LAYER_BATCH = 16
# (c) the TP trainer on two gloo ranks of the one card against one device:
# section 2's f32 train limits (the losses; the parameters after two steps
# and the sample as relative L2), the sample bit for bit across the ranks.
# Each parameter element is also held within TP_PARAM_ABS_TOL, the CPU
# tests' limit (tests/test_torch_tp.py): a whole-model relative L2 cannot
# see one small parameter gone wrong. On the H100 the whole-model relative
# L2 reads 1.69e-9-1.70e-9 over a norm of 204.7 (16,968,652 parameters),
# which bounds every element's difference below 3.5e-7.
# The planted fault, the value-head gate's and value-residual mix's grads
# left unsummed over the model axis (a rank's update then leaves the other
# ranks' heads' rows where they were: up to lr / 10 * pi / 2 = 1.2e-5 on the
# second ADOPT step, the first updates nothing), must exceed it
TP_LOSS_TOL = DIST_LOSS_TOL
TP_PARAM_TOL = DIST_PARAM_TOL
TP_PARAM_ABS_TOL = 1e-6
TP_SAMPLE_TOL = 1e-4
TP_SAMPLE_FRAMES, TP_SAMPLE_STEPS = 256, 4
# then the TP code's own cost at world 1 over NCCL, mesh (1, 1): the
# flagship at its full depth (as the distributed phase times DDP and FSDP2),
# bf16, B = 16 x 1024 with text, one device and the TP trainer side by side,
# TP_COST_ROUNDS rounds in turns of TP_TRAIN_STEPS_TIMED steps a side (the
# host is shared: one block a side swings 1.0-1.5x), then one profiled step a
# side
TP_COST_ROUNDS = 3
TP_TRAIN_STEPS_TIMED = 5
TP_STORE = os.path.join('build', 'tp_store')
TP_RANK1_SAMPLE = os.path.join('build', 'tp_rank1_sample.pt')
TP_RANK1_LOG = os.path.join('build', 'tp_rank1.log')
TP_RANK_TIMEOUT_S = 240


def dropout_offset_check(torch, dev):
    """(a) of the tensor_parallel phase: K1 / K2 (packed, gated, heads of 64)
    and K8 / K9 ((b, h, n, dh), heads of 72), bf16 (the Hopper design) and
    f32 (the wmma templates), dropout 0.1, softclamp 50, a key mask, 2 x 2
    rows of 1056: for each T in `OFFSET_SPLITS`, rows [2, 4) and each rank's
    heads launched alone at ``hash_b0 = 2``, ``hash_h0 = h0`` against those
    rows and heads of one launch of all four rows and every head, and
    against their plain version; the planted faults at ``hash_b0 = 0`` and
    ``hash_h0 = 0`` must fail. Then K6 / K7 at inner 2752 and 3072 on a
    rank's value and gate columns under `fold_column_offset`, with the
    planted unfolded seed."""
    from e2_tts_tpu_torch.ops import flash_attention as fa
    from e2_tts_tpu_torch.ops import geglu_kernel as gk
    from e2_tts_tpu_torch.ops.dropout import fold_column_offset

    g = torch.Generator(device=dev).manual_seed(17)
    b, n, rate, seed = 2, 1056, 0.1, 1234
    lens = torch.tensor([n, 700, 1000, 333], device=dev)
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    for label, packed, heads, dh in OFFSET_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            shape = (2 * b, n, heads * dh) if packed else (2 * b, heads, n, dh)
            q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            kw = dict(softclamp_value=50.0, dropout_rate=rate, dropout_seed=seed)
            if packed:
                gate = (2 * torch.randn(2 * b, n, heads, generator=g, device=dev)).to(dtype)
                fwd = lambda q, k, v, m, gt, hl, **o: fa.flash_attention_packed(
                    q, k, v, m, heads=hl, gate_logits=gt, return_lse=True, **kw, **o)
                bwd = lambda q, k, v, m, gt, out, lse, do, hl, **o: \
                    fa.flash_attention_packed_backward(q, k, v, m, out, lse, do, heads=hl,
                                                       gate_logits=gt, **kw, **o)
                plain = lambda q, k, v, m, gt, hl, **o: fa.flash_attention_packed_plain(
                    q, k, v, m, heads=hl, scale=dh ** -0.5, gate_logits=gt, **kw, **o)
                part = lambda t, h0, hl: t[b:, ..., h0 * dh:(h0 + hl) * dh]
            else:
                gate = None
                fwd = lambda q, k, v, m, gt, hl, **o: fa.flash_attention(
                    q, k, v, m, return_lse=True, **kw, **o)
                bwd = lambda q, k, v, m, gt, out, lse, do, hl, **o: \
                    fa.flash_attention_backward(q, k, v, m, out, lse, do, **kw, **o)
                plain = lambda q, k, v, m, gt, hl, **o: fa.flash_attention_plain(
                    q, k, v, m, scale=dh ** -0.5, **kw, **o)
                part = lambda t, h0, hl: t[b:, h0:h0 + hl]
            out, lse = fwd(q, k, v, mask, gate, heads)
            grads = bwd(q, k, v, mask, gate, out, lse, do, heads)
            fwd_tol = (1e-3, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
            bwd_tol = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
            name = f'{label} {str(dtype).split(".")[1]} dh {dh}'
            for T in OFFSET_SPLITS:
                hl = heads // T
                bits, dq_worst, plain_worst = True, 0.0, 0.0
                faults = {'hash_b0': [False, math.inf], 'hash_h0': [False, math.inf]}
                for h0 in range(0, heads, hl):
                    args = [part(t, h0, hl) for t in (q, k, v)] + [mask[b:]]
                    gate_r = gate[b:, :, h0:h0 + hl].contiguous() if packed else None
                    at = dict(hash_b0=b, hash_h0=h0, hash_heads=heads)
                    o2, l2 = fwd(*args, gate_r, hl, **at)
                    g2 = bwd(*args, gate_r, o2, l2, part(do, h0, hl), hl, **at)
                    want = part(out, h0, hl)
                    want_lse = lse.view(2 * b, heads, n)[b:, h0:h0 + hl].reshape(b * hl, n)
                    bits &= (torch.equal(o2, want) and torch.equal(l2, want_lse)
                             and torch.equal(g2[1], part(grads[1], h0, hl))
                             and torch.equal(g2[2], part(grads[2], h0, hl))
                             and (not packed or torch.equal(
                                 g2[3], grads[3][b:, :, h0:h0 + hl])))
                    dq_worst = max(dq_worst, compare(g2[0], part(grads[0], h0, hl), *bwd_tol,
                                                     scaled=True)[1])
                    plain_worst = max(plain_worst, compare(
                        (o2,), (plain(*args, gate_r, hl, **at)[0],), *fwd_tol)[1])
                    planted = dict(hash_b0=dict(at, hash_b0=0),
                                   hash_h0=dict(at, hash_h0=0) if h0 else None)
                    for fault, wrong in planted.items():
                        if wrong is None:                 # hash_h0 = 0 is right here
                            continue
                        o3 = fwd(*args, gate_r, hl, **wrong)[0]
                        faults[fault][0] |= torch.equal(o3, want)
                        faults[fault][1] = min(faults[fault][1],
                                               compare((o3,), (want,), *fwd_tol)[1])
                torch.cuda.synchronize()
                fault_text = '; '.join(f'planted {f}=0: bit-equal={e} least worst/limit={w:.3f}'
                                       for f, (e, w) in faults.items() if w < math.inf)
                log(f'tensor_parallel dropout offsets {name} T={T}: rows [{b}, {2 * b}) and each '
                    f'rank\'s {hl} heads at hash_b0={b}, hash_h0=h0 of {heads} ({n} keys, '
                    f'dropout {rate}, mask, softclamp 50) vs one launch: out/lse/dk/dv'
                    f'{"/gate grad" if packed else ""} bit-equal={bits} dq worst/limit='
                    f'{dq_worst:.3f}; vs plain: out worst/limit={plain_worst:.3f}; {fault_text} '
                    f'(must exceed 1)')
                if not (bits and dq_worst <= 1.0 and plain_worst <= 1.0):
                    raise AssertionError(f'{name} T={T}: a rank\'s rows and heads differ from '
                                         f'the whole launch\'s')
                if any(e or w <= 1.0 for e, w in faults.values() if w < math.inf):
                    raise AssertionError(f'{name} T={T}: a planted offset fault passed')
            del q, k, v, do, out, lse, grads

    for inner in OFFSET_GEGLU_INNER:
        for dtype in (torch.bfloat16, torch.float32):
            h2 = torch.randn(2 * b, n, 2 * inner, generator=g, device=dev).to(dtype)
            gout = torch.randn(2 * b, n, inner, generator=g, device=dev).to(dtype)
            act = gk.geglu_dropout(h2, seed, rate)
            gh2 = gk.geglu_dropout_backward(h2, gout, seed, rate)
            tol = (1e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)
            for T in OFFSET_SPLITS[1:]:
                c = inner // T
                bits, fault_bits, fault_worst = True, False, math.inf
                for c0 in range(0, inner, c):
                    cols = lambda t: torch.cat((t[..., c0:c0 + c],
                                                t[..., inner + c0:inner + c0 + c]), -1)
                    h2r = cols(h2).contiguous()
                    folded = fold_column_offset(seed, c0)
                    bits &= torch.equal(gk.geglu_dropout(h2r, folded, rate), act[..., c0:c0 + c])
                    bits &= torch.equal(gk.geglu_dropout_backward(
                        h2r, gout[..., c0:c0 + c].contiguous(), folded, rate), cols(gh2))
                    if c0:                                # the planted c0 = 0
                        a3 = gk.geglu_dropout(h2r, seed, rate)
                        fault_bits |= torch.equal(a3, act[..., c0:c0 + c])
                        fault_worst = min(fault_worst,
                                          compare((a3,), (act[..., c0:c0 + c],), *tol)[1])
                torch.cuda.synchronize()
                name = f'K6 / K7 {str(dtype).split(".")[1]} inner {inner}'
                log(f'tensor_parallel column fold {name} T={T}: each rank\'s {c} value and '
                    f'gate columns under fold_column_offset (dropout {rate}) vs one launch: '
                    f'bit-equal={bits}; planted c0=0: bit-equal={fault_bits} least '
                    f'worst/limit={fault_worst:.3f} (must exceed 1)')
                if not bits:
                    raise AssertionError(f'{name} T={T}: a rank\'s columns differ')
                if fault_bits or fault_worst <= 1.0:
                    raise AssertionError(f'{name} T={T}: the planted c0=0 fault passed')
            del h2, gout, act, gh2


def local_axis(tp, size: int, rank: int, mesh=None):
    """A `ModelAxis` of ``size`` ranks (on ``mesh``) whose sums take
    nothing: one rank's share computed alone, the caller summing the
    shares; at one rank, TP's layers without their collectives."""
    class Local(tp.ModelAxis):
        def all_reduce(self, t):
            return t
    return Local(None, size, rank, mesh)


def sharded_layer_check(torch, dev):
    """(b) of the tensor_parallel phase: one attention (gated, softclamp 50,
    the value-residual mix, RoPE, a key mask) and one feedforward at the
    paper's widths (1024, 16 x 64, GEGLU 2752: K1 / K2 / K6 / K7) and DiT's
    (1152, 16 x 72, GEGLU 3072: K8 / K9 / K6 / K7), B = 16 x 1056, dropout
    0.1, f32 and bf16: for T = 2 and 4 each rank's shard (`tp.cut_module_tp`
    on a copy, its model axis summing nothing) runs alone and the shards'
    outputs and input grads are summed (the feedforward's output bias on
    one shard only), against the whole layers at `TP_LAYER_TOL`."""
    from e2_tts_tpu_torch.models.blocks import Attention, FeedForward
    from e2_tts_tpu_torch.ops.rotary import rotary_tables
    from e2_tts_tpu_torch.parallel import tp

    n = FRAMES + 32
    for label, dim, heads, dh in TP_LAYER_CASES:
        for kind, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
            gen = torch.Generator().manual_seed(7)
            layers = torch.nn.ModuleDict(dict(
                attn=Attention(dim, heads, dh, dropout=0.1, gate_value_heads=True,
                               softclamp_logits=True, learned_value_residual_mix=True,
                               dtype=dtype, generator=gen),
                ff=FeedForward(dim, dropout=0.1, dtype=dtype, generator=gen)))
            with torch.no_grad():
                for p in layers.parameters():
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))
            layers = layers.to(dev).train()
            g = torch.Generator(device=dev).manual_seed(8)
            x = torch.randn(TP_LAYER_BATCH, n, dim, generator=g, device=dev).to(dtype)
            vr = torch.randn(TP_LAYER_BATCH, n, heads * dh, generator=g, device=dev).to(dtype)
            w_a, w_f = (torch.randn(TP_LAYER_BATCH, n, dim, generator=g, device=dev)
                        for _ in range(2))
            mask = torch.arange(n, device=dev)[None, :] < torch.randint(
                n // 2, n + 1, (TP_LAYER_BATCH, 1), generator=g, device=dev)
            rotary = rotary_tables(n, dh, device=dev)

            def run(mod, value_residual):
                xx = x.detach().clone().requires_grad_()
                a_out, _ = mod['attn'](xx, rotary_pos_emb=rotary, mask=mask,
                                       value_residual=value_residual, dropout_seed=11)
                f_out = mod['ff'](xx, dropout_seed=12)
                ((a_out.float() * w_a).sum() + (f_out.float() * w_f).sum()).backward()
                return a_out.detach().float(), f_out.detach().float(), xx.grad.float()

            whole = run(layers, vr)
            for T in (2, 4):
                sums = None
                for r in range(T):
                    shard = copy.deepcopy(layers)
                    tp.cut_module_tp(shard, local_axis(tp, T, r))
                    if r:       # the bias is added once, after the sum over the ranks
                        shard['ff'].proj_out.bias.data.zero_()
                    cols = heads * dh // T
                    parts = run(shard, vr[..., r * cols:(r + 1) * cols])
                    sums = parts if sums is None else tuple(a + b for a, b in zip(sums, parts))
                    del shard
                rel = [float((s - w).norm() / w.norm()) for s, w in zip(sums, whole)]
                lim = TP_LAYER_TOL[kind]
                log(f'tensor_parallel layers {label} {kind} (dim {dim}, {heads} x {dh}, GEGLU '
                    f'{layers["ff"].inner}, B={TP_LAYER_BATCH} x {n}, dropout 0.1) T={T} shards '
                    f'summed vs whole: attention out rel_l2={rel[0]:.3e} feedforward out '
                    f'rel_l2={rel[1]:.3e} input grad rel_l2={rel[2]:.3e} (<= {lim:g})')
                if not all(r <= lim for r in rel):
                    raise AssertionError(f'{label} {kind} T={T}: the shards\' sum differs '
                                         f'from the whole layers')
            del layers, x, vr, whole, sums
            torch.cuda.empty_cache()


def tp_check_batch():
    """The TP check's global batch: 8 seeded mels of up to 512 frames
    (ragged) with texts, as `E2Trainer.prepare_batch` takes a collated one;
    the same in every process."""
    import numpy as np
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches
    rng = np.random.default_rng(5)
    words = TEXT.split()
    data = ArrayDataset([rng.standard_normal((100, int(f))).astype(np.float32)
                         for f in rng.integers(256, 513, 8)],
                        [' '.join(rng.choice(words, size=12)) for _ in range(8)])
    return next(iter_batches(data, 8, seed=1))


def tp_train_and_sample(torch, dev, mesh=None, sample=True):
    """The TP check's run: the flagship at depth 2, f32, dropout 0.1 under
    `E2Trainer` (sharded over ``mesh`` when given): two steps (with text,
    text dropped) on `tp_check_batch`, then (``sample``) a midpoint sample
    of `TP_SAMPLE_STEPS` steps from a seeded generator. Returns the losses,
    every parameter as one f32 CPU vector in the single-device layout (a
    collective under ``mesh``) and the sample (or None)."""
    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.parallel import tp

    model = build_e2tts(torch, dev, None, depth=2, dropout=0.1)
    if mesh is not None:
        tp.shard_module_tp(model, mesh)
    trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0, total_steps=10_000,
                        seed=0, **(dict(mesh=mesh) if mesh is not None else {}))
    batch = trainer.prepare_batch(tp_check_batch())
    losses = [float(trainer.train_step(*batch, drop_text_cond=drop)[0]) for drop in (False, True)]
    layouts, axis = tp.param_layouts(model), tp.tp_axis(model)
    params = torch.cat([(tp.full_tensor(p.detach().cpu(), layouts[p], axis) if p in layouts
                         else p.detach().cpu()).float().flatten() for p in model.parameters()])
    if not sample:
        return losses, params, None
    prompt = torch.randn(1, TP_SAMPLE_FRAMES // 2, 100,
                         generator=torch.Generator().manual_seed(2))
    mel = model.sample(prompt.to(dev), text=[TEXT], duration=TP_SAMPLE_FRAMES,
                       steps=TP_SAMPLE_STEPS, generator=torch.Generator().manual_seed(1))
    return losses, params, mel.float().cpu()


def tp_rank(torch, dev, rank: int):
    """Rank ``rank`` of the two gloo ranks on the one card: the TP check's
    run on mesh (1, 2), then the planted fault's (the trainer's
    `sum_shared_grads_` a no-op: the value-head gate's and the
    value-residual mix's grads unsummed) without the sample; rank 1 saves its sample for rank 0 to
    compare. Returns both runs' results and leaves the group stopped."""
    import torch.distributed as dist

    from e2_tts_tpu_torch.parallel import tp
    from e2_tts_tpu_torch.parallel.multihost import maybe_initialize_distributed
    from e2_tts_tpu_torch.training import trainer

    store = os.path.abspath(TP_STORE)
    if not maybe_initialize_distributed(init_method=f'file://{store}', world_size=2, rank=rank,
                                        device='cpu', timeout=TP_RANK_TIMEOUT_S):
        raise AssertionError('no process group')
    shared_sum = trainer.sum_shared_grads_
    try:
        mesh = tp.make_2d_mesh(1, 2)
        results = tp_train_and_sample(torch, dev, mesh)
        if rank == 1:
            torch.save(results[2], TP_RANK1_SAMPLE)
        trainer.sum_shared_grads_ = lambda params, axis: None
        fault = tp_train_and_sample(torch, dev, mesh, sample=False)
        dist.barrier()
    finally:
        trainer.sum_shared_grads_ = shared_sum
        dist.destroy_process_group()
    return results, fault


def tp_two_ranks(torch, dev):
    """(c), first part: rank 1 in a process of its own (this script with
    ``--tp-rank 1``), rank 0 here, one gloo group on the one card (NCCL
    takes one rank a GPU); the single-device reference runs while rank 1
    starts. Losses, parameters and the sample against one device; the
    ranks' samples bit for bit; the planted fault's parameters must exceed
    `TP_PARAM_ABS_TOL`."""
    for path in (TP_STORE, TP_RANK1_SAMPLE):
        if os.path.exists(path):
            os.remove(path)
    os.makedirs(os.path.dirname(TP_STORE), exist_ok=True)
    with open(TP_RANK1_LOG, 'w') as log_file:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), '--tp-rank', '1'],
                                stdout=log_file, stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        ref_losses, ref_params, ref_sample = tp_train_and_sample(torch, dev)
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (losses, params, sample), (_, fault_params, _) = tp_rank(torch, dev, 0)
        tp_s = time.perf_counter() - t0
        code = proc.wait(timeout=TP_RANK_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(TP_RANK1_LOG) as f:
        rank1_log = f.read()
    if code != 0:
        raise AssertionError(f'tensor_parallel rank 1 exited with {code}:\n{rank1_log[-3000:]}')
    rank1_sample = torch.load(TP_RANK1_SAMPLE, weights_only=True)
    os.remove(TP_RANK1_SAMPLE)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    param_rel = float((params - ref_params).norm() / ref_params.norm())
    param_abs = float((params - ref_params).abs().max())
    fault_rel = float((fault_params - ref_params).norm() / ref_params.norm())
    fault_abs = float((fault_params - ref_params).abs().max())
    sample_rel = float((sample - ref_sample).norm() / ref_sample.norm())
    ranks_equal = torch.equal(sample, rank1_sample)
    finite = bool(torch.isfinite(sample).all())
    log(f'tensor_parallel trainer (gloo, 2 ranks on one card, mesh (1, 2)) vs one device: '
        f'flagship depth 2 f32 dropout 0.1 B=8 x <=512 ragged, with text then text dropped: '
        f'losses={losses} single={ref_losses} loss_rel={loss_rel:.3e} (<= {TP_LOSS_TOL:g}) '
        f'after two steps: param_rel_l2={param_rel:.3e} (<= {TP_PARAM_TOL:g}) '
        f'param_max_abs={param_abs:.3e} (<= {TP_PARAM_ABS_TOL:g}) over {ref_params.numel()} '
        f'(norm {float(ref_params.norm()):.3f}); planted unsummed shared grads: param_rel_l2='
        f'{fault_rel:.3e} param_max_abs={fault_abs:.3e} (must exceed {TP_PARAM_ABS_TOL:g}); '
        f'sample ({TP_SAMPLE_STEPS} midpoint steps, {TP_SAMPLE_FRAMES} frames) rel_l2='
        f'{sample_rel:.3e} (<= {TP_SAMPLE_TOL:g}) finite={finite} ranks bit-equal='
        f'{ranks_equal}; seconds: one device {ref_s:.1f}, TP rank 0 {tp_s:.1f} (rendezvous '
        f'and the fault included)')
    if not (loss_rel <= TP_LOSS_TOL and param_rel <= TP_PARAM_TOL
            and param_abs <= TP_PARAM_ABS_TOL and sample_rel <= TP_SAMPLE_TOL
            and ranks_equal and finite):
        raise AssertionError('the TP trainer disagrees with the single device, or its ranks '
                             'with each other')
    if fault_abs <= TP_PARAM_ABS_TOL:
        raise AssertionError('the planted unsummed shared grads passed the TP trainer check')


def step_profile(torch, run):
    """One call of ``run`` (already warm) under the profiler: its wall ms,
    the device's busy ms, and ``{operator: (calls, self host ms)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = profile_averages(prof)
    on_device = [e for e in averages if e.device_type == DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False)]
    host = {e.key: (e.count, e.self_cpu_time_total / 1e3) for e in averages
            if e.device_type != DeviceType.CUDA}
    return wall * 1e3, sum(e.self_device_time_total for e in on_device) / 1e3, host


def tp_world1_steps(torch, dev, smi):
    """(c), second part: one NCCL rank: the flagship at its full depth, bf16,
    dropout 0.1, B = 16 x 1024 with text; one device, DDP (the 1-D data
    mesh), the TP trainer (a model sharded over mesh (1, 1)) and the same
    with its layers' collectives taken out (`local_axis`: at one rank the
    same numbers) built side by side, then `TP_COST_ROUNDS` rounds in turns
    of `TP_TRAIN_STEPS_TIMED` steps a side: ms a step (and the host's, to
    the last step's return), the memory each side holds and its peak over
    that, the launch counts of every block against the model's structure;
    then a step a side with the synchronizing CUDA calls counted
    (`torch.cuda.set_sync_debug_mode`), and one profiled step a side, with
    the host operators that take more time under DDP than on one device,
    and under TP than under DDP. Returns the TP steps' counts of one
    block."""
    import statistics
    import warnings

    import numpy as np
    import torch.distributed as dist

    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.parallel import tp
    from e2_tts_tpu_torch.parallel.mesh import make_mesh
    from e2_tts_tpu_torch.parallel.multihost import maybe_initialize_distributed
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches

    store = os.path.abspath(TP_STORE)
    if os.path.exists(store):
        os.remove(store)
    if not maybe_initialize_distributed(init_method=f'file://{store}', world_size=1, rank=0,
                                        timeout=120):
        raise AssertionError('no process group')
    try:
        if dist.get_backend() != 'nccl':
            raise AssertionError(f'backend {dist.get_backend()}, not NCCL')
        mesh_tp = tp.make_2d_mesh(1, 1)
        meshes = {'one device': None, 'ddp': make_mesh(), 'tp': mesh_tp, 'tp local': mesh_tp}
        where = {'one device': 'no mesh', 'ddp': 'data mesh (1,)', 'tp': 'mesh (1, 1)',
                 'tp local': 'mesh (1, 1), no model-axis collectives'}
        rng = np.random.default_rng(6)
        words = TEXT.split()
        train_set = ArrayDataset([rng.standard_normal((100, FRAMES)).astype(np.float32)
                                  for _ in range(TRAIN_BATCH)],
                                 [' '.join(rng.choice(words, size=12))
                                  for _ in range(TRAIN_BATCH)])
        sides, held = {}, {}
        built = build_e2tts(torch, dev, torch.bfloat16, dropout=0.1)
        for name, mesh in meshes.items():
            before = torch.cuda.memory_allocated()
            model = copy.deepcopy(built)
            if name.startswith('tp'):
                tp.shard_module_tp(model, mesh)
            if name == 'tp local':
                axis = local_axis(tp, 1, 0, mesh)
                for sub in model.modules():
                    if getattr(sub, 'tp', None) is not None:
                        sub.place_tp(axis)
            trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0,
                                total_steps=10_000, seed=0,
                                **(dict(mesh=mesh) if mesh is not None else {}))
            batch = trainer.prepare_batch(next(iter_batches(train_set, TRAIN_BATCH, seed=1)))
            trainer.train_step(*batch, drop_text_cond=False)      # warm-up: optimizer state
            torch.cuda.synchronize()
            held[name] = (torch.cuda.memory_allocated() - before) / 2 ** 30
            expected = {k: TP_TRAIN_STEPS_TIMED * n
                        for k, n in expected_train_launches(model, True).items()}
            sides[name] = (trainer, batch, {k: expected.get(k, 0) for k in _cuda.KERNELS})
        del built
        ms = {name: [] for name in sides}
        host_ms = {name: [] for name in sides}
        peak = dict.fromkeys(sides, 0.0)
        block_counts = {}
        for _ in range(TP_COST_ROUNDS):
            for name, (trainer, batch, expected) in sides.items():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                losses = [trainer.train_step(*batch, drop_text_cond=False)[0]
                          for _ in range(TP_TRAIN_STEPS_TIMED)]
                host_ms[name].append((time.perf_counter() - t0) * 1e3 / TP_TRAIN_STEPS_TIMED)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3 / TP_TRAIN_STEPS_TIMED)
                counts = dict(_cuda.launch_counts)
                peak[name] = max(peak[name], (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
                if counts != expected or not bool(torch.isfinite(torch.stack(losses)).all()):
                    raise AssertionError(f'{name} train steps: launch counts {counts} != '
                                         f'{expected}, or a loss not finite')
                block_counts[name] = counts
        syncs = {}
        for name, (trainer, batch, _) in sides.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    trainer.train_step(*batch, drop_text_cond=False)
                finally:
                    torch.cuda.set_sync_debug_mode('default')
            syncs[name] = sum('synchroniz' in str(w.message) for w in caught)
        ratio = lambda a, b: [x / y for x, y in zip(ms[a], ms[b])]
        for name in sides:
            log(f'tensor_parallel train steps {name} (NCCL world 1, {where[name]}) flagship depth '
                f'{FLAGSHIP["depth"]} bf16 B={TRAIN_BATCH} frames={FRAMES} dropout 0.1 with '
                f'text, {TP_COST_ROUNDS} rounds in turns of {TP_TRAIN_STEPS_TIMED} steps: '
                f'ms_per_step={json.dumps([round(t, 3) for t in ms[name]])} median='
                f'{statistics.median(ms[name]):.3f} host_ms_per_step='
                f'{json.dumps([round(t, 3) for t in host_ms[name]])} synchronizing_calls_a_step='
                f'{syncs[name]} held_gib={held[name]:.3f} '
                f'step_peak_over_held_gib={peak[name]:.3f} '
                f'launches_a_block={json.dumps(block_counts[name], sort_keys=True)} [{smi}]')
        for a, b in (('tp', 'one device'), ('ddp', 'one device'), ('tp', 'ddp'),
                     ('tp local', 'ddp'), ('tp', 'tp local')):
            log(f'tensor_parallel world-1 step cost: {a.replace(" ", "_")}/{b.replace(" ", "_")} '
                f'by round={json.dumps([round(r, 4) for r in ratio(a, b)])} '
                f'median={statistics.median(ratio(a, b)):.4f} [{smi}]')
        profiles = {name: step_profile(torch, lambda t=trainer, b=batch: t.train_step(
            *b, drop_text_cond=False)) for name, (trainer, batch, _) in sides.items()}
        for name, (wall, busy, host) in profiles.items():
            log(f'tensor_parallel profiled step {name}: wall_ms={wall:.3f} device_busy_ms='
                f'{busy:.3f} host operators={sum(c for c, _ in host.values())} host_self_ms='
                f'{sum(t for _, t in host.values()):.3f}')
        for a, b in (('one device', 'ddp'), ('ddp', 'tp'), ('tp local', 'tp')):
            was, now = profiles[a][2], profiles[b][2]
            more = sorted(((now[k][1] - was.get(k, (0, 0.0))[1], k) for k in now), reverse=True)
            for extra, key in more[:10]:
                log(f'  {b} over {a}: host +{extra:.3f} ms {key[:64]:64s} calls '
                    f'{was.get(key, (0, 0))[0]} -> {now[key][0]}')
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    return block_counts['tp']


def phase_tensor_parallel(torch, dev, smi):
    """(a) `dropout_offset_check`; (b) `sharded_layer_check`; (c)
    `tp_two_ranks` and `tp_world1_steps`. Returns the TP steps' launch
    counts."""
    dropout_offset_check(torch, dev)
    sharded_layer_check(torch, dev)
    tp_two_ranks(torch, dev)
    return tp_world1_steps(torch, dev, smi)


# -- sequence_parallel -----------------------------------------------------------------

# (a) the ring (one process, `sp.Loopback`) against one launch over the whole
# sequence at these attention shapes: (label, heads, dim_head), B = 16 x
# 1056 rows, bf16, dropout 0.1, softclamp 50, gated; at P = 2 and 4. out at
# K1's forward limit (K8's: the kernels' bf16 limit), the grads at the
# backward limit (scaled). The ring rounds each block's output and dk / dv
# to bf16 before it sums them in f32, one launch sums in f32 first: a bf16
# ulp or two apart. The planted faults must exceed the limits
SP_RING_CASES = (('flagship K1 / K2', 8, 64), ('DiT K8 / K9', 16, 72))
SP_SPLITS = (2, 4)
SP_BATCH = 16
# (b) the SP trainer on two gloo ranks of the card against one device: the
# TP check's limits (tests/test_torch_sp.py holds the CPU to the same)
SP_LOSS_TOL = TP_LOSS_TOL
SP_PARAM_ABS_TOL = TP_PARAM_ABS_TOL
SP_STORE = os.path.join('build', 'sp_store')
SP_RANK1_LOG = os.path.join('build', 'sp_rank1.log')
# (c) the ring's cost: calls timed a side after a warm-up (host-inclusive);
# the device's time with each call queued behind a sleep of this many cycles
# (~0.1 s, past the host's ~13 ms to queue a P = 4 call), the median of
# these tries
SP_COST_CALLS = 5
SP_SLEEP_CYCLES = 200_000_000
SP_DEVICE_TRIES = 3


def sp_ring_inputs(torch, dev, heads, dh, dtype=None):
    g = torch.Generator(device=dev).manual_seed(21)
    b, n = SP_BATCH, FRAMES + 32
    dtype = dtype or torch.bfloat16
    q, k, v, do = (torch.randn(b, n, heads * dh, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    gate = (2 * torch.randn(b, n, heads, generator=g, device=dev)).to(dtype)
    lens = torch.randint(n // 2, n + 1, (b,), generator=g, device=dev)
    lens[1] = 500                  # row 1's last shard wholly masked at P = 2 and 4
    mask = torch.arange(n, device=dev)[None, :] < lens[:, None]
    return q, k, v, do, gate, mask


def sp_ring_run(torch, q, k, v, do, gate, mask, heads, mesh=None):
    """Attention (`attention_packed`: dropout 0.1, softclamp 50, the gate)
    forward and backward, routed over ``mesh`` when given: out and the
    grads of q, k, v and the gate logits."""
    from e2_tts_tpu_torch.ops.attention import attention_packed
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, gate)]
    out = attention_packed(*leaves[:3], mask, heads=heads, softclamp_value=50.0,
                           dropout_rate=0.1, dropout_seed=2024, gate_logits=leaves[3],
                           hash_b0=0, sp_mesh=mesh)
    out.backward(do)
    return (out.detach(),), tuple(t.grad for t in leaves)


def sp_keep_bits(torch, q, mask, heads, dh, P):
    """Every ring block's keep bits against the whole launch's, on every key
    column: q = k = 0 and v a shifted identity (head columns [0, w) hold keys
    [c, c + w), a window of at most dh keys inside one key block), so a
    positive output column is a kept key; the whole sequence launched once
    per window, and each block at its hash_r0 / hash_c0 (`fa.block_forward`,
    the ring's launch), the windows stepping through every block's keys.
    True when all P * P blocks agree bit for bit on the keys the mask lets
    through (a masked key's bit shows in neither: one launch gives it no
    weight, and a block whose keys are all masked spreads its weight over
    them)."""
    from e2_tts_tpu_torch.ops import flash_attention as fa
    b, n, D = q.shape
    nl = n // P
    zeros = torch.zeros_like(q)
    kw = dict(heads=heads, scale=dh ** -0.5, softclamp_value=50.0, dropout_rate=0.1,
              dropout_seed=2024)
    hash0 = fa._check_hash(0, 0, None, heads)
    eye = torch.eye(dh, device=q.device, dtype=q.dtype)
    equal = True
    for o in range(P):
        c0 = o * nl
        for c in range(c0, c0 + nl, dh):
            w = min(dh, c0 + nl - c)
            v = torch.zeros(b, n, heads, dh, device=q.device, dtype=q.dtype)
            v[:, c:c + w] = eye[:w, None, :]
            v = v.flatten(-2)
            whole = fa.block_forward(zeros, zeros, v, mask, hash_kw=hash0, **kw)[0] > 0
            visible = torch.zeros(b, heads, dh, device=q.device, dtype=torch.bool)
            visible[:, :, :w] = mask[:, None, c:c + w]
            visible = visible.reshape(b, 1, D)
            for s in range(P):
                rows, cols = slice(s * nl, (s + 1) * nl), slice(c0, c0 + nl)
                block = fa.block_forward(zeros[:, rows], zeros[:, cols],
                                         v[:, cols].contiguous(), mask[:, cols].contiguous(),
                                         hash_kw=dict(hash0, hash_r0=s * nl, hash_c0=c0),
                                         **kw)[0] > 0
                equal &= torch.equal(block & visible, whole[:, rows] & visible)
    return equal


def sp_ring_check(torch, dev, smi):
    """(a) and (c) of the sequence_parallel phase."""
    from e2_tts_tpu_torch.parallel import sp
    bf16 = torch.bfloat16
    fwd_lim = {'flagship K1 / K2': (1e-3, 1e-2), 'DiT K8 / K9': (1e-2, 1e-2)}
    bwd_lim = (1e-2, 1e-2)
    faults = {
        'offsets 0': [(sp, name, (lambda block: lambda *a, hash_kw, **o: block(
            *a, hash_kw=dict(hash_kw, hash_r0=0, hash_c0=0), **o))(getattr(sp, name)))
            for name in ('block_forward', 'block_backward')],
        'combine without rescale': [(sp, '_merge', lambda acc, lse, out, lse_b: (
            (out, lse_b) if acc is None else (acc + out, torch.logaddexp(lse, lse_b))))],
        'dk / dv kept by the visitor': [(sp, '_move_grads',
                                         lambda comm, travel: sp._Pending(travel))],
    }
    for label, heads, dh in SP_RING_CASES:
        q, k, v, do, gate, mask = sp_ring_inputs(torch, dev, heads, dh)
        ref_out, ref_grads = sp_ring_run(torch, q, k, v, do, gate, mask, heads)
        for P in SP_SPLITS:
            loop = sp.Loopback(P)
            out, grads = sp_ring_run(torch, q, k, v, do, gate, mask, heads, loop)
            f_err, f_worst = compare(out, ref_out, *fwd_lim[label])
            b_err, b_worst = compare(grads, ref_grads, *bwd_lim, scaled=True)
            bits = sp_keep_bits(torch, q, mask, heads, dh, P)
            planted = {}
            for fault, patches in faults.items():
                saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
                try:
                    for mod, name, fn in patches:
                        setattr(mod, name, fn)
                    f_out, f_grads = sp_ring_run(torch, q, k, v, do, gate, mask, heads, loop)
                finally:
                    for mod, name, fn in saved:
                        setattr(mod, name, fn)
                planted[fault] = max(compare(f_out, ref_out, *fwd_lim[label])[1],
                                     compare(f_grads, ref_grads, *bwd_lim, scaled=True)[1])
            torch.cuda.synchronize()
            fault_text = '; '.join(f'{f} worst/limit={w:.3f}' for f, w in planted.items())
            log(f'sequence_parallel ring {label} ({SP_BATCH} x {q.shape[1]} rows, {heads} x '
                f'{dh}, bf16, dropout 0.1, softclamp 50, gate, ragged mask with a wholly '
                f'masked last shard) P={P} vs one launch: out max_abs_err={f_err:.3e} '
                f'worst/limit={f_worst:.3f}; dq/dk/dv/gate grad max_abs_err={b_err:.3e} '
                f'worst/limit={b_worst:.3f}; every block\'s keep bits on every key '
                f'bit-equal={bits}; '
                f'planted: {fault_text} (must exceed 1) [{smi}]')
            if not (f_worst <= 1.0 and b_worst <= 1.0 and bits):
                raise AssertionError(f'{label} P={P}: the ring differs from one launch')
            if any(w <= 1.0 for w in planted.values()):
                raise AssertionError(f'{label} P={P}: a planted ring fault passed')
        del q, k, v, do, gate, mask, ref_out, ref_grads
        torch.cuda.empty_cache()

    # (c) the ring's cost at the flagship's training attention
    label, heads, dh = SP_RING_CASES[0]
    q, k, v, do, gate, mask = sp_ring_inputs(torch, dev, heads, dh)

    def device_ms(run):
        """The device ms of one call with the host ahead of the card: the
        call queued behind `SP_SLEEP_CYCLES` of `torch.cuda._sleep`, so its
        kernels run back to back (the median of `SP_DEVICE_TRIES`); None and
        why when the card woke before the call was queued (the host was slow
        or waited on the card)."""
        times = []
        for _ in range(SP_DEVICE_TRIES):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SP_SLEEP_CYCLES)
            start.record()
            run()
            stop.record()
            ahead = not start.query()
            torch.cuda.synchronize()
            if ahead:
                times.append(start.elapsed_time(stop))
        if not times:
            return None, (f'not measured: the card woke before the call was queued in all '
                          f'{SP_DEVICE_TRIES} tries')
        return sorted(times)[len(times) // 2], None

    def timed(mesh):
        """(device ms of one call or None, why not, host-inclusive ms a call)"""
        run = lambda: sp_ring_run(torch, q, k, v, do, gate, mask, heads, mesh)
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SP_COST_CALLS):
            run()
        stop.record()
        torch.cuda.synchronize()
        return (*device_ms(run), start.elapsed_time(stop) / SP_COST_CALLS)
    one, one_why, one_host = timed(None)
    for P in SP_SPLITS:
        ring, ring_why, ring_host = timed(sp.Loopback(P))
        device = (f'one launch {one:.3f} ring P={P} (all {P * P} blocks in one process) '
                  f'{ring:.3f} ratio {ring / one:.3f}, one rank\'s share (/ P) {ring / P:.3f} '
                  f'ratio {ring / P / one:.3f}' if one and ring else
                  f'one launch {one_why or one} ring P={P} {ring_why or ring}')
        log(f'sequence_parallel ring cost {label} ({SP_BATCH} x {q.shape[1]} rows, {heads} x '
            f'{dh}, bf16, dropout 0.1, gate, mask), forward + backward: device ms (one call queued '
            f'behind a sleep, its kernels back to back, median of {SP_DEVICE_TRIES}) {device}; '
            f'host-inclusive ms a call (CUDA events over {SP_COST_CALLS} calls) one launch '
            f'{one_host:.3f} ring P={P} {ring_host:.3f} [{smi}]')


def sp_train(torch, dev, mesh=None):
    """(b)'s run: the flagship at depth 2, f32, dropout 0.1 under `E2Trainer`
    (with ``mesh``, `sequence_parallel=2` on it): two steps on
    `tp_check_batch`. Returns the losses and every parameter as one f32 CPU
    vector."""
    from e2_tts_tpu_torch import E2Trainer

    model = build_e2tts(torch, dev, None, depth=2, dropout=0.1)
    kw = dict(mesh=mesh, sequence_parallel=2) if mesh is not None else {}
    trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0, total_steps=10_000,
                        seed=0, **kw)
    batch = trainer.prepare_batch(tp_check_batch())
    losses = [float(trainer.train_step(*batch, drop_text_cond=drop)[0]) for drop in (False, True)]
    return losses, torch.cat([p.detach().float().cpu().flatten() for p in model.parameters()])


def sp_rank(torch, dev, rank: int):
    """Rank ``rank`` of the two gloo ranks on the one card: the SP run on the
    (1, 2) mesh, then the planted fault's (each shard's conv zero-padded
    where its halo belongs). Returns both runs' results and leaves the group
    stopped."""
    import torch.distributed as dist

    from e2_tts_tpu_torch.parallel import sp
    from e2_tts_tpu_torch.parallel.multihost import maybe_initialize_distributed

    store = os.path.abspath(SP_STORE)
    if not maybe_initialize_distributed(init_method=f'file://{store}', world_size=2, rank=rank,
                                        device='cpu', timeout=TP_RANK_TIMEOUT_S):
        raise AssertionError('no process group')
    halo = sp.halo_pad
    try:
        mesh = sp.make_seq_mesh(2)
        results = sp_train(torch, dev, mesh)
        sp.halo_pad = lambda x, seq, width: torch.nn.functional.pad(x, (0, 0, width, width))
        fault = sp_train(torch, dev, mesh)
        dist.barrier()
    finally:
        sp.halo_pad = halo
        dist.destroy_process_group()
    return results, fault


def sp_start_rank1():
    """Rank 1 of (b) in a process of its own (this script with ``--sp-rank
    1``), started at the phase's start: it imports torch and waits at the
    rendezvous while (a) and (c) run."""
    if os.path.exists(SP_STORE):
        os.remove(SP_STORE)
    os.makedirs(os.path.dirname(SP_STORE), exist_ok=True)
    with open(SP_RANK1_LOG, 'w') as log_file:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), '--sp-rank', '1'],
                                stdout=log_file, stderr=subprocess.STDOUT)


def sp_two_ranks(torch, dev, smi, proc):
    """(b): rank 0 here and rank 1 in ``proc``, one gloo group on the one
    card, against the single device."""
    t0 = time.perf_counter()
    ref_losses, ref_params = sp_train(torch, dev)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (losses, params), (fault_losses, fault_params) = sp_rank(torch, dev, 0)
    sp_s = time.perf_counter() - t0
    code = proc.wait(timeout=TP_RANK_TIMEOUT_S)
    if code != 0:
        with open(SP_RANK1_LOG) as f:
            raise AssertionError(f'sequence_parallel rank 1 exited with {code}:\n'
                                 f'{f.read()[-3000:]}')
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    loss_rel, fault_loss_rel = rel(losses, ref_losses), rel(fault_losses, ref_losses)
    param_abs = float((params - ref_params).abs().max())
    fault_abs = float((fault_params - ref_params).abs().max())
    log(f'sequence_parallel trainer (E2Trainer(sequence_parallel=2), gloo, 2 ranks on one card, '
        f'mesh (1, 2); gloo\'s point-to-point calls take CUDA tensors through host memory) vs '
        f'one device: flagship depth 2 f32 dropout 0.1 B=8 x <=512 ragged, with text then text '
        f'dropped: losses={losses} single={ref_losses} loss_rel={loss_rel:.3e} (<= '
        f'{SP_LOSS_TOL:g}) param_max_abs={param_abs:.3e} (<= {SP_PARAM_ABS_TOL:g}) over '
        f'{ref_params.numel()}; planted conv without its halo: loss_rel={fault_loss_rel:.3e} '
        f'param_max_abs={fault_abs:.3e} (must exceed the limits); seconds: one device {ref_s:.1f}, SP rank 0 {sp_s:.1f} (rendezvous and the '
        f'fault included) [{smi}]')
    if not (loss_rel <= SP_LOSS_TOL and param_abs <= SP_PARAM_ABS_TOL):
        raise AssertionError('the SP trainer disagrees with the single device')
    if fault_loss_rel <= SP_LOSS_TOL and fault_abs <= SP_PARAM_ABS_TOL:
        raise AssertionError('the planted conv without its halo passed the SP trainer check')


def phase_sequence_parallel(torch, dev, smi):
    """(a) and (c) `sp_ring_check` while (b)'s rank 1 starts; (b)
    `sp_two_ranks`."""
    proc = sp_start_rank1()
    try:
        sp_ring_check(torch, dev, smi)
        sp_two_ranks(torch, dev, smi, proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- phase 16: scan_layers ----------------------------------------------------------

# a scan model's step against the unrolled model's on the card, f32, the same
# weights, draws and dropout seeds: the same kernels on the same inputs, so the
# loss is equal; the grads differ only where K2 sums dq by atomics in a
# run-dependent order (PERF.md section 2's remat limit)
SCAN_GRAD_TOL = 1e-5
SCAN_TRAIN_STEPS_TIMED = 3


def scan_twin(torch, model, dtype):
    """``model`` (a flagship E2TTS) built again with ``scan_layers`` and
    loaded from its state dict: the names are the unrolled model's."""
    from e2_tts_tpu_torch import E2TTS
    tf = model.transformer
    twin = E2TTS(transformer=dict(FLAGSHIP, dropout=tf.dropout, scan_layers=True), dtype=dtype,
                 device='cpu')
    twin.load_state_dict(model.state_dict())
    return twin.to(model.device).train(model.training)


def phase_scan_layers(torch, dev, smi):
    """``scan_layers=True`` at the flagship (512 x 8, 8 x 64; the plan's scan
    groups are layers 1-3 and 4-6), from the unrolled model's state dict:
    (a) one sequential-CFG evaluation in bf16 at 1024 frames, bit for bit the
    unrolled model's; (b) one f32 step at B=2 x 512, dropout 0.1, its loss the
    unrolled step's exactly and its grads within SCAN_GRAD_TOL (relative L2),
    and a planted fault (the dropout seeds of layer 1, the first scanned,
    shifted by one) that must exceed that ten times; (c) three with-text
    bf16 `E2Trainer` steps at B=16 x 1024 each way: ms a step, peak memory,
    launch counts against `expected_train_launches` (the scanned layers'
    forward kernels run twice)."""
    import numpy as np

    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.models import transformer as transformer_module
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches

    model = build_e2tts(torch, dev, torch.bfloat16).eval()
    scan = scan_twin(torch, model, torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, FRAMES, 100, generator=g).to(dev, torch.bfloat16)
    cond = torch.zeros(1, FRAMES, 100)
    cond[:, :PROMPT_FRAMES] = torch.randn(1, PROMPT_FRAMES, 100, generator=g)
    kw = dict(text=torch.as_tensor(model.tokenizer([TEXT]), dtype=torch.long, device=dev),
              mask=torch.ones(1, FRAMES, dtype=torch.bool, device=dev), cfg_strength=1.0,
              batched_cfg=False)
    with torch.no_grad():
        outs = [m.cfg_transformer_with_pred_head(x, cond.to(dev, torch.bfloat16),
                                                 torch.tensor([0.5], device=dev), **kw)
                for m in (model, scan)]
    equal = torch.equal(*outs)
    log(f'scan_layers (a) cfg eval bf16 B=1 frames={FRAMES} plan={scan.transformer.scan_plan}: '
        f'bit_equal_to_unrolled={equal} finite={bool(torch.isfinite(outs[1]).all())}')
    if not (equal and torch.isfinite(outs[1]).all()):
        raise AssertionError('scan_layers: the CFG evaluation is not the unrolled model\'s')
    del model, scan, outs

    model = build_e2tts(torch, dev, None, dropout=0.1).train()
    scan = scan_twin(torch, model, None)
    batch = train_check_batch(torch, model)
    seeded = lambda: torch.Generator().manual_seed(7)
    loss_u, grad_u = step_loss_and_grads(torch, model, batch, generator=seeded())
    _cuda.reset_launch_counts()
    loss_s, grad_s = step_loss_and_grads(torch, scan, batch, generator=seeded())
    fwd_s = _cuda.launch_counts['flash_fwd']
    draw, calls = transformer_module.draw_seed, [0]

    def shifted(generator):          # layer 1's four seeds (text attn, text ff, attn, ff) + 1
        calls[0] += 1
        return draw(generator) + int(4 < calls[0] <= 8)
    transformer_module.draw_seed = shifted
    try:
        loss_f, grad_f = step_loss_and_grads(torch, scan, batch, generator=seeded())
    finally:
        transformer_module.draw_seed = draw
    rel = float((grad_s - grad_u).norm() / grad_u.norm())
    rel_f = float((grad_f - grad_u).norm() / grad_u.norm())
    want_fwd = expected_train_launches(scan, True)['flash_fwd']
    log(f'scan_layers (b) f32 step B=2 frames=512 dropout 0.1 vs unrolled, same weights, draws '
        f'and seeds: loss={loss_s:.7f} unrolled_loss={loss_u:.7f} loss_equal={loss_s == loss_u} '
        f'grad_rel_l2={rel:.3e} (<= {SCAN_GRAD_TOL:g}) flash_fwd launches={fwd_s} '
        f'(expected {want_fwd}); planted fault, layer 1\'s seeds + 1: loss={loss_f:.7f} '
        f'grad_rel_l2={rel_f:.3e} (must be >= {10 * SCAN_GRAD_TOL:g})')
    if not (loss_s == loss_u and rel <= SCAN_GRAD_TOL and fwd_s == want_fwd):
        raise AssertionError('scan_layers: the f32 step is not the unrolled model\'s')
    if not rel_f >= 10 * SCAN_GRAD_TOL:
        raise AssertionError('scan_layers: the planted seed fault passed the check')
    del model, scan, grad_u, grad_s, grad_f
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    words = TEXT.split()
    dataset = ArrayDataset(
        [rng.standard_normal((100, FRAMES)).astype(np.float32) for _ in range(TRAIN_BATCH)],
        [' '.join(rng.choice(words, size=12)) for _ in range(TRAIN_BATCH)])
    results = {}
    for label in ('unrolled', 'scan'):
        model = build_e2tts(torch, dev, torch.bfloat16, dropout=0.1)
        if label == 'scan':
            model = scan_twin(torch, model, torch.bfloat16)
        trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0, total_steps=10_000,
                            seed=0)
        step_batch = trainer.prepare_batch(next(iter_batches(dataset, TRAIN_BATCH, seed=1)))
        trainer.train_step(*step_batch, drop_text_cond=False)    # warm-up: optimizer state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [trainer.train_step(*step_batch, drop_text_cond=False)[0]
                  for _ in range(SCAN_TRAIN_STEPS_TIMED)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SCAN_TRAIN_STEPS_TIMED
        counts = dict(_cuda.launch_counts)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        finite = bool(torch.isfinite(torch.stack(losses)).all())
        results[label] = (ms, peak_gib)
        log(f'scan_layers (c) train steps {label} depth {FLAGSHIP["depth"]} B={TRAIN_BATCH} '
            f'frames={FRAMES} dropout 0.1 bf16 with text, {SCAN_TRAIN_STEPS_TIMED} steps: '
            f'ms_per_step={ms:.3f} max_memory_allocated_gib={peak_gib:.3f} '
            f'loss_finite={finite} last_loss={float(losses[-1]):.5f} '
            f'launches={json.dumps(counts, sort_keys=True)} [{smi}]')
        expected = {k: SCAN_TRAIN_STEPS_TIMED * n
                    for k, n in expected_train_launches(model, True).items()}
        expected = {k: expected.get(k, 0) for k in _cuda.KERNELS}
        if counts != expected:
            raise AssertionError(f'scan_layers {label} train launch counts {counts} != '
                                 f'expected {expected}')
        if not finite:
            raise AssertionError(f'scan_layers {label} train loss is not finite')
        del model, trainer, step_batch
        torch.cuda.empty_cache()
    (ms_u, peak_u), (ms_s, peak_s) = results['unrolled'], results['scan']
    log(f'scan_layers (c) scan / unrolled: ms_ratio={ms_s / ms_u:.4f} '
        f'peak_memory_ratio={peak_s / peak_u:.4f} [{smi}]')


def sp_rank_main() -> int:
    """``chip_smoke.py --sp-rank 1``: rank 1 of `sp_two_ranks`, started by
    rank 0; prints no result."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp_rank(torch, torch.device('cuda', 0), int(sys.argv[2]))
    return 0


def tp_rank_main() -> int:
    """``chip_smoke.py --tp-rank 1``: rank 1 of `tp_two_ranks`, started by
    rank 0; prints no result."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tp_rank(torch, torch.device('cuda', 0), int(sys.argv[2]))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    try:
        from e2_tts_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f'chip_smoke: run from the root of the repository ({e})', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)

    smi = nvidia_smi_line()
    log(f'device: nvidia-smi "{smi}" torch "{torch.cuda.get_device_name(0)}" '
        f'count={torch.cuda.device_count()} torch={torch.__version__} cuda={torch.version.cuda}')

    one_tf32_build = start_mel_variant(_cuda, 'one_tf32', MEL_ONE_TF32)
    _cuda.build(force=True)
    log(f'build: nvcc sm_90a {len(list(_cuda.CSRC.glob("*.cu")))} sources '
        f'seconds={_cuda.build_seconds:.2f}')
    _cuda.lib()
    mel_one_tf32, _ = one_tf32_build()
    for source, marker in (('flash_attention.cu', '4sm90'), ('flash_attention_bwd.cu', '4sm90'),
                           ('flash_attention_bhnd.cu', '4sm90'), ('hyper_conn_bwd.cu', 'kernel'),
                           ('hyper_conn_bwd_save.cu', 'kernel'), ('hyper_conn.cu', 'sm90'),
                           ('hyper_conn_save.cu', 'sm90'), ('geglu.cu', 'geglu'),
                           ('mel.cu', 'mel'), ('flash_probe.cu', '4sm90')):
        for name, regs, spill_st, spill_ld in _cuda.ptxas_usage(source, marker):
            log(f'ptxas {source} {name}: {regs} registers, {spill_st} bytes spill stores, '
                f'{spill_ld} bytes spill loads')
    log_geglu_sass(_cuda)

    phase_start = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        log(f'phase {name} seconds={now - phase_start[0]:.1f}')
        phase_start[0] = now

    phase_done('build')
    records, train_records = phase_kernels(torch, dev, mel_one_tf32)
    for kid in train_records:
        r, t = records[kid], train_records[kid]
        log(f'kernel {kid} at the training shape vs the sampling shape: ms={t["ms"]:.5f} '
            f'(sampling {r["ms"]:.5f}) plain_ms={t["plain_ms"]:.5f} '
            f'eager_call_ms={t["eager_ms"]:.5f} bound_ms={t["bound_ms"]:.5f} ({t["bound_by"]})'
            + (f' sfu_floor_ms={t["sfu_floor_ms"]:.5f}' if 'sfu_floor_ms' in t else ''))
    time_hc_save_pairs(torch, dev, smi)
    time_sdpa_yardstick(torch, dev, smi)
    time_probe_floor(torch, dev, smi)
    phase_done('kernels')
    sample_counts, model = phase_main(torch, dev, smi)
    phase_profile(torch, model)
    del model
    torch.cuda.empty_cache()
    phase_done('main')
    serve_counts = phase_serve(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_done('serve')
    phase_train_check(torch, dev)
    train_counts = phase_train(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_done('train')
    phase_trainer(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_done('trainer')
    dit_sample_counts, dit_train_counts = phase_dit(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_done('dit')
    phase_tiny(torch, dev)
    phase_done('tiny')
    _, _, paper_save_counts = phase_paper(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_done('paper')
    phase_adaptive(torch, dev, smi)
    phase_done('adaptive')
    phase_options(torch, dev, smi)
    phase_done('options')
    phase_distributed(torch, dev, smi)
    phase_done('distributed')
    phase_tensor_parallel(torch, dev, smi)
    phase_done('tensor_parallel')
    phase_sequence_parallel(torch, dev, smi)
    phase_done('sequence_parallel')
    phase_scan_layers(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_done('scan_layers')

    kernels = []
    for kid, info in KERNEL_INFO.items():
        rec = records[kid]
        counts = (sample_counts if kid in SAMPLE_KERNELS else
                  serve_counts if kid in SERVE_KERNELS else
                  dit_sample_counts if kid in DIT_SAMPLE_KERNELS else
                  dit_train_counts if kid in DIT_TRAIN_KERNELS else
                  paper_save_counts if kid in PAPER_SAVE_KERNELS else train_counts)
        kernels.append(dict(
            name=info['name'], route=info['route'], source=info['source'],
            replaces=info['replaces'], launches=counts[info['name']],
            max_abs_err=rec['max_abs_err'], ms=rec['ms'], plain_ms=rec['plain_ms'],
            bound_ms=rec['bound_ms'], bound_by=rec['bound_by'],
            library_ms=rec['library_ms'],
            **({'kernel_only_ms': rec['kernel_only_ms']} if 'kernel_only_ms' in rec else {})))
    log(json.dumps({'kernels': kernels}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                           'kind': torch.cuda.get_device_name(0),
                                           'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(tp_rank_main() if sys.argv[1:2] == ['--tp-rank'] else
             sp_rank_main() if sys.argv[1:2] == ['--sp-rank'] else main())
