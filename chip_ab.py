#!/usr/bin/env python3
"""Hold this checkout's kernels against another checkout's on one card.

    python3 chip_ab.py OTHER_CHECKOUT [LABEL_PREFIX ...]   # this checkout's root; one card

Builds K11 (csrc/mel.cu), K5 / K3 (the hyper-connection forwards,
hyper_conn.cu with hyper_conn_save.cu), K5b / K4 (the adjoints), K8 / K9
and the probe (flash_attention_bhnd.cu, its wide-head source and, where
the checkout has it, flash_probe.cu), K1 / K2 / K10
(flash_attention.cu, flash_attention_bwd.cu) and K6 / K7 (geglu.cu) from
both checkouts' sources with nvcc into build/ (every nvcc at once), and
times each pair in turns
(other, this, this, other) as device time per call, 100 calls captured in a
CUDA graph (K9, K2: 20): K11 at the 3-s prompt (282 frames) and at the
training shape (16 x 1024 frames), each checkout split over frequency
tiles as its own wrapper splits it, after a `dft` line per shape
(`MelSpec(mode='dft')`, the plain torch frontend K11 has to beat, timed
once); the probe in its three modes at the flagship's (16, 8, 1056, 64)
and DiT's (16, 16, 1056, 72) training heads; K5 / K3 at the training shapes
(4 streams, 16896 rows, widths 256, 512, 576, 1024 and 1152, bf16), the
sampler's (1056 rows at 256, 512, 576 and 1152) and the duration
predictor's (314 rows at 256 and 512), K5b / K4 and their save variants
K5bs / K4s at the training shapes, each checkout at the launch geometry its
own wrapper computes and each save adjoint from the state (ta, inv) of its
own checkout's K5s / K3s, K8 at the DiT sampler's and training shapes (1 and 16, 16
heads, 1056, 72; bf16, softclamp 50; dropout 0.1 at 16) and K9 at the
training shape, its launch alone and with the wrapper's PyTorch work
(delta, the dq fill and cast); K1 gated at the flagship sampler's shape (1,
1056, 8 x 64) and at the paper's heads (16, 1056, 16 x 64) with dropout
0.1, and K2 with its wrapper's work (K10, the dq fill and cast, the gate
grad) at the flagship's and the paper's training shapes (16, 1056, 8 x 64
and 16 x 64), gated, dropout 0.1, softclamp 50; K1 / K2 as the frequency
attention runs them (8 x 64, no gate, softclamp or dropout): K1 at f = 2
over the training batch's 16,896 sequences and the sampler's 1,056 and
2,112, K2 there with its wrapper's work and alone, and both at n = 4, 8,
16, 32 and 64 tokens over 16,896 sequences (where the few-token design
and the tiled one cross); K6 and K7 (bf16, through
their C entry points) at the sampler's (1, 1056, 2 x 1408 / 2 x 704), the
flagship's training (16, 1056, 2 x 1408 / 2 x 704), the paper's speech
(16, 1056, 2 x 2752) and DiT's (16, 1056, 2 x 3072 / 2 x 1536) shapes,
dropout 0.1 at B = 16, and at (16, 1056, 2 x 1408) without dropout (the
cost of the hash). The other checkout's
adjoint may predate the warps argument (it then ran 8 warps a block); its K8 / K9 may take a `design` argument (it is passed as 1, the
Hopper design); its K10 may predate do_g (its K1 / K2 then ran the wmma
design, K2 gating do itself and K10 writing delta alone); its K1 / K2 / K8 /
K9 may predate the dropout hash's batch offset `hash_b0` (this one gets 0)
and its head offset `hash_h0` of `hash_heads` (this one gets 0 of the
launch's heads), and the row / column offset `hash_rc` (this one gets 0).
Prints one line
per kernel with the card's name and power limit.
"""
import ctypes
import importlib.util
import inspect
import os
import subprocess
import sys
import tempfile

import torch

NVCC = '/usr/local/cuda/bin/nvcc'
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']


def build(jobs):
    """``jobs``: (root, sources, library path). One nvcc -c per source of
    every job, all started together, then one link a job; the libraries
    loaded, in the jobs' order."""
    procs, links = [], []
    for root, srcs, out in jobs:
        csrc = os.path.join(root, 'e2_tts_tpu_torch', 'csrc')
        objs = [f'{out}.{i}.o' for i in range(len(srcs))]
        procs += [subprocess.Popen([NVCC, *ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-I',
                                    csrc, '-c', os.path.join(csrc, src), '-o', obj])
                  for src, obj in zip(srcs, objs)]
        links.append((objs, out))
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError('nvcc failed')
    for objs, out in links:
        subprocess.run([NVCC, *ARCH, '-shared', *objs, '-o', out], check=True)
    return [ctypes.CDLL(out) for _, out in links]


def graph_ms(fn, iters=100):
    fn(); torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(); a.record(); g.replay(); b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main():
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print('usage: python3 chip_ab.py OTHER_CHECKOUT [LABEL_PREFIX ...] (needs a CUDA card)',
              file=sys.stderr)
        return 1
    prefixes = tuple(sys.argv[2:])
    sys.path.insert(0, os.getcwd())
    from e2_tts_tpu_torch.ops.mel import MelSpec, frame_signal
    dev = torch.device('cuda', 0)
    P = ctypes.c_void_p
    os.makedirs('build', exist_ok=True)
    tmp = tempfile.mkdtemp(dir='build')
    libs = {}
    other = sys.argv[1]
    old_bwd = not os.path.exists(os.path.join(other, 'e2_tts_tpu_torch', 'csrc',
                                              'hyper_conn_bwd.cuh'))
    roots = (('other', other), ('this', '.'))
    csrc_text = lambda root, name: open(os.path.join(root, 'e2_tts_tpu_torch', 'csrc',
                                                     name)).read()
    # K8 / K9 entry points that take the design as an argument
    has_design = {tag: 'int design' in csrc_text(root, 'flash_attention_bhnd.cu')
                  for tag, root in roots}
    # K1 / K2 / K8 / K9 entry points that take hash_b0 (before the dtype)
    has_hash_b0 = {tag: 'int hash_b0' in csrc_text(root, 'flash_attention.cu')
                   for tag, root in roots}
    # ... and hash_h0, hash_heads after it
    has_hash_h0 = {tag: 'int hash_h0' in csrc_text(root, 'flash_attention.cu')
                   for tag, root in roots}
    # ... and the ring block's row / column offset hash_rc after those
    has_hash_rc = {tag: 'unsigned hash_rc' in csrc_text(root, 'flash_attention.cu')
                   for tag, root in roots}
    # K10 gating do into do_g for K2 (K1 / K2 on the Hopper design)
    packed_sm90 = {tag: 'void* dout_g' in csrc_text(root, 'flash_attention_bwd.cu')
                   for tag, root in roots}
    jobs = []
    for tag, root in roots:
        bwd = ['hyper_conn_bwd.cu'] if tag == 'other' and old_bwd else [
            'hyper_conn_bwd.cu', 'hyper_conn_bwd_save.cu', 'hyper_conn_bwd_streams.cu',
            'hyper_conn_bwd_f32.cu']
        jobs += [(root, ['mel.cu'], f'{tmp}/mel_{tag}.so'), (root, bwd, f'{tmp}/bwd_{tag}.so'),
                 (root, ['flash_attention_bhnd.cu', 'flash_attention_bhnd_wide.cu']
                  + (['flash_probe.cu'] if os.path.exists(os.path.join(
                      root, 'e2_tts_tpu_torch', 'csrc', 'flash_probe.cu')) else []),
                  f'{tmp}/flash_{tag}.so'),
                 (root, ['flash_attention.cu', 'flash_attention_bwd.cu'],
                  f'{tmp}/packed_{tag}.so'),
                 (root, ['hyper_conn.cu', 'hyper_conn_save.cu'], f'{tmp}/fwd_{tag}.so'),
                 (root, ['geglu.cu'], f'{tmp}/geglu_{tag}.so')]
    built = build(jobs)
    per_root = len(jobs) // len(roots)
    for i, (tag, _) in enumerate(roots):
        libs[tag] = tuple(built[per_root * i:per_root * (i + 1)])
    g = torch.Generator(device=dev).manual_seed(0)
    # K11 at the prompt (282 frames) and at the training shape (16 x 1024
    # frames), each checkout split over frequency tiles as its own wrapper
    # splits (its mel_kernel.frequency_splits)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spec = MelSpec(mode='pallas').to(dev)
    dft_spec = MelSpec().to(dev)
    n_freqs, n_mels = spec.fbanks.shape
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    mel_waves = {'prompt': torch.randn(1, 72000, generator=g, device=dev) * 0.1,
                 'train': torch.randn(16, 1023 * 256, generator=g, device=dev) * 0.1}

    def mel_splits(tag, rows):
        root = dict(roots)[tag]
        mspec = importlib.util.spec_from_file_location(
            f'mk_{tag}', os.path.join(root, 'e2_tts_tpu_torch', 'ops', 'mel_kernel.py'))
        mod = importlib.util.module_from_spec(mspec)
        mspec.loader.exec_module(mod)
        return mod.frequency_splits(rows, n_freqs, sms)

    def mel(tag, shape):
        fn = libs[tag][0].e2_mel_fwd
        fn.argtypes = [P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, P, P, ctypes.c_int, P, ctypes.c_int, P, P, ctypes.c_int,
                       ctypes.c_float, P]
        frames = frame_signal(mel_waves[shape], 1024, 256, center=True)
        b, t, n_fft = frames.shape
        nsplit = mel_splits(tag, b * t)
        out = torch.empty(b, t, n_mels, device=dev)
        part = torch.empty(nsplit, b * t, n_mels, device=dev)

        def call():
            err = fn(frames.data_ptr(), frames.stride(0), frames.stride(1), t, b * t, n_fft,
                     spec.dft_cos.data_ptr(), spec.dft_sin.data_ptr(), n_freqs,
                     spec.fbanks.data_ptr(), n_mels, out.data_ptr(), part.data_ptr(), nsplit,
                     1.0, stream())
            if err:
                raise RuntimeError(f'e2_mel_fwd failed to launch: cudaError {err}')
        call.tensors = (frames, out, part)
        return call

    # K5b / K4 at (4, 16896, d) bf16, each checkout at its own wrapper's
    # launch geometry (warps, blocks)
    s, m = 4, 16896
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=g, device=dev) * scale)
    bf = torch.bfloat16
    hc_inputs = {}

    def geometry(tag, d, save):
        root = dict(roots)[tag]
        spec = importlib.util.spec_from_file_location(
            f'hck_{tag}', os.path.join(root, 'e2_tts_tpu_torch', 'ops', 'hyper_conn_kernel.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if hasattr(mod, '_bwd_geometry'):
            # a checkout whose geometry still depends on saving takes the flag
            takes_save = len(inspect.signature(mod._bwd_geometry).parameters) == 5
            return mod._bwd_geometry(s, m, d, bf, *([save] if takes_save else []))
        warps = mod._bwd_warps(s, d) if hasattr(mod, '_bwd_warps') else 8
        return warps, max(1, min(-(-m // warps), mod._BWD_MAX_BLOCKS))

    def bwd(lib, tag, fused, d, save=False):
        if d not in hc_inputs:
            hc_inputs[d] = dict(
                ins=[rnd(s, m, d).to(bf), rnd(m, d).to(bf), rnd(s, m, scale=0.5).to(bf)],
                grads=[rnd(m, d).to(bf), rnd(s, m, d).to(bf), rnd(s, m).to(bf)],
                params=[torch.eye(s, s + 1, device=dev), torch.ones(s, device=dev),
                        rnd(d, s + 1, scale=0.05), rnd(d, scale=0.05),
                        torch.tensor(0.5, device=dev), torch.tensor(0.5, device=dev)])
        t = hc_inputs[d]
        warps, blocks = geometry(tag, d, save)
        np_ = (s + 2) * d + s * (s + 2) + 2
        partials = torch.empty(blocks, np_, device=dev)
        row = torch.empty(np_, device=dev)
        ins = t['ins'] if fused else t['ins'][:1]
        outs = [torch.empty_like(x) for x in ins]
        name = 'e2_hc_width_fused_bwd' if fused else 'e2_hc_width_bwd'
        state = ()
        if save:        # (ta, inv) from this checkout's K3s / K5s on the same inputs
            name += '_save'
            state = (torch.empty(s, m, s + 2, device=dev), torch.empty(s, m, device=dev))
            fwd_save(libs[tag][4], fused, ins, t['params'], state)
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        warps_arg = [] if tag == 'other' and old_bwd else [ctypes.c_int(warps)]
        args = [P(x.data_ptr()) for x in (*ins, *t['grads'], *t['params'], *state, *outs,
                                          partials, row)]

        def call():
            err = fn(*args, ctypes.c_int(blocks), *warps_arg, ctypes.c_int(s),
                     ctypes.c_longlong(m), ctypes.c_int(d), ctypes.c_int(1), P(stream()))
            if err:
                raise RuntimeError(f'{name} failed to launch: cudaError {err}')
        call.tensors = (partials, row, outs, state)
        return call

    def fwd_save(lib, fused, ins, params, state):
        """K3s / K5s once on ``ins``: writes the state (ta, inv) a save
        adjoint reads."""
        m_, d = ins[0].shape[-2:]
        outs = [torch.empty(m_, d, dtype=bf, device=dev),
                torch.empty(s, m_, d, dtype=bf, device=dev), torch.empty(s, m_, dtype=bf, device=dev)]
        name = 'e2_hc_width_fused' if fused else 'e2_hc_width'
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        err = fn(*(P(x.data_ptr()) for x in (*ins, *params, *outs, *state)), ctypes.c_int(s),
                 ctypes.c_longlong(m_), ctypes.c_int(d), ctypes.c_int(1), P(stream()))
        if err:
            raise RuntimeError(f'{name} (saving) failed to launch: cudaError {err}')
        torch.cuda.synchronize()

    # K5 / K3 at (4, m, d) bf16: the streams (K3: carried, branch and the
    # previous beta), the parameters and the outputs, one set per shape
    fwd_inputs = {}

    def fwd(lib, fused, m, d):
        if (m, d) not in fwd_inputs:
            fwd_inputs[m, d] = dict(
                ins=[rnd(s, m, d).to(bf), rnd(m, d).to(bf), rnd(s, m, scale=0.5).to(bf)],
                params=[torch.eye(s, s + 1, device=dev), torch.ones(s, device=dev),
                        rnd(d, s + 1, scale=0.05), rnd(d, scale=0.05),
                        torch.tensor(0.5, device=dev), torch.tensor(0.5, device=dev)])
        t = fwd_inputs[m, d]
        outs = [torch.empty(m, d, dtype=bf, device=dev), torch.empty(s, m, d, dtype=bf, device=dev),
                torch.empty(s, m, dtype=bf, device=dev)]
        name = 'e2_hc_width_fused' if fused else 'e2_hc_width'
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        ins = t['ins'] if fused else t['ins'][:1]
        args = [P(x.data_ptr()) for x in (*ins, *t['params'], *outs)] + [P(None), P(None)]

        def call():
            err = fn(*args, ctypes.c_int(s), ctypes.c_longlong(m), ctypes.c_int(d),
                     ctypes.c_int(1), P(stream()))
            if err:
                raise RuntimeError(f'{name} failed to launch: cudaError {err}')
        call.tensors = outs
        return call

    # K8 / K9 on (b, h, n, dh) views of one packed projection, as the model has them
    from e2_tts_tpu_torch.ops import flash_attention as fa
    from e2_tts_tpu_torch.ops.dropout import keep_threshold
    LL, I, F, U = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    st = lambda t: (LL * 3)(*t.stride()[:3])

    def flash_inputs(b, h=16, n=1056, dh=72):
        qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=dev).to(bf)
        to = lambda t: t.unflatten(-1, (h, dh)).transpose(1, 2)
        q, k, v = (to(qkv[..., i * h * dh:(i + 1) * h * dh]) for i in range(3))
        return q, k, v

    def hash_h0_args(tag, heads):
        return ([I(0), I(heads)] if has_hash_h0[tag] else []) + [U(0)] * has_hash_rc[tag]

    def flash_common(tag, q, rate):
        b, h, n, dh = q.shape
        return [I(b), I(n), I(h), I(dh), F(dh ** -0.5), F(50.0),
                F(1.0 / (1.0 - rate) if rate else 1.0), U(1234), U(keep_threshold(rate)),
                I(int(rate > 0))] + [I(0)] * has_hash_b0[tag] + hash_h0_args(tag, h) + [I(1)]

    def k8(tag, q, k, v, rate):
        fn = libs[tag][2].e2_flash_fwd_bhnd
        fn.restype = ctypes.c_int
        b, h, n, dh = q.shape
        o = torch.empty((b, n, h, dh), dtype=bf, device=dev).transpose(1, 2)
        lse = torch.empty((b * h, n), device=dev)
        design = [I(1)] if has_design[tag] else []
        args = [P(t.data_ptr()) for t in (q, k, v)] + [st(q), st(k), st(v), P(None),
                P(o.data_ptr()), st(o), P(lse.data_ptr())] + flash_common(tag, q, rate) + design

        def call():
            err = fn(*args, P(stream()))
            if err:
                raise RuntimeError(f'e2_flash_fwd_bhnd failed to launch: cudaError {err}')
        call.tensors = (q, k, v, o, lse)       # alive as long as the launches use them
        return call

    def k9(tag, q, k, v, rate, wrapper):
        fn = libs[tag][2].e2_flash_bwd_bhnd
        fn.restype = ctypes.c_int
        b, h, n, dh = q.shape
        out, lse = fa.flash_attention_plain(q, k, v, scale=dh ** -0.5, softclamp_value=50.0,
                                            dropout_rate=rate, dropout_seed=1234)
        dout = torch.randn(b, h, n, dh, generator=g, device=dev).to(bf)
        delta = (dout.float() * out.float()).sum(-1)
        dq = torch.zeros((b, n, h, dh), device=dev).transpose(1, 2)
        dk, dv = torch.empty_like(dq, dtype=bf), torch.empty_like(dq, dtype=bf)
        design = [I(1)] if has_design[tag] else []
        args = ([P(t.data_ptr()) for t in (q, k, v, dout)] + [st(q), st(k), st(v), st(dout),
                P(None), P(lse.data_ptr()), P(delta.data_ptr()), st(delta), P(dq.data_ptr()),
                st(dq), P(dk.data_ptr()), st(dk), P(dv.data_ptr()), st(dv)]
                + flash_common(tag, q, rate) + design)

        def call():
            if wrapper:
                delta.copy_((dout.float() * out.float()).sum(-1))
                dq.zero_()
            err = fn(*args, P(stream()))
            if err:
                raise RuntimeError(f'e2_flash_bwd_bhnd failed to launch: cudaError {err}')
            if wrapper:
                dq.to(bf)
        call.tensors = (q, k, v, out, lse, dout, delta, dq, dk, dv)
        return call

    # K1 / K2 on q, k, v as views of one packed (b, n, 3 h dh) projection, gated
    def packed_inputs(b, h, n=1056, dh=64, gated=True):
        qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=dev).to(bf)
        gate = (2 * torch.randn(b, n, h, generator=g, device=dev)).to(bf) if gated else None
        return (*qkv.split(h * dh, dim=-1), gate, h)

    # the frequency attention: b sequences of a few tokens, 8 heads of 64, no
    # gate, softclamp or dropout (softclamp 0 in the C call)
    freq_inputs = {}

    def freq(b, n):
        if (b, n) not in freq_inputs:
            freq_inputs[(b, n)] = packed_inputs(b, 8, n, gated=False)
        return freq_inputs[(b, n)]

    def packed_common(tag, q, h, rate, softclamp=50.0):
        b, n, D = q.shape
        dh = D // h
        return [I(b), I(n), I(h), I(dh), F(dh ** -0.5), F(softclamp),
                F(1.0 / (1.0 - rate) if rate else 1.0), U(1234), U(keep_threshold(rate)),
                I(int(rate > 0))] + [I(0)] * has_hash_b0[tag] + hash_h0_args(tag, h) + [I(1)]

    def qkv_strides(q, k, v):
        return [LL(t.stride(i)) for t in (q, k, v) for i in (0, 1)]

    def k1(tag, q, k, v, gate, h, rate, softclamp=50.0):
        fn = libs[tag][3].e2_flash_fwd
        fn.restype = ctypes.c_int
        b, n, D = q.shape
        o = torch.empty((b, n, D), dtype=bf, device=dev)
        lse = torch.empty((b * h, n), device=dev)
        args = ([P(t.data_ptr()) for t in (q, k, v)] + qkv_strides(q, k, v)
                + [P(None), P(None if gate is None else gate.data_ptr()), P(o.data_ptr()),
                   P(lse.data_ptr())]
                + packed_common(tag, q, h, rate, softclamp))

        def call():
            err = fn(*args, P(stream()))
            if err:
                raise RuntimeError(f'e2_flash_fwd failed to launch: cudaError {err}')
        call.tensors = (q, k, v, gate, o, lse)
        return call

    def k2(tag, q, k, v, gate, h, rate, softclamp=50.0, wrapper=True):
        """K2 with its wrapper's work: K10 (and, gated on the Hopper design,
        its do_g), the dq fill, K2, the dq cast and the gate grad; without
        ``wrapper`` K2's launch alone (adding to dq)."""
        lib = libs[tag][3]
        delta_fn, fn = lib.e2_flash_delta, lib.e2_flash_bwd
        delta_fn.restype = fn.restype = ctypes.c_int
        b, n, D = q.shape
        dh = D // h
        out, lse = fa.flash_attention_packed_plain(q, k, v, heads=h, scale=dh ** -0.5,
                                                   softclamp_value=softclamp or None,
                                                   dropout_rate=rate, dropout_seed=1234,
                                                   gate_logits=gate)
        dout = torch.randn(b, n, D, generator=g, device=dev).to(bf)
        delta = torch.empty((b, n, h), device=dev)
        do_g = torch.empty_like(dout)
        dq = torch.zeros((b, n, D), device=dev)
        dk, dv = torch.empty_like(dout), torch.empty_like(dout)
        if gate is None:            # K10 writes delta; K2 reads do
            delta_args = [P(out.data_ptr()), P(dout.data_ptr()), P(None), P(None),
                          P(delta.data_ptr())]
            bwd_args = [P(dout.data_ptr()), P(None)]
        elif packed_sm90[tag]:      # K10 gates do; K2 reads do_g and no gate
            delta_args = [P(out.data_ptr()), P(dout.data_ptr()), P(gate.data_ptr()),
                          P(do_g.data_ptr()), P(delta.data_ptr())]
            bwd_args = [P(do_g.data_ptr()), P(None)]
        else:                       # K10 writes delta; K2 gates do itself
            delta_args = [P(out.data_ptr()), P(dout.data_ptr()), P(delta.data_ptr())]
            bwd_args = [P(dout.data_ptr()), P(None), P(gate.data_ptr())]
        delta_args += [LL(b * n), I(h), I(dh), I(1)]
        args = ([P(t.data_ptr()) for t in (q, k, v)] + qkv_strides(q, k, v) + bwd_args
                + [P(lse.data_ptr()), P(delta.data_ptr()), P(dq.data_ptr()), P(dk.data_ptr()),
                   P(dv.data_ptr())] + packed_common(tag, q, h, rate, softclamp))

        def launch():
            err = fn(*args, P(stream()))
            if err:
                raise RuntimeError(f'e2_flash_bwd failed to launch: cudaError {err}')

        if not wrapper:
            delta_fn(*delta_args, P(stream()))
            launch.tensors = (q, k, v, out, lse, dout, delta, do_g, dq, dk, dv)
            return launch

        def call():
            err = delta_fn(*delta_args, P(stream()))
            if err:
                raise RuntimeError(f'e2_flash_delta failed to launch: cudaError {err}')
            dq.zero_()
            err = fn(*args, P(stream()))
            if err:
                raise RuntimeError(f'e2_flash_bwd failed to launch: cudaError {err}')
            dq.to(bf)
            if gate is not None:
                (delta * (1.0 - torch.sigmoid(gate.float()))).to(bf)
        call.tensors = (q, k, v, gate, out, lse, dout, delta, do_g, dq, dk, dv)
        return call

    # K6 / K7 on (b, 1056, 2 inner) bf16, one set of inputs a shape
    geglu_inputs = {}

    def geglu(tag, kind, b, inner, rate):
        if (b, inner) not in geglu_inputs:
            geglu_inputs[b, inner] = (
                torch.randn(b, 1056, 2 * inner, generator=g, device=dev).to(bf),
                torch.randn(b, 1056, inner, generator=g, device=dev).to(bf))
        h2, gout = geglu_inputs[b, inner]
        common = [I(b), I(1056), I(inner), F(1.0 / (1.0 - rate) if rate else 1.0), U(1234),
                  U(keep_threshold(rate)), I(int(rate > 0)), I(1)]
        lib = libs[tag][5]
        if kind == 'K6':
            fn, out = lib.e2_geglu_fwd, torch.empty_like(gout)
            args = [P(h2.data_ptr()), P(out.data_ptr())] + common
        else:
            fn, out = lib.e2_geglu_bwd, torch.empty_like(h2)
            args = [P(h2.data_ptr()), P(gout.data_ptr()), P(out.data_ptr())] + common
        fn.restype = ctypes.c_int

        def call():
            err = fn(*args, P(stream()))
            if err:
                raise RuntimeError(f'{kind} failed to launch: cudaError {err}')
        call.tensors = (h2, gout, out)
        return call

    sampler, train = flash_inputs(1), flash_inputs(16)
    flagship_sampler, flagship_train = packed_inputs(1, 8), packed_inputs(16, 8)
    paper_train = packed_inputs(16, 16)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()

    def probe(tag, x, mode):
        fn = libs[tag][2].e2_flash_probe
        fn.restype = ctypes.c_int
        b, h, n, dh = x.shape
        o = torch.empty_like(x)
        args = [P(x.data_ptr()), st(x), P(o.data_ptr()), st(o), I(b), I(n), I(h), I(dh),
                I(mode)]

        def call():
            err = fn(*args, P(stream()))
            if err:
                raise RuntimeError(f'e2_flash_probe failed to launch: cudaError {err}')
        call.tensors = (x, o)
        return call

    probe_x = {(h, dh): (torch.randn(16, h, 1056, dh, generator=g, device=dev) * 0.25).to(bf)
               for h, dh in ((8, 64), (16, 72))}
    for shape, rows in (('prompt', 282), ('train', 16384)):
        wave = mel_waves[shape]
        print(f'dft {shape} ({rows} frames): MelSpec(mode=\'dft\')_ms='
              f'{graph_ms(lambda: dft_spec(wave), 50):.5f} [{smi}]', flush=True)
    for label, make in (('K11 prompt (1,72000) = 282 frames',
                         lambda tag: mel(tag, 'prompt')),
                        ('K11 train (16,261888) = 16x1024 frames',
                         lambda tag: mel(tag, 'train')),
                        *((f'probe mode {mode} (16,{h},1056,{dh}) bf16',
                           lambda tag, mode=mode, h=h, dh=dh: probe(tag, probe_x[(h, dh)], mode))
                          for h, dh in ((8, 64), (16, 72)) for mode in (0, 1, 2)),
                        *((f'{k} (4,{rows},{d}) bf16',
                           lambda tag, rows=rows, d=d, fused=k == 'K3': fwd(libs[tag][4], fused,
                                                                          rows, d))
                          for rows, d in ((16896, 256), (16896, 512), (16896, 576),
                                          (16896, 1024), (16896, 1152), (1056, 512),
                                          (1056, 256), (1056, 576), (1056, 1152), (314, 512),
                                          (314, 256))
                          for k in ('K5', 'K3')),
                        *((f'{k} (4,16896,{d}) bf16',
                           lambda tag, d=d, fused=k.startswith('K4'), save=k.endswith('s'):
                           bwd(libs[tag][1], tag, fused, d, save))
                          for d in (256, 512, 576, 1024, 1152) for k in ('K5b', 'K4', 'K5bs', 'K4s')),
                        ('K8 (1,16,1056,72) bf16 softclamp 50',
                         lambda tag: k8(tag, *sampler, 0.0)),
                        ('K8 (16,16,1056,72) bf16 softclamp 50 dropout 0.1',
                         lambda tag: k8(tag, *train, 0.1)),
                        ('K9 launch (16,16,1056,72) bf16 softclamp 50 dropout 0.1',
                         lambda tag: k9(tag, *train, 0.1, False)),
                        ('K9 with the wrapper\'s delta, dq fill and cast (16,16,1056,72)',
                         lambda tag: k9(tag, *train, 0.1, True)),
                        ('K1 (1,1056,8x64) bf16 gated softclamp 50',
                         lambda tag: k1(tag, *flagship_sampler, 0.0)),
                        ('K1 (16,1056,16x64) bf16 gated softclamp 50 dropout 0.1',
                         lambda tag: k1(tag, *paper_train, 0.1)),
                        ('K2 with its wrapper\'s K10, dq fill and cast, gate grad (16,1056,8x64) '
                         'bf16 gated softclamp 50 dropout 0.1',
                         lambda tag: k2(tag, *flagship_train, 0.1)),
                        ('K2 with its wrapper\'s K10, dq fill and cast, gate grad (16,1056,16x64) '
                         'bf16 gated softclamp 50 dropout 0.1',
                         lambda tag: k2(tag, *paper_train, 0.1)),
                        # the frequency attention at f = 2: the training batch (16 x 1056
                        # sequences), the sampler's (1 x 1056, 2 x 1056 with batched CFG)
                        *((f'K1 freq ({fb},2,8x64) bf16',
                           lambda tag, fb=fb: k1(tag, *freq(fb, 2), 0.0, 0.0))
                          for fb in (16896, 1056, 2112)),
                        ('K2 with its wrapper\'s K10, dq fill and cast freq (16896,2,8x64) bf16',
                         lambda tag: k2(tag, *freq(16896, 2), 0.0, 0.0)),
                        ('K2 launch freq (16896,2,8x64) bf16',
                         lambda tag: k2(tag, *freq(16896, 2), 0.0, 0.0, wrapper=False)),
                        # the crossover between the two designs: n tokens at the
                        # frequency attention's training batch
                        *((f'{kind} crossover (16896,{n},8x64) bf16',
                           lambda tag, kind=kind, n=n: (k1 if kind == 'K1' else k2)(
                               tag, *freq(16896, n), 0.0, 0.0))
                          for n in (4, 8, 16, 32, 64) for kind in ('K1', 'K2 with its wrapper')),
                        *((f'{k} ({b},1056,2x{inner}) bf16' + (' dropout 0.1' if rate else ''),
                           lambda tag, k=k, b=b, inner=inner, rate=rate: geglu(tag, k, b, inner,
                                                                               rate))
                          for b, inner, rate in ((1, 1408, 0.0), (1, 704, 0.0), (16, 1408, 0.1),
                                                 (16, 704, 0.1), (16, 2752, 0.1),
                                                 (16, 3072, 0.1), (16, 1536, 0.1),
                                                 (16, 1408, 0.0))
                          for k in ('K6', 'K7'))):
        if prefixes and not label.startswith(prefixes):
            continue
        times = {tag: [] for tag in ('other', 'this')}
        for tag in ('other', 'this', 'this', 'other'):
            times[tag].append(graph_ms(make(tag), 20 if label[:2] in ('K9', 'K2') else 100))
        print(f'ab {label}: other_ms={[round(x, 5) for x in times["other"]]} '
              f'this_ms={[round(x, 5) for x in times["this"]]} [{smi}]', flush=True)
    # the softclamp's floor on the special-function units, beside K8 / K9's
    # tensor-core bound: a tanh and an exp2 a score (K9 recomputes both), 16
    # results a clock per SM at the card's highest SM clock
    mhz = float(subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                                '--format=csv,noheader,nounits'], capture_output=True,
                               text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, b, h in (('K8 / K9', 1, 16), ('K8 / K9', 16, 16), ('K1', 1, 8),
                        ('K1 / K2', 16, 8), ('K1 / K2', 16, 16)):
        scores = b * h * 1056 * 1056
        print(f'sfu floor ({label}) ({b},{h},1056): '
              f'{2 * scores / (16 * sms * mhz * 1e6) * 1e3:.5f} '
              f'ms ({scores} scores, {sms} SMs at {mhz:g} MHz) [{smi}]', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
