#!/usr/bin/env python3
"""The options cell's train step on one checkout's package, timed and
profiled, to hold two checkouts against each other on one card.

    python3 chip_options_step.py [CHECKOUT]     # default: this checkout; one CUDA card

Imports ``e2_tts_tpu_torch`` from CHECKOUT (another checkout unpacked under
a gitignored directory, its kernels built into its own build/kernels), and
the model, batch and trainer settings from this checkout's chip_smoke.py:
the flagship widths at depth 8 with every option on (num_freq_tokens=2,
concat_cond, interpolated_text, the FANformer input map), bf16, dropout
0.1, B = 16 x 1024 frames with text, remat off and on. For each remat mode
it prints the wall ms a step over five timed steps, then one profiled step:
its wall ms, the device-busy ms (every device activity but user ranges,
as chip_smoke.py sums them) and the device ms of the attention kernels (K1
/ K2 / K10, the frequency attention's and the layers'), with the card's
name and power limit. Run it for both checkouts in one call, in turns
(other, this, this, other).
"""
import importlib.util
import os
import sys
import time

STEPS_TIMED = 5
# the attention kernels' names: the tiled designs' and the few-token ones
ATTENTION_MARKERS = ('flash_fwd_kernel', 'flash_bwd_kernel', 'flash_delta_kernel',
                     'short_seq::')


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else '.')
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print('chip_options_step.py needs a CUDA card', file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location('chip_smoke_settings',
                                                  os.path.join(here, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np

    import e2_tts_tpu_torch
    from e2_tts_tpu_torch import E2Trainer
    from e2_tts_tpu_torch.training.data import ArrayDataset, iter_batches
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not os.path.abspath(e2_tts_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f'e2_tts_tpu_torch came from {e2_tts_tpu_torch.__file__}, not {root}')
    dev = torch.device('cuda', 0)
    smi = cs.nvidia_smi_line()
    rng = np.random.default_rng(0)
    words = cs.TEXT.split()
    dataset = ArrayDataset(
        [rng.standard_normal((100, cs.FRAMES)).astype(np.float32)
         for _ in range(cs.TRAIN_BATCH)],
        [' '.join(rng.choice(words, size=12)) for _ in range(cs.TRAIN_BATCH)])
    for remat in (False, True):
        model = cs.build_e2tts(torch, dev, torch.bfloat16, cs.OPTIONS_E2TTS, dropout=0.1,
                               **dict(cs.OPTIONS_TF, remat=remat))
        trainer = E2Trainer(model, learning_rate=7.5e-5, num_warmup_steps=0,
                            total_steps=10_000, seed=0)
        batch = trainer.prepare_batch(next(iter_batches(dataset, cs.TRAIN_BATCH, seed=1)))
        step = lambda: trainer.train_step(*batch, drop_text_cond=False)
        step()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS_TIMED):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / STEPS_TIMED
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in cs.profile_averages(prof) if e.device_type == DeviceType.CUDA
                  and not getattr(e, 'is_user_annotation', False)]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        attention = [e for e in events if any(m in e.key for m in ATTENTION_MARKERS)]
        attn_ms = sum(e.self_device_time_total for e in attention) / 1e3
        print(f'options step {root} remat={remat}: ms_per_step={ms:.3f} profiled_wall_ms='
              f'{wall:.3f} device_busy_ms={busy:.3f} attention_kernels_device_ms={attn_ms:.3f} '
              f'({sum(e.count for e in attention)} launches) [{smi}]', flush=True)
        del model, trainer, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
