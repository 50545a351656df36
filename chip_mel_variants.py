#!/usr/bin/env python3
"""Measure K11's design choices on one card, one change at a time.

    python3 chip_mel_variants.py       # from the repository's root; one CUDA card

Each variant is this checkout's csrc/mel.cu with one named change
(`VARIANTS`), built with nvcc into build/mel_variants/ (every nvcc at once):

  design        the kernel as it is
  one_tf32      one TF32 product a product (hi hi): the precision fault the
                split avoids
  cvt_rna       the split's rounding by cvt.rna.tf32.f32, not on the bits
  fb_last       the filterbank rows in the last stage's cp.async group (so
                no stage waits for them), not the first stage's
  no_kgroups    Small as one k-group: 32 rows x 64 bins, 4 warps, one ring
  three_stages  the rings three stages deep, not two
  bins32_8w     32-bin tiles (Small: 4 k-groups of 2 warps, 8 warps; the
                prompt's 9 row blocks x 17 tiles = 153 blocks)
  bins32_16w    32-bin tiles, Small as 8 k-groups of 2 warps (16 warps)
  small_only    the Small geometry at every row count
  large_only    the Large geometry at every row count

Prints, for each variant, ptxas's registers and spills; the worst error
ratio to K11's limit (2e-3 + 1e-3 |ref|) against the plain version on the
tone prompt (chip_smoke.tone_prompt: a 220-Hz tone, noise, the last 30%
digital silence; 282 frames) and on 16 x 1024 frames of noise; and device
ms a call (50 calls in a CUDA graph) at both shapes, each variant split
over frequency tiles as `frequency_splits` splits for the variant's own
geometry (read off its source), the design also unsplit at the prompt.
Variants are timed in turns, twice. Then small_only against large_only at
row counts from 282 to 16384 frames (one wave of noise each), which places
the row count from which the entry point takes the Large geometry
(LARGE_ROWS). Every line carries the card's name and power limit.
"""
import os
import re
import sys

import torch

import chip_smoke as cs

VARIANTS = {
    'design': (),
    'one_tf32': cs.MEL_ONE_TF32,
    'cvt_rna': (('  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n',
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
                 '  return r;\n'),),
    'fb_last': (('    if (s == 0) load_fbanks(f0);', '    if (s == max(n_stages - 1, 0)) load_fbanks(f0);'),),
    'no_kgroups': (('using Small = Geometry<1, 4, 16>;', 'using Small = Geometry<1, 1, 16>;'),),
    'three_stages': (('MT = 2, NT = 2, WN = 4, NSTAGE = 2;', 'MT = 2, NT = 2, WN = 4, NSTAGE = 3;'),),
    'bins32_8w': (('MT = 2, NT = 2, WN = 4, NSTAGE = 2;', 'MT = 2, NT = 2, WN = 2, NSTAGE = 2;'),),
    'bins32_16w': (('MT = 2, NT = 2, WN = 4, NSTAGE = 2;', 'MT = 2, NT = 2, WN = 2, NSTAGE = 2;'),
                   ('using Small = Geometry<1, 4, 16>;', 'using Small = Geometry<1, 8, 16>;')),
    'small_only': (('constexpr int LARGE_ROWS = 1152;', 'constexpr int LARGE_ROWS = 2147483647;'),),
    'large_only': (('constexpr int LARGE_ROWS = 1152;', 'constexpr int LARGE_ROWS = 0;'),),
}
SWEEP_ROWS = (282, 564, 1024, 1152, 1280, 1408, 1536, 1792, 2048, 3072, 4096, 8192, 16384)


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise AssertionError(f'{old!r} occurs {src.count(old)} times in csrc/mel.cu')
        src = src.replace(old, new)
    return src


def geometries(src: str):
    """``({'small': (rows, bins), 'large': (rows, bins)}, LARGE_ROWS)`` of a
    mel.cu source: the wrapper's GEOMETRIES and LARGE_ROWS for it."""
    mt, nt, wn = map(int, re.search(r'static constexpr int MT = (\d+), NT = (\d+), WN = (\d+),',
                                    src).groups())
    geo = {}
    for name in ('Small', 'Large'):
        wm = int(re.search(rf'using {name} = Geometry<(\d+),', src).group(1))
        geo[name.lower()] = (16 * mt * wm, 8 * nt * wn)
    return geo, int(re.search(r'constexpr int LARGE_ROWS = (\d+);', src).group(1))


def main():
    if not torch.cuda.is_available():
        print('chip_mel_variants: needs a CUDA card', file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from e2_tts_tpu_torch.ops import _cuda
    from e2_tts_tpu_torch.ops import mel_kernel as mk
    from e2_tts_tpu_torch.ops.mel import MelSpec, frame_signal
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    smi = cs.nvidia_smi_line()
    src = (_cuda.CSRC / 'mel.cu').read_text()
    builds = {name: cs.start_mel_variant(_cuda, name, subs) for name, subs in VARIANTS.items()}
    libs, geos = {}, {}
    for name, finish in builds.items():
        try:
            libs[name], out = finish()
        except RuntimeError as e:
            print(f'variant {name}: build failed ({e})', flush=True)
            continue
        geos[name] = geometries(variant_source(src, VARIANTS[name]))
        usage = []
        for line in out.splitlines():
            if 'Compiling entry function' in line:
                args = re.search(r'GeometryI((?:Li\d+E)+)E', line)
                kern = ('Geometry<' + ', '.join(re.findall(r'Li(\d+)E', args.group(1))) + '>'
                        if args else 'mel_log_kernel')
            elif 'spill stores' in line:
                spill = line.split(',')[0].split()[0]
            elif 'Used' in line and 'registers' in line:
                usage.append(f'{kern} {line.split("Used")[1].split(",")[0].strip()}, '
                             f'{spill} B spill stores')
        print(f'variant {name}: geometries {geos[name][0]} LARGE_ROWS {geos[name][1]}; '
              f'ptxas {"; ".join(usage)}', flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    spec = MelSpec(mode='pallas').to(dev)
    tables = (spec.dft_cos, spec.dft_sin, spec.fbanks)
    n_freqs, n_mels = spec.fbanks.shape

    def splits(name, rows):
        saved = mk.GEOMETRIES, mk.LARGE_ROWS
        mk.GEOMETRIES, mk.LARGE_ROWS = geos[name]
        try:
            return mk.frequency_splits(rows, n_freqs, sms)
        finally:
            mk.GEOMETRIES, mk.LARGE_ROWS = saved

    def caller(name, frames, nsplit):
        b, t, n_fft = frames.shape
        out = torch.empty((b, t, n_mels), device=dev)
        part = torch.empty((nsplit, b * t, n_mels), device=dev) if nsplit > 1 else None
        fn = libs[name].e2_mel_fwd

        def call():
            err = fn(frames.data_ptr(), frames.stride(0), frames.stride(1), t, b * t, n_fft,
                     tables[0].data_ptr(), tables[1].data_ptr(), n_freqs, tables[2].data_ptr(),
                     n_mels, out.data_ptr(), part.data_ptr() if part is not None else None,
                     nsplit, 1.0, _cuda.stream_ptr(dev))
            if err:
                raise RuntimeError(f'variant {name}: e2_mel_fwd returned {err}')
            return out
        return call

    g = torch.Generator(device=dev).manual_seed(0)
    shapes = {'tone prompt (1,72000) = 282 frames': torch.from_numpy(cs.tone_prompt()).to(dev),
              'train (16,261888) = 16x1024 frames':
                  torch.randn(16, 1023 * 256, generator=g, device=dev) * 0.1}
    for label, wave in shapes.items():
        frames = frame_signal(wave, 1024, 256, center=True)
        rows = frames.shape[0] * frames.shape[1]
        ref = mk.fused_log_mel_plain(frames, *tables, 1.0)
        nsplits = {name: splits(name, rows) for name in libs}
        if rows < 1152:
            nsplits['design unsplit'] = 1
        calls, worst = {}, {}
        for name, nsplit in nsplits.items():
            call = caller(name.split()[0], frames, nsplit)
            try:
                _, worst[name] = cs.compare(call(), ref, 2e-3, 1e-3)
                calls[name] = call
            except (RuntimeError, AssertionError) as e:
                print(f'mel variant {label} {name}: failed ({e}) [{smi}]', flush=True)
        times = {name: [] for name in calls}
        for _ in range(2):
            for name, call in calls.items():
                times[name].append(cs.graph_ms(call, 50))
        for name in calls:
            print(f'mel variant {label} {name}: ms={[round(x, 5) for x in times[name]]} '
                  f'worst_ratio={worst[name]:.3f} nsplit={nsplits[name]} [{smi}]', flush=True)

    for rows in SWEEP_ROWS:
        wave = torch.randn(1, (rows - 1) * 256, generator=g, device=dev) * 0.1
        frames = frame_signal(wave, 1024, 256, center=True)
        assert frames.shape[1] == rows
        calls = {name: caller(name, frames, splits(name, rows))
                 for name in ('small_only', 'large_only') if name in libs}
        times = {name: [] for name in calls}
        for _ in range(2):
            for name, call in calls.items():
                times[name].append(cs.graph_ms(call, 50))
        print(f'mel sweep rows={rows}: ' + ' '.join(
            f'{name}_ms={[round(x, 5) for x in times[name]]} (nsplit {splits(name, rows)})'
            for name in calls) + f' [{smi}]', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
