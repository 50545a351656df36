#!/usr/bin/env python3
"""Hold this checkout's kernels against another checkout's on one card.

    python3 chip_ab.py OTHER_CHECKOUT      # from this checkout's root; one CUDA card

Builds K11 (csrc/mel.cu) and K5b / K4 (the hyper-connection adjoints) from
both checkouts' sources with nvcc into build/, and times each pair in turns
(other, this, this, other) as device time per call, 100 calls captured in a
CUDA graph: K11 at the 3-s prompt (282 frames, split over frequency tiles
as its wrapper splits it) and K5b / K4 at the flagship's training shape
(4 streams, 16896 rows, width 512, bf16, 8 warps a block, 264 blocks). The
other checkout's adjoint may predate the warps argument (it then ran 8
warps a block at this width). Prints one line per kernel with the card's
name and power limit.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

NVCC = '/usr/local/cuda/bin/nvcc'
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']


def build(root, srcs, out):
    """One nvcc -c per source, all started together, then one link."""
    csrc = os.path.join(root, 'e2_tts_tpu_torch', 'csrc')
    objs = [f'{out}.{i}.o' for i in range(len(srcs))]
    procs = [subprocess.Popen([NVCC, *ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-I', csrc,
                               '-c', os.path.join(csrc, src), '-o', obj])
             for src, obj in zip(srcs, objs)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError(f'nvcc failed in {root}')
    subprocess.run([NVCC, *ARCH, '-shared', *objs, '-o', out], check=True)
    return ctypes.CDLL(out)


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
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print('usage: python3 chip_ab.py OTHER_CHECKOUT (needs a CUDA card)', file=sys.stderr)
        return 1
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
    for tag, root in (('other', other), ('this', '.')):
        bwd = ['hyper_conn_bwd.cu'] if tag == 'other' and old_bwd else [
            'hyper_conn_bwd.cu', 'hyper_conn_bwd_save.cu', 'hyper_conn_bwd_streams.cu',
            'hyper_conn_bwd_f32.cu']
        libs[tag] = (build(root, ['mel.cu'], f'{tmp}/mel_{tag}.so'),
                     build(root, bwd, f'{tmp}/bwd_{tag}.so'))
    g = torch.Generator(device=dev).manual_seed(0)
    # K11 at the prompt: 282 frames, split over frequency tiles as the wrapper does
    spec = MelSpec(mode='pallas').to(dev)
    wave = torch.randn(1, 72000, generator=g, device=dev) * 0.1
    frames = frame_signal(wave, 1024, 256, center=True)
    b, t, n_fft = frames.shape
    n_freqs, n_mels = spec.fbanks.shape
    from e2_tts_tpu_torch.ops import mel_kernel as mk
    nsplit = mk.frequency_splits(b * t, n_freqs, torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
    out = torch.empty(b, t, n_mels, device=dev)
    part = torch.empty(nsplit, b * t, n_mels, device=dev)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def mel(lib):
        fn = lib.e2_mel_fwd
        fn.argtypes = [P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, P, P, ctypes.c_int, P, ctypes.c_int, P, P, ctypes.c_int,
                       ctypes.c_float, P]
        return lambda: fn(frames.data_ptr(), frames.stride(0), frames.stride(1), t, b * t, n_fft,
                          spec.dft_cos.data_ptr(), spec.dft_sin.data_ptr(), n_freqs,
                          spec.fbanks.data_ptr(), n_mels, out.data_ptr(), part.data_ptr(),
                          nsplit, 1.0, stream())

    # K5b / K4 at (4, 16896, 512) bf16
    s, m, d = 4, 16896, 512
    rnd = lambda *shape, scale=1.0: (torch.randn(shape, generator=g, device=dev) * scale)
    bf = torch.bfloat16
    res, branch, beta = rnd(s, m, d).to(bf), rnd(m, d).to(bf), rnd(s, m, scale=0.5).to(bf)
    gb0, gcar, gbeta = rnd(m, d).to(bf), rnd(s, m, d).to(bf), rnd(s, m).to(bf)
    sa, sb = torch.eye(s, s + 1, device=dev), torch.ones(s, device=dev)
    aw, bw = rnd(d, s + 1, scale=0.05), rnd(d, scale=0.05)
    asc = bsc = torch.tensor(0.5, device=dev)
    blocks, np_ = 264, (s + 2) * d + s * (s + 2) + 2
    partials = torch.empty(blocks, np_, device=dev)
    row = torch.empty(np_, device=dev)
    outs = [torch.empty_like(res), torch.empty_like(branch), torch.empty_like(beta)]
    params = [t.data_ptr() for t in (sa, sb, aw, bw, asc, bsc)]

    def bwd(lib, tag, fused):
        name = 'e2_hc_width_fused_bwd' if fused else 'e2_hc_width_bwd'
        fn = getattr(lib, name)
        ins = [res, branch, beta] if fused else [res]
        o = outs if fused else outs[:1]
        warps = [] if tag == 'other' and old_bwd else [ctypes.c_int(8)]
        args = lambda: [*(t.data_ptr() for t in ins), gb0.data_ptr(), gcar.data_ptr(),
                        gbeta.data_ptr(), *params, *(t.data_ptr() for t in o),
                        partials.data_ptr(), row.data_ptr()]
        fn.restype = ctypes.c_int

        def call():
            err = fn(*(P(a) for a in args()), ctypes.c_int(blocks), *warps, ctypes.c_int(s),
                     ctypes.c_longlong(m), ctypes.c_int(d), ctypes.c_int(1), P(stream()))
            if err:
                raise RuntimeError(f'{name} failed to launch: cudaError {err}')
        return call

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    for label, make in (('K11 prompt', lambda tag: mel(libs[tag][0])),
                        ('K5b (4,16896,512) bf16', lambda tag: bwd(libs[tag][1], tag, False)),
                        ('K4 (4,16896,512) bf16', lambda tag: bwd(libs[tag][1], tag, True))):
        times = {tag: [] for tag in ('other', 'this')}
        for tag in ('other', 'this', 'this', 'other'):
            times[tag].append(graph_ms(make(tag)))
        print(f'ab {label}: other_ms={[round(x, 5) for x in times["other"]]} '
              f'this_ms={[round(x, 5) for x in times["this"]]} [{smi}]', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
