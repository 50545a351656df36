"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``e2_tts_tpu_torch/csrc/*.cu`` are compiled for the H100
(``sm_90a``) with ``nvcc`` at first use: one ``nvcc -c`` per source, all
started together, then one link into ``build/kernels/libe2kernels.so``
(a directory listed in ``.gitignore``) with a plain C interface loaded by
``ctypes``. The library is rebuilt when a source is newer than it.

Nothing here runs at import time: this module imports on a machine with no
``nvcc`` and no GPU, where the kernels' plain PyTorch versions are used for
CPU tensors only.

``launch_counts`` holds one integer per kernel; each wrapper adds one where
it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
LIB_NAME = 'libe2kernels.so'
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
# -Xptxas -v: each kernel's registers and spills, kept in build_logs
NVCC_FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-lineinfo', '-Xptxas', '-v']

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# forward kernels K1, K5, K3, K6, then their backward kernels K2, K5b, K4, K7,
# then K11 (the log-mel frontend), K10 (K2's delta pre-pass), K8 and K9 (flash
# attention on (b, h, n, dh) operands), the flash cost-floor probe, and the
# hyper-connection save-state variants K5s, K3s, K5bs, K4s
KERNELS = ('flash_fwd', 'hc_width', 'hc_width_fused', 'geglu_fwd',
           'flash_bwd', 'hc_width_bwd', 'hc_width_fused_bwd', 'geglu_bwd',
           'mel_fwd', 'flash_delta', 'flash_fwd_bhnd', 'flash_bwd_bhnd', 'flash_probe',
           'hc_width_save', 'hc_width_fused_save', 'hc_width_bwd_save',
           'hc_width_fused_bwd_save')
launch_counts = dict.fromkeys(KERNELS, 0)

_lib = None
build_seconds = None
build_logs = {}      # source file name -> nvcc's output of the last build


def reset_launch_counts():
    for name in KERNELS:
        launch_counts[name] = 0


def count_launch(name: str):
    launch_counts[name] += 1


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit')


def build(force: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the shared
    library; returns its path. Skipped when the library is newer than every
    source, unless ``force``."""
    global build_seconds
    sources = sorted(CSRC.glob('*.cu'))
    headers = sorted(CSRC.glob('*.cuh'))
    lib_path = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in sources + headers)
    if not force and lib_path.exists() and lib_path.stat().st_mtime >= newest:
        return lib_path

    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + '.o')
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, '-I', str(CSRC),
                   '-c', str(src), '-o', str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            build_logs[src.name] = out
            if proc.returncode != 0:
                failed.append(f'{src.name}:\n{out}')
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, '-shared', '-o', str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError('nvcc link failed:\n' + link.stdout)
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


_P, _I, _LL, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_uint32)

_SIGNATURES = {
    'e2_flash_fwd': [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P,
                     _I, _I, _I, _I, _F, _F, _F, _U, _U, _I, _I, _I, _I, _U, _I, _P],
    'e2_hc_width': [_P] * 12 + [_I, _LL, _I, _I, _P],
    'e2_hc_width_fused': [_P] * 14 + [_I, _LL, _I, _I, _P],
    'e2_geglu_fwd': [_P, _P, _I, _I, _I, _F, _U, _U, _I, _I, _P],
    'e2_flash_bwd': [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P,
                     _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _U, _U, _I, _I, _I, _I, _U, _I,
                     _P],
    'e2_hc_width_bwd': [_P] * 13 + [_I, _I, _I, _LL, _I, _I, _P],
    'e2_hc_width_fused_bwd': [_P] * 17 + [_I, _I, _I, _LL, _I, _I, _P],
    'e2_hc_width_bwd_save': [_P] * 15 + [_I, _I, _I, _LL, _I, _I, _P],
    'e2_hc_width_fused_bwd_save': [_P] * 19 + [_I, _I, _I, _LL, _I, _I, _P],
    'e2_geglu_bwd': [_P, _P, _P, _I, _I, _I, _F, _U, _U, _I, _I, _P],
    'e2_mel_fwd': [_P, _LL, _LL, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P, _I, _F, _P],
    'e2_flash_delta': [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _P],
    'e2_flash_fwd_bhnd': [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _F, _F, _F, _U, _U, _I, _I, _I, _I, _U, _I, _P],
    'e2_flash_bwd_bhnd': [_P] * 18 + [_I, _I, _I, _I, _F, _F, _F, _U, _U, _I, _I, _I, _I, _U,
                                      _I, _P],
    'e2_flash_probe': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def ptxas_usage(source: str, marker: str):
    """``(kernel, registers, spill stores, spill loads)`` for each kernel of
    ``source`` whose mangled name holds ``marker``, from the last build's
    ``-Xptxas -v`` output."""
    rows, name = [], None
    for line in build_logs.get(source, '').splitlines():
        if 'Compiling entry function' in line:
            name = line.split("'")[1] if marker in line else None
        elif name and 'spill stores' in line:
            nums = [int(w) for w in line.replace(',', ' ').split() if w.isdigit()]
            spill = (nums[1], nums[2])
        elif name and 'Used' in line and 'registers' in line:
            regs = int(line.split('Used')[1].split()[0])
            rows.append((name, regs, *spill))
            name = None
    return rows


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def strides_bhn(t: torch.Tensor):
    """The (batch, head, row) element strides of a (b, h, n, dh) tensor (or
    of a (b, h, n) one) as a C ``long long[3]``, read during the call."""
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError {err}')


def check_cuda_tensor(t: torch.Tensor, name: str, device: torch.device,
                      dtype=None):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f'{name} has dtype {t.dtype}, expected {dtype}')
