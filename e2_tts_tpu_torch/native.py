"""ctypes bindings for the host-side audio library (counterpart of
e2_tts_tpu/native/__init__.py).

The library is the repository's ``native/audioprep.cc`` (polyphase
resampling), compiled on first use with the host C++ compiler into the
port's build directory (``build/native/``, never into ``native/``). Without
a compiler `load` returns None and `resample` returns None, and callers
take the scipy path.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _REPO_ROOT / 'native' / 'audioprep.cc'
BUILD_DIR = _REPO_ROOT / 'build' / 'native'
LIB_PATH = BUILD_DIR / 'libaudioprep.so'
CXXFLAGS = ['-O3', '-fPIC', '-shared', '-std=c++17', '-Wall']   # native/Makefile's

_lib = None
_load_attempted = False


def _build() -> None:
    cxx = shutil.which('g++')
    if cxx is None:
        raise OSError('no C++ compiler (g++)')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / LIB_PATH.name
        subprocess.run([cxx, *CXXFLAGS, '-o', str(out), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(out, LIB_PATH)


def load():
    """The library, built if needed; None when it cannot be built or
    loaded."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    try:
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))
    except (OSError, subprocess.SubprocessError):
        return None

    lib.audioprep_resample_out_len.restype = ctypes.c_int64
    lib.audioprep_resample_out_len.argtypes = [ctypes.c_int64] * 3
    lib.audioprep_resample.restype = ctypes.c_int64
    lib.audioprep_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return _lib


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray | None:
    """Polyphase resampling of a mono float waveform; None if the library
    is unavailable or refuses the rates."""
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(audio, dtype=np.float32)
    if x.ndim != 1:
        raise ValueError(f'resample takes a mono (n,) waveform, got shape {x.shape}')
    if sr_in <= 0 or sr_out <= 0:     # the C code divides by both
        raise ValueError(f'sample rates must be positive, got {sr_in} and {sr_out}')
    n_out = lib.audioprep_resample_out_len(len(x), sr_in, sr_out)
    y = np.empty(n_out, dtype=np.float32)
    written = lib.audioprep_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        sr_in, sr_out, y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if written < 0:
        return None
    return y[:written]
