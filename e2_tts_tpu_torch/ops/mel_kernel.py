"""K11: the fused log-mel kernel (counterpart of
e2_tts_tpu/ops/mel_kernel.py::fused_log_mel).

Replaces the TPU kernel ``_mel_kernel``. Framed audio -> window-folded DFT
(two products against the cos / sin bases) -> |.|^power -> mel filterbank
-> ``log(max(., 1e-5))``, in one pass: the ``(rows, n_freqs)`` spectrum
never reaches device memory. The CUDA kernel is ``csrc/mel.cu``; its source
note says what bounds it on the H100 (operations: three split-TF32
tensor-core products a product, 165 TFLOP/s at f32 grade) and how its
design answers. The C entry point runs one of two block geometries of that
kernel by the row count (`GEOMETRIES`, `geometry`); for few rows (a serving
prompt) the wrapper splits the frequency tiles over several blocks per row
block (`frequency_splits`, from the row count and the card's SM count) and
allocates their scratch; such a call launches two CUDA kernels, the product
pass and the pass that sums the splits and takes the log. The ``mel_fwd``
launch counter counts wrapper calls: one per call, split or not.

`fused_log_mel` takes the frames as a strided view (``(rows, n_fft)`` or
``(b, frames, n_fft)``, unit last stride): `ops.mel` hands it the
reflect-padded wave unfolded with step ``hop``, which the kernel reads by
index, so no frame tensor is materialised. It runs the plain PyTorch
version for CPU tensors (tests) and launches the kernel for CUDA tensors;
there is no other route. The TPU kernel's lane padding of the tables (513
-> 576 bins, 100 -> 128 mels) is a TPU artefact and is not carried over.
The kernel takes any n_fft and any mel count (more than 128 mels run as
groups of 128 over the grid).
"""

from __future__ import annotations

import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.utils.helpers import exists


def spectrum(mag_sq: torch.Tensor, power: float) -> torch.Tensor:
    """``|X|^power`` from ``|X|^2``."""
    if power == 1.0:
        return torch.sqrt(torch.clamp(mag_sq, min=0.0))
    if power == 2.0:
        return mag_sq
    return torch.pow(torch.clamp(mag_sq, min=0.0), power / 2.0)


def fused_log_mel_plain(frames: torch.Tensor, dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                        fbanks: torch.Tensor, power: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K11 (f32), for CPU tensors and the tests:
    ``frames (..., n_fft)`` -> log-mel ``(..., n_mels)``."""
    frames = frames.float()
    re = frames @ dft_cos
    im = frames @ dft_sin
    mel = spectrum(re * re + im * im, power) @ fbanks
    return torch.log(torch.clamp(mel, min=1e-5))


# csrc/mel.cu's two block geometries, (frame rows, frequency bins a tile),
# and the row count from which its entry point takes the large one
GEOMETRIES = {'small': (32, 64), 'large': (128, 64)}
LARGE_ROWS = 1152


def geometry(rows: int) -> str:
    """The block geometry ``e2_mel_fwd`` runs for ``rows`` frame rows."""
    return 'large' if rows >= LARGE_ROWS else 'small'


def frequency_splits(rows: int, n_freqs: int, sms: int) -> int:
    """How many blocks share a row block's frequency tiles: each split walks
    about ``tiles x row blocks / sms`` tiles (at least one), so that row
    blocks x splits come near the card's ``sms`` SMs; 1 when the row blocks
    alone fill the card."""
    block_rows, tile_bins = GEOMETRIES[geometry(rows)]
    row_blocks = -(-rows // block_rows)
    tiles = -(-n_freqs // tile_bins)
    per_split = min(tiles, max(1, (2 * tiles * row_blocks + sms) // (2 * sms)))
    return -(-tiles // per_split)


def _mel_cuda(frames, dft_cos, dft_sin, fbanks, power):
    device = frames.device
    squeeze = frames.ndim == 2
    if squeeze:
        frames = frames[None]
    if frames.ndim != 3:
        raise ValueError(f'frames must be (rows, n_fft) or (b, frames, n_fft), got '
                         f'{tuple(frames.shape)}')
    b, t, n_fft = frames.shape
    n_freqs, n_mels = fbanks.shape
    _cuda.check_cuda_tensor(frames, 'frames', device, torch.float32)
    if frames.stride(-1) != 1:
        raise ValueError(f'frames need a unit last stride, got strides {frames.stride()}')
    for tab, name, shape in ((dft_cos, 'dft_cos', (n_fft, n_freqs)),
                             (dft_sin, 'dft_sin', (n_fft, n_freqs)),
                             (fbanks, 'fbanks', (n_freqs, n_mels))):
        _cuda.check_cuda_tensor(tab, name, device, torch.float32)
        if tuple(tab.shape) != shape or not tab.is_contiguous():
            raise ValueError(f'{name} must be a contiguous {shape} tensor, '
                             f'got {tuple(tab.shape)}')
    if n_fft < 1 or n_mels < 1:
        raise ValueError(f'the kernel takes n_fft >= 1 and n_mels >= 1, '
                         f'got n_fft={n_fft}, n_mels={n_mels}')
    out = torch.empty((b, t, n_mels), dtype=torch.float32, device=device)
    nsplit = frequency_splits(b * t, n_freqs, torch.cuda.get_device_properties(device)
                              .multi_processor_count)
    partial = (torch.empty((nsplit, b * t, n_mels), dtype=torch.float32, device=device)
               if nsplit > 1 else None)
    err = _cuda.lib().e2_mel_fwd(
        frames.data_ptr(), frames.stride(0), frames.stride(1), t, b * t, n_fft,
        dft_cos.data_ptr(), dft_sin.data_ptr(), n_freqs, fbanks.data_ptr(), n_mels,
        out.data_ptr(), partial.data_ptr() if exists(partial) else None, nsplit,
        float(power), _cuda.stream_ptr(device))
    _cuda.check(err, 'mel_fwd')
    _cuda.count_launch('mel_fwd')        # once per call, also when the split adds a pass
    return out[0] if squeeze else out


def fused_log_mel(frames: torch.Tensor, dft_cos: torch.Tensor, dft_sin: torch.Tensor,
                  fbanks: torch.Tensor, power: float = 1.0) -> torch.Tensor:
    """Log-mel of ``frames`` ((rows, n_fft) or (b, frames, n_fft), f32, any
    strides but the last) against window-folded bases ``(n_fft, n_freqs)``
    and ``fbanks (n_freqs, n_mels)``: ``(..., n_mels)`` f32."""
    power = float(power)
    if not power > 0.0:
        raise ValueError(f'power must be positive, got {power}')
    if frames.device.type == 'cpu':
        return fused_log_mel_plain(frames, dft_cos, dft_sin, fbanks, power)
    return _mel_cuda(frames, dft_cos, dft_sin, fbanks, power)
