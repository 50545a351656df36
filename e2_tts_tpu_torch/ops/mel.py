"""Log-mel spectrogram frontend (counterpart of e2_tts_tpu/ops/mel.py).

The numerical contract of the JAX package's `MelSpec`: torchaudio's
MelSpectrogram with n_fft 1024, window 1024, hop 256, 100 mels at 24 kHz,
power 1, centred (reflect pad), HTK mel scale, no filterbank norm, then a
natural log clamped at 1e-5. The tables are numpy copies of the JAX
package's (built in float64, cast to f32), so both packages hold bit-equal
tables.

Modes, with the JAX package's names so that one config dict means the same
thing in both packages:
- ``'dft'`` (default): the spectrum as two plain torch matmuls against the
  window-folded DFT bases;
- ``'fft'``: ``torch.fft.rfft`` of the windowed frames;
- ``'pallas'``: the fused kernel K11 (ops/mel_kernel.py, ``csrc/mel.cu``)
  on a CUDA tensor, its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from e2_tts_tpu_torch.ops.mel_kernel import fused_log_mel, spectrum

MODES = ('dft', 'fft', 'pallas')


def hz_to_mel(freq: np.ndarray, mel_scale: str = 'htk') -> np.ndarray:
    """HTK (default) or slaney mel scale, matching torchaudio.functional."""
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == 'htk':
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz, min_log_mel + np.log(freq / min_log_hz) / logstep, mels)


def mel_to_hz(mels: np.ndarray, mel_scale: str = 'htk') -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == 'htk':
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int,
                    norm: str | None = None, mel_scale: str = 'htk') -> np.ndarray:
    """Triangular mel filterbank ``(n_freqs, n_mels)`` f32, matching
    torchaudio.functional.melscale_fbanks."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min, mel_scale), hz_to_mel(f_max, mel_scale), n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.clip(np.minimum(down_slopes, up_slopes), 0.0, None)
    if norm == 'slaney':
        fb *= (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True)), f32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def dft_bases(window: np.ndarray, n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real DFT bases ``(n_fft, n_fft // 2 + 1)`` f32 (built
    in float64): ``frame @ cos + i frame @ sin == rfft(window * frame)``."""
    k = np.arange(n_fft // 2 + 1)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    return ((np.cos(ang) * window[:, None]).astype(np.float32),
            (-np.sin(ang) * window[:, None]).astype(np.float32))


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int, center: bool) -> torch.Tensor:
    """``(b, nw) -> (b, 1 + nw' // hop, n_fft)`` frames, a strided view of
    the wave (reflect-padded by ``n_fft // 2`` on each side when centred)."""
    if center:
        pad = n_fft // 2
        if x.shape[-1] <= pad:
            # torch's reflect pad needs pad < length; jnp.pad reflects such
            # short waves differently, so there is no common answer
            raise ValueError(f'a centred MelSpec needs more than {pad} samples, '
                             f'got {x.shape[-1]}')
        x = F.pad(x[:, None], (pad, pad), mode='reflect')[:, 0]
    if x.shape[-1] < n_fft:
        raise ValueError(f'a wave of {x.shape[-1]} samples holds no {n_fft}-sample frame')
    return x.unfold(-1, n_fft, hop_length)


class MelSpec(nn.Module):
    """Waveform -> log-mel, no trainable parameters. The tables are
    non-persistent buffers: they follow the module's device and stay out of
    its state dict.

    Call with ``(nw)``, ``(b, nw)`` or ``(b, 1, nw)``; returns ``(b, n_mels,
    frames)`` (``(n_mels, frames)`` for a 1-D input). ``mode``: ``'dft'``
    (torch matmuls), ``'fft'`` (``torch.fft.rfft``) or ``'pallas'`` (kernel
    K11 on a CUDA tensor, its plain PyTorch version on a CPU tensor)."""

    def __init__(self, filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mel_channels: int = 100,
                 sampling_rate: int = 24_000, normalize: bool = False, power: float = 1.0,
                 norm: str | None = None, center: bool = True, mode: str = 'dft'):
        super().__init__()
        if normalize:
            raise ValueError('spectrogram normalization is not used by the reference')
        if win_length > filter_length:
            raise ValueError('win_length must not exceed filter_length')
        if mode not in MODES:
            raise ValueError(f'mode must be one of {MODES}, got {mode!r}')
        self.n_fft = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.sampling_rate = sampling_rate
        self.power = float(power)
        self.center = center
        self.mode = mode

        n_freqs = filter_length // 2 + 1
        window = hann_window(win_length)
        if win_length < filter_length:          # centre the window in n_fft, like torch.stft
            lpad = (filter_length - win_length) // 2
            window = np.pad(window, (lpad, filter_length - win_length - lpad))
        fb = melscale_fbanks(n_freqs, 0.0, float(sampling_rate // 2), n_mel_channels,
                             sampling_rate, norm=norm, mel_scale='htk')
        self.register_buffer('fbanks', torch.from_numpy(fb), persistent=False)
        if mode == 'fft':
            self.register_buffer('window', torch.from_numpy(window), persistent=False)
        else:
            cos, sin = dft_bases(window, filter_length)
            self.register_buffer('dft_cos', torch.from_numpy(cos), persistent=False)
            self.register_buffer('dft_sin', torch.from_numpy(sin), persistent=False)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        squeeze_batch = inp.ndim == 1
        if squeeze_batch:
            inp = inp[None]
        if inp.ndim == 3:
            if inp.shape[1] != 1:
                raise ValueError(f'a 3-dim wave must be (b, 1, nw), got {tuple(inp.shape)}')
            inp = inp[:, 0]
        if inp.ndim != 2:
            raise ValueError(f'MelSpec takes (nw), (b, nw) or (b, 1, nw), got {tuple(inp.shape)}')
        frames = frame_signal(inp.float(), self.n_fft, self.hop_length, self.center)

        if self.mode == 'pallas':
            mel = fused_log_mel(frames, self.dft_cos, self.dft_sin, self.fbanks, self.power)
        else:
            if self.mode == 'dft':
                re, im = frames @ self.dft_cos, frames @ self.dft_sin
            else:
                spec = torch.fft.rfft(frames * self.window, dim=-1)
                re, im = spec.real, spec.imag
            mel = torch.log(torch.clamp(spectrum(re * re + im * im, self.power) @ self.fbanks,
                                        min=1e-5))
        mel = mel.transpose(1, 2)                   # (b, n_mels, frames)
        return mel[0] if squeeze_batch else mel


def as_mel(mel_spec: MelSpec, inp: torch.Tensor, num_channels: int) -> torch.Tensor:
    """A mel ``(b, n, num_channels)`` as it is; a raw wave ``(b, nw)``
    through ``mel_spec``, as ``(b, frames, num_channels)``."""
    if inp.ndim == 2:
        inp = mel_spec(inp).transpose(1, 2)
        if inp.shape[-1] != num_channels:
            raise ValueError(f'the mel frontend gives {inp.shape[-1]} channels, the model '
                             f'takes {num_channels}')
    return inp


def db_to_amplitude(x: torch.Tensor, ref: float = 1.0, power: float = 0.5) -> torch.Tensor:
    """torchaudio.functional.DB_to_amplitude: ``ref * 10^(power * x / 10)``
    (used on the vocoder decode path)."""
    return ref * torch.pow(10.0, power * x / 10.0)
