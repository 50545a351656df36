"""Vocos vocoder, mel -> waveform (counterpart of
e2_tts_tpu/vocoder/vocos.py; arXiv 2303.00501).

The ``charactr/vocos-mel-24khz`` architecture:

    mel (b, n, 100)
      -> Conv1d embed (k=7) -> LayerNorm
      -> 8 x ConvNeXt blocks (depthwise k=7, LayerNorm, 512 -> 1536 GELU
         1536 -> 512, layer-scale gamma, residual)
      -> final LayerNorm
      -> ISTFT head: Linear 512 -> n_fft + 2, split into log-magnitude and
         phase, inverse STFT (Hann, n_fft 1024, hop 256, centred)

The submodules carry the published torch package's names, so
``Vocos().state_dict()`` has the checkpoint's keys and shapes (pinned in
tests/fixtures/vocos_mel24khz_schema.json, less the ``feature_extractor.*``
mel buffers, which `ops.mel.MelSpec` replaces): a published state dict loads
with `Vocos.load_torch_state_dict`, or with ``load_state_dict(...,
strict=False)``, which reports exactly those keys as unexpected. The JAX
package's parameters load through `convert.load_jax_vocos`.

The inverse STFT is two products against inverse-rFFT bases and n_fft / hop
shifted adds, as in the JAX package, which computes it outside any Pallas
kernel; everything runs in f32. Weights start as the torch package
initialises them (truncated normal, std 0.02; zero biases).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from e2_tts_tpu_torch.utils.helpers import resolve_device


def irfft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """``(n_fft // 2 + 1, n_fft)`` f32 bases with ``Re @ br + Im @ bi ==
    irfft(Re + i Im, n_fft)``."""
    k = np.arange(n_fft // 2 + 1)[:, None]
    t = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    c = np.full((n_fft // 2 + 1, 1), 2.0)
    c[0] = c[-1] = 1.0
    return ((c * np.cos(ang) / n_fft).astype(np.float32),
            (-c * np.sin(ang) / n_fft).astype(np.float32))


class ISTFT(nn.Module):
    """Inverse STFT of a ``(b, frames, n_fft // 2 + 1)`` spectrum ->
    ``(b, (frames - 1) * hop)`` (centred), as ``torch.istft`` with a Hann
    window: per-frame inverse rFFT, windowed overlap-add, division by the
    window envelope, centre trim. ``window`` is the checkpoint's buffer."""

    def __init__(self, n_fft: int, hop_length: int):
        super().__init__()
        if n_fft % hop_length:
            raise ValueError('n_fft must be a multiple of hop_length')
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.register_buffer('window', torch.from_numpy(
            np.hanning(n_fft + 1)[:-1].astype(np.float32)))
        br, bi = irfft_bases(n_fft)
        self.register_buffer('basis_re', torch.from_numpy(br), persistent=False)
        self.register_buffer('basis_im', torch.from_numpy(bi), persistent=False)

    def forward(self, real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
        b, nf, _ = real.shape
        hop, r = self.hop_length, self.n_fft // self.hop_length
        frames = (real @ self.basis_re + imag @ self.basis_im) * self.window
        # overlap-add: hop block i + j of the output accumulates chunk j of frame i
        chunks = frames.view(b, nf, r, hop)
        total = nf + r - 1
        out = frames.new_zeros(b, total, hop)
        env = frames.new_zeros(total, hop)
        wsq = (self.window ** 2).view(r, hop)
        for j in range(r):
            out[:, j:j + nf] += chunks[:, :, j]
            env[j:j + nf] += wsq[j]
        y = out.reshape(b, total * hop) / torch.clamp(env.reshape(-1), min=1e-11)
        pad = self.n_fft // 2
        return y[:, pad: pad + (nf - 1) * hop]


class ConvNeXtBlock(nn.Module):
    """vocos.modules.ConvNeXtBlock: depthwise conv k=7, LayerNorm, pointwise
    MLP with exact GELU, layer-scale ``gamma``, residual."""

    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):                           # (b, n, d)
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
        return x + self.gamma * h


class VocosBackbone(nn.Module):
    """vocos.models.VocosBackbone, the plain-LayerNorm variant of the mel
    model."""

    def __init__(self, input_channels: int, dim: int, intermediate_dim: int, num_layers: int):
        super().__init__()
        self.embed = nn.Conv1d(input_channels, dim, kernel_size=7, padding=3)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.convnext = nn.ModuleList([
            ConvNeXtBlock(dim, intermediate_dim, layer_scale_init=1.0 / num_layers)
            for _ in range(num_layers)])
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, mel):                         # (b, n, input_channels)
        h = self.norm(self.embed(mel.transpose(1, 2)).transpose(1, 2))
        for block in self.convnext:
            h = block(h)
        return self.final_layer_norm(h)


class ISTFTHead(nn.Module):
    """vocos.heads.ISTFTHead: Linear to n_fft + 2, magnitude ``min(exp(.),
    1e2)`` (clamped after the exp, so an overflow to inf comes back as 1e2),
    phase through cos / sin, inverse STFT."""

    def __init__(self, dim: int, n_fft: int, hop_length: int):
        super().__init__()
        self.out = nn.Linear(dim, n_fft + 2)
        self.istft = ISTFT(n_fft, hop_length)
        self.hop_length = hop_length

    def forward(self, h):                           # (b, n, dim) -> (b, (n - 1) * hop)
        x = self.out(h).float()
        half = self.istft.n_fft // 2 + 1
        mag = torch.clamp(torch.exp(x[..., :half]), max=1e2)
        p = x[..., half:]
        return self.istft(mag * torch.cos(p), mag * torch.sin(p))


class Vocos(nn.Module):
    """Mel ``(b, n, input_channels)`` -> waveform ``(b, (n - 1) * hop)``,
    f32 (``charactr/vocos-mel-24khz`` geometry by default)."""

    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8, n_fft: int = 1024,
                 hop_length: int = 256, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.backbone = VocosBackbone(input_channels, dim, intermediate_dim, num_layers)
        self.head = ISTFTHead(dim, n_fft, hop_length)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.Linear)):
                    nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                    nn.init.zeros_(m.bias)
        self.to(device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(mel.float()))

    decode = forward

    def load_torch_state_dict(self, sd) -> 'Vocos':
        """Load the published torch Vocos checkpoint's state dict (its
        ``pytorch_model.bin``; torch tensors or numpy arrays), as the JAX
        package's `Vocos.load_torch_state_dict`: ``feature_extractor.*``
        and other keys the model does not hold are ignored, ``head.istft.
        window`` is optional, a missing key raises KeyError and a tensor of
        another shape ValueError."""
        with torch.no_grad():
            for name, dst in self.state_dict(keep_vars=True).items():
                if name == 'head.istft.window' and name not in sd:
                    continue
                value = sd[name]
                value = value.detach() if torch.is_tensor(value) else torch.from_numpy(
                    np.array(value, copy=True))
                if tuple(value.shape) != tuple(dst.shape):
                    raise ValueError(f'{name}: checkpoint tensor of shape {tuple(value.shape)}, '
                                     f'model parameter is {tuple(dst.shape)}')
                dst.copy_(value.to(dst.dtype))
        return self
