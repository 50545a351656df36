"""Tensor helpers: projection and 1-D interpolation (counterpart of
e2_tts_tpu/utils/tensor.py).

`project` runs in float32 as the JAX package does (the original PyTorch
implementation used float64); the port matches the JAX reference.

`interpolate_1d` is a bilinear resize of a ``(n, d)`` sequence, as
``F.interpolate(mode='bilinear', align_corners=False)`` resizes a ``(n, 1)``
image; `masked_interpolate_1d` resizes each sample of a batch from its own
source length to its own target length in one gather, as the JAX package
does for `InterpolatedCharacterEmbed`.
"""

from __future__ import annotations

import torch


def project(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose ``x`` into components parallel / orthogonal to ``y``, per
    batch element over all remaining axes. Used by APG classifier-free
    guidance (arXiv 2410.02416)."""
    dtype = x.dtype
    batch = x.shape[0]
    xf = x.reshape(batch, -1).float()
    yf = y.reshape(batch, -1).float()

    unit = yf / torch.linalg.vector_norm(yf, dim=-1, keepdim=True).clamp(min=1e-12)
    parallel = (xf * unit).sum(dim=-1, keepdim=True) * unit
    orthogonal = xf - parallel

    return (parallel.reshape(x.shape).to(dtype),
            orthogonal.reshape(x.shape).to(dtype))


def _linear_resize_positions(src_len: torch.Tensor, tgt_len: torch.Tensor,
                             out_len: int) -> torch.Tensor:
    """Source coordinates of a bilinear resize with align_corners=False:
    ``(i + 0.5) * src / tgt - 0.5``, clamped to ``[0, src - 1]``, in f32.
    ``src_len`` / ``tgt_len`` are integer tensors that broadcast against
    the ``(out_len,)`` positions (positions beyond ``tgt_len`` are junk for
    the caller to mask)."""
    i = torch.arange(out_len, dtype=torch.float32, device=src_len.device)
    src_f = src_len.float()
    scale = src_f / torch.clamp(tgt_len.float(), min=1.0)
    src = (i + 0.5) * scale - 0.5
    return torch.minimum(torch.clamp(src, min=0.0), torch.clamp(src_f - 1.0, min=0.0))


def interpolate_1d(x: torch.Tensor, length: int) -> torch.Tensor:
    """Bilinear resize ``(n, d) -> (length, d)``."""
    n = x.shape[0]
    src = _linear_resize_positions(torch.tensor(n, device=x.device),
                                   torch.tensor(length, device=x.device), length)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=n - 1)
    w = (src - lo.float())[:, None].to(x.dtype)
    return x[lo] * (1.0 - w) + x[hi] * w


def masked_interpolate_1d(x: torch.Tensor, src_lens: torch.Tensor, tgt_lens: torch.Tensor,
                          out_len: int) -> torch.Tensor:
    """Per-sample bilinear resize of a batch: the first ``src_lens[b]`` rows
    of ``x[b] (n_src, d)`` to ``tgt_lens[b]`` rows, padded to ``out_len``
    (rows beyond the target are junk for the caller to mask). Both
    neighbours of every output row come from one gather."""
    b, n_src, d = x.shape
    src = _linear_resize_positions(src_lens[:, None], tgt_lens[:, None], out_len)  # (b, out)
    lo = torch.floor(src).long()
    hi = torch.minimum(lo + 1, torch.clamp(src_lens - 1, min=0)[:, None])
    lo = lo.clamp(0, n_src - 1)
    hi = hi.clamp(0, n_src - 1)
    w = (src - lo.float())[..., None].to(x.dtype)
    both = torch.gather(x, 1, torch.cat((lo, hi), dim=1)[..., None].expand(b, 2 * out_len, d))
    return both[:, :out_len] * (1.0 - w) + both[:, out_len:] * w
