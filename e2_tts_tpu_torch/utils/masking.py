"""Mask / length utilities (counterpart of e2_tts_tpu/utils/masking.py).

Randomness comes in through an explicit ``torch.Generator`` (the JAX
package threads PRNG keys), never torch's global generator."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from e2_tts_tpu_torch.utils.helpers import exists


def lens_to_mask(lens: torch.Tensor, length: int | None = None) -> torch.Tensor:
    """``lens (b,) -> bool mask (b, length)``; ``length`` defaults to the
    longest length."""
    if not exists(length):
        length = int(lens.max())
    seq = torch.arange(length, device=lens.device, dtype=lens.dtype)
    return seq[None, :] < lens[:, None]


def maybe_masked_mean(t: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over the sequence axis, respecting an optional bool mask:
    ``t (b, n, d) -> (b, d)``."""
    if not exists(mask):
        return t.mean(dim=1)
    t = torch.where(mask[..., None], t, torch.zeros((), dtype=t.dtype, device=t.device))
    den = mask.to(t.dtype).sum(dim=-1)
    return t.sum(dim=1) / torch.clamp(den, min=1.0)[..., None]


def pad_to_length(t: torch.Tensor, length: int, value=None) -> torch.Tensor:
    """Right-pad (or truncate) the LAST axis to ``length``."""
    seq_len = t.shape[-1]
    if length > seq_len:
        t = F.pad(t, (0, length - seq_len), value=0 if value is None else value)
    return t[..., :length]


def mask_from_start_end_indices(start: torch.Tensor, end: torch.Tensor,
                                length: int) -> torch.Tensor:
    """Bool mask ``(b, length)`` that is True on ``[start, end)``."""
    seq = torch.arange(length, device=start.device, dtype=start.dtype)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(seq_len: torch.Tensor, frac_lengths: torch.Tensor,
                           max_length: int, generator: torch.Generator | None = None,
                           rand: torch.Tensor | None = None) -> torch.Tensor:
    """Random span mask covering ``int(frac * len)`` frames from a uniform
    random start, per row: the JAX package's formula, with the start's
    uniform ``rand`` drawn from ``generator`` (on its own device, then moved
    to ``seq_len``'s) unless given."""
    lengths = (frac_lengths * seq_len.to(frac_lengths.dtype)).to(seq_len.dtype)
    max_start = seq_len - lengths
    if not exists(rand):
        rand = torch.rand(frac_lengths.shape, generator=generator, device=generator.device,
                          dtype=frac_lengths.dtype)
    rand = rand.to(seq_len.device)
    start = (max_start.to(rand.dtype) * rand).to(seq_len.dtype).clamp(min=0)
    return mask_from_start_end_indices(start, start + lengths, max_length)
