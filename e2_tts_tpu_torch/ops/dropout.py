"""Counter-hash dropout bits (counterpart of e2_tts_tpu/ops/dropout.py and
the hash helpers of e2_tts_tpu/ops/flash_attention.py).

A keep bit is a pure function of (seed, coordinates) through a murmur3-style
finalizer, so a kernel and its plain version draw the same mask, and the
masks are bit-identical to the JAX package's for the same uint32 seed.
The plain versions compute in int64 holding uint32 values; every product
is split so no intermediate exceeds 2**48.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF

# hash_keep axis multipliers (ops/dropout.py:_PRIMES in the JAX package)
PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0xD3A2646D)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` holding uint32 values."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(x: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    """32-bit mix finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    if rounds >= 2:
        x = mul32(x, 0x846CA68B)
        x = x ^ (x >> 16)
    return x


def keep_threshold(rate: float) -> int:
    """uint32 threshold with P(bits < threshold) = rate."""
    return min(int(rate * 4294967296.0), 4294967295)


def hash_keep(shape, seed: int, rate: float, device=None) -> torch.Tensor:
    """Boolean keep mask over ``shape`` with P(keep) = 1 - rate: the counter
    is seed + sum_axis index * PRIMES[axis] (mod 2**32)."""
    assert len(shape) <= len(PRIMES)
    ctr = torch.full((1,) * len(shape), int(seed) & _M32, dtype=torch.int64,
                     device=device)
    for axis, size in enumerate(shape):
        view = [1] * len(shape)
        view[axis] = size
        idx = torch.arange(size, dtype=torch.int64, device=device).view(view)
        ctr = (ctr + mul32(idx, PRIMES[axis])) & _M32
    return fmix32(ctr) >= keep_threshold(rate)


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Dropout with keep probability 1 - rate and 1 / (1 - rate) scaling, the
    mask `hash_keep` over ``x``'s shape (ops/dropout.py:hash_dropout in the
    JAX package, whose key reaches the same uint32 ``seed``)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        raise ValueError(f'dropout rate must be below 1, got {rate}')
    keep = hash_keep(x.shape, seed, rate, device=x.device)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0).to(x.dtype)


def fold_batch_offset(seed: int, b0: int) -> int:
    """The seed whose `hash_keep` over rows ``[0, b)`` of axis 0 draws the
    bits of rows ``[b0, b0 + b)`` under ``seed``: the counter is linear in
    the index, so the offset folds into the seed as ``seed + b0 *
    PRIMES[0]`` (mod 2**32). A data-parallel rank holding rows from ``b0``
    draws the global batch's bits this way, with no kernel change."""
    return (int(seed) + int(b0) * PRIMES[0]) & _M32


def fold_column_offset(seed: int, c0: int) -> int:
    """The seed whose `hash_keep` over columns ``[0, c)`` of axis 2 draws the
    bits of columns ``[c0, c0 + c)`` under ``seed``: ``seed + c0 *
    PRIMES[2]`` (mod 2**32), as `fold_batch_offset` folds a row offset. A
    tensor-parallel rank holding the GEGLU columns from ``c0`` draws the
    whole layer's bits this way, with no kernel change."""
    return (int(seed) + int(c0) * PRIMES[2]) & _M32


def fold_seq_offset(seed: int, t0: int) -> int:
    """The seed whose `hash_keep` over frames ``[0, n)`` of axis 1 draws the
    bits of frames ``[t0, t0 + n)`` under ``seed``: ``seed + t0 *
    PRIMES[1]`` (mod 2**32), as `fold_batch_offset` folds a row offset. A
    sequence-parallel rank holding the rows from ``t0`` of the sequence draws
    the whole sequence's GEGLU bits this way, with no kernel change."""
    return (int(seed) + int(t0) * PRIMES[1]) & _M32
