"""K6 and K7: GEGLU + counter-hash dropout, forward and backward
(counterpart of e2_tts_tpu/ops/geglu_kernel.py::geglu_dropout).

K6 replaces the TPU kernel ``_fwd_kernel`` (driven by ``_fwd_pallas``), K7
the TPU kernel ``_bwd_kernel`` (driven by ``_bwd_pallas``). Both CUDA
kernels are in ``csrc/geglu.cu``: bandwidth bound, one pass each, its C
entry points choosing a 16-byte vector design or a scalar one from the
width and the operands' alignment (no argument here); K7
regenerates the forward's keep bits from the seed and writes the grads of
both halves into one ``(b, n, 2*inner)`` tensor. Unlike the TPU kernels they
take any ``inner`` (the text FF's 704 as well as 1408) and use the exact
``erff``. `_Geglu` is the ``torch.autograd.Function``.

`geglu_dropout` and `geglu_dropout_backward` take the plain PyTorch versions
for CPU tensors and launch the kernels for CUDA tensors; there is no other
route.
"""

from __future__ import annotations

import math

import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops.dropout import hash_keep, keep_threshold

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def geglu_dropout_plain(h2: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Plain PyTorch version of K6 (f32 math, exact erf)."""
    h, g = h2.float().chunk(2, dim=-1)
    act = h * (0.5 * g * (1.0 + torch.erf(g * _INV_SQRT2)))
    if rate > 0.0:
        keep = hash_keep(act.shape, seed, rate, device=h2.device)
        act = torch.where(keep, act * (1.0 / (1.0 - rate)), 0.0)
    return act.to(h2.dtype)


def geglu_dropout_backward_plain(h2: torch.Tensor, gout: torch.Tensor, seed: int,
                                 rate: float) -> torch.Tensor:
    """Plain PyTorch version of K7 (f32 math): the grad of ``h2``."""
    h, g = h2.float().chunk(2, dim=-1)
    go = gout.float()
    if rate > 0.0:
        keep = hash_keep(go.shape, seed, rate, device=h2.device)
        go = torch.where(keep, go * (1.0 / (1.0 - rate)), 0.0)
    phi = 0.5 * (1.0 + torch.erf(g * _INV_SQRT2))
    dgelu = phi + g * torch.exp(-0.5 * g * g) * _INV_SQRT2PI
    return torch.cat((go * (g * phi), go * h * dgelu), dim=-1).to(h2.dtype)


def _geglu_cuda(h2, seed, rate):
    b, n, two_inner = h2.shape
    inner = two_inner // 2
    if h2.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'geglu_dropout takes bf16 or f32, got {h2.dtype}')
    if not h2.is_contiguous():
        raise ValueError('geglu_dropout needs a contiguous (b, n, 2*inner) input')
    out = torch.empty((b, n, inner), dtype=h2.dtype, device=h2.device)
    dropping = rate > 0.0
    err = _cuda.lib().e2_geglu_fwd(
        h2.data_ptr(), out.data_ptr(), b, n, inner,
        1.0 / (1.0 - rate) if dropping else 1.0, int(seed) & 0xFFFFFFFF,
        keep_threshold(rate), int(dropping), _cuda.DTYPE_CODES[h2.dtype],
        _cuda.stream_ptr(h2.device))
    _cuda.check(err, 'geglu_fwd')
    _cuda.count_launch('geglu_fwd')
    return out


def _geglu_bwd_cuda(h2, gout, seed, rate):
    b, n, two_inner = h2.shape
    inner = two_inner // 2
    if h2.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'geglu_dropout_backward takes bf16 or f32, got {h2.dtype}')
    if not h2.is_contiguous():
        raise ValueError('geglu_dropout_backward needs a contiguous (b, n, 2*inner) input')
    _cuda.check_cuda_tensor(gout, 'gout', h2.device, h2.dtype)
    if tuple(gout.shape) != (b, n, inner):
        raise ValueError(f'gout has shape {tuple(gout.shape)}, expected {(b, n, inner)}')
    gout = gout.contiguous()
    gh2 = torch.empty_like(h2)
    dropping = rate > 0.0
    err = _cuda.lib().e2_geglu_bwd(
        h2.data_ptr(), gout.data_ptr(), gh2.data_ptr(), b, n, inner,
        1.0 / (1.0 - rate) if dropping else 1.0, int(seed) & 0xFFFFFFFF,
        keep_threshold(rate), int(dropping), _cuda.DTYPE_CODES[h2.dtype],
        _cuda.stream_ptr(h2.device))
    _cuda.check(err, 'geglu_bwd')
    _cuda.count_launch('geglu_bwd')
    return gh2


def _check_args(h2, rate):
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f'dropout rate must be in [0, 1), got {rate}')
    if h2.ndim != 3 or h2.shape[-1] % 2:
        raise ValueError(f'geglu_dropout takes (b, n, 2*inner), got {tuple(h2.shape)}')
    return rate


def geglu_dropout_backward(h2: torch.Tensor, gout: torch.Tensor, seed: int = 0,
                           rate: float = 0.0) -> torch.Tensor:
    """K7 alone (the counterpart of ``_bwd_pallas``): the grad of ``h2
    (b, n, 2*inner)`` from the output grad ``gout (b, n, inner)``."""
    rate = _check_args(h2, rate)
    if h2.device.type == 'cpu':
        return geglu_dropout_backward_plain(h2, gout, seed, rate)
    return _geglu_bwd_cuda(h2, gout, seed, rate)


class _Geglu(torch.autograd.Function):
    """K6 forward, K7 backward; saves the projection output ``h2``."""

    @staticmethod
    def forward(ctx, h2, seed, rate):
        ctx.save_for_backward(h2)
        ctx.config = (seed, rate)
        if h2.device.type == 'cpu':
            return geglu_dropout_plain(h2, seed, rate)
        return _geglu_cuda(h2, seed, rate)

    @staticmethod
    def backward(ctx, gout):
        (h2,) = ctx.saved_tensors
        return geglu_dropout_backward(h2, gout, *ctx.config), None, None


def geglu_dropout(h2: torch.Tensor, seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """``h2 (b, n, 2*inner) -> (b, n, inner)``: h * gelu(gate), then dropout
    with keep probability 1 - rate (rate 0 disables the mask);
    differentiable (backward: K7)."""
    rate = _check_args(h2, rate)
    return _Geglu.apply(h2, seed, rate)
