"""Attention op with the reference's "epicycles" (counterpart of
e2_tts_tpu/ops/attention.py::attention and ``attention_packed``).

`attention` runs on ``(b, h, n, dh)`` tensors through K8 / K9
(`flash_attention`); `attention_packed` on the packed ``(b, n, h*dh)``
projection layout: through K1 / K2 (`flash_attention_packed`, the per-head
sigmoid output gate folded into the kernel) when dim_head is 32, 64 or 128,
else through K8 / K9 on strided ``(b, h, n, dh)`` views of the projection
(no copies), the gate applied after the kernel, as the JAX package routes
the heads its lane-packed kernels reject. Both take the tanh logit
softclamp, the key-padding mask, counter-hash attention dropout (its bits
drawn for global batch rows from ``hash_b0``, the first row's place in the
global batch: a data-parallel rank passes its offset; and for global heads
from ``hash_h0`` of ``hash_heads``: a tensor-parallel rank passes its first
head and the layer's head count) and LASER:
exp-space values ``exp(softclamp(v, 15))`` cast to q's dtype before the
kernel and ``log(max(out, 1e-20))`` after it, with the gate after the log.
With ``sp_mesh`` (sequence parallelism, parallel/sp.py) q, k, v are this
rank's rows of the sequence and the core runs as ring attention over the
mesh's ``sp_axis``, block by block on K1 / K2 or K8 / K9 (the same
softclamp, mask and dropout bits); LASER and the gate apply around the
ring, as in the JAX package.
The JAX package sent small batches to XLA on the TPU; the port has no such
routing by batch.
"""

from __future__ import annotations

import torch

from e2_tts_tpu_torch.ops.flash_attention import (
    SUPPORTED_DIM_HEAD, flash_attention, flash_attention_packed,
)
from e2_tts_tpu_torch.parallel.sp import ring_attention
from e2_tts_tpu_torch.utils.helpers import default, exists


def softclamp(x: torch.Tensor, value: float) -> torch.Tensor:
    """tanh soft clamp: value * tanh(x / value)."""
    return torch.tanh(x / value) * value


def _laser_values(v, laser_softclamp_value):
    return torch.exp(softclamp(v.float(), laser_softclamp_value))


def _laser_log(out):
    return torch.log(torch.clamp(out.float(), min=1e-20))


def attention(q, k, v, mask=None, *, scale=None, softclamp_value: float | None = 50.0,
              laser: bool = False, laser_softclamp_value: float = 15.0,
              dropout_rate: float = 0.0, dropout_seed: int | None = None,
              hash_b0: int = 0, hash_h0: int = 0, hash_heads: int | None = None):
    """``q, k, v (b, h, n, dh)`` -> ``(b, h, n, dh)`` through K8 (K9 in the
    backward). Dropout is drawn only when both ``dropout_rate > 0`` and a
    ``dropout_seed`` are given."""
    scale = default(scale, q.shape[-1] ** -0.5)
    if laser:
        v = _laser_values(v, laser_softclamp_value)
    dropping = dropout_rate > 0.0 and exists(dropout_seed)
    out = flash_attention(q, k, v.to(q.dtype), mask, scale=scale,
                          softclamp_value=softclamp_value,
                          dropout_rate=dropout_rate if dropping else 0.0,
                          dropout_seed=dropout_seed if dropping else 0, hash_b0=hash_b0,
                          hash_h0=hash_h0, hash_heads=hash_heads)
    if laser:
        out = _laser_log(out)
    return out.to(q.dtype)


def attention_packed(q, k, v, mask=None, *, heads: int, scale=None,
                     softclamp_value: float | None = 50.0, laser: bool = False,
                     laser_softclamp_value: float = 15.0,
                     dropout_rate: float = 0.0, dropout_seed: int | None = None,
                     gate_logits=None, hash_b0: int = 0, hash_h0: int = 0,
                     hash_heads: int | None = None, sp_mesh=None, sp_axis: str = 'seq'):
    """``q, k, v (b, n, h*dh)`` -> ``(b, n, h*dh)``; ``gate_logits (b, n,
    h)`` the optional per-head sigmoid output gate. Dropout is drawn only
    when both ``dropout_rate > 0`` and a ``dropout_seed`` are given. With
    ``sp_mesh``, this rank's rows of a sequence sharded on its ``sp_axis``
    (`parallel.sp.ring_attention`)."""
    b, n, D = q.shape
    dh = D // heads
    scale = default(scale, dh ** -0.5)
    if laser:
        v = _laser_values(v, laser_softclamp_value)

    if exists(sp_mesh):
        # the combined output stays f32 through LASER's log and the gate
        # (one launch folds the gate into K1 in f32): one rounding, at the end
        out = ring_attention(q, k, v.to(q.dtype), mask, mesh=sp_mesh, heads=heads, scale=scale,
                             softclamp_value=softclamp_value, dropout_rate=dropout_rate,
                             dropout_seed=dropout_seed, axis_name=sp_axis, hash_b0=hash_b0,
                             hash_h0=hash_h0, hash_heads=hash_heads)
        if laser:
            out = _laser_log(out)
        if exists(gate_logits):
            gate = torch.sigmoid(gate_logits.float())
            out = (out.unflatten(-1, (heads, dh)) * gate[..., None]).flatten(-2)
        return out.to(q.dtype)

    fold_gate = exists(gate_logits) and dh in SUPPORTED_DIM_HEAD and not laser
    if dh in SUPPORTED_DIM_HEAD:
        dropping = dropout_rate > 0.0 and exists(dropout_seed)
        out = flash_attention_packed(
            q, k, v.to(q.dtype), mask, heads=heads, scale=scale,
            softclamp_value=softclamp_value, dropout_rate=dropout_rate if dropping else 0.0,
            dropout_seed=dropout_seed if dropping else 0,
            gate_logits=gate_logits if fold_gate else None, hash_b0=hash_b0, hash_h0=hash_h0,
            hash_heads=hash_heads)
    else:
        to_bhnd = lambda t: t.unflatten(-1, (heads, dh)).transpose(1, 2)
        out = attention(to_bhnd(q), to_bhnd(k), to_bhnd(v), mask, scale=scale,
                        softclamp_value=softclamp_value, dropout_rate=dropout_rate,
                        dropout_seed=dropout_seed, hash_b0=hash_b0, hash_h0=hash_h0,
                        hash_heads=hash_heads)
        out = out.transpose(1, 2).reshape(b, n, D)

    if laser:
        out = _laser_log(out)
    if exists(gate_logits) and not fold_gate:
        gate = torch.sigmoid(gate_logits).to(out.dtype)
        out = (out.unflatten(-1, (heads, dh)) * gate[..., None]).flatten(-2)
    return out.to(q.dtype)
