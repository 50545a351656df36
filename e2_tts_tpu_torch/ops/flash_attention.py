"""K1, K2 and K10: packed flash attention, forward and backward (counterpart
of e2_tts_tpu/ops/flash_attention.py::flash_attention_packed).

K1 replaces the TPU kernel ``_packed_fwd_kernel`` (driven by
``_flash_packed_forward``), K2 the TPU kernel ``_packed_bwd_kernel`` (driven
by ``_flash_packed_backward``), K10 the TPU kernel ``_delta_kernel`` (driven
by ``_delta_bnh_pallas``), K2's pre-pass. The CUDA kernels are
``csrc/flash_attention.cu`` (K1) and ``csrc/flash_attention_bwd.cu`` (K2,
K10); their source notes say what bounds them on the H100 and how their
designs answer.
In short: tensor-core bound at the model's shapes; score tiles stay in
shared memory, the products run on the tensor cores (wmma, bf16 in / f32
accumulate). `_FlashPacked` ties the two together as one
``torch.autograd.Function``.

Semantics, on the packed ``(b, n, h*dh)`` projection layout:
tanh softclamp of the scaled logits, key-padding bias 0 / -1e30, softmax,
post-softmax counter-hash dropout (bits identical to the JAX package's
``_keep_tile``), optional per-head sigmoid output gate; also returns the
per-row log-sum-exp ``(b*h, n)`` the backward uses. The backward takes
``delta = rowsum(do * o)`` per head from K10, launched just before K2 on
the same stream, and returns the gate-logit grad
``delta * (1 - sigmoid(gate))``.

`flash_attention_packed`, `flash_attention_packed_backward` and
`flash_delta` take the plain PyTorch versions for CPU tensors (tests) and
launch the kernels for CUDA tensors; there is no other route.
"""

from __future__ import annotations

import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops.dropout import fmix32, keep_threshold, mul32
from e2_tts_tpu_torch.utils.helpers import default, exists

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
SUPPORTED_DIM_HEAD = (32, 64, 128)


def dropout_keep_mask(seed: int, bh_total: int, n: int, rate: float,
                      device=None) -> torch.Tensor:
    """Full (bh, n, n) keep mask: the bits the kernel draws for global head
    ``bh = batch * heads + head``, absolute query row and key column."""
    bhs = torch.arange(bh_total, dtype=torch.int64, device=device)[:, None, None]
    rows = torch.arange(n, dtype=torch.int64, device=device)[None, :, None]
    cols = torch.arange(n, dtype=torch.int64, device=device)[None, None, :]
    h = fmix32((int(seed) & _M32) ^ mul32(bhs, 0x27D4EB2F))
    u = fmix32((h + mul32(rows, 0x9E3779B1) + mul32(cols, 0x85EBCA77)) & _M32,
               rounds=1)
    return u >= keep_threshold(rate)


def flash_attention_packed_plain(q, k, v, mask=None, *, heads, scale,
                                 softclamp_value=None, dropout_rate=0.0,
                                 dropout_seed=0, gate_logits=None):
    """Plain PyTorch version of K1 (f32 math): returns (out, lse)."""
    b, n, D = q.shape
    dh = D // heads
    split = lambda t: t.reshape(b, n, heads, dh).permute(0, 2, 1, 3).float()
    qf, kf, vf = split(q), split(k), split(v)

    s = torch.einsum('bhid,bhjd->bhij', qf, kf) * scale
    if exists(softclamp_value):
        s = torch.tanh(s / softclamp_value) * softclamp_value
    if exists(mask):
        s = s + torch.where(mask, 0.0, NEG_INF).float()[:, None, None, :]

    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    lse = (m + torch.log(l)).reshape(b * heads, n)
    p = p / l
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, b * heads, n, dropout_rate,
                                 device=q.device).view(b, heads, n, n)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)

    o = p @ vf                                              # (b, h, n, dh)
    if exists(gate_logits):
        o = o * torch.sigmoid(gate_logits.float()).permute(0, 2, 1)[..., None]
    return o.permute(0, 2, 1, 3).reshape(b, n, D).to(q.dtype), lse


def flash_delta_plain(out, dout, heads):
    """Plain PyTorch version of K10: ``rowsum(dout * out)`` per head, f32
    ``(b, n, heads)``."""
    b, n, D = out.shape
    return (dout.float() * out.float()).view(b, n, heads, D // heads).sum(-1)


def _flash_delta_cuda(out, dout, heads):
    b, n, D = out.shape
    device, dtype = out.device, out.dtype
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'flash_delta takes bf16 or f32, got {dtype}')
    for t, name in ((out, 'out'), (dout, 'dout')):
        _cuda.check_cuda_tensor(t, name, device, dtype)
        if tuple(t.shape) != (b, n, D) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be a contiguous, 16-byte aligned {(b, n, D)} '
                             f'tensor, got shape {tuple(t.shape)} strides {t.stride()}')
    delta = torch.empty((b, n, heads), dtype=torch.float32, device=device)
    err = _cuda.lib().e2_flash_delta(out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                                     b * n, heads, D // heads, _cuda.DTYPE_CODES[dtype],
                                     _cuda.stream_ptr(device))
    _cuda.check(err, 'flash_delta')
    _cuda.count_launch('flash_delta')
    return delta


def flash_delta(out, dout, *, heads: int):
    """K10 alone: ``delta = rowsum(dout * out)`` per head of the packed
    ``(b, n, heads*dh)`` layout, f32 ``(b, n, heads)``."""
    if out.device.type == 'cpu':
        return flash_delta_plain(out, dout, heads)
    return _flash_delta_cuda(out, dout, heads)


def flash_attention_packed_backward_plain(q, k, v, mask, out, lse, dout, *, heads, scale,
                                          softclamp_value=None, dropout_rate=0.0,
                                          dropout_seed=0, gate_logits=None):
    """Plain PyTorch version of K2 (f32 math, the compute dtype's rounding
    where the TPU kernel rounds): returns ``(dq, dk, dv, d_gate_logits)``,
    the last None without a gate."""
    b, n, D = q.shape
    dh = D // heads
    dt = q.dtype
    split = lambda t: t.reshape(b, n, heads, dh).permute(0, 2, 1, 3).float()
    qf, kf, vf = split(q), split(k), split(v)

    gv = None
    do = dout
    if exists(gate_logits):
        gv = torch.sigmoid(gate_logits.float())                       # (b, n, h)
        do = (dout.float() * gv.repeat_interleave(dh, dim=-1)).to(dt)
    dof = split(do)
    delta = flash_delta_plain(out, dout, heads)                        # (b, n, h)
    delta_col = delta.permute(0, 2, 1)[..., None]                     # (b, h, n, 1)

    s = torch.einsum('bhid,bhjd->bhij', qf, kf) * scale
    jac = None
    if exists(softclamp_value):
        th = torch.tanh(s / softclamp_value)
        s = th * softclamp_value
        jac = 1.0 - th * th
    if exists(mask):
        s = s + torch.where(mask, 0.0, NEG_INF).float()[:, None, None, :]
    p = torch.exp(s - lse.view(b, heads, n, 1))
    dp = dof @ vf.transpose(-1, -2)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, b * heads, n, dropout_rate,
                                 device=q.device).view(b, heads, n, n)
        keep_scaled = keep.float() * (1.0 / (1.0 - dropout_rate))
        ds = p * (keep_scaled * dp - delta_col)
        p = p * keep_scaled
    else:
        ds = p * (dp - delta_col)
    if exists(jac):
        ds = ds * jac
    ds = ds * scale
    p = p.to(dt).float()
    ds = ds.to(dt).float()

    dv = p.transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf
    dq = ds @ kf
    merge = lambda t: t.permute(0, 2, 1, 3).reshape(b, n, D).to(dt)
    dgate = (delta * (1.0 - gv)).to(gate_logits.dtype) if exists(gv) else None
    return merge(dq), merge(dk), merge(dv), dgate


def _check_operand(t, name, shape, device, dtype, vec):
    _cuda.check_cuda_tensor(t, name, device, dtype)
    if tuple(t.shape) != shape:
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    if t.stride(-1) != 1 or t.stride(0) % vec or t.stride(1) % vec \
            or t.data_ptr() % 16:
        raise ValueError(
            f'{name} must have a unit last stride, batch and row strides that '
            f'are multiples of {vec} elements and a 16-byte aligned start; got '
            f'strides {t.stride()}')


def _check_inputs(q, k, v, mask, gate_logits, heads):
    """What K1 and K2 take: q, k, v as (strided) bf16 / f32 projections, a
    contiguous (b, n) bool mask, contiguous (b, n, heads) gate logits."""
    b, n, D = q.shape
    dh = D // heads
    device, dtype = q.device, q.dtype
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'flash attention takes bf16 or f32, got {dtype}')
    if dh not in SUPPORTED_DIM_HEAD or D != heads * dh:
        raise ValueError(f'dim_head must be one of {SUPPORTED_DIM_HEAD}, got {D}/{heads}')
    vec = 16 // q.element_size()
    for t, name in ((q, 'q'), (k, 'k'), (v, 'v')):
        _check_operand(t, name, (b, n, D), device, dtype, vec)
    if exists(mask):
        _cuda.check_cuda_tensor(mask, 'mask', device, torch.bool)
        if tuple(mask.shape) != (b, n) or not mask.is_contiguous():
            raise ValueError('mask must be a contiguous (b, n) bool tensor')
    if exists(gate_logits):
        _cuda.check_cuda_tensor(gate_logits, 'gate_logits', device, dtype)
        if tuple(gate_logits.shape) != (b, n, heads) or not gate_logits.is_contiguous():
            raise ValueError('gate_logits must be a contiguous (b, n, heads) tensor')
    return b, n, D, dh


def _flash_cuda(q, k, v, mask, heads, scale, softclamp_value, dropout_rate,
                dropout_seed, gate_logits):
    b, n, D, dh = _check_inputs(q, k, v, mask, gate_logits, heads)
    device, dtype = q.device, q.dtype
    out = torch.empty((b, n, D), dtype=dtype, device=device)
    lse = torch.empty((b * heads, n), dtype=torch.float32, device=device)
    dropping = dropout_rate > 0.0
    err = _cuda.lib().e2_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        mask.data_ptr() if exists(mask) else None,
        gate_logits.data_ptr() if exists(gate_logits) else None,
        out.data_ptr(), lse.data_ptr(), b, n, heads, dh, float(scale),
        float(softclamp_value) if exists(softclamp_value) else 0.0,
        1.0 / (1.0 - dropout_rate) if dropping else 1.0,
        int(dropout_seed) & _M32, keep_threshold(dropout_rate), int(dropping),
        _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    _cuda.check(err, 'flash_fwd')
    _cuda.count_launch('flash_fwd')
    return out, lse


def _flash_bwd_cuda(q, k, v, mask, out, lse, dout, heads, scale, softclamp_value,
                    dropout_rate, dropout_seed, gate_logits):
    b, n, D, dh = _check_inputs(q, k, v, mask, gate_logits, heads)
    device, dtype = q.device, q.dtype
    for t, name in ((out, 'out'), (dout, 'dout')):
        _cuda.check_cuda_tensor(t, name, device, dtype)
        if tuple(t.shape) != (b, n, D):
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {(b, n, D)}')
    dout = dout.contiguous()
    _cuda.check_cuda_tensor(lse, 'lse', device, torch.float32)
    if tuple(lse.shape) != (b * heads, n) or not lse.is_contiguous():
        raise ValueError('lse must be a contiguous (b * heads, n) f32 tensor')

    delta = _flash_delta_cuda(out, dout, heads)           # K10, same stream
    dq = torch.zeros((b, n, D), dtype=torch.float32, device=device)
    dk = torch.empty((b, n, D), dtype=dtype, device=device)
    dv = torch.empty((b, n, D), dtype=dtype, device=device)
    dropping = dropout_rate > 0.0
    err = _cuda.lib().e2_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        dout.data_ptr(), mask.data_ptr() if exists(mask) else None,
        gate_logits.data_ptr() if exists(gate_logits) else None,
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, n, heads, dh, float(scale),
        float(softclamp_value) if exists(softclamp_value) else 0.0,
        1.0 / (1.0 - dropout_rate) if dropping else 1.0,
        int(dropout_seed) & _M32, keep_threshold(dropout_rate), int(dropping),
        _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    _cuda.check(err, 'flash_bwd')
    _cuda.count_launch('flash_bwd')
    dgate = None
    if exists(gate_logits):
        dgate = (delta * (1.0 - torch.sigmoid(gate_logits.float()))).to(gate_logits.dtype)
    return dq.to(dtype), dk, dv, dgate


def _check_rate(dropout_rate):
    dropout_rate = float(dropout_rate)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f'dropout rate must be in [0, 1), got {dropout_rate}')
    return dropout_rate


def flash_attention_packed_backward(q, k, v, mask, out, lse, dout, *, heads: int,
                                    scale=None, softclamp_value=None,
                                    dropout_rate: float = 0.0, dropout_seed: int = 0,
                                    gate_logits=None):
    """K2 alone (the counterpart of ``_flash_packed_backward`` with the gate
    grad of ``_flash_packed_gated_bwd``): from the forward's inputs, its
    output ``out``, its ``lse`` and the output grad ``dout``, returns
    ``(dq, dk, dv, d_gate_logits)`` (the last None without a gate)."""
    scale = default(scale, (q.shape[-1] // heads) ** -0.5)
    dropout_rate = _check_rate(dropout_rate)
    if q.device.type == 'cpu':
        return flash_attention_packed_backward_plain(
            q, k, v, mask, out, lse, dout, heads=heads, scale=scale,
            softclamp_value=softclamp_value, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, gate_logits=gate_logits)
    return _flash_bwd_cuda(q, k, v, mask, out, lse, dout, heads, scale, softclamp_value,
                           dropout_rate, dropout_seed, gate_logits)


def _flash_forward(q, k, v, mask, heads, scale, softclamp_value, dropout_rate,
                   dropout_seed, gate_logits):
    if q.device.type == 'cpu':
        return flash_attention_packed_plain(
            q, k, v, mask, heads=heads, scale=scale,
            softclamp_value=softclamp_value, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, gate_logits=gate_logits)
    return _flash_cuda(q, k, v, mask, heads, scale, softclamp_value,
                       dropout_rate, dropout_seed, gate_logits)


class _FlashPacked(torch.autograd.Function):
    """K1 forward, K2 backward. Saves q, k, v (as given: views of the qkv
    projection stay views), the mask, the gate logits, the output and K1's
    lse; the dropout bits are regenerated from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, mask, gate_logits, heads, scale, softclamp_value,
                dropout_rate, dropout_seed):
        out, lse = _flash_forward(q, k, v, mask, heads, scale, softclamp_value,
                                  dropout_rate, dropout_seed, gate_logits)
        ctx.save_for_backward(q, k, v, mask, gate_logits, out, lse)
        ctx.config = (heads, scale, softclamp_value, dropout_rate, dropout_seed)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, gate_logits, out, lse = ctx.saved_tensors
        heads, scale, softclamp_value, dropout_rate, dropout_seed = ctx.config
        dq, dk, dv, dgate = flash_attention_packed_backward(
            q, k, v, mask, out, lse, dout, heads=heads, scale=scale,
            softclamp_value=softclamp_value, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, gate_logits=gate_logits)
        return dq, dk, dv, None, dgate, None, None, None, None, None


def flash_attention_packed(q, k, v, mask=None, *, heads: int, scale=None,
                           softclamp_value=None, dropout_rate: float = 0.0,
                           dropout_seed: int = 0, gate_logits=None,
                           return_lse: bool = False):
    """Attention on projection-layout ``q, k, v (b, n, h*dh)`` with a key
    padding ``mask (b, n)`` (True = attend) and optional per-head output
    gate logits ``(b, n, h)``. Returns ``out`` (and ``lse`` if asked);
    differentiable in q, k, v and the gate logits (backward: K2)."""
    b, n, D = q.shape
    dh = D // heads
    scale = default(scale, dh ** -0.5)
    dropout_rate = _check_rate(dropout_rate)
    out, lse = _FlashPacked.apply(q, k, v, mask, gate_logits, heads, scale,
                                  softclamp_value, dropout_rate, dropout_seed)
    return (out, lse) if return_lse else out
