"""Flash attention, forward and backward: K1, K2 and K10 on the packed
``(b, n, h*dh)`` projection layout (counterpart of
e2_tts_tpu/ops/flash_attention.py::flash_attention_packed), K8 and K9 on
``(b, h, n, dh)`` operands (counterpart of ``flash_attention``), and the
cost-floor probe.

K1 replaces the TPU kernel ``_packed_fwd_kernel`` (driven by
``_flash_packed_forward``), K2 the TPU kernel ``_packed_bwd_kernel`` (driven
by ``_flash_packed_backward``), K10 the TPU kernel ``_delta_kernel`` (driven
by ``_delta_bnh_pallas``), K2's pre-pass. K8 replaces ``_fwd_kernel``
(``_flash_forward``), K9 the backward kernels of ``_flash_backward``, the
probe ``scripts/_kernel_floor.py::kern``. The CUDA kernels are
``csrc/flash_attention.cu`` (K1), ``csrc/flash_attention_bwd.cu`` (K2, K10),
``csrc/flash_attention_bhnd.cu`` (K8, K9) and ``csrc/flash_probe.cu`` (the
probe). The source notes say what bounds them on the H100 and how their
designs answer. In short: tensor-core bound over the model's long
sequences, bytes across a few tokens. K1 / K2 have two designs and one rule
between them, a comparison in their C entry points: a sequence of at most
``N_SHORT`` tokens (``csrc/flash_attention_short.cuh``; the frequency
attention's f tokens) runs the few-token design of that header, bf16 or
f32 (a group of lanes a (sequence, head) pair, many pairs a block, every
score, probability and product in f32 on the CUDA cores, any view of the
projection); a longer one runs the tiled designs. Of those, bf16 K1/K2 and
bf16 K8/K9 on heads up to 128 run the Hopper design of
``csrc/flash_attention_sm90.cuh`` (wgmma products on register-resident
scores, cp.async tile rings, dq by vector reductions), and the probe is
that design's forward with its probe flag (K8 with the softmax's pieces
compiled out); f32 and K8/K9 on heads wider than 128 run the wmma
templates of ``csrc/flash_attention.cuh`` (score tiles in shared memory).
The C entry points choose the design from the length, the dtype and
dim_head; no argument or setting does.
`_FlashPacked` (K1 + K2) and `_Flash` (K8 + K9) are the
``torch.autograd.Function`` s.

Semantics: tanh softclamp of the scaled logits, key-padding bias 0 / -1e30,
softmax, post-softmax counter-hash dropout (bits identical to the JAX
package's ``_keep_tile`` for the global head ``(hash_b0 + b) * hash_heads +
hash_h0 + h``: ``hash_b0``, default 0, is the first row's place in the global
batch, so a data-parallel rank holding rows ``[b0, b0 + B/P)`` passes ``b0``
and draws the bits a single device draws for those rows; ``hash_h0``, default
0, is the first head's place among the ``hash_heads`` heads of a row
(default: the launch's own), so a tensor-parallel rank holding heads ``[h0,
h0 + H/T)`` passes ``h0`` and ``H``; ``hash_r0`` / ``hash_c0``, default 0,
are the first query row's and key column's places in the global sequence,
so a ring block of sequence-parallel attention (parallel/sp.py) draws the
bits one launch over the whole sequence draws for those rows and columns:
the row and column enter the hash linearly, so the kernels take them as
one uint32 added to each head's seed; they move no memory); K1 also the
optional per-head sigmoid output gate. The forward also returns the
per-row log-sum-exp ``(b*h, n)`` the backward uses. K2 takes
``delta = rowsum(do * o)`` per head from K10, launched just before K2 on the
same stream, which for a gated layer also writes ``do_g = do *
sigmoid(gate)`` in the compute dtype for K2 to read as its output grad; the
wrapper returns the gate-logit grad ``delta * (1 - sigmoid(gate))``;
K9 takes delta from a plain PyTorch sum, as the JAX package takes it from
XLA. K1/K2 take dim_head 32, 64 or 128; K8/K9 any dim_head from 1 to 256:
the kernels take multiples of 8 (a head wider than 128 as two column
chunks), and the wrappers zero-pad any other head to the next multiple of 8
(zero columns add nothing to q k^T; the padded output columns are dropped)
and launch the same kernels with the caller's scale. The probe takes
multiples of 8 up to 128.

Every wrapper takes its plain PyTorch version for CPU tensors (tests) and
launches its kernel for CUDA tensors; there is no other route.
"""

from __future__ import annotations


import torch

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops.dropout import fmix32, keep_threshold, mul32
from e2_tts_tpu_torch.utils.helpers import default, exists

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
SUPPORTED_DIM_HEAD = (32, 64, 128)      # K1 / K2
MAX_DIM_HEAD_BHND = 256                 # K8 / K9: any dim_head up to this
MAX_DIM_HEAD_PROBE = 128                # the probe: multiples of 8 up to this


def dropout_keep_mask(seed: int, bh_total: int, n: int, rate: float, device=None, *,
                      hash_b0: int = 0, heads: int = 1, hash_h0: int = 0,
                      hash_heads: int | None = None, hash_r0: int = 0,
                      hash_c0: int = 0) -> torch.Tensor:
    """Full (bh, n, n) keep mask: the bits the kernel draws for global head
    ``(hash_b0 + batch) * hash_heads + hash_h0 + head`` (``bh = batch * heads
    + head``; ``hash_heads`` defaults to ``heads``), global query row
    ``hash_r0 + row`` and key column ``hash_c0 + column``."""
    hash_heads = default(hash_heads, heads)
    bh = torch.arange(bh_total, dtype=torch.int64, device=device)
    bhs = ((bh // heads + int(hash_b0)) * hash_heads + int(hash_h0) + bh % heads)[:, None, None]
    rows = torch.arange(n, dtype=torch.int64, device=device)[None, :, None] + int(hash_r0)
    cols = torch.arange(n, dtype=torch.int64, device=device)[None, None, :] + int(hash_c0)
    h = fmix32((int(seed) & _M32) ^ mul32(bhs, 0x27D4EB2F))
    u = fmix32((h + mul32(rows, 0x9E3779B1) + mul32(cols, 0x85EBCA77)) & _M32,
               rounds=1)
    return u >= keep_threshold(rate)


def _forward_core_plain(qf, kf, vf, mask, scale, softclamp_value, dropout_rate,
                        dropout_seed, hash_kw):
    """f32 ``(b, h, n, dh)`` q, k, v -> f32 ``o (b, h, n, dh)`` and ``lse
    (b*h, n)``: the arithmetic K1 and K8 share."""
    b, h, n, _ = qf.shape
    s = torch.einsum('bhid,bhjd->bhij', qf, kf) * scale
    if exists(softclamp_value):
        s = torch.tanh(s / softclamp_value) * softclamp_value
    if exists(mask):
        s = s + torch.where(mask, 0.0, NEG_INF).float()[:, None, None, :]

    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    lse = (m + torch.log(l)).reshape(b * h, n)
    p = p / l
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, b * h, n, dropout_rate, device=qf.device,
                                 heads=h, **hash_kw).view(b, h, n, n)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    return p @ vf, lse


def _split_heads(t, heads):
    """Packed ``(b, n, h*dh)`` -> f32 ``(b, h, n, dh)``."""
    b, n, D = t.shape
    return t.reshape(b, n, heads, D // heads).permute(0, 2, 1, 3).float()


def _merge_heads(t):
    b, h, n, dh = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, n, h * dh)


def flash_attention_packed_plain(q, k, v, mask=None, *, heads, scale,
                                 softclamp_value=None, dropout_rate=0.0,
                                 dropout_seed=0, gate_logits=None, hash_b0=0, hash_h0=0,
                                 hash_heads=None, hash_r0=0, hash_c0=0):
    """Plain PyTorch version of K1 (f32 math): returns (out, lse)."""
    o, lse = _forward_core_plain(
        _split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads), mask,
        scale, softclamp_value, dropout_rate, dropout_seed,
        dict(hash_b0=hash_b0, hash_h0=hash_h0, hash_heads=hash_heads, hash_r0=hash_r0,
             hash_c0=hash_c0))
    if exists(gate_logits):
        o = o * torch.sigmoid(gate_logits.float()).permute(0, 2, 1)[..., None]
    return _merge_heads(o).to(q.dtype), lse


def flash_attention_plain(q, k, v, mask=None, *, scale, softclamp_value=None,
                          dropout_rate=0.0, dropout_seed=0, hash_b0=0, hash_h0=0,
                          hash_heads=None, hash_r0=0, hash_c0=0):
    """Plain PyTorch version of K8 (f32 math) on ``(b, h, n, dh)``: returns
    (out, lse)."""
    o, lse = _forward_core_plain(q.float(), k.float(), v.float(), mask, scale,
                                 softclamp_value, dropout_rate, dropout_seed,
                                 dict(hash_b0=hash_b0, hash_h0=hash_h0, hash_heads=hash_heads,
                                      hash_r0=hash_r0, hash_c0=hash_c0))
    return o.to(q.dtype), lse


def flash_delta_plain(out, dout, heads, gate_logits=None):
    """Plain PyTorch version of K10: returns ``(delta, do_g)``, ``delta =
    rowsum(dout * out)`` per head, f32 ``(b, n, heads)``, and ``do_g = dout
    * sigmoid(gate)`` rounded to dout's dtype for ``gate_logits (b, n,
    heads)``, dout itself without them. delta takes the ungated dout either
    way (it is gate-invariant: rowsum(do * o) = rowsum(do_g * o / g))."""
    b, n, D = out.shape
    delta = (dout.float() * out.float()).view(b, n, heads, D // heads).sum(-1)
    if not exists(gate_logits):
        return delta, dout
    g = torch.sigmoid(gate_logits.float()).repeat_interleave(D // heads, dim=-1)
    return delta, (dout.float() * g).to(dout.dtype)


def _flash_delta_cuda(out, dout, heads, gate_logits=None):
    b, n, D = out.shape
    device, dtype = out.device, out.dtype
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'flash_delta takes bf16 or f32, got {dtype}')
    for t, name in ((out, 'out'), (dout, 'dout')):
        _cuda.check_cuda_tensor(t, name, device, dtype)
        if tuple(t.shape) != (b, n, D) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be a contiguous, 16-byte aligned {(b, n, D)} '
                             f'tensor, got shape {tuple(t.shape)} strides {t.stride()}')
    do_g = None
    if exists(gate_logits):
        _cuda.check_cuda_tensor(gate_logits, 'gate_logits', device, dtype)
        if tuple(gate_logits.shape) != (b, n, heads) or not gate_logits.is_contiguous():
            raise ValueError('gate_logits must be a contiguous (b, n, heads) tensor')
        do_g = torch.empty((b, n, D), dtype=dtype, device=device)
    delta = torch.empty((b, n, heads), dtype=torch.float32, device=device)
    err = _cuda.lib().e2_flash_delta(
        out.data_ptr(), dout.data_ptr(), gate_logits.data_ptr() if exists(gate_logits) else None,
        do_g.data_ptr() if exists(do_g) else None, delta.data_ptr(), b * n, heads, D // heads,
        _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    _cuda.check(err, 'flash_delta')
    _cuda.count_launch('flash_delta')
    return delta, (dout if do_g is None else do_g)


def flash_delta(out, dout, *, heads: int, gate_logits=None):
    """K10 alone on the packed ``(b, n, heads*dh)`` layout: returns ``(delta,
    do_g)``, delta ``rowsum(dout * out)`` per head, f32 ``(b, n, heads)``,
    do_g ``dout * sigmoid(gate)`` in dout's dtype with ``gate_logits``, dout
    itself without them (no buffer written; see `flash_delta_plain`)."""
    if out.device.type == 'cpu':
        return flash_delta_plain(out, dout, heads, gate_logits)
    return _flash_delta_cuda(out, dout, heads, gate_logits)


def _backward_core_plain(qf, kf, vf, dof, delta, mask, lse, dt, scale, softclamp_value,
                         dropout_rate, dropout_seed, hash_kw):
    """f32 ``(b, h, n, dh)`` q, k, v, do and ``delta (b, h, n)`` -> f32 dq,
    dk, dv: the arithmetic K2 and K9 share, with the compute dtype ``dt``'s
    rounding where the TPU kernels round."""
    b, h, n, _ = qf.shape
    delta_col = delta[..., None]                                       # (b, h, n, 1)
    s = torch.einsum('bhid,bhjd->bhij', qf, kf) * scale
    jac = None
    if exists(softclamp_value):
        th = torch.tanh(s / softclamp_value)
        s = th * softclamp_value
        jac = 1.0 - th * th
    if exists(mask):
        s = s + torch.where(mask, 0.0, NEG_INF).float()[:, None, None, :]
    p = torch.exp(s - lse.view(b, h, n, 1))
    dp = dof @ vf.transpose(-1, -2)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(dropout_seed, b * h, n, dropout_rate, device=qf.device,
                                 heads=h, **hash_kw).view(b, h, n, n)
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
    return ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof


def flash_attention_packed_backward_plain(q, k, v, mask, out, lse, dout, *, heads, scale,
                                          softclamp_value=None, dropout_rate=0.0,
                                          dropout_seed=0, gate_logits=None, hash_b0=0,
                                          hash_h0=0, hash_heads=None, hash_r0=0, hash_c0=0):
    """Plain PyTorch version of K2 (f32 math, the compute dtype's rounding
    where the TPU kernel rounds): returns ``(dq, dk, dv, d_gate_logits)``,
    the last None without a gate."""
    dt = q.dtype
    delta, do = flash_delta_plain(out, dout, heads, gate_logits)       # K10: (b, n, h)
    grads = _backward_core_plain(
        _split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads),
        _split_heads(do, heads), delta.permute(0, 2, 1), mask, lse, dt, scale,
        softclamp_value, dropout_rate, dropout_seed,
        dict(hash_b0=hash_b0, hash_h0=hash_h0, hash_heads=hash_heads, hash_r0=hash_r0,
             hash_c0=hash_c0))
    dq, dk, dv = (_merge_heads(g).to(dt) for g in grads)
    return dq, dk, dv, _gate_grad(delta, gate_logits)


def _gate_grad(delta, gate_logits):
    """The gate-logit grad ``delta * (1 - sigmoid(gate))`` (None without a
    gate), outside the kernels as the JAX package computes it."""
    if not exists(gate_logits):
        return None
    return (delta * (1.0 - torch.sigmoid(gate_logits.float()))).to(gate_logits.dtype)


def flash_attention_backward_plain(q, k, v, mask, out, lse, dout, *, scale,
                                   softclamp_value=None, dropout_rate=0.0, dropout_seed=0,
                                   hash_b0=0, hash_h0=0, hash_heads=None, hash_r0=0,
                                   hash_c0=0):
    """Plain PyTorch version of K9 on ``(b, h, n, dh)``, with K9's delta =
    rowsum(dout * out) (f32): returns ``(dq, dk, dv)``."""
    delta = (dout.float() * out.float()).sum(-1)                      # (b, h, n)
    grads = _backward_core_plain(q.float(), k.float(), v.float(), dout.float(), delta,
                                 mask, lse, q.dtype, scale, softclamp_value, dropout_rate,
                                 dropout_seed, dict(hash_b0=hash_b0, hash_h0=hash_h0,
                                                    hash_heads=hash_heads, hash_r0=hash_r0,
                                                    hash_c0=hash_c0))
    return tuple(g.to(q.dtype) for g in grads)


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


# the dropout hash's place of a launch that is the whole batch, every head and
# the whole sequence
_NO_OFFSET = dict(hash_b0=0, hash_h0=0, hash_heads=None, hash_r0=0, hash_c0=0)


def hash_rc(hash_r0: int, hash_c0: int) -> int:
    """The uint32 the kernels add to each head's seed for a launch whose
    first query row and key column are ``hash_r0`` and ``hash_c0`` of the
    global sequence: the hash reads ``seed + row * 0x9E3779B1 + col *
    0x85EBCA77`` (mod 2**32), linear in both."""
    return (int(hash_r0) * 0x9E3779B1 + int(hash_c0) * 0x85EBCA77) & _M32


def _hash_ints(hash_kw, heads):
    """``hash_kw`` (`_check_hash`'s) as the four values the C entry points
    take: ``hash_b0``, ``hash_h0``, ``hash_heads`` (None: the launch's
    ``heads``) and `hash_rc`."""
    return (int(hash_kw['hash_b0']), int(hash_kw['hash_h0']),
            int(default(hash_kw['hash_heads'], heads)),
            hash_rc(hash_kw['hash_r0'], hash_kw['hash_c0']))


def _flash_cuda(q, k, v, mask, heads, scale, softclamp_value, dropout_rate,
                dropout_seed, gate_logits, hash_kw=_NO_OFFSET):
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
        *_hash_ints(hash_kw, heads), _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    _cuda.check(err, 'flash_fwd')
    _cuda.count_launch('flash_fwd')
    return out, lse


def _flash_bwd_cuda(q, k, v, mask, out, lse, dout, heads, scale, softclamp_value,
                    dropout_rate, dropout_seed, gate_logits, hash_kw=_NO_OFFSET):
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

    # K10, same stream; a gated layer's K2 reads K10's do_g as its do
    delta, dout = _flash_delta_cuda(out, dout, heads, gate_logits)
    dq = torch.zeros((b, n, D), dtype=torch.float32, device=device)
    dk = torch.empty((b, n, D), dtype=dtype, device=device)
    dv = torch.empty((b, n, D), dtype=dtype, device=device)
    launch_bwd(q, k, v, dout, mask, lse, delta, dq, dk, dv, heads, scale, softclamp_value,
               dropout_rate, dropout_seed, hash_kw)
    return dq.to(dtype), dk, dv, _gate_grad(delta, gate_logits)


def launch_bwd(q, k, v, dout, mask, lse, delta, dq, dk, dv, heads, scale, softclamp_value,
               dropout_rate, dropout_seed, hash_kw=_NO_OFFSET):
    """K2's launch alone, on checked operands: ``dout`` contiguous (K10's
    do_g for a gated layer), ``delta (b, n, heads)`` f32, ``dq`` a
    contiguous f32 ``(b, n, h*dh)`` buffer K2 adds to (atomically: zeroed
    for one launch, a running sum over a ring's blocks), ``dk`` / ``dv``
    contiguous, written."""
    b, n, D = q.shape
    dropping = dropout_rate > 0.0
    err = _cuda.lib().e2_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        dout.data_ptr(), mask.data_ptr() if exists(mask) else None,
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, n, heads, D // heads, float(scale),
        float(softclamp_value) if exists(softclamp_value) else 0.0,
        1.0 / (1.0 - dropout_rate) if dropping else 1.0,
        int(dropout_seed) & _M32, keep_threshold(dropout_rate), int(dropping),
        *_hash_ints(hash_kw, heads), _cuda.DTYPE_CODES[q.dtype], _cuda.stream_ptr(q.device))
    _cuda.check(err, 'flash_bwd')
    _cuda.count_launch('flash_bwd')


def _check_rate(dropout_rate):
    dropout_rate = float(dropout_rate)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f'dropout rate must be in [0, 1), got {dropout_rate}')
    return dropout_rate


def _check_offset(value, name):
    if int(value) != value or not 0 <= value < 2 ** 31:
        raise ValueError(f'{name} must be an int in [0, 2**31), got {value}')
    return int(value)


def _check_hash(hash_b0, hash_h0, hash_heads, heads, hash_r0=0, hash_c0=0):
    """``(hash_b0, hash_h0, hash_heads, hash_r0, hash_c0)`` checked: a
    launch's ``heads`` heads from ``hash_h0`` must lie among a row's
    ``hash_heads`` (default ``heads``), the offsets ints in [0, 2**31);
    returned as the keyword arguments the plain versions take."""
    hash_heads = default(hash_heads, heads)
    if int(hash_h0) != hash_h0 or int(hash_heads) != hash_heads \
            or not 0 <= hash_h0 <= hash_heads - heads:
        raise ValueError(f'heads [hash_h0, hash_h0 + heads) = [{hash_h0}, {hash_h0 + heads}) '
                         f'must lie in [0, hash_heads = {hash_heads})')
    return dict(hash_b0=_check_offset(hash_b0, 'hash_b0'), hash_h0=int(hash_h0),
                hash_heads=int(hash_heads), hash_r0=_check_offset(hash_r0, 'hash_r0'),
                hash_c0=_check_offset(hash_c0, 'hash_c0'))


def flash_attention_packed_backward(q, k, v, mask, out, lse, dout, *, heads: int,
                                    scale=None, softclamp_value=None,
                                    dropout_rate: float = 0.0, dropout_seed: int = 0,
                                    gate_logits=None, hash_b0: int = 0, hash_h0: int = 0,
                                    hash_heads: int | None = None, hash_r0: int = 0,
                                    hash_c0: int = 0):
    """K2 alone (the counterpart of ``_flash_packed_backward`` with the gate
    grad of ``_flash_packed_gated_bwd``): from the forward's inputs, its
    output ``out``, its ``lse`` and the output grad ``dout``, returns
    ``(dq, dk, dv, d_gate_logits)`` (the last None without a gate)."""
    scale = default(scale, (q.shape[-1] // heads) ** -0.5)
    dropout_rate = _check_rate(dropout_rate)
    hash_kw = _check_hash(hash_b0, hash_h0, hash_heads, heads, hash_r0, hash_c0)
    if q.device.type == 'cpu':
        return flash_attention_packed_backward_plain(
            q, k, v, mask, out, lse, dout, heads=heads, scale=scale,
            softclamp_value=softclamp_value, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, gate_logits=gate_logits, **hash_kw)
    return _flash_bwd_cuda(q, k, v, mask, out, lse, dout, heads, scale, softclamp_value,
                           dropout_rate, dropout_seed, gate_logits, hash_kw)


def _flash_forward(q, k, v, mask, heads, scale, softclamp_value, dropout_rate,
                   dropout_seed, gate_logits, hash_kw):
    if q.device.type == 'cpu':
        return flash_attention_packed_plain(
            q, k, v, mask, heads=heads, scale=scale,
            softclamp_value=softclamp_value, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, gate_logits=gate_logits, **hash_kw)
    return _flash_cuda(q, k, v, mask, heads, scale, softclamp_value,
                       dropout_rate, dropout_seed, gate_logits, hash_kw)


class _FlashPacked(torch.autograd.Function):
    """K1 forward, K2 backward. Saves q, k, v (as given: views of the qkv
    projection stay views), the mask, the gate logits, the output and K1's
    lse; the dropout bits are regenerated from the seed."""

    @staticmethod
    def forward(ctx, q, k, v, mask, gate_logits, heads, scale, softclamp_value,
                dropout_rate, dropout_seed, hash_kw):
        out, lse = _flash_forward(q, k, v, mask, heads, scale, softclamp_value,
                                  dropout_rate, dropout_seed, gate_logits, hash_kw)
        ctx.save_for_backward(q, k, v, mask, gate_logits, out, lse)
        ctx.config = (heads, scale, softclamp_value, dropout_rate, dropout_seed, hash_kw)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, gate_logits, out, lse = ctx.saved_tensors
        heads, scale, softclamp_value, dropout_rate, dropout_seed, hash_kw = ctx.config
        dq, dk, dv, dgate = flash_attention_packed_backward(
            q, k, v, mask, out, lse, dout, heads=heads, scale=scale,
            softclamp_value=softclamp_value, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, gate_logits=gate_logits, **hash_kw)
        return dq, dk, dv, None, dgate, None, None, None, None, None, None


def flash_attention_packed(q, k, v, mask=None, *, heads: int, scale=None,
                           softclamp_value=None, dropout_rate: float = 0.0,
                           dropout_seed: int = 0, gate_logits=None,
                           return_lse: bool = False, hash_b0: int = 0, hash_h0: int = 0,
                           hash_heads: int | None = None, hash_r0: int = 0,
                           hash_c0: int = 0):
    """Attention on projection-layout ``q, k, v (b, n, h*dh)`` with a key
    padding ``mask (b, n)`` (True = attend) and optional per-head output
    gate logits ``(b, n, h)``. Returns ``out`` (and ``lse`` if asked);
    differentiable in q, k, v and the gate logits (backward: K2). For the
    dropout bits: ``hash_b0`` the first row's place in the global batch,
    ``hash_h0`` the first head's among a row's ``hash_heads`` (default
    ``heads``), ``hash_r0`` / ``hash_c0`` the first query row's and key
    column's in the global sequence."""
    b, n, D = q.shape
    dh = D // heads
    scale = default(scale, dh ** -0.5)
    dropout_rate = _check_rate(dropout_rate)
    out, lse = _FlashPacked.apply(q, k, v, mask, gate_logits, heads, scale,
                                  softclamp_value, dropout_rate, dropout_seed,
                                  _check_hash(hash_b0, hash_h0, hash_heads, heads, hash_r0,
                                              hash_c0))
    return (out, lse) if return_lse else out


# -- K8 / K9: (b, h, n, dh) operands ------------------------------------------------

def _check_bhnd(t, name, shape, device, dtype):
    """A (b, h, n, dh) operand K8 / K9 take: unit column stride, batch, head
    and row strides in whole 16-byte chunks, a 16-byte aligned start (so a
    head of 72 bf16 values is nine chunks, and the heads of a packed
    projection's view are chunk-aligned)."""
    _cuda.check_cuda_tensor(t, name, device, dtype)
    if tuple(t.shape) != shape:
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
    vec = 16 // t.element_size()
    if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(
            f'{name} must have a unit last stride, batch, head and row strides that '
            f'are multiples of {vec} elements and a 16-byte aligned start; got '
            f'strides {t.stride()}')


def _check_dim_head(dh):
    if not 1 <= dh <= MAX_DIM_HEAD_BHND:
        raise ValueError(f'dim_head must be from 1 to {MAX_DIM_HEAD_BHND}, got {dh}')


def _padded_dim_head(dh):
    """The head width the kernels run: ``dh`` rounded up to a multiple of 8
    (a head of 12 bf16 values is 24 bytes, not whole 16-byte chunks)."""
    return -(-dh // 8) * 8


def _pad_head(t, dhp):
    return torch.nn.functional.pad(t, (0, dhp - t.shape[-1]))


def _check_bhnd_inputs(q, k, v, mask):
    b, h, n, dh = q.shape
    device, dtype = q.device, q.dtype
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'flash attention takes bf16 or f32, got {dtype}')
    _check_dim_head(dh)
    if dh % 8:
        raise ValueError(f'the kernels take dim_head a multiple of 8, got {dh}')
    for t, name in ((q, 'q'), (k, 'k'), (v, 'v')):
        _check_bhnd(t, name, (b, h, n, dh), device, dtype)
    if exists(mask):
        _cuda.check_cuda_tensor(mask, 'mask', device, torch.bool)
        if tuple(mask.shape) != (b, n) or not mask.is_contiguous():
            raise ValueError('mask must be a contiguous (b, n) bool tensor')
    return b, h, n, dh


def _bhnd_empty(b, h, n, dh, dtype, device):
    """A (b, h, n, dh) view of a (b, n, h, dh) buffer: the packed layout the
    model's out-projection reads without a copy."""
    return torch.empty((b, n, h, dh), dtype=dtype, device=device).transpose(1, 2)


def _flash_bhnd_cuda(q, k, v, mask, scale, softclamp_value, dropout_rate, dropout_seed,
                     hash_kw=_NO_OFFSET):
    dh = q.shape[-1]
    _check_dim_head(dh)
    if dh % 8:              # K8 on zero-padded heads, the caller's scale; pad columns dropped
        dhp = _padded_dim_head(dh)
        out, lse = _flash_bhnd_cuda(*(_pad_head(t, dhp) for t in (q, k, v)), mask, scale,
                                    softclamp_value, dropout_rate, dropout_seed, hash_kw)
        return out[..., :dh], lse
    b, h, n, dh = _check_bhnd_inputs(q, k, v, mask)
    device, dtype = q.device, q.dtype
    out = _bhnd_empty(b, h, n, dh, dtype, device)
    lse = torch.empty((b * h, n), dtype=torch.float32, device=device)
    dropping = dropout_rate > 0.0
    st = _cuda.strides_bhn
    err = _cuda.lib().e2_flash_fwd_bhnd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), st(q), st(k), st(v),
        mask.data_ptr() if exists(mask) else None, out.data_ptr(), st(out), lse.data_ptr(),
        b, n, h, dh, float(scale), float(softclamp_value) if exists(softclamp_value) else 0.0,
        1.0 / (1.0 - dropout_rate) if dropping else 1.0,
        int(dropout_seed) & _M32, keep_threshold(dropout_rate), int(dropping),
        *_hash_ints(hash_kw, h), _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    _cuda.check(err, 'flash_fwd_bhnd')
    _cuda.count_launch('flash_fwd_bhnd')
    return out, lse


def _flash_bwd_bhnd_cuda(q, k, v, mask, out, lse, dout, scale, softclamp_value,
                         dropout_rate, dropout_seed, hash_kw=_NO_OFFSET):
    dh = q.shape[-1]
    _check_dim_head(dh)
    if dh % 8:              # K9 on zero-padded heads (o, do too); pad columns dropped
        dhp = _padded_dim_head(dh)
        grads = _flash_bwd_bhnd_cuda(*(_pad_head(t, dhp) for t in (q, k, v)), mask,
                                     _pad_head(out, dhp), lse, _pad_head(dout, dhp), scale,
                                     softclamp_value, dropout_rate, dropout_seed, hash_kw)
        return tuple(g[..., :dh] for g in grads)
    b, h, n, dh = _check_bhnd_inputs(q, k, v, mask)
    device, dtype = q.device, q.dtype
    for t, name in ((out, 'out'), (dout, 'dout')):
        _check_bhnd(t, name, (b, h, n, dh), device, dtype)
    _cuda.check_cuda_tensor(lse, 'lse', device, torch.float32)
    if tuple(lse.shape) != (b * h, n) or not lse.is_contiguous():
        raise ValueError('lse must be a contiguous (b * heads, n) f32 tensor')

    delta = (dout.float() * out.float()).sum(-1)          # (b, h, n), as XLA does it
    dq = torch.zeros((b, n, h, dh), dtype=torch.float32, device=device).transpose(1, 2)
    dk = _bhnd_empty(b, h, n, dh, dtype, device)
    dv = _bhnd_empty(b, h, n, dh, dtype, device)
    launch_bwd_bhnd(q, k, v, dout, mask, lse, delta, dq, dk, dv, scale, softclamp_value,
                    dropout_rate, dropout_seed, hash_kw)
    return dq.to(dtype), dk, dv


def launch_bwd_bhnd(q, k, v, dout, mask, lse, delta, dq, dk, dv, scale, softclamp_value,
                    dropout_rate, dropout_seed, hash_kw=_NO_OFFSET):
    """K9's launch alone, on checked operands: ``delta (b, h, n)`` f32, ``dq``
    a zeroed f32 ``(b, h, n, dh)`` view, ``dk`` / ``dv`` written in place."""
    b, h, n, dh = q.shape
    dropping = dropout_rate > 0.0
    st = _cuda.strides_bhn
    err = _cuda.lib().e2_flash_bwd_bhnd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), st(q), st(k), st(v),
        st(dout), mask.data_ptr() if exists(mask) else None, lse.data_ptr(),
        delta.data_ptr(), st(delta), dq.data_ptr(), st(dq), dk.data_ptr(), st(dk), dv.data_ptr(), st(dv),
        b, n, h, dh, float(scale), float(softclamp_value) if exists(softclamp_value) else 0.0,
        1.0 / (1.0 - dropout_rate) if dropping else 1.0,
        int(dropout_seed) & _M32, keep_threshold(dropout_rate), int(dropping),
        *_hash_ints(hash_kw, h), _cuda.DTYPE_CODES[q.dtype], _cuda.stream_ptr(q.device))
    _cuda.check(err, 'flash_bwd_bhnd')
    _cuda.count_launch('flash_bwd_bhnd')


def flash_attention_backward(q, k, v, mask, out, lse, dout, *, scale=None,
                             softclamp_value=None, dropout_rate: float = 0.0,
                             dropout_seed: int = 0, hash_b0: int = 0, hash_h0: int = 0,
                             hash_heads: int | None = None, hash_r0: int = 0,
                             hash_c0: int = 0):
    """K9 alone (the counterpart of ``_flash_backward``): from the forward's
    ``(b, h, n, dh)`` inputs, its output ``out``, its ``lse`` and the output
    grad ``dout``, returns ``(dq, dk, dv)``."""
    scale = default(scale, q.shape[-1] ** -0.5)
    dropout_rate = _check_rate(dropout_rate)
    hash_kw = _check_hash(hash_b0, hash_h0, hash_heads, q.shape[1], hash_r0, hash_c0)
    if q.device.type == 'cpu':
        return flash_attention_backward_plain(
            q, k, v, mask, out, lse, dout, scale=scale, softclamp_value=softclamp_value,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed, **hash_kw)
    return _flash_bwd_bhnd_cuda(q, k, v, mask, out, lse, dout, scale, softclamp_value,
                                dropout_rate, dropout_seed, hash_kw)


class _Flash(torch.autograd.Function):
    """K8 forward, K9 backward. Saves q, k, v (as given: views stay views),
    the mask, the output and K8's lse; the dropout bits are regenerated from
    the seed."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, softclamp_value, dropout_rate, dropout_seed,
                hash_kw):
        if q.device.type == 'cpu':
            out, lse = flash_attention_plain(
                q, k, v, mask, scale=scale, softclamp_value=softclamp_value,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed, **hash_kw)
        else:
            out, lse = _flash_bhnd_cuda(q, k, v, mask, scale, softclamp_value,
                                        dropout_rate, dropout_seed, hash_kw)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.config = (scale, softclamp_value, dropout_rate, dropout_seed, hash_kw)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        scale, softclamp_value, dropout_rate, dropout_seed, hash_kw = ctx.config
        dq, dk, dv = flash_attention_backward(
            q, k, v, mask, out, lse, dout, scale=scale, softclamp_value=softclamp_value,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed, **hash_kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, mask=None, *, scale=None, softclamp_value=None,
                    dropout_rate: float = 0.0, dropout_seed: int = 0,
                    return_lse: bool = False, hash_b0: int = 0, hash_h0: int = 0,
                    hash_heads: int | None = None, hash_r0: int = 0, hash_c0: int = 0):
    """Attention on ``q, k, v (b, h, n, dh)`` (strided views are read where
    they lie) with a key padding ``mask (b, n)`` (True = attend), dropout
    bits for global batch rows from ``hash_b0``, global heads from
    ``hash_h0`` of ``hash_heads`` (default ``h``) and global query rows and
    key columns from ``hash_r0`` and ``hash_c0``. Returns
    ``out (b, h, n, dh)`` (and ``lse (b*h, n)`` if asked); differentiable in
    q, k and v (forward K8, backward K9). On the card ``out`` is a view of a
    ``(b, n, h, dh)`` buffer, so ``out.transpose(1, 2)`` is contiguous (for
    dh a multiple of 8). Any dh from 1 to 256: a head that is not a multiple
    of 8 is zero-padded to one on the head axis (q, k, v, and o, do in the
    backward), K8 / K9 run on the padded heads with the caller's ``scale``,
    and the outputs are sliced back: zero columns add nothing to q k^T and
    the padded output columns are dropped. That is a launch of K8 / K9, not
    a fallback."""
    scale = default(scale, q.shape[-1] ** -0.5)
    dropout_rate = _check_rate(dropout_rate)
    out, lse = _Flash.apply(q, k, v, mask, scale, softclamp_value, dropout_rate, dropout_seed,
                            _check_hash(hash_b0, hash_h0, hash_heads, q.shape[1], hash_r0,
                                        hash_c0))
    return (out, lse) if return_lse else out


# -- ring blocks: one query block against one key block (parallel/sp.py) -------------

def _to_bhnd(t, heads):
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(1, 2)


def block_forward(q, k, v, mask, *, heads, scale, softclamp_value, dropout_rate, dropout_seed,
                  hash_kw):
    """One block of ring attention without autograd: packed ``q (b, n, h*dh)``
    against the key block ``k, v`` with its key mask, the dropout bits those
    of the block's place (``hash_kw``: `_check_hash`'s, with ``hash_r0`` /
    ``hash_c0`` the block's first query row and key column). K1 for dim_head
    32, 64 or 128, else K8 on ``(b, h, n, dh)`` views (dim_head a multiple
    of 8 on the card: the ring zero-pads). Returns ``(out, lse)``, ``out``
    packed in q's dtype, ``lse (b*h, n)`` f32."""
    b, n, D = q.shape
    if D // heads in SUPPORTED_DIM_HEAD:
        return _flash_forward(q, k, v, mask, heads, scale, softclamp_value, dropout_rate,
                              dropout_seed, None, hash_kw)
    args = [_to_bhnd(t, heads) for t in (q, k, v)]
    if q.device.type == 'cpu':
        out, lse = flash_attention_plain(*args, mask, scale=scale,
                                         softclamp_value=softclamp_value,
                                         dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                                         **hash_kw)
    else:
        out, lse = _flash_bhnd_cuda(*args, mask, scale, softclamp_value, dropout_rate,
                                    dropout_seed, hash_kw)
    return out.transpose(1, 2).reshape(b, n, D), lse


def block_delta(out, dout, *, heads):
    """``rowsum(dout * out)`` per head, f32 ``(b, n, heads)``, of the ring's
    combined output: K10 for dim_head 32, 64 or 128 (the heads K1 / K2
    take), else a plain PyTorch sum, as K9's wrapper takes it."""
    b, n, D = out.shape
    if D // heads in SUPPORTED_DIM_HEAD:
        return flash_delta(out, dout, heads=heads)[0]
    return (dout.float() * out.float()).view(b, n, heads, D // heads).sum(-1)


def block_backward(q, k, v, mask, lse, delta, dout, dq, *, heads, scale, softclamp_value,
                   dropout_rate, dropout_seed, hash_kw):
    """`block_forward`'s backward against the GLOBAL ``lse (b*h, n)`` and
    ``delta (b, n, h)`` of the query rows (the ring's combined statistics):
    K2 for dim_head 32, 64 or 128, else K9. Adds the block's dq to ``dq``, a
    contiguous f32 ``(b, n, h*dh)`` buffer (on the card the kernels' own
    atomic adds), and returns the key block's ``(dk, dv)``, packed in q's
    dtype."""
    b, n, D = q.shape
    dh, dt = D // heads, q.dtype
    dout = dout.contiguous()
    if q.device.type == 'cpu':
        split = lambda t: _split_heads(t, heads)
        grads = _backward_core_plain(split(q), split(k), split(v), split(dout),
                                     delta.permute(0, 2, 1), mask, lse, dt, scale,
                                     softclamp_value, dropout_rate, dropout_seed, hash_kw)
        dq += _merge_heads(grads[0])
        return tuple(_merge_heads(g).to(dt) for g in grads[1:])
    if dh in SUPPORTED_DIM_HEAD:
        _check_inputs(q, k, v, mask, None, heads)
        dk, dv = (torch.empty((b, n, D), dtype=dt, device=q.device) for _ in range(2))
        launch_bwd(q, k, v, dout, mask, lse, delta, dq, dk, dv, heads, scale,
                   softclamp_value, dropout_rate, dropout_seed, hash_kw)
        return dk, dv
    args = [_to_bhnd(t, heads) for t in (q, k, v, dout)]
    _check_bhnd_inputs(*args[:3], mask)
    dk, dv = (_bhnd_empty(b, heads, n, dh, dt, q.device) for _ in range(2))
    launch_bwd_bhnd(*args[:3], args[3], mask, lse, delta.permute(0, 2, 1), _to_bhnd(dq, heads),
                    dk, dv, scale, softclamp_value, dropout_rate, dropout_seed, hash_kw)
    return tuple(t.transpose(1, 2).reshape(b, n, D) for t in (dk, dv))


# -- the cost-floor probe -------------------------------------------------------------

PROBE_MODES = (0, 1, 2)    # the products only; + exp; + the tile's max / sum


def flash_probe_plain(x, mode: int):
    """Plain PyTorch version of the probe on ``x (b, h, n, dh)`` bf16 used as
    q, k and v: per 64-key tile (keys past n are zero rows) s = x x^T, then
    mode 1 ``exp(s)``, mode 2 ``exp(s) - (max + sum)`` over the tile; the
    tiles' bf16(s) v summed in f32; bf16 out."""
    if mode not in PROBE_MODES:
        raise ValueError(f'probe mode must be one of {PROBE_MODES}, got {mode}')
    b, h, n, dh = x.shape
    nk = -(-n // 64) * 64
    xf = x.float()
    kv = torch.nn.functional.pad(xf, (0, 0, 0, nk - n))
    s = torch.einsum('bhid,bhjd->bhij', xf, kv)
    if mode >= 1:
        s = torch.exp(s)
    if mode == 2:
        tiles = s.view(b, h, n, nk // 64, 64)
        s = (tiles - (tiles.amax(-1, keepdim=True) + tiles.sum(-1, keepdim=True))).view(s.shape)
    return (s.to(x.dtype).float() @ kv).to(x.dtype)


def flash_probe(x, mode: int):
    """The probe (K8 stripped to its products, exp and tile statistics) on
    ``x (b, h, n, dh)`` bf16; returns a contiguous ``(b, h, n, dh)``."""
    if x.device.type == 'cpu':
        return flash_probe_plain(x, mode)
    if mode not in PROBE_MODES:
        raise ValueError(f'probe mode must be one of {PROBE_MODES}, got {mode}')
    b, h, n, dh = x.shape
    if dh % 8 or not 8 <= dh <= MAX_DIM_HEAD_PROBE:
        raise ValueError(f'the probe takes dim_head a multiple of 8 from 8 to '
                         f'{MAX_DIM_HEAD_PROBE}, got {dh}')
    _check_bhnd(x, 'x', (b, h, n, dh), x.device, torch.bfloat16)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    err = _cuda.lib().e2_flash_probe(x.data_ptr(), _cuda.strides_bhn(x), out.data_ptr(),
                                     _cuda.strides_bhn(out), b, n, h, dh, int(mode),
                                     _cuda.stream_ptr(x.device))
    _cuda.check(err, 'flash_probe')
    _cuda.count_launch('flash_probe')
    return out
