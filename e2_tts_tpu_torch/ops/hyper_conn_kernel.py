"""K5 / K3 and their adjoints K5b / K4: the hyper-connection width
connection (counterpart of e2_tts_tpu/ops/hyper_conn_kernel.py::
width_connection and ::width_connection_fused).

Replace the TPU kernels ``_width_kernel`` (K5, driven by ``_width_pallas``),
``_width_fused_kernel`` (K3, driven by ``_width_fused_pallas``),
``_width_bwd_kernel`` (K5b, driven by ``_width_bwd_pallas``) and
``_width_fused_bwd_kernel`` (K4, driven by ``_width_fused_bwd_pallas``).
The forward kernels live in ``csrc/hyper_conn.cu``, the adjoints in
``csrc/hyper_conn_bwd.cu``: all bandwidth bound; one warp holds one row of
every stream in registers, so each input is read once and each output
written once, and K3 / K4 form the previous branch's depth connection
``carried + branch * beta`` in registers instead of device memory. The
adjoints port the hand-derived chain rule of the JAX package's
``_width_bwd_core_tall``; their parameter grads are per-block partial sums
reduced in a fixed order (the same result every run). `_Width` (K5 + K5b)
and `_WidthFused` (K3 + K4) are the ``torch.autograd.Function``s.

Outputs are the mix's column 0 (the branch input, ``(M, d)``), columns 1..s
(the carried streams, ``(s, M, d)``) and ``beta (s, M)``. K3 takes the
previous ``beta`` as ``(s, M)`` — the layout K3/K5 write — where the JAX
API took its transpose.

The wrappers take the plain PyTorch versions for CPU tensors and launch the
kernels for CUDA tensors; there is no other route.
"""

from __future__ import annotations

import torch

from e2_tts_tpu_torch.ops import _cuda

# 4 streams at the flagship's text and speech widths (256, 512) and DiT-XL's
# (576, 1152)
SUPPORTED_STREAMS = (4,)
SUPPORTED_DIMS = (256, 512, 576, 1152)


def width_connection_plain(residuals, static_alpha, static_beta, dyn_alpha_w,
                           dyn_alpha_scale, dyn_beta_w, dyn_beta_scale):
    """Plain PyTorch version of K5 on ``residuals (s, M, d)``: norm stats and
    products accumulate in f32, the normed rows, alpha, beta and the mix are
    rounded to the compute dtype where the reference rounds them."""
    dt = residuals.dtype
    s, _, d = residuals.shape
    rf = residuals.float()
    inv = torch.rsqrt(torch.clamp((rf * rf).sum(-1) / d, min=1e-12))
    normed = (residuals * inv[..., None].to(dt)).float()
    w = torch.cat((dyn_alpha_w, dyn_beta_w[:, None]), dim=1).to(dt).float()
    t = torch.tanh(torch.einsum('smd,dc->smc', normed, w))
    alpha = (t[..., :s + 1] * dyn_alpha_scale.float()
             + static_alpha.float()[:, None, :]).to(dt)           # (s, M, s+1)
    beta = (t[..., s + 1] * dyn_beta_scale.float()
            + static_beta.float()[:, None]).to(dt)                # (s, M)
    mixed = torch.einsum('smt,smd->tmd', alpha.float(), rf).to(dt)
    return mixed[0], mixed[1:], beta


def width_connection_fused_plain(carried, branch, beta, *params):
    """Plain PyTorch version of K3: the depth connection in the compute
    dtype, then K5's math."""
    r = carried + branch[None].to(carried.dtype) * beta[..., None].to(carried.dtype)
    return width_connection_plain(r, *params)


def _packed_params(params, s, dt):
    """The beta-folded packs of the JAX kernels: weights (d, s+2) rounded to
    the compute dtype, statics (s, s+2), per-column scales (s+2,)."""
    sa, sb, aw, ascale, bw, bscale = (p.float() for p in params)
    w = torch.cat((aw, bw[:, None]), dim=1).to(dt).float()
    sa_p = torch.cat((sa, sb[:, None]), dim=1)
    scale_row = torch.cat((ascale.reshape(1).expand(s + 1), bscale.reshape(1)))
    return w, sa_p, scale_row


def _width_adjoint_plain(r, params, g_branch_in, g_carried, g_beta):
    """The hand-derived adjoint of `_width_bwd_core_tall` on streams ``r
    (s, M, d)``: returns the f32 residual grads (s, M, d) and the six
    parameter grads (f32)."""
    dt = r.dtype
    s, _, d = r.shape
    w, sa_p, scale_row = _packed_params(params, s, dt)
    rf = r.float()
    var = (rf * rf).sum(-1) / d
    inv = torch.rsqrt(torch.clamp(var, min=1e-12))
    normed = (r * inv[..., None].to(dt)).float()
    ta = torch.tanh(torch.einsum('smd,dc->smc', normed, w))          # (s, M, s+2)
    alpha = (ta * scale_row + sa_p[:, None, :]).to(dt).float()

    gm = torch.cat((g_branch_in[None], g_carried)).float()            # (s+1, M, d)
    ga = torch.cat((torch.einsum('tmd,smd->smt', gm, rf),
                    g_beta.float()[..., None]), dim=-1)               # (s, M, s+2)
    g_mix = torch.einsum('smt,tmd->smd', alpha[..., :s + 1], gm)
    g_p = (ga * scale_row * (1.0 - ta * ta)).to(dt).float()
    gt = ga * ta
    g_static = ga.sum(1)                                              # (s, s+2)
    g_n = torch.einsum('smc,dc->smd', g_p, w)
    g_w = torch.einsum('smd,smc->dc', normed, g_p)                    # (d, s+2)
    g_inv = (g_n * rf).sum(-1)
    g_sq = torch.where(var > 1e-12, g_inv * (-0.5) * inv * inv * inv / d, 0.0)
    g_r = g_mix + (g_n * inv[..., None] + 2.0 * rf * g_sq[..., None])
    grads = (g_static[:, :s + 1], g_static[:, s + 1], g_w[:, :s + 1].contiguous(),
             gt[..., :s + 1].sum(), g_w[:, s + 1].contiguous(), gt[..., s + 1].sum())
    return g_r, grads


def width_connection_backward_plain(residuals, static_alpha, static_beta, dyn_alpha_w,
                                    dyn_alpha_scale, dyn_beta_w, dyn_beta_scale,
                                    g_branch_in, g_carried, g_beta):
    """Plain PyTorch version of K5b: returns ``(g_residuals, *param_grads)``
    in the order of the parameters."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    g_r, grads = _width_adjoint_plain(residuals, params, g_branch_in, g_carried, g_beta)
    return (g_r.to(residuals.dtype), *grads)


def width_connection_fused_backward_plain(carried, branch, beta, static_alpha, static_beta,
                                          dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
                                          dyn_beta_scale, g_branch_in, g_carried, g_beta):
    """Plain PyTorch version of K4: returns ``(g_carried, g_branch, g_beta,
    *param_grads)`` for the inputs ``carried (s, M, d), branch (M, d), beta
    (s, M)``."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    dt = carried.dtype
    r = carried + branch[None].to(dt) * beta[..., None].to(dt)
    g_r, grads = _width_adjoint_plain(r, params, g_branch_in, g_carried, g_beta)
    g_branch = (g_r * beta.float()[..., None]).sum(0)
    g_beta_prev = (g_r * branch.float()[None]).sum(-1)
    return (g_r.to(dt), g_branch.to(branch.dtype), g_beta_prev.to(beta.dtype), *grads)


def _f32(t):
    t = t if t.dtype == torch.float32 else t.float()
    return t.contiguous()


def _checked_params(name, tensors, params, s, d, dtype, device):
    """Check what the kernels take (contiguous bf16 / f32 ``tensors`` on
    ``device``, s and d among the compiled widths, parameter shapes) and
    return the six parameters as contiguous f32."""
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'{name} takes bf16 or f32 streams, got {dtype}')
    if s not in SUPPORTED_STREAMS or d not in SUPPORTED_DIMS:
        raise ValueError(f'{name}: streams {s} / dim {d} not in '
                         f'{SUPPORTED_STREAMS} / {SUPPORTED_DIMS}')
    for t, label in tensors:
        _cuda.check_cuda_tensor(t, label, device, dtype)
        if not t.is_contiguous():
            raise ValueError(f'{name}: {label} must be contiguous')
    params = [_f32(p) for p in params]
    for p in params:
        _cuda.check_cuda_tensor(p, 'hyper-connection parameter', device)
    sa, sb, aw, _, bw, _ = params
    if tuple(sa.shape) != (s, s + 1) or tuple(aw.shape) != (d, s + 1) \
            or tuple(bw.shape) != (d,) or tuple(sb.shape) != (s,):
        raise ValueError(f'{name}: parameter shapes do not match s={s}, d={d}')
    return params


def _launch(name, streams_in, params, s, m, d, dtype, device):
    sa, sb, aw, ascale, bw, bscale = _checked_params(name, streams_in, params, s, d, dtype,
                                                     device)
    out_branch = torch.empty((m, d), dtype=dtype, device=device)
    out_carried = torch.empty((s, m, d), dtype=dtype, device=device)
    out_beta = torch.empty((s, m), dtype=dtype, device=device)
    fn = getattr(_cuda.lib(), 'e2_' + name)
    err = fn(*(t.data_ptr() for t, _ in streams_in),
             sa.data_ptr(), sb.data_ptr(), aw.data_ptr(), bw.data_ptr(),
             ascale.data_ptr(), bscale.data_ptr(),
             out_branch.data_ptr(), out_carried.data_ptr(), out_beta.data_ptr(),
             s, m, d, _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    _cuda.check(err, name)
    _cuda.count_launch(name)
    return out_branch, out_carried, out_beta


# blocks of the adjoint kernels (csrc/hyper_conn_bwd.cu: 8 rows in flight
# per block, 4 at d = 1152; two blocks per SM of the H100's 132)
_BWD_ROWS_PER_BLOCK = 8
_BWD_MAX_BLOCKS = 264


def _launch_bwd(name, streams_in, grads_in, params, s, m, d, dtype, device, outs):
    """Launch K5b / K4 and its fixed-order reduction of the per-block
    parameter-grad rows; returns the six parameter grads."""
    sa, sb, aw, ascale, bw, bscale = _checked_params(name, streams_in + grads_in, params, s,
                                                     d, dtype, device)
    nc = s + 2
    n_param = nc * d + s * nc + 2
    blocks = max(1, min(-(-m // _BWD_ROWS_PER_BLOCK), _BWD_MAX_BLOCKS))
    partials = torch.empty((blocks, n_param), dtype=torch.float32, device=device)
    row = torch.empty((n_param,), dtype=torch.float32, device=device)
    fn = getattr(_cuda.lib(), 'e2_' + name)
    err = fn(*(t.data_ptr() for t, _ in streams_in + grads_in),
             sa.data_ptr(), sb.data_ptr(), aw.data_ptr(), bw.data_ptr(),
             ascale.data_ptr(), bscale.data_ptr(), *(t.data_ptr() for t in outs),
             partials.data_ptr(), row.data_ptr(), blocks, s, m, d,
             _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    _cuda.check(err, name)
    _cuda.count_launch(name)
    g_w = row[:nc * d].view(nc, d)
    g_static = row[nc * d:nc * d + s * nc].view(s, nc)
    return (g_static[:, :s + 1], g_static[:, s + 1], g_w[:s + 1].t().contiguous(),
            row[-2].reshape(()), g_w[s + 1], row[-1].reshape(()))


def _grads_or_zeros(g_branch_in, g_carried, g_beta, s, m, d, like):
    """Incoming grads, contiguous, with zeros where an output got none."""
    z = lambda shape: torch.zeros(shape, dtype=like.dtype, device=like.device)
    pick = lambda g, shape: z(shape) if g is None else g.to(like.dtype).contiguous()
    return pick(g_branch_in, (m, d)), pick(g_carried, (s, m, d)), pick(g_beta, (s, m))


def width_connection_backward(residuals, static_alpha, static_beta, dyn_alpha_w,
                              dyn_alpha_scale, dyn_beta_w, dyn_beta_scale,
                              g_branch_in, g_carried, g_beta):
    """K5b alone (the counterpart of ``_width_bwd_pallas``): returns
    ``(g_residuals, g_static_alpha, g_static_beta, g_dyn_alpha_w,
    g_dyn_alpha_scale, g_dyn_beta_w, g_dyn_beta_scale)``."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    s, m, d = residuals.shape
    grads = _grads_or_zeros(g_branch_in, g_carried, g_beta, s, m, d, residuals)
    if residuals.device.type == 'cpu':
        return width_connection_backward_plain(residuals, *params, *grads)
    g_res = torch.empty_like(residuals)
    pgrads = _launch_bwd('hc_width_bwd', [(residuals, 'residuals')],
                         list(zip(grads, ('g_branch_in', 'g_carried', 'g_beta'))),
                         params, s, m, d, residuals.dtype, residuals.device, [g_res])
    return (g_res, *pgrads)


def width_connection_fused_backward(carried, branch, beta, static_alpha, static_beta,
                                    dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
                                    dyn_beta_scale, g_branch_in, g_carried, g_beta):
    """K4 alone (the counterpart of ``_width_fused_bwd_pallas``): returns
    ``(g_carried, g_branch, g_beta_prev, *param_grads)``."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    s, m, d = carried.shape
    grads = _grads_or_zeros(g_branch_in, g_carried, g_beta, s, m, d, carried)
    if carried.device.type == 'cpu':
        return width_connection_fused_backward_plain(carried, branch, beta, *params, *grads)
    outs = [torch.empty_like(carried), torch.empty_like(branch), torch.empty_like(beta)]
    pgrads = _launch_bwd('hc_width_fused_bwd',
                         [(carried, 'carried'), (branch, 'branch'), (beta, 'beta')],
                         list(zip(grads, ('g_branch_in', 'g_carried', 'g_beta'))),
                         params, s, m, d, carried.dtype, carried.device, outs)
    return (*outs, *pgrads)


def _param_grads(params, grads):
    """Each parameter grad in its parameter's dtype and shape."""
    return tuple(g.to(p.dtype).reshape(p.shape) for p, g in zip(params, grads))


class _Width(torch.autograd.Function):
    """K5 forward, K5b backward."""

    @staticmethod
    def forward(ctx, residuals, *params):
        s, m, d = residuals.shape
        if residuals.device.type == 'cpu':
            outs = width_connection_plain(residuals, *params)
        else:
            outs = _launch('hc_width', [(residuals, 'residuals')], params, s, m, d,
                           residuals.dtype, residuals.device)
        ctx.save_for_backward(residuals, *params)
        return outs

    @staticmethod
    def backward(ctx, g_branch_in, g_carried, g_beta):
        residuals, *params = ctx.saved_tensors
        g_res, *grads = width_connection_backward(residuals, *params, g_branch_in,
                                                  g_carried, g_beta)
        return (g_res, *_param_grads(params, grads))


class _WidthFused(torch.autograd.Function):
    """K3 forward, K4 backward."""

    @staticmethod
    def forward(ctx, carried, branch, beta, *params):
        s, m, d = carried.shape
        if carried.device.type == 'cpu':
            outs = width_connection_fused_plain(carried, branch, beta, *params)
        else:
            outs = _launch('hc_width_fused',
                           [(carried, 'carried'), (branch, 'branch'), (beta, 'beta')],
                           params, s, m, d, carried.dtype, carried.device)
        ctx.save_for_backward(carried, branch, beta, *params)
        return outs

    @staticmethod
    def backward(ctx, g_branch_in, g_carried, g_beta):
        carried, branch, beta, *params = ctx.saved_tensors
        g_c, g_br, g_bp, *grads = width_connection_fused_backward(
            carried, branch, beta, *params, g_branch_in, g_carried, g_beta)
        return (g_c, g_br, g_bp, *_param_grads(params, grads))


def width_connection(residuals, static_alpha, static_beta, dyn_alpha_w,
                     dyn_alpha_scale, dyn_beta_w, dyn_beta_scale):
    """K5: ``residuals (s, M, d)`` -> ``(branch_input (M, d), carried
    (s, M, d), beta (s, M))``; differentiable (backward: K5b)."""
    return _Width.apply(residuals, static_alpha, static_beta, dyn_alpha_w,
                        dyn_alpha_scale, dyn_beta_w, dyn_beta_scale)


def width_connection_fused(carried, branch, beta, static_alpha, static_beta,
                           dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
                           dyn_beta_scale):
    """K3: ``carried (s, M, d)``, ``branch (M, d)``, ``beta (s, M)`` stand
    for the streams ``carried + branch * beta``; same outputs as K5;
    differentiable (backward: K4)."""
    s, m, d = carried.shape
    if tuple(branch.shape) != (m, d) or tuple(beta.shape) != (s, m):
        raise ValueError('width_connection_fused: branch must be (M, d) and '
                         'beta (s, M) for carried (s, M, d)')
    return _WidthFused.apply(carried, branch, beta, static_alpha, static_beta,
                             dyn_alpha_w, dyn_alpha_scale, dyn_beta_w, dyn_beta_scale)
