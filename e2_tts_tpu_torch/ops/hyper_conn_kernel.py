"""K5 / K3 and their adjoints K5b / K4, with the save-state variants K5s /
K3s / K5bs / K4s: the hyper-connection width connection (counterpart of
e2_tts_tpu/ops/hyper_conn_kernel.py::width_connection and
::width_connection_fused).

Replace the TPU kernels ``_width_kernel`` (K5, driven by ``_width_pallas``),
``_width_fused_kernel`` (K3, driven by ``_width_fused_pallas``),
``_width_bwd_kernel`` (K5b, driven by ``_width_bwd_pallas``) and
``_width_fused_bwd_kernel`` (K4, driven by ``_width_fused_bwd_pallas``), and
their ``_save`` bodies. The forward kernels live in ``csrc/hyper_conn.cu``,
the adjoints in ``csrc/hyper_conn_bwd.cu``: all bandwidth bound, each
input read once and each output written once, and K3 / K4 form the previous
branch's depth connection ``carried + branch * beta`` on chip instead of in
device memory. On bf16 at 4 streams (every configuration of the repo) the
forwards and the adjoints, with their save variants, run Hopper designs
(``csrc/hyper_conn_sm90.cuh``, ``csrc/hyper_conn_bwd_sm90.cuh``: a team of
warps a row, 8 columns a thread, a cp.async ring; the forwards' projection
on the tensor cores); the templates of ``csrc/hyper_conn.cuh`` /
``hyper_conn_bwd.cuh`` (f32, bf16 at 2, 3 and 5-8 streams) give one warp
one row of every stream. The C entry points choose the design from the
dtype and the stream count. The adjoints port
the hand-derived chain rule of the JAX package's ``_width_bwd_core``; their
parameter grads are per-block partial sums reduced in a fixed order (the
same result every run). `_Width` (K5 + K5b)
and `_WidthFused` (K3 + K4) are the ``torch.autograd.Function`` s. They take
any stream count from 2 to 8 and any width from 1 to `max_dim` (s) (2901
at 8 streams, 4840 at 4).

``save_state=True`` is the explicit counterpart of the JAX package's
``E2TTS_HC_SAVE_STATE`` knob: when a backward can follow, the forward runs
K5s / K3s, which also write ``ta (s, M, s+2)`` f32 (tanh of the packed
projection, beta's at column s+1, before the scale / static affine) and
``inv (s, M)`` f32 (the rms reciprocal before it is rounded), kept for the
backward and never returned; the backward then runs K5bs / K4s, which read
them instead of recomputing the rms statistic, the projection and the
tanh. Under ``torch.no_grad`` the flag runs K5 / K3.

Outputs are the mix's column 0 (the branch input, ``(M, d)``), columns 1..s
(the carried streams, ``(s, M, d)``) and ``beta (s, M)``. K3 takes the
previous ``beta`` as ``(s, M)`` — the layout K3/K5 write — where the JAX
API took its transpose.

The wrappers take the plain PyTorch versions for CPU tensors and launch the
kernels for CUDA tensors; there is no other route. The plain adjoints also
run in f64 (``acc=``): `width_backward_reference` is that reference with the
alternatives f32 sums may legitimately round to, which the card's checks
hold the adjoints against; nothing on a kernel path calls it.
"""

from __future__ import annotations

import torch

from e2_tts_tpu_torch.ops import _cuda

MIN_STREAMS, MAX_STREAMS = 2, 8
_MAX_SMEM_FLOATS = 232448 // 4        # the shared memory a block may have on the H100


def _n_small(s):
    """The adjoint's per-warp g_static / scale partials: s (s+2) + 2 values."""
    return s * (s + 2) + 2


def max_dim(s: int) -> int:
    """The widest row the adjoint takes at ``s`` streams: one warp's (s+2, d)
    f32 weight-grad partials beside the (d, s+2) weights in 227 KB."""
    return (_MAX_SMEM_FLOATS - _n_small(s)) // (2 * (s + 2))


def _bwd_warps(s, d):
    """Warps of an adjoint block (csrc/hyper_conn_bwd.cuh): as many (up to
    8) as per-warp partials fit beside the weights."""
    nc = s + 2
    return max(1, min(8, (_MAX_SMEM_FLOATS - nc * d) // (nc * d + _n_small(s))))


# blocks of the adjoint templates: up to two per SM of the H100's 132
_BWD_MAX_BLOCKS = 264
# partial rows the Hopper design of the adjoints takes (bf16, 4 streams;
# csrc/hyper_conn_bwd_sm90.cuh::MAX_BLOCKS): it launches at most that many
# blocks and sets its own warps a block
_SM90_MAX_BLOCKS = 1056


def _bwd_geometry(s, m, d, dtype):
    """``(warps, blocks)`` of an adjoint launch (K5b / K4 and their save
    variants alike): the blocks are the partial rows allocated for the
    parameter grads. On bf16 at 4 streams the adjoints run the Hopper
    design, which takes no warps (0 is passed); the rest the templates of
    csrc/hyper_conn_bwd.cuh (as the C entry points choose)."""
    if dtype == torch.bfloat16 and s == 4:
        return 0, max(1, min(m, _SM90_MAX_BLOCKS))
    warps = _bwd_warps(s, d)
    return warps, max(1, min(-(-m // warps), _BWD_MAX_BLOCKS))


def width_connection_plain(residuals, static_alpha, static_beta, dyn_alpha_w,
                           dyn_alpha_scale, dyn_beta_w, dyn_beta_scale, *, save_state=False):
    """Plain PyTorch version of K5 on ``residuals (s, M, d)``: norm stats and
    products accumulate in f32, the normed rows, alpha, beta and the mix are
    rounded to the compute dtype where the reference rounds them. With
    ``save_state`` (K5s) returns ``(outputs, (ta, inv))``: tanh of the packed
    projection ``(s, M, s+2)`` and the unrounded rms reciprocal ``(s, M)``,
    both f32."""
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
    outs = (mixed[0], mixed[1:], beta)
    return (outs, (t, inv)) if save_state else outs


def _depth_connection(carried, branch, beta):
    dt = carried.dtype
    return carried + branch[None].to(dt) * beta[..., None].to(dt)


def width_connection_fused_plain(carried, branch, beta, *params, save_state=False):
    """Plain PyTorch version of K3 (K3s with ``save_state``): the depth
    connection in the compute dtype, then K5's math."""
    return width_connection_plain(_depth_connection(carried, branch, beta), *params,
                                  save_state=save_state)


def _packed_params(params, s, dt, acc=torch.float32):
    """The beta-folded packs of the JAX kernels: weights (d, s+2) rounded to
    the compute dtype, statics (s, s+2), per-column scales (s+2,), in
    ``acc``."""
    sa, sb, aw, ascale, bw, bscale = (p.to(acc) for p in params)
    w = torch.cat((aw, bw[:, None]), dim=1).to(dt).to(acc)
    sa_p = torch.cat((sa, sb[:, None]), dim=1)
    scale_row = torch.cat((ascale.reshape(1).expand(s + 1), bscale.reshape(1)))
    return w, sa_p, scale_row


def _width_adjoint_plain(r, params, g_branch_in, g_carried, g_beta, state=None,
                         acc=torch.float32, rounding=None):
    """The hand-derived adjoint of `_width_bwd_core` on streams ``r (s, M,
    d)``: returns the residual grads (s, M, d) and the six parameter grads,
    all in ``acc``. With ``state = (ta, inv)`` (the save-state path) the tanh
    and the unrounded rms reciprocal come from the forward, and the clamp
    test is ``inv < 1e6``, as the reference's. ``acc`` is the dtype of every
    sum and every elementwise step: f32 as the kernels, or f64 for a
    reference with no f32 rounding of its own. The compute-dtype roundings
    (``inv``, ``normed``, ``alpha``, ``gp``) stay where the kernels have
    them; ``rounding(name, x, nearest)``, where given, picks the value of
    the ``inv``, ``alpha`` and ``gp`` points (`width_backward_reference`)."""
    dt = r.dtype
    s, _, d = r.shape

    def rnd(name, x):
        nearest = x.to(dt).to(acc)
        return nearest if rounding is None else rounding(name, x, nearest)

    w, sa_p, scale_row = _packed_params(params, s, dt, acc)
    rf = r.to(acc)
    if state is None:
        var = (rf * rf).sum(-1) / d
        inv = torch.rsqrt(torch.clamp(var, min=1e-12))
        var_ok = var > 1e-12
        normed = (rf * rnd('inv', inv)[..., None]).to(dt).to(acc)
        ta = torch.tanh(torch.einsum('smd,dc->smc', normed, w))      # (s, M, s+2)
    else:
        ta, inv = (t.to(acc) for t in state)
        var_ok = inv < 1e6
        normed = (rf * inv[..., None].to(dt).to(acc)).to(dt).to(acc)
    alpha = rnd('alpha', ta * scale_row + sa_p[:, None, :])

    gm = torch.cat((g_branch_in[None], g_carried)).to(acc)            # (s+1, M, d)
    ga = torch.cat((torch.einsum('tmd,smd->smt', gm, rf),
                    g_beta.to(acc)[..., None]), dim=-1)               # (s, M, s+2)
    g_mix = torch.einsum('smt,tmd->smd', alpha[..., :s + 1], gm)
    g_p = rnd('gp', ga * scale_row * (1.0 - ta * ta))
    gt = ga * ta
    g_static = ga.sum(1)                                              # (s, s+2)
    g_n = torch.einsum('smc,dc->smd', g_p, w)
    g_w = torch.einsum('smd,smc->dc', normed, g_p)                    # (d, s+2)
    g_inv = (g_n * rf).sum(-1)
    g_sq = torch.where(var_ok, g_inv * (-0.5) * inv * inv * inv / d, 0.0)
    g_r = g_mix + (g_n * inv[..., None] + 2.0 * rf * g_sq[..., None])
    grads = (g_static[:, :s + 1], g_static[:, s + 1], g_w[:, :s + 1].contiguous(),
             gt[..., :s + 1].sum(), g_w[:, s + 1].contiguous(), gt[..., s + 1].sum())
    return g_r, grads


def _out_dtype(dt, acc):
    """The input grads' dtype: the inputs' for the kernels' plain version
    (f32 sums), ``acc`` itself, unrounded, for a wider reference."""
    return dt if acc == torch.float32 else acc


def width_connection_backward_plain(residuals, static_alpha, static_beta, dyn_alpha_w,
                                    dyn_alpha_scale, dyn_beta_w, dyn_beta_scale,
                                    g_branch_in, g_carried, g_beta, *, state=None,
                                    acc=torch.float32, rounding=None):
    """Plain PyTorch version of K5b (K5bs with ``state = (ta, inv)``):
    returns ``(g_residuals, *param_grads)`` in the order of the parameters.
    ``acc=torch.float64`` gives the f64 reference of `_width_adjoint_plain`,
    with every grad in f64 (``rounding`` as there)."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    g_r, grads = _width_adjoint_plain(residuals, params, g_branch_in, g_carried, g_beta,
                                      state, acc, rounding)
    return (g_r.to(_out_dtype(residuals.dtype, acc)), *grads)


def width_connection_fused_backward_plain(carried, branch, beta, static_alpha, static_beta,
                                          dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
                                          dyn_beta_scale, g_branch_in, g_carried, g_beta, *,
                                          state=None, acc=torch.float32, rounding=None):
    """Plain PyTorch version of K4 (K4s with ``state = (ta, inv)``): returns
    ``(g_carried, g_branch, g_beta, *param_grads)`` for the inputs ``carried
    (s, M, d), branch (M, d), beta (s, M)``; ``acc`` and ``rounding`` as
    `width_connection_backward_plain`."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    r = _depth_connection(carried, branch, beta)
    g_r, grads = _width_adjoint_plain(r, params, g_branch_in, g_carried, g_beta, state, acc,
                                      rounding)
    g_branch = (g_r * beta.to(acc)[..., None]).sum(0)
    g_beta_prev = (g_r * branch.to(acc)[None]).sum(-1)
    return (g_r.to(_out_dtype(carried.dtype, acc)), g_branch.to(_out_dtype(branch.dtype, acc)),
            g_beta_prev.to(_out_dtype(beta.dtype, acc)), *grads)


# A rounding point whose f64 value lies within this fraction of its magnitude
# of a bf16 rounding midpoint may round either way in a kernel that sums in
# f32: its sums of a few thousand terms carry ~1e-7 of relative error, its
# rsqrtf and tanhf two f32 ulps; 2**-16 leaves a margin of ~50.
_EITHER_WAY = 2.0 ** -16
_MAX_ALTERNATIVES = 8


def _other_bf16(x, nearest):
    """The bf16 neighbour of ``nearest`` on the side of ``x`` (x's dtype):
    one step of the bf16 magnitude bits, outward where |x| > |nearest|."""
    bits = nearest.to(torch.bfloat16).view(torch.int16)
    step = torch.where(x.abs() > nearest.abs(), 1, -1).to(torch.int16)
    return (bits + step).view(torch.bfloat16).to(x.dtype)


def width_backward_reference(fused, *args, state=None):
    """The f64 reference of K4 (``fused``; ``args`` as
    `width_connection_fused_backward_plain` takes them) or K5b (as
    `width_connection_backward_plain`), of K4s / K5bs with the forward's
    ``state``, and the other results a kernel that sums in f32 may
    legitimately give: ``(ref, alts)``.

    ``ref`` rounds to nearest at every rounding point. A point whose f64
    value lies within ``_EITHER_WAY`` of its magnitude of a bf16 midpoint
    (``gp``, ``alpha`` and, where the kernel computes it, ``inv``) may round
    either way in f32. Alternative k rounds the k-th such point of each row
    the other way, and ``alts[k]`` is its input grads less ``ref``'s; a row's
    alternatives add (the grads are linear in alpha and gp). The parameter
    grads, sums over every row, stay ``ref``'s: their limits allow for
    these points. For BF16 streams only."""
    plain = width_connection_fused_backward_plain if fused else width_connection_backward_plain
    n_in = 3 if fused else 1
    s = args[0].shape[0]
    seen = {}

    def record(name, x, nearest):
        seen[name] = (x, nearest)
        return nearest

    ref = plain(*args, state=state, acc=torch.float64, rounding=record)
    # each point's row-major position: (M, points of the row)
    either = {}
    for name, (x, nearest) in seen.items():
        if name == 'inv' and state is not None:
            continue                      # the kernel rounds the forward's own value
        mid = (nearest + _other_bf16(x, nearest)) / 2
        amb = (x - mid).abs() <= _EITHER_WAY * x.abs()
        if name == 'alpha':
            amb[..., s + 1] = False       # beta's column: not used by the adjoint
        either[name] = amb
    rows = torch.cat([a.movedim(1, 0).reshape(a.shape[1], -1) for a in either.values()], dim=1)
    rank = rows.cumsum(1) - 1
    count = int(rows.sum(1).max()) if rows.numel() else 0
    if count > _MAX_ALTERNATIVES:
        raise ValueError(f'{count} rounding points of one row within {_EITHER_WAY:g} of a '
                         'bf16 midpoint')
    alts = []
    for k in range(count):
        pick = (rows & (rank == k)).reshape(rows.shape[0], -1)
        flips, start = {}, 0
        for name, a in either.items():
            n = a[:, 0].numel()
            flips[name] = pick[:, start:start + n].reshape(a.movedim(1, 0).shape).movedim(0, 1)
            start += n

        def other_way(name, x, nearest):
            if name not in flips:
                return nearest
            return torch.where(flips[name], _other_bf16(x, nearest), nearest)

        alt = plain(*args, state=state, acc=torch.float64, rounding=other_way)
        alts.append(tuple(a - b for a, b in zip(alt[:n_in], ref[:n_in])))
    return ref, alts


def reference_ratios(got, ref, alts, atol=1e-5, rtol=2.0 ** -7):
    """Each input grad of ``got`` against `width_backward_reference`'s ``(ref,
    alts)``: the worst over its elements of |got - ref'| / (atol max|ref| +
    rtol |ref'|), ref' the nearest of ``ref`` plus any sum of the
    alternatives (one bf16 ulp at the defaults)."""
    ratios = []
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.to(r.dtype)
        a = atol * float(r.abs().max())
        best = None
        for pick in range(1 << len(alts)):
            cand = r
            for k, alt in enumerate(alts):
                if pick >> k & 1:
                    cand = cand + alt[i]
            ratio = (g - cand).abs() / (a + rtol * cand.abs() + 1e-300)
            best = ratio if best is None else torch.minimum(best, ratio)
        ratios.append(float(best.max()))
    return ratios


def _f32(t):
    t = t if t.dtype == torch.float32 else t.float()
    return t.contiguous()


def check_geometry(name, s, d):
    """The stream counts and widths the kernels take."""
    if not MIN_STREAMS <= s <= MAX_STREAMS:
        raise ValueError(f'{name}: the kernels take {MIN_STREAMS} to {MAX_STREAMS} streams, '
                         f'got {s}')
    if not 1 <= d <= max_dim(s):
        raise ValueError(f'{name}: the kernels take a width from 1 to {max_dim(s)} at {s} '
                         f'streams, got {d}')


def _checked_params(name, tensors, params, s, d, dtype, device):
    """Check what the kernels take (contiguous bf16 / f32 ``tensors`` on
    ``device``, the stream count and width, parameter shapes) and return the
    six parameters as contiguous f32."""
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f'{name} takes bf16 or f32 streams, got {dtype}')
    check_geometry(name, s, d)
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


def _launch(name, streams_in, params, s, m, d, dtype, device, save_state):
    """Launch K5 / K3, or K5s / K3s with ``save_state`` (then also returns
    ``(ta, inv)``)."""
    sa, sb, aw, ascale, bw, bscale = _checked_params(name, streams_in, params, s, d, dtype,
                                                     device)
    out_branch = torch.empty((m, d), dtype=dtype, device=device)
    out_carried = torch.empty((s, m, d), dtype=dtype, device=device)
    out_beta = torch.empty((s, m), dtype=dtype, device=device)
    state = None
    if save_state:
        state = (torch.empty((s, m, s + 2), dtype=torch.float32, device=device),
                 torch.empty((s, m), dtype=torch.float32, device=device))
    fn = getattr(_cuda.lib(), 'e2_' + name)
    err = fn(*(t.data_ptr() for t, _ in streams_in),
             sa.data_ptr(), sb.data_ptr(), aw.data_ptr(), bw.data_ptr(),
             ascale.data_ptr(), bscale.data_ptr(),
             out_branch.data_ptr(), out_carried.data_ptr(), out_beta.data_ptr(),
             *((t.data_ptr() for t in state) if save_state else (None, None)),
             s, m, d, _cuda.DTYPE_CODES[dtype], _cuda.stream_ptr(device))
    counter = name + ('_save' if save_state else '')
    _cuda.check(err, counter)
    _cuda.count_launch(counter)
    outs = (out_branch, out_carried, out_beta)
    return (outs, state) if save_state else outs


def _checked_state(name, state, s, m, device):
    ta, inv = state
    for t, label, shape in ((ta, 'ta', (s, m, s + 2)), (inv, 'inv', (s, m))):
        _cuda.check_cuda_tensor(t, label, device, torch.float32)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'{name}: saved {label} must be a contiguous f32 {shape} tensor')
    return ta, inv


def _launch_bwd(name, streams_in, grads_in, params, s, m, d, dtype, device, outs, state):
    """Launch K5b / K4 (K5bs / K4s with ``state``) and the fixed-order
    reduction of the per-block parameter-grad rows; returns the six
    parameter grads."""
    sa, sb, aw, ascale, bw, bscale = _checked_params(name, streams_in + grads_in, params, s,
                                                     d, dtype, device)
    nc = s + 2
    n_param = nc * d + _n_small(s)
    warps, blocks = _bwd_geometry(s, m, d, dtype)
    partials = torch.empty((blocks, n_param), dtype=torch.float32, device=device)
    row = torch.empty((n_param,), dtype=torch.float32, device=device)
    saved = ()
    if state is not None:
        name += '_save'
        saved = tuple(t.data_ptr() for t in _checked_state(name, state, s, m, device))
    fn = getattr(_cuda.lib(), 'e2_' + name)
    err = fn(*(t.data_ptr() for t, _ in streams_in + grads_in),
             sa.data_ptr(), sb.data_ptr(), aw.data_ptr(), bw.data_ptr(),
             ascale.data_ptr(), bscale.data_ptr(), *saved, *(t.data_ptr() for t in outs),
             partials.data_ptr(), row.data_ptr(), blocks, warps, s, m, d,
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


def width_connection_forward(residuals, *params, save_state=False):
    """K5 alone (K5s with ``save_state``; the counterpart of
    ``_width_pallas``): ``residuals (s, M, d)`` -> ``(branch_input,
    carried, beta)``, and with ``save_state`` ``((branch_input, carried,
    beta), (ta, inv))``. Not differentiable: `width_connection` is."""
    s, m, d = residuals.shape
    if residuals.device.type == 'cpu':
        return width_connection_plain(residuals, *params, save_state=save_state)
    return _launch('hc_width', [(residuals, 'residuals')], params, s, m, d,
                   residuals.dtype, residuals.device, save_state)


def width_connection_fused_forward(carried, branch, beta, *params, save_state=False):
    """K3 alone (K3s with ``save_state``; the counterpart of
    ``_width_fused_pallas``): outputs as `width_connection_forward`."""
    s, m, d = carried.shape
    if tuple(branch.shape) != (m, d) or tuple(beta.shape) != (s, m):
        raise ValueError('width_connection_fused: branch must be (M, d) and '
                         'beta (s, M) for carried (s, M, d)')
    if carried.device.type == 'cpu':
        return width_connection_fused_plain(carried, branch, beta, *params,
                                            save_state=save_state)
    return _launch('hc_width_fused', [(carried, 'carried'), (branch, 'branch'), (beta, 'beta')],
                   params, s, m, d, carried.dtype, carried.device, save_state)


def width_connection_backward(residuals, static_alpha, static_beta, dyn_alpha_w,
                              dyn_alpha_scale, dyn_beta_w, dyn_beta_scale,
                              g_branch_in, g_carried, g_beta, *, state=None):
    """K5b alone, or K5bs with the forward's ``state = (ta, inv)`` (the
    counterpart of ``_width_bwd_pallas``): returns ``(g_residuals,
    g_static_alpha, g_static_beta, g_dyn_alpha_w, g_dyn_alpha_scale,
    g_dyn_beta_w, g_dyn_beta_scale)``."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    s, m, d = residuals.shape
    grads = _grads_or_zeros(g_branch_in, g_carried, g_beta, s, m, d, residuals)
    if residuals.device.type == 'cpu':
        return width_connection_backward_plain(residuals, *params, *grads, state=state)
    g_res = torch.empty_like(residuals)
    pgrads = _launch_bwd('hc_width_bwd', [(residuals, 'residuals')],
                         list(zip(grads, ('g_branch_in', 'g_carried', 'g_beta'))),
                         params, s, m, d, residuals.dtype, residuals.device, [g_res], state)
    return (g_res, *pgrads)


def width_connection_fused_backward(carried, branch, beta, static_alpha, static_beta,
                                    dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
                                    dyn_beta_scale, g_branch_in, g_carried, g_beta, *,
                                    state=None):
    """K4 alone, or K4s with the forward's ``state = (ta, inv)`` (the
    counterpart of ``_width_fused_bwd_pallas``): returns ``(g_carried,
    g_branch, g_beta_prev, *param_grads)``."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale,
              dyn_beta_w, dyn_beta_scale)
    s, m, d = carried.shape
    grads = _grads_or_zeros(g_branch_in, g_carried, g_beta, s, m, d, carried)
    if carried.device.type == 'cpu':
        return width_connection_fused_backward_plain(carried, branch, beta, *params, *grads,
                                                     state=state)
    outs = [torch.empty_like(carried), torch.empty_like(branch), torch.empty_like(beta)]
    pgrads = _launch_bwd('hc_width_fused_bwd',
                         [(carried, 'carried'), (branch, 'branch'), (beta, 'beta')],
                         list(zip(grads, ('g_branch_in', 'g_carried', 'g_beta'))),
                         params, s, m, d, carried.dtype, carried.device, outs, state)
    return (*outs, *pgrads)


def _param_grads(params, grads):
    """Each parameter grad in its parameter's dtype and shape."""
    return tuple(g.to(p.dtype).reshape(p.shape) for p, g in zip(params, grads))


def _save_and_split(ctx, out, save_state, inputs):
    """Keep the inputs (and the save-state path's ``(ta, inv)``) for the
    backward; return the public outputs."""
    ctx.save_state = save_state
    if save_state:
        out, state = out
        ctx.save_for_backward(*inputs, *state)
    else:
        ctx.save_for_backward(*inputs)
    return out


def _saved(ctx):
    """The inputs and the state (or None) that `_save_and_split` kept."""
    saved = ctx.saved_tensors
    return (saved[:-2], tuple(saved[-2:])) if ctx.save_state else (saved, None)


class _Width(torch.autograd.Function):
    """K5 (or K5s) forward, K5b (or K5bs) backward."""

    @staticmethod
    def forward(ctx, residuals, save_state, *params):
        out = width_connection_forward(residuals, *params, save_state=save_state)
        return _save_and_split(ctx, out, save_state, (residuals, *params))

    @staticmethod
    def backward(ctx, g_branch_in, g_carried, g_beta):
        (residuals, *params), state = _saved(ctx)
        g_res, *grads = width_connection_backward(residuals, *params, g_branch_in,
                                                  g_carried, g_beta, state=state)
        return (g_res, None, *_param_grads(params, grads))


class _WidthFused(torch.autograd.Function):
    """K3 (or K3s) forward, K4 (or K4s) backward."""

    @staticmethod
    def forward(ctx, carried, branch, beta, save_state, *params):
        out = width_connection_fused_forward(carried, branch, beta, *params,
                                             save_state=save_state)
        return _save_and_split(ctx, out, save_state, (carried, branch, beta, *params))

    @staticmethod
    def backward(ctx, g_branch_in, g_carried, g_beta):
        (carried, branch, beta, *params), state = _saved(ctx)
        g_c, g_br, g_bp, *grads = width_connection_fused_backward(
            carried, branch, beta, *params, g_branch_in, g_carried, g_beta, state=state)
        return (g_c, g_br, g_bp, None, *_param_grads(params, grads))


def _keeps_state(save_state, tensors):
    """Save the state only where a backward can follow."""
    return bool(save_state) and torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)


def width_connection(residuals, static_alpha, static_beta, dyn_alpha_w,
                     dyn_alpha_scale, dyn_beta_w, dyn_beta_scale, *, save_state=False):
    """K5: ``residuals (s, M, d)`` -> ``(branch_input (M, d), carried
    (s, M, d), beta (s, M))``; differentiable (backward: K5b). With
    ``save_state``, when a backward can follow, K5s and K5bs instead."""
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
              dyn_beta_scale)
    return _Width.apply(residuals, _keeps_state(save_state, (residuals, *params)), *params)


def width_connection_fused(carried, branch, beta, static_alpha, static_beta,
                           dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
                           dyn_beta_scale, *, save_state=False):
    """K3: ``carried (s, M, d)``, ``branch (M, d)``, ``beta (s, M)`` stand
    for the streams ``carried + branch * beta``; same outputs as K5;
    differentiable (backward: K4). With ``save_state``, when a backward can
    follow, K3s and K4s instead."""
    s, m, d = carried.shape
    if tuple(branch.shape) != (m, d) or tuple(beta.shape) != (s, m):
        raise ValueError('width_connection_fused: branch must be (M, d) and '
                         'beta (s, M) for carried (s, M, d)')
    params = (static_alpha, static_beta, dyn_alpha_w, dyn_alpha_scale, dyn_beta_w,
              dyn_beta_scale)
    save = _keeps_state(save_state, (carried, branch, beta, *params))
    return _WidthFused.apply(carried, branch, beta, save, *params)
