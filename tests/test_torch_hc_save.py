"""The hyper-connection kernels at any stream count and width, and their
save-state variants K5s / K3s / K5bs / K4s, against the JAX package on the
CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version;
the JAX side runs the JAX package's Pallas kernels in interpret mode
(``_INTERPRET`` set on the imported module), and its save-state path with
``_SAVE_STATE`` set the same way. Inputs come from numpy seeds. A zero row
in the streams puts the rms statistic on its clamp (``inv`` = 1e6), where
the save path's test ``inv < 1e6`` and the recompute path's ``var > 1e-12``
must agree.

Tolerances: f32 values and grads 1e-6 relative plus 1e-6 of the tensor's
largest |value| (sums of a few hundred f32 products in other orders; the
saved ``ta`` and ``inv`` are single f32 ops); bf16 1e-2 relative plus 1e-2 of
the largest |value| (the kernels' limits on the card: the two sides round at
the same points and sum in other orders, one bf16 ulp is 2**-8). The
parameter grads are compared as one vector by relative L2 (see
`_grads_close`). The model-level tests are in tests/test_torch_paper.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2_tts_tpu.ops.hyper_conn_kernel as jhck

from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck

SAVE_CASES = [(4, 200, 256), (2, 130, 64), (3, 50, 96)]


@pytest.fixture
def interpret():
    saved = jhck._INTERPRET
    jhck._INTERPRET = True
    yield
    jhck._INTERPRET = saved


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _close(port, ref, rel):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rel, atol=rel * float(np.abs(ref).max()) + 1e-30)


def _grads_close(got, want, n_inputs, rel):
    """The input grads tensor by tensor (`_close`); the six parameter grads
    as one vector by relative L2: the two scale grads are sums of M s (s+2)
    products that cancel to ~1e-3 of their terms, so alone they carry f32
    summation noise far above ``rel`` of their own size."""
    assert len(got) == len(want) == n_inputs + 6
    for a, b in zip(got[:n_inputs], want[:n_inputs]):
        _close(a, b, rel)
    for a, b in zip(got[n_inputs:], want[n_inputs:]):
        assert _np(a).shape == _np(b).shape
    a = np.concatenate([_np(t).ravel() for t in got[n_inputs:]])
    b = np.concatenate([_np(t).ravel() for t in want[n_inputs:]])
    assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _params(s, d, seed):
    rng = np.random.default_rng(seed)
    alpha0 = np.zeros((s, 1), np.float32)
    alpha0[seed % s, 0] = 1.0
    return (np.concatenate([alpha0, np.eye(s, dtype=np.float32)], axis=1)
            + 0.1 * rng.standard_normal((s, s + 1)).astype(np.float32),
            1.0 + 0.1 * rng.standard_normal(s).astype(np.float32),
            0.05 * rng.standard_normal((d, s + 1)).astype(np.float32),
            np.float32(0.3),
            0.05 * rng.standard_normal(d).astype(np.float32),
            np.float32(0.3))


def _case(s, m, d, seed, fused):
    """Streams with one zero row (row 3 of every stream), the incoming grads
    and the parameters, as numpy."""
    rng = np.random.default_rng(seed)
    if fused:
        carried = rng.standard_normal((s, m, d)).astype(np.float32)
        branch = rng.standard_normal((m, d)).astype(np.float32)
        beta = (0.5 * rng.standard_normal((s, m))).astype(np.float32)
        carried[:, 3], branch[3] = 0.0, 0.0
        inputs = (carried, branch, beta)
    else:
        res = rng.standard_normal((s, m, d)).astype(np.float32)
        res[:, 3] = 0.0
        inputs = (res,)
    grads = (rng.standard_normal((m, d)).astype(np.float32),
             rng.standard_normal((s, m, d)).astype(np.float32),
             rng.standard_normal((s, m)).astype(np.float32))
    return inputs, grads, _params(s, d, seed + 1)


def _jax_inputs(inputs, fused, jdt):
    """The JAX kernels take the previous beta transposed, (M, s)."""
    if fused:
        carried, branch, beta = inputs
        return (jnp.asarray(carried, jdt), jnp.asarray(branch, jdt), jnp.asarray(beta.T, jdt))
    return (jnp.asarray(inputs[0], jdt),)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('fused', [False, True], ids=['K5s', 'K3s'])
@pytest.mark.parametrize('s,m,d', SAVE_CASES)
def test_save_variants_match_jax_save_path(interpret, s, m, d, fused, dtype):
    """K5s / K3s: the public outputs and the saved (ta, inv) against
    ``_width_pallas(save_state=True)`` / ``_width_fused_pallas(...)``; then
    K5bs / K4s from that state against ``_width_bwd_pallas(state=)`` /
    ``_width_fused_bwd_pallas(state=)``, and against the recomputing
    adjoint. ta is compared on its s+2 used columns (the JAX state carries a
    lane pad)."""
    tdt, jdt = (torch.float32, jnp.float32) if dtype == 'f32' else (torch.bfloat16,
                                                                     jnp.bfloat16)
    rel = 1e-6 if dtype == 'f32' else 1e-2
    inputs, gouts, params = _case(s, m, d, seed=s * 100 + d, fused=fused)
    tin = [_t(a, tdt) for a in inputs]
    if fused:
        tin[2] = _t(inputs[2], tdt)
    tparams = [torch.as_tensor(p) for p in params]
    jin = _jax_inputs(inputs, fused, jdt)
    jparams = [jnp.asarray(p) for p in params]
    fwd = hck.width_connection_fused_forward if fused else hck.width_connection_forward
    jfwd = jhck._width_fused_pallas if fused else jhck._width_pallas
    pub, (ta, inv) = fwd(*tin, *tparams, save_state=True)
    jpub, (jta, jinv) = jfwd(*jin, *jparams, save_state=True)
    assert ta.shape == (s, m, s + 2) and inv.shape == (s, m)
    assert ta.dtype == inv.dtype == torch.float32
    for a, b in zip(pub, jpub):
        _close(a, b, rel)
    _close(ta, jta[..., :s + 2], 1e-6 if dtype == 'f32' else 1e-2)
    _close(inv, jinv, 1e-6)
    assert float(inv[0, 3]) == pytest.approx(1e6, rel=1e-6)      # the zero row
    # the public outputs do not depend on the flag
    for a, b in zip(pub, fwd(*tin, *tparams)):
        assert torch.equal(a, b)

    tg = [_t(g, tdt) for g in gouts]
    jg = [jnp.asarray(g, jdt) for g in gouts]
    bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
    jbwd = jhck._width_fused_bwd_pallas if fused else jhck._width_bwd_pallas
    got = bwd(*tin, *tparams, *tg, state=(ta, inv))
    want = list(jbwd(*jin, *jparams, *jg, state=(jta, jinv)))
    if fused:
        want[2] = jnp.transpose(want[2])
    _grads_close(got, want, len(tin), rel)
    # the save path against the recomputing adjoint, the zero row included
    _grads_close(got, bwd(*tin, *tparams, *tg), len(tin), rel)


@pytest.mark.parametrize('s,d', [(2, 32), (2, 100), (3, 32), (3, 100)])
def test_width_any_streams_and_width_match_jax_kernels(interpret, s, d):
    """K5 / K3 and their adjoints K5b / K4 (plain versions) at stream counts
    and widths the flagship does not use, against the JAX kernels and jax.vjp
    through them."""
    m = 40
    for fused in (False, True):
        inputs, gouts, params = _case(s, m, d, seed=7 * s + d, fused=fused)
        tin, tparams = [_t(a) for a in inputs], [torch.as_tensor(p) for p in params]
        jin, jparams = _jax_inputs(inputs, fused, jnp.float32), [jnp.asarray(p) for p in params]
        jfn = jhck.width_connection_fused if fused else jhck.width_connection
        jout, vjp = jax.vjp(jfn, *jin, *jparams)
        fn = hck.width_connection_fused if fused else hck.width_connection
        for a, b in zip(fn(*tin, *tparams), jout):
            _close(a, b, 1e-6)
        want = list(vjp(tuple(jnp.asarray(g) for g in gouts)))
        if fused:
            want[2] = jnp.transpose(want[2])
        bwd = hck.width_connection_fused_backward if fused else hck.width_connection_backward
        _grads_close(bwd(*tin, *tparams, *map(_t, gouts)), want, len(tin), 1e-5)


def test_autograd_save_state_keeps_state_only_for_a_backward():
    """``save_state`` changes no value: the autograd grads with the flag
    equal the recomputing adjoint's within f32 summation order; under
    ``no_grad`` the flag runs the plain forward and keeps nothing."""
    s, m, d = 3, 30, 48
    inputs, gouts, params = _case(s, m, d, seed=5, fused=True)
    tin, tparams = [_t(a) for a in inputs], [torch.as_tensor(p) for p in params]
    grads = {}
    for save in (False, True):
        leaves = [t.clone().requires_grad_() for t in [*tin, *tparams]]
        out = hck.width_connection_fused(*leaves, save_state=save)
        sum((o * _t(g)).sum() for o, g in zip(out, gouts)).backward()
        grads[save] = [leaf.grad for leaf in leaves]
        assert out[0].grad_fn.save_state == save
    _grads_close(grads[True], grads[False], 3, 1e-6)
    with torch.no_grad():
        out = hck.width_connection(_t(inputs[0]), *tparams, save_state=True)
    assert out[0].grad_fn is None


def test_geometry_limits_raise():
    """The kernels' stream and width limits (the CPU path checks them only on
    the card; the limits themselves are plain arithmetic)."""
    assert hck.max_dim(8) >= 2048 and hck.max_dim(4) >= 4096
    for s, d in ((1, 64), (9, 64), (4, 0), (4, hck.max_dim(4) + 1), (8, hck.max_dim(8) + 1)):
        with pytest.raises(ValueError):
            hck.check_geometry('test', s, d)
    hck.check_geometry('test', 8, hck.max_dim(8))
    hck.check_geometry('test', 2, 1)
