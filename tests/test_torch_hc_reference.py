"""The f64 reference of the hyper-connection adjoints, on the CPU.

`width_connection_backward_plain` / `width_connection_fused_backward_plain`
take ``acc``, the dtype of their sums and elementwise math: f32 (the
default) is the kernels' plain version, f64 the reference the card holds
K5b / K4 / K5bs / K4s against. At f32 streams no compute-dtype rounding
applies, so the f64 reference must agree with the f32 plain version within
f32 error, and with ``jax.vjp`` of the JAX package's pure reference
(``_width_reference_split`` / ``_width_fused_reference_split``) in f32.

Tolerances: the input grads elementwise at 1e-5 relative plus 1e-5 of the
tensor's largest |value| (f32 sums of a few hundred terms, ~1e-7 relative
each); the six parameter grads as one vector at 1e-5 relative L2 (the scale
grads alone are sums of M s (s+2) products that cancel to ~1e-3 of their
terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2_tts_tpu.ops.hyper_conn_kernel as jhck

from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck

CASES = [(4, 60, 96), (2, 40, 64), (3, 33, 100)]
F64 = torch.float64


def _case(s, m, d, seed, fused):
    """Streams with one zero row (row 3: the rms clamp), incoming grads and
    parameters, as numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(np.float32)
    if fused:
        inputs = [f(s, m, d), f(m, d), f(s, m, scale=0.5)]
        inputs[0][:, 3], inputs[1][3] = 0.0, 0.0
    else:
        inputs = [f(s, m, d)]
        inputs[0][:, 3] = 0.0
    params = (np.eye(s, s + 1, 1, dtype=np.float32) + f(s, s + 1, scale=0.1),
              1.0 + f(s, scale=0.1), f(d, s + 1, scale=0.05), np.float32(0.4),
              f(d, scale=0.05), np.float32(0.3))
    return inputs, (f(m, d), f(s, m, d), f(s, m)), params


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).astype(np.float64)


def _grads_close(got, want, n_inputs, rel=1e-5):
    assert len(got) == len(want) == n_inputs + 6
    for a, b in zip(got[:n_inputs], want[:n_inputs]):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max())
    a = np.concatenate([_np(t).ravel() for t in got[n_inputs:]])
    b = np.concatenate([_np(t).ravel() for t in want[n_inputs:]])
    assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b)


def _plain(fused):
    return (hck.width_connection_fused_backward_plain if fused
            else hck.width_connection_backward_plain)


@pytest.mark.parametrize('save', [False, True], ids=['recompute', 'save'])
@pytest.mark.parametrize('fused', [False, True], ids=['K5b', 'K4'])
@pytest.mark.parametrize('s,m,d', CASES)
def test_f64_reference_matches_f32_plain(s, m, d, fused, save):
    """The f64 adjoint returns every grad in f64 and agrees with the f32
    plain version within f32 error; the save form takes the forward's (ta,
    inv) as the f32 version does."""
    inputs, gouts, params = _case(s, m, d, seed=s * 31 + d, fused=fused)
    tin, tg = [_t(a) for a in inputs], [_t(g) for g in gouts]
    tp = [torch.as_tensor(p) for p in params]
    state = None
    if save:
        fwd = hck.width_connection_fused_plain if fused else hck.width_connection_plain
        _, state = fwd(*tin, *tp, save_state=True)
    ref = _plain(fused)(*tin, *tp, *tg, state=state, acc=F64)
    got = _plain(fused)(*tin, *tp, *tg, state=state)
    assert all(t.dtype == F64 for t in ref)
    assert all(t.dtype == torch.float32 for t in got)
    _grads_close(got, ref, len(tin))


@pytest.mark.parametrize('fused', [False, True], ids=['K5b', 'K4'])
@pytest.mark.parametrize('s,m,d', CASES)
def test_f64_reference_matches_jax_vjp(s, m, d, fused):
    """The f64 adjoint against ``jax.vjp`` of the JAX package's pure
    reference, in f32 (the JAX function takes beta as (M, s): its grad is
    compared transposed)."""
    inputs, gouts, params = _case(s, m, d, seed=s * 17 + d, fused=fused)
    jin = [jnp.asarray(a) for a in inputs]
    if fused:
        jin[2] = jnp.transpose(jin[2])
    jfn = jhck._width_fused_reference_split if fused else jhck._width_reference_split
    _, vjp = jax.vjp(jfn, *jin, *map(jnp.asarray, params))
    want = [np.asarray(x) for x in vjp(tuple(map(jnp.asarray, gouts)))]
    if fused:
        want[2] = want[2].T
    ref = _plain(fused)(*map(_t, inputs), *(torch.as_tensor(p) for p in params),
                        *map(_t, gouts), acc=F64)
    _grads_close(ref, want, len(inputs))


def test_f64_reference_keeps_the_bf16_rounding_points():
    """At bf16 streams the f64 reference rounds where the kernels round (inv,
    normed, alpha, gp, the depth connection) and nowhere else: its grads
    are f64, and the f32 plain version's stream grads are one bf16 rounding
    of values within f32 error of the reference's, on this small case where
    no rounding point lies within f32 error of a bf16 midpoint."""
    s, m, d = 4, 24, 64
    inputs, gouts, params = _case(s, m, d, seed=5, fused=True)
    tin = [_t(a).to(torch.bfloat16) for a in inputs]
    tg = [_t(g).to(torch.bfloat16) for g in gouts]
    tp = [torch.as_tensor(p) for p in params]
    ref = hck.width_connection_fused_backward_plain(*tin, *tp, *tg, acc=F64)
    got = hck.width_connection_fused_backward_plain(*tin, *tp, *tg)
    assert all(t.dtype == F64 for t in ref)
    assert [t.dtype for t in got[:3]] == [torch.bfloat16] * 3
    for a, b in zip(got[:3], ref[:3]):
        # one bf16 rounding: half an ulp, 2**-8 of |b|, plus f32 sums
        np.testing.assert_allclose(_np(a.float()), _np(b), rtol=2 ** -8,
                                   atol=1e-5 * float(b.abs().max()))
    _grads_close((*ref[:3], *got[3:]), ref, 3)


def test_other_bf16_is_the_neighbour_on_the_side_of_x():
    """`_other_bf16` steps the bf16 value to the side of the unrounded
    value, either sign, across a power of two."""
    x = torch.tensor([1.0 + 2 ** -9, 1.0 - 2 ** -10, -3.0 - 2 ** -8, -3.0 + 2 ** -8, 0.75 + 1e-6],
                     dtype=F64)
    nearest = x.to(torch.bfloat16).to(F64)
    want = torch.tensor([1.0 + 2 ** -7, 1.0 - 2 ** -8, -3.0 - 2 ** -6, -3.0 + 2 ** -6,
                         0.75 + 2 ** -8], dtype=F64)
    assert torch.equal(hck._other_bf16(x, nearest), want)


@pytest.mark.parametrize('save', [False, True], ids=['recompute', 'save'])
@pytest.mark.parametrize('fused', [False, True], ids=['K5b', 'K4'])
def test_reference_set_holds_an_f32_adjoint_and_refuses_faults(fused, save):
    """bf16 streams: the f32 plain adjoint, an adjoint that sums in f32 as
    the kernels do, lies within one bf16 ulp of the f64 reference or of one
    of its alternatives (`width_backward_reference`, `reference_ratios`);
    the save form's alternatives leave inv alone. Row 0 left out fails by
    its stream grads."""
    s, m, d = 4, 400, 512
    inputs, gouts, params = _case(s, m, d, seed=11, fused=fused)
    tin = [_t(a).to(torch.bfloat16) for a in inputs]
    tg = [_t(g).to(torch.bfloat16) for g in gouts]
    tp = [torch.as_tensor(p) for p in params]
    state = None
    if save:
        fwd = hck.width_connection_fused_plain if fused else hck.width_connection_plain
        _, state = fwd(*tin, *tp, save_state=True)
    ref, alts = hck.width_backward_reference(fused, *tin, *tp, *tg, state=state)
    assert all(t.dtype == F64 for t in ref)
    assert all(len(a) == len(tin) for a in alts)
    got = _plain(fused)(*tin, *tp, *tg, state=state)
    assert max(hck.reference_ratios(got[:len(tin)], ref[:len(tin)], alts)) <= 1.0
    drop = [g.clone() for g in tg]
    drop[0][0], drop[1][:, 0], drop[2][:, 0] = 0, 0, 0
    dropped = _plain(fused)(*tin, *tp, *drop, state=state)
    assert max(hck.reference_ratios(dropped[:len(tin)], ref[:len(tin)], alts)) > 3.0


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32], ids=['bf16', 'f32'])
@pytest.mark.parametrize('fused', [False, True], ids=['K5b', 'K4'])
def test_save_adjoint_matches_recompute_on_tiny_and_zero_rows(fused, dtype):
    """A row of rms 1e-7 (its variance 1e-14, under the clamp, but its
    streams not zero) and a zero row: the plain save adjoint, from the
    plain forward's state, equals the recomputing plain adjoint. The state
    holds inv = rsqrt(1e-12) = 1e6 exactly there, so the save path's test
    inv < 1e6 agrees with the recomputing var > 1e-12; a saved inv one f32
    step under 1e6 would add 2 r g_sq on the tiny row, which this test must
    see."""
    s, m, d = 4, 12, 64
    inputs, gouts, params = _case(s, m, d, seed=23, fused=fused)
    inputs[0][:, 7] *= 1e-7                   # row 7: rms ~1e-7; row 3 is zero
    if fused:
        inputs[1][7] = 0.0
    tin = [_t(a).to(dtype) for a in inputs]
    tg = [_t(g).to(dtype) for g in gouts]
    tp = [torch.as_tensor(p) for p in params]
    fwd = hck.width_connection_fused_plain if fused else hck.width_connection_plain
    _, (ta, inv) = fwd(*tin, *tp, save_state=True)
    assert float(inv[:, 7].min()) == float(inv[:, 3].min()) == 1e6
    assert float(tin[0][:, 7].float().abs().max()) > 0
    rec = _plain(fused)(*tin, *tp, *tg)
    save = _plain(fused)(*tin, *tp, *tg, state=(ta, inv))
    for a, b in zip(save, rec):
        assert torch.equal(a, b)
    # the fault the test guards against: inv one f32 step under the clamp
    below = inv.clone()
    below[:, 7] = torch.nextafter(torch.tensor(1e6), torch.tensor(0.0))
    off = _plain(fused)(*tin, *tp, *tg, state=(ta, below))
    assert not torch.equal(off[0][:, 7], rec[0][:, 7])
    assert torch.equal(off[0][:, :7], rec[0][:, :7])
