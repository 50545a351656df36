"""The port's backward kernels K2 (with its delta pre-pass K10), K4, K5b and
K7 against the JAX package, on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version;
the JAX side is ``jax.vjp`` of the JAX package's public function with its
Pallas kernels in interpret mode (so the backward runs ``_packed_bwd_kernel``,
``_width_bwd_kernel``, ``_width_fused_bwd_kernel`` and ``_bwd_kernel``; K10
against ``_delta_kernel`` directly), and
for GEGLU at an inner the Pallas kernel does not take, its XLA reference.
Inputs and output grads come from numpy seeds.

Tolerances: everything is f32. The forward values agree to a few f32 ulps
(1e-5, as in tests/test_torch_kernels.py); a grad is a sum over up to a few
hundred rows of such values, so grads are held to 1e-5 relative plus 1e-5
of the largest |grad| of the tensor (2e-5 for the attention grads, which
sum two matrix products of length n over the recomputed probabilities).
Dropout enters both sides as the same keep bits (the masks themselves are
compared bit for bit in tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2_tts_tpu.ops.flash_attention as jfa
import e2_tts_tpu.ops.geglu_kernel as jgk
import e2_tts_tpu.ops.hyper_conn_kernel as jhck

from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.ops import geglu_kernel as gk
from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck


@pytest.fixture
def interpret():
    saved = (jfa._INTERPRET, jhck._INTERPRET, jgk._INTERPRET)
    jfa._INTERPRET = jhck._INTERPRET = jgk._INTERPRET = True
    yield
    jfa._INTERPRET, jhck._INTERPRET, jgk._INTERPRET = saved


def _close(port, ref, rel=1e-5):
    """|port - ref| <= rel * (|ref| + max |ref|), per tensor."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rel, atol=rel * float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- K2: packed flash attention backward ------------------------------------------------

def _attn_case(seed, b=2, n=128, heads=4, dh=32, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, heads * dh)).astype(np.float32) for _ in range(3))
    q, k = q * qk_scale, k * qk_scale
    mask = np.ones((b, n), bool)
    mask[1, 83:] = False                       # ragged second sample
    gate = (2 * rng.standard_normal((b, n, heads))).astype(np.float32)
    dout = rng.standard_normal((b, n, heads * dh)).astype(np.float32)
    return q, k, v, mask, gate, dout


# every gate / dropout / softclamp combination at dim_head 32, and K2's other
# head widths gated with dropout 0.1 and softclamp 50
_BWD_CASES = [pytest.param(gated, rate, softclamp, 32, id=f'softclamp{softclamp:g}-{rate}-{gated}')
              for softclamp in (50.0, 2.0) for rate in (0.0, 0.1) for gated in (False, True)]
_BWD_CASES += [pytest.param(True, 0.1, 50.0, dh, id=f'softclamp50-0.1-True-dh{dh}')
               for dh in (64, 128)]


@pytest.mark.parametrize('gated, rate, softclamp, dh', _BWD_CASES)
def test_flash_backward_matches_jax_kernel(interpret, gated, rate, softclamp, dh):
    """dq, dk, dv and d gate_logits of the plain K2 (a gated layer's do gated
    by the plain K10) against jax.vjp through `_packed_bwd_kernel`, which
    gates do inside its tile loop; softclamp 2 puts the scores (~N(0, 1)
    scaled by 3) deep into the tanh, so its Jacobian matters."""
    q, k, v, mask, gate, dout = _attn_case(seed=int(gated) + 2 * int(rate > 0), dh=dh,
                                           qk_scale=3.0 if softclamp == 2.0 else 1.0)
    seed, heads = 4321, 4
    kw = dict(heads=heads, softclamp_value=softclamp, dropout_rate=rate)

    def jfn(q, k, v, gate):
        return jfa.flash_attention_packed(q, k, v, jnp.asarray(mask), dropout_seed=seed,
                                          gate_logits=gate if gated else None, **kw)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, gate)))
    jgrads = vjp(jnp.asarray(dout))

    out, lse = fa.flash_attention_packed(_t(q), _t(k), _t(v), _t(mask), dropout_seed=seed,
                                         gate_logits=_t(gate) if gated else None,
                                         return_lse=True, **kw)
    pgrads = fa.flash_attention_packed_backward(
        _t(q), _t(k), _t(v), _t(mask), out, lse, _t(dout), dropout_seed=seed,
        gate_logits=_t(gate) if gated else None, **kw)
    for p, j in zip(pgrads[:3], jgrads[:3]):
        _close(p.numpy(), j, rel=2e-5)
    if gated:
        _close(pgrads[3].numpy(), jgrads[3], rel=2e-5)
    else:
        assert pgrads[3] is None


@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_flash_backward_matches_autograd_of_plain_forward(rate):
    """K2's hand-written plain backward against torch.autograd through the
    plain forward (same bits, f32); also what the autograd.Function returns."""
    q, k, v, mask, gate, dout = _attn_case(seed=7, qk_scale=2.0)
    kw = dict(heads=4, scale=32 ** -0.5, softclamp_value=5.0, dropout_rate=rate,
              dropout_seed=99)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, gate)]
    out, _ = fa.flash_attention_packed_plain(*leaves[:3], _t(mask), gate_logits=leaves[3], **kw)
    (out * _t(dout)).sum().backward()
    auto = [t.grad for t in leaves]

    out, lse = fa.flash_attention_packed_plain(_t(q), _t(k), _t(v), _t(mask),
                                               gate_logits=_t(gate), **kw)
    hand = fa.flash_attention_packed_backward(_t(q), _t(k), _t(v), _t(mask), out, lse,
                                              _t(dout), gate_logits=_t(gate), **kw)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, gate)]
    out = fa.flash_attention_packed(*leaves[:3], _t(mask), gate_logits=leaves[3], **kw)
    (out * _t(dout)).sum().backward()
    for a, h, f in zip(auto, hand, [t.grad for t in leaves]):
        _close(h.numpy(), a.numpy())
        np.testing.assert_array_equal(f.numpy(), h.numpy())


# -- K10: the delta pre-pass of K2 ------------------------------------------------------

@pytest.mark.parametrize('shape', [(2, 128, 4, 32), (3, 37, 8, 64), (1, 20, 2, 128)],
                         ids=['4x32', 'ragged_n_8x64', '2x128'])
def test_flash_delta_matches_jax_kernel(interpret, shape):
    """K10's plain version against ``_delta_kernel`` in interpret mode and
    the XLA pre-pass, 1e-5 relative (f32 sums of dh products in other
    orders; the JAX kernel sums on the MXU through a 0/1 matrix)."""
    b, n, heads, dh = shape
    rng = np.random.default_rng(n)
    o, do = (rng.standard_normal((b, n, heads * dh)).astype(np.float32) for _ in range(2))
    do_t = _t(do)
    port, do_g = fa.flash_delta(_t(o), do_t, heads=heads)
    assert port.shape == (b, n, heads) and port.dtype == torch.float32
    assert do_g is do_t                                 # ungated: do itself, no copy
    for ref in (jfa._delta_bnh_pallas(jnp.asarray(o), jnp.asarray(do), heads),
                jfa._delta_bnh_xla(jnp.asarray(o), jnp.asarray(do), heads)):
        _close(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_gated_flash_delta_plain(dtype):
    """The gated K10's plain version: the same delta as without the gate
    (the ungated do against o), and do_g = do * sigmoid(gate) per head,
    rounded to do's dtype, bit for bit."""
    b, n, heads, dh = 2, 37, 4, 64
    rng = np.random.default_rng(5)
    o, do = (_t(rng.standard_normal((b, n, heads * dh)).astype(np.float32)).to(dtype)
             for _ in range(2))
    gate = _t(2 * rng.standard_normal((b, n, heads)).astype(np.float32)).to(dtype)
    delta, do_g = fa.flash_delta(o, do, heads=heads, gate_logits=gate)
    assert torch.equal(delta, fa.flash_delta(o, do, heads=heads)[0])
    g = torch.sigmoid(gate.float())[..., None]
    ref = (do.float().view(b, n, heads, dh) * g).to(dtype).view(b, n, heads * dh)
    assert do_g.dtype == dtype and torch.equal(do_g, ref)


# -- K5b / K4: hyper-connection width-connection adjoints -------------------------------

def _hc_params(s=4, d=128, seed=0):
    rng = np.random.default_rng(seed)
    alpha0 = np.zeros((s, 1), np.float32)
    alpha0[1, 0] = 1.0
    return (np.concatenate([alpha0, np.eye(s, dtype=np.float32)], axis=1)
            + 0.1 * rng.standard_normal((s, s + 1)).astype(np.float32),
            1.0 + 0.1 * rng.standard_normal(s).astype(np.float32),
            0.05 * rng.standard_normal((d, s + 1)).astype(np.float32),
            np.float32(0.3),
            0.05 * rng.standard_normal(d).astype(np.float32),
            np.float32(0.3))


def _hc_out_grads(rng, s, m, d):
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((s, m, d)).astype(np.float32),
            rng.standard_normal((s, m)).astype(np.float32))


@pytest.mark.parametrize('d', [128, 256])
def test_width_backward_matches_jax_kernel(interpret, d):
    """K5b: grads of the streams and all six parameters; M = 150 is not a
    multiple of the JAX adjoint's 128-row block."""
    rng = np.random.default_rng(d)
    s, m = 4, 150
    res = rng.standard_normal((s, m, d)).astype(np.float32)
    params = _hc_params(s, d, seed=d + 1)
    gouts = _hc_out_grads(rng, s, m, d)
    _, vjp = jax.vjp(jhck.width_connection, jnp.asarray(res), *map(jnp.asarray, params))
    jgrads = vjp(tuple(map(jnp.asarray, gouts)))
    pgrads = hck.width_connection_backward(_t(res), *(torch.as_tensor(p) for p in params),
                                           *map(_t, gouts))
    assert len(pgrads) == len(jgrads) == 7
    for p, j in zip(pgrads, jgrads):
        _close(p.numpy(), j)


@pytest.mark.parametrize('d', [128, 256])
def test_width_fused_backward_matches_jax_kernel(interpret, d):
    """K4: grads of carried, branch, beta and the six parameters. The JAX
    function takes beta as (M, s) and the port as (s, M): the beta grad is
    compared transposed."""
    rng = np.random.default_rng(d + 7)
    s, m = 4, 150
    carried = rng.standard_normal((s, m, d)).astype(np.float32)
    branch = rng.standard_normal((m, d)).astype(np.float32)
    beta = (0.5 * rng.standard_normal((s, m))).astype(np.float32)
    params = _hc_params(s, d, seed=d + 8)
    gouts = _hc_out_grads(rng, s, m, d)
    _, vjp = jax.vjp(jhck.width_connection_fused, jnp.asarray(carried), jnp.asarray(branch),
                     jnp.asarray(beta.T), *map(jnp.asarray, params))
    jgrads = list(vjp(tuple(map(jnp.asarray, gouts))))
    jgrads[2] = jnp.transpose(jgrads[2])
    pgrads = hck.width_connection_fused_backward(
        _t(carried), _t(branch), _t(beta), *(torch.as_tensor(p) for p in params),
        *map(_t, gouts))
    assert len(pgrads) == len(jgrads) == 9
    for p, j in zip(pgrads, jgrads):
        _close(p.numpy(), j)


def test_width_autograd_functions_use_the_adjoints():
    """`width_connection(_fused)` differentiate through K5b / K4: the
    autograd.Function grads equal the adjoints called alone; an output that
    gets no grad counts as a zero grad."""
    rng = np.random.default_rng(11)
    s, m, d = 4, 40, 64
    carried, branch = rng.standard_normal((s, m, d)), rng.standard_normal((m, d))
    beta = 0.5 * rng.standard_normal((s, m))
    carried, branch, beta = (_t(a.astype(np.float32)) for a in (carried, branch, beta))
    params = [torch.as_tensor(p) for p in _hc_params(s, d, seed=12)]
    g_b0, g_car, _ = (_t(a) for a in _hc_out_grads(rng, s, m, d))

    leaves = [t.clone().requires_grad_() for t in [carried, branch, beta, *params]]
    b0, car, _ = hck.width_connection_fused(*leaves)
    ((b0 * g_b0).sum() + (car * g_car).sum()).backward()
    alone = hck.width_connection_fused_backward(carried, branch, beta, *params, g_b0, g_car,
                                                None)
    for leaf, a in zip(leaves, alone):
        np.testing.assert_array_equal(leaf.grad.numpy(), a.numpy())

    leaves = [t.clone().requires_grad_() for t in [carried, *params]]
    b0, car, _ = hck.width_connection(*leaves)
    ((b0 * g_b0).sum() + (car * g_car).sum()).backward()
    alone = hck.width_connection_backward(carried, *params, g_b0, g_car,
                                          torch.zeros(s, m))
    for leaf, a in zip(leaves, alone):
        np.testing.assert_array_equal(leaf.grad.numpy(), a.numpy())


# -- K7: GEGLU + dropout backward ----------------------------------------------------------

@pytest.mark.parametrize('inner', [128, 256])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_geglu_backward_matches_jax_kernel(interpret, inner, rate):
    rng = np.random.default_rng(inner + int(rate * 10))
    h2 = rng.standard_normal((2, 48, 2 * inner)).astype(np.float32)
    gout = rng.standard_normal((2, 48, inner)).astype(np.float32)
    seed = 987654321
    assert jgk._use_pallas(jnp.asarray(h2), rate)
    _, vjp = jax.vjp(lambda a: jgk.geglu_dropout(a, jnp.uint32(seed), rate), jnp.asarray(h2))
    (jgrad,) = vjp(jnp.asarray(gout))
    _close(gk.geglu_dropout_backward(_t(h2), _t(gout), seed, rate).numpy(), jgrad)


@pytest.mark.parametrize('inner', [64, 96])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_geglu_backward_matches_jax_reference(inner, rate):
    """An inner the Pallas kernel does not take: jax.vjp of the XLA
    reference; the port's autograd.Function gives the same grad."""
    rng = np.random.default_rng(inner + int(rate * 10))
    h2 = rng.standard_normal((2, 30, 2 * inner)).astype(np.float32)
    gout = rng.standard_normal((2, 30, inner)).astype(np.float32)
    seed = 12345
    _, vjp = jax.vjp(lambda a: jgk._geglu_dropout_reference(a, jnp.uint32(seed), rate),
                     jnp.asarray(h2))
    (jgrad,) = vjp(jnp.asarray(gout))
    _close(gk.geglu_dropout_backward(_t(h2), _t(gout), seed, rate).numpy(), jgrad)
    x = _t(h2).requires_grad_()
    (gk.geglu_dropout(x, seed, rate) * _t(gout)).sum().backward()
    _close(x.grad.numpy(), jgrad)
