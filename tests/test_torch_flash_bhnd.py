"""K8 and K9 (flash attention on (b, h, n, dh) operands), the attention op's
routing to them, LASER, and the cost-floor probe: the port against the JAX
package on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version;
the JAX side runs its Pallas kernels (`_fwd_kernel`, the backward kernels of
`_flash_backward`) in interpret mode, as its own kernel tests do. Inputs
come from numpy seeds.

Tolerances: everything is f32, so the sides differ only by summation order
and by the tanh / exp implementations: 1e-5 absolute and relative on
outputs and lse of order 1; the grads, sums over ~100 rows, 1e-5 relative
plus 1e-5 of the tensor's largest |grad|. Dropout masks are bit-identical
(the same counter hash on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2_tts_tpu.ops.flash_attention as jfa
from e2_tts_tpu.ops.attention import attention as jax_attention
from e2_tts_tpu.ops.attention import attention_packed as jax_attention_packed
from e2_tts_tpu.ops.rotary import apply_rotary_packed as jax_apply_rotary_packed
from e2_tts_tpu.ops.rotary import rotary_freqs as jax_rotary_freqs

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.ops.attention import attention, attention_packed
from e2_tts_tpu_torch.ops.rotary import apply_rotary_packed, rotary_tables

TOL = dict(atol=1e-5, rtol=1e-5)
SEED = 1234


@pytest.fixture
def interpret():
    saved = jfa._INTERPRET
    jfa._INTERPRET = True
    yield
    jfa._INTERPRET = saved


def _inputs(shape, seed=0, qk_scale=3.0):
    """q, k, v (b, h, n, dh) f32 (q, k scaled so a softclamp of 5 bites) and
    a (b, n) mask, ragged for the last sample when b > 1."""
    rng = np.random.default_rng(seed)
    b, h, n, dh = shape
    q, k = (qk_scale * rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    v = rng.standard_normal(shape).astype(np.float32)
    mask = np.ones((b, n), bool)
    if b > 1:
        mask[-1, (2 * n) // 3:] = False
    return q, k, v, mask


SHAPES = [(2, 3, 100, 72), (2, 2, 130, 16), (1, 4, 64, 8)]
# (softclamp, dropout rate): both off, both on
FEATURES = [(None, 0.0), (5.0, 0.1)]


def _bias(mask):
    return jnp.where(jnp.asarray(mask), 0.0, jfa.NEG_INF).astype(jnp.float32)


@pytest.mark.parametrize('softclamp,rate', FEATURES)
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_k8_plain_matches_jax_kernel(interpret, shape, softclamp, rate):
    """Out and lse against `_flash_forward` (the K8 call `flash_attention`
    makes), with a ragged mask, the softclamp and dropout."""
    q, k, v, mask = _inputs(shape)
    dh = shape[-1]
    out_j, lse_j = jfa._flash_forward(
        *map(jnp.asarray, (q, k, v)), _bias(mask), jnp.full((1,), SEED, jnp.int32),
        dh ** -0.5, softclamp, rate)
    out_p, lse_p = fa.flash_attention(
        *map(torch.from_numpy, (q, k, v, mask)), softclamp_value=softclamp, dropout_rate=rate,
        dropout_seed=SEED, return_lse=True)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j)[..., 0], **TOL)
    # the public JAX entry point agrees too
    out_jp = jfa.flash_attention(*map(jnp.asarray, (q, k, v, mask)), softclamp_value=softclamp,
                                 dropout_rate=rate, dropout_seed=SEED if rate else None)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_jp), **TOL)


def _assert_grads(ported, jax_grads):
    for name, p, j in zip('qkv', ported, jax_grads):
        j = np.asarray(j)
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(j).max()), err_msg=name)


@pytest.mark.parametrize('softclamp,rate', FEATURES)
@pytest.mark.parametrize('shape', [SHAPES[0], SHAPES[2]], ids=lambda s: 'x'.join(map(str, s)))
def test_k9_plain_matches_jax_vjp(interpret, shape, softclamp, rate):
    """dq, dk, dv of K9's plain version, through `flash_attention`'s
    autograd, against ``jax.vjp`` of the JAX `flash_attention` (its backward
    kernels in interpret mode)."""
    q, k, v, mask = _inputs(shape, seed=1)
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    f = lambda q, k, v: jfa.flash_attention(q, k, v, jnp.asarray(mask),
                                            softclamp_value=softclamp, dropout_rate=rate,
                                            dropout_seed=SEED if rate else None)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, torch.from_numpy(mask), softclamp_value=softclamp,
                             dropout_rate=rate, dropout_seed=SEED)
    out.backward(torch.from_numpy(g))
    _assert_grads((qt.grad, kt.grad, vt.grad), grads_j)


@pytest.mark.parametrize('laser', [False, True])
def test_attention_packed_routes_dh72_to_k8(interpret, laser):
    """dim_head 72 with the per-head gate (and LASER): `attention_packed`
    hands K8 strided views of the packed projection, against JAX
    `attention_packed(backend='pallas')`, which on the CPU routes to
    `attention` -> `flash_attention`; the output and the grads of q, k, v
    and the gate logits, with dropout drawn from the seed JAX draws."""
    rng = np.random.default_rng(3)
    b, n, heads, dh = 2, 70, 2, 72
    D = heads * dh
    qkv = rng.standard_normal((b, n, 3 * D)).astype(np.float32)
    gate = (2 * rng.standard_normal((b, n, heads))).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 50:] = False
    g = rng.standard_normal((b, n, D)).astype(np.float32)
    key = jax.random.key(4)
    seed = int(jax.random.randint(key, (1,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)[0])

    def f_j(qkv, gate):
        q, k, v = jnp.split(qkv, 3, axis=-1)
        return jax_attention_packed(q, k, v, jnp.asarray(mask), heads=heads, laser=laser,
                                    dropout_rate=0.1, dropout_rng=key, backend='pallas',
                                    gate_logits=gate)
    out_j, vjp = jax.vjp(f_j, jnp.asarray(qkv), jnp.asarray(gate))
    dqkv_j, dgate_j = vjp(jnp.asarray(g))

    qkv_t, gate_t = (torch.from_numpy(a).requires_grad_() for a in (qkv, gate))
    q, k, v = qkv_t[..., :D], qkv_t[..., D:2 * D], qkv_t[..., 2 * D:]
    out = attention_packed(q, k, v, torch.from_numpy(mask), heads=heads, laser=laser,
                           dropout_rate=0.1, dropout_seed=seed, gate_logits=gate_t)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for name, p, j in (('qkv', qkv_t.grad, dqkv_j), ('gate', gate_t.grad, dgate_j)):
        j = np.asarray(j)
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(j).max()), err_msg=name)


def test_attention_laser_matches_jax(interpret):
    """`attention` on (b, h, n, dh) with LASER against the JAX op on K8."""
    q, k, v, mask = _inputs((2, 2, 80, 48), seed=5, qk_scale=1.0)
    out_j = jax_attention(*map(jnp.asarray, (q, k, v, mask)), laser=True, backend='pallas')
    out_p = attention(*map(torch.from_numpy, (q, k, v, mask)), laser=True)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), **TOL)


def test_rotary_at_dim_head_72():
    rng = np.random.default_rng(6)
    t = rng.standard_normal((2, 40, 3 * 72)).astype(np.float32)
    j = jax_apply_rotary_packed(jnp.asarray(t), jax_rotary_freqs(40, 72))
    p = apply_rotary_packed(torch.from_numpy(t), rotary_tables(40, 72))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize('mode', fa.PROBE_MODES)
def test_probe_plain_matches_a_tile_loop(mode):
    """The probe's plain version against a loop over its 64-key tiles."""
    rng = np.random.default_rng(7)
    b, h, n, dh = 1, 2, 100, 24
    x = torch.from_numpy(0.3 * rng.standard_normal((b, h, n, dh)).astype(np.float32))
    x = x.to(torch.bfloat16)
    xf = x.float()
    acc = torch.zeros(b, h, n, dh)
    for k0 in range(0, n, 64):
        kv = torch.zeros(b, h, 64, dh)
        kv[:, :, :min(64, n - k0)] = xf[:, :, k0:k0 + 64]
        s = xf @ kv.transpose(-1, -2)
        if mode >= 1:
            s = s.exp()
        if mode == 2:
            s = s - (s.amax(-1, keepdim=True) + s.sum(-1, keepdim=True))
        acc += s.to(torch.bfloat16).float() @ kv
    out = fa.flash_probe(x, mode)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    # the f32 sums differ in order (tile by tile here, one product there), so
    # the bf16 outputs may differ by one ulp (2**-8 relative)
    torch.testing.assert_close(out.float(), acc.to(torch.bfloat16).float(), atol=1e-6,
                               rtol=2 ** -7)


def test_k8_wrapper_checks():
    """What K8's wrapper refuses before a launch (the checks run on any
    device): a dim_head outside 1..256, a dim_head that is not a multiple of
    8 at the launch (the wrapper pads such heads first), a head stride that
    is not a whole number of 16-byte chunks."""
    ok = torch.zeros(1, 2, 8, 72)
    fa._check_bhnd_inputs(ok, ok, ok, None)
    fa._check_bhnd_inputs(*(torch.zeros(1, 2, 8, 136),) * 3, None)
    for dh in (12, 4):
        t = torch.zeros(1, 2, 8, dh)
        with pytest.raises(ValueError, match='multiple of 8'):
            fa._check_bhnd_inputs(t, t, t, None)
    for dh in (264, 0):
        t = torch.zeros(1, 2, 8, dh)
        with pytest.raises(ValueError, match='from 1 to 256'):
            fa._check_bhnd_inputs(t, t, t, None)
    assert [fa._padded_dim_head(dh) for dh in (1, 8, 12, 250)] == [8, 8, 16, 256]
    # (b, n, h*dh) with dh 72 packed at an odd offset: rows of 2 * 72 + 2 floats
    skew = torch.zeros(1, 8, 146)[..., 2:].unflatten(-1, (2, 72)).transpose(1, 2)
    with pytest.raises(ValueError, match='strides'):
        fa._check_bhnd_inputs(skew, skew, skew, None)


@pytest.mark.parametrize('dh', [12, 160])
def test_k8_k9_plain_at_any_dim_head_match_jax(interpret, dh):
    """K8 / K9's plain versions at a head that is not a multiple of 8 (12:
    the wrapper pads it on the card) and one wider than 128 (160: two column
    chunks on the card), against `_flash_forward` and ``jax.vjp`` of the JAX
    `flash_attention` in interpret mode, softclamp and dropout on."""
    shape = (2, 2, 70, dh)
    q, k, v, mask = _inputs(shape, seed=dh)
    out_j, lse_j = jfa._flash_forward(
        *map(jnp.asarray, (q, k, v)), _bias(mask), jnp.full((1,), SEED, jnp.int32),
        dh ** -0.5, 5.0, 0.1)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out_p, lse_p = fa.flash_attention(qt, kt, vt, torch.from_numpy(mask), softclamp_value=5.0,
                                      dropout_rate=0.1, dropout_seed=SEED, return_lse=True)
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j)[..., 0], **TOL)

    g = np.random.default_rng(dh + 1).standard_normal(shape).astype(np.float32)
    f = lambda q, k, v: jfa.flash_attention(q, k, v, jnp.asarray(mask), softclamp_value=5.0,
                                            dropout_rate=0.1, dropout_seed=SEED)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    out_p.backward(torch.from_numpy(g))
    _assert_grads((qt.grad, kt.grad, vt.grad), vjp(jnp.asarray(g)))


def test_plain_paths_do_not_count_launches():
    before = dict(_cuda.launch_counts)
    x = torch.zeros(1, 2, 8, 72, requires_grad=True)
    fa.flash_attention(x, x, x).sum().backward()
    fa.flash_probe(torch.zeros(1, 2, 8, 72, dtype=torch.bfloat16), 0)
    assert _cuda.launch_counts == before
