"""The port's kernel modules against the JAX package, on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version;
the JAX side runs its Pallas kernel in interpret mode (as the JAX package's
own kernel tests do) and its XLA reference. Inputs come from numpy seeds.

Tolerances: everything is f32, so the sides differ only by summation order
and by transcendental implementations (tanh, erf, rsqrt, exp) — a few f32
ulps on values of order 1; 1e-5 absolute and relative. Dropout masks are
compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import e2_tts_tpu.ops.flash_attention as jfa
import e2_tts_tpu.ops.geglu_kernel as jgk
import e2_tts_tpu.ops.hyper_conn_kernel as jhck
from e2_tts_tpu.ops.dropout import hash_keep as jax_hash_keep

from e2_tts_tpu_torch.ops import _cuda
from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.ops import geglu_kernel as gk
from e2_tts_tpu_torch.ops import hyper_conn_kernel as hck
from e2_tts_tpu_torch.ops.dropout import hash_keep
from e2_tts_tpu_torch.ops.mel import MelSpec

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def interpret():
    saved = (jfa._INTERPRET, jhck._INTERPRET, jgk._INTERPRET)
    jfa._INTERPRET = jhck._INTERPRET = jgk._INTERPRET = True
    yield
    jfa._INTERPRET, jhck._INTERPRET, jgk._INTERPRET = saved


# -- K1: packed flash attention ----------------------------------------------------

def _attn_inputs(b=2, n=100, heads=4, dh=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, heads * dh)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, n), bool)
    mask[1, 71:] = False                       # ragged second sample
    gate = rng.standard_normal((b, n, heads)).astype(np.float32) * 2
    return q, k, v, mask, gate


@pytest.mark.parametrize('gated', [False, True])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_flash_plain_matches_jax_kernel(interpret, gated, rate):
    q, k, v, mask, gate = _attn_inputs()
    seed = 1234
    j = jfa.flash_attention_packed(
        *map(jnp.asarray, (q, k, v, mask)), heads=4, softclamp_value=50.0,
        dropout_rate=rate, dropout_seed=seed if rate else None,
        gate_logits=jnp.asarray(gate) if gated else None)
    t = lambda a: torch.from_numpy(a)
    p = fa.flash_attention_packed(
        t(q), t(k), t(v), t(mask), heads=4, softclamp_value=50.0, dropout_rate=rate,
        dropout_seed=seed, gate_logits=t(gate) if gated else None)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


def test_flash_lse_matches_jax_forward(interpret):
    q, k, v, mask, _ = _attn_inputs(seed=3)
    b, n, D = q.shape
    bias = jnp.where(jnp.asarray(mask), 0.0, jfa.NEG_INF).astype(jnp.float32)
    _, lse_j = jfa._flash_packed_forward(
        *map(jnp.asarray, (q, k, v)), bias, jnp.zeros((1,), jnp.int32), 4, 32 ** -0.5,
        50.0, 0.0)
    _, lse_p = fa.flash_attention_packed(
        *map(torch.from_numpy, (q, k, v, mask)), heads=4, softclamp_value=50.0,
        return_lse=True)
    assert lse_p.shape == (b * 4, n)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j)[..., 0], **TOL)


def test_flash_dropout_mask_bit_identical():
    for seed in (0, 1234, 2 ** 31 - 1):
        a = fa.dropout_keep_mask(seed, 6, 70, 0.1).numpy()
        b = np.asarray(jfa.dropout_keep_mask(seed, 6, 70, 0.1))
        np.testing.assert_array_equal(a, b)


def test_flash_plain_reads_strided_projection_views():
    """q/k/v as views of one (b, n, 3D) projection give the same result as
    contiguous copies (the kernel reads them through a row stride)."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 3 * 128)).astype(np.float32))
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    a = fa.flash_attention_packed(q, k, v, heads=4, softclamp_value=50.0)
    b = fa.flash_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(),
                                  heads=4, softclamp_value=50.0)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# -- K5 / K3: hyper-connection width connection -------------------------------

def _hc_params(s=4, d=64, seed=0):
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


@pytest.mark.parametrize('m', [100, 37])
def test_width_plain_matches_jax_kernel_and_reference(interpret, m):
    rng = np.random.default_rng(1)
    res = rng.standard_normal((4, m, 64)).astype(np.float32)
    params = _hc_params()
    jargs = (jnp.asarray(res), *map(jnp.asarray, params))
    ported = hck.width_connection(torch.from_numpy(res),
                                  *(torch.as_tensor(p) for p in params))
    for ref in (jhck.width_connection(*jargs), jhck._width_reference_split(*jargs)):
        for a, b in zip(ported, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize('m', [100, 37])
def test_width_fused_plain_matches_jax_kernel_and_reference(interpret, m):
    rng = np.random.default_rng(2)
    carried = rng.standard_normal((4, m, 64)).astype(np.float32)
    branch = rng.standard_normal((m, 64)).astype(np.float32)
    beta = (0.5 * rng.standard_normal((4, m))).astype(np.float32)
    params = _hc_params(seed=3)
    jargs = (jnp.asarray(carried), jnp.asarray(branch), jnp.asarray(beta.T),
             *map(jnp.asarray, params))
    ported = hck.width_connection_fused(
        torch.from_numpy(carried), torch.from_numpy(branch), torch.from_numpy(beta),
        *(torch.as_tensor(p) for p in params))
    for ref in (jhck.width_connection_fused(*jargs),
                jhck._width_fused_reference_split(*jargs)):
        for a, b in zip(ported, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_width_plain_bf16_rounding_matches_jax_reference():
    """In bf16 the plain version rounds where the JAX reference rounds
    (normed rows, alpha, beta, the mix): equal up to one bf16 ulp."""
    rng = np.random.default_rng(4)
    res = rng.standard_normal((4, 64, 128)).astype(np.float32)
    params = _hc_params(d=128, seed=5)
    jref = jhck._width_reference_split(jnp.asarray(res, jnp.bfloat16),
                                       *map(jnp.asarray, params))
    ported = hck.width_connection(torch.from_numpy(res).bfloat16(),
                                  *(torch.as_tensor(p) for p in params))
    for a, b in zip(ported, jref):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, atol=1e-2, rtol=2 ** -7)


# -- K6: GEGLU + dropout ------------------------------------------------------------

@pytest.mark.parametrize('inner', [128, 64])
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_geglu_plain_matches_jax_reference(inner, rate):
    rng = np.random.default_rng(inner)
    h2 = rng.standard_normal((2, 50, 2 * inner)).astype(np.float32)
    seed = 987654321
    j = jgk._geglu_dropout_reference(jnp.asarray(h2), jnp.uint32(seed), rate)
    p = gk.geglu_dropout(torch.from_numpy(h2), seed, rate)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize('shape', [(2, 50, 64), (1, 33, 704)])
def test_hash_keep_bit_identical(shape):
    for seed in (0, 987654321, 2 ** 32 - 1):
        a = hash_keep(shape, seed, 0.1).numpy()
        b = np.asarray(jax_hash_keep(shape, jnp.uint32(seed), 0.1))
        np.testing.assert_array_equal(a, b)


def test_plain_path_does_not_count_launches():
    """Only a kernel launch counts: the CPU path leaves the counters alone."""
    before = dict(_cuda.launch_counts)
    gk.geglu_dropout(torch.zeros(1, 4, 128), 0, 0.0)
    hck.width_connection(torch.zeros(4, 8, 64), *(torch.as_tensor(p) for p in _hc_params()))
    fa.flash_attention_packed(*(torch.zeros(1, 8, 128),) * 3, heads=4)
    fa.flash_delta(torch.zeros(1, 8, 128), torch.zeros(1, 8, 128), heads=4)
    spec = MelSpec(mode='pallas')
    spec(torch.zeros(1, 2048))
    assert _cuda.launch_counts == before


def test_kernel_sources_exist_for_every_counter():
    names = {p.stem for p in _cuda.CSRC.glob('*.cu')}
    assert names == {'flash_attention', 'flash_attention_bwd', 'flash_attention_bhnd',
                     'flash_attention_bhnd_wide', 'flash_probe', 'hyper_conn', 'hyper_conn_save',
                     'hyper_conn_bwd', 'hyper_conn_bwd_save', 'hyper_conn_bwd_streams',
                     'hyper_conn_bwd_f32', 'geglu', 'mel'}
    assert set(_cuda.launch_counts) == set(_cuda.KERNELS)
