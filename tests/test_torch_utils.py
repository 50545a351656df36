"""The port's host-side helpers against the JAX package: tokenizer, masks,
APG projection, rotary tables and the fixed-grid ODE steppers (f32; the
ODE tolerance 1e-5 covers f32 rounding of a few dozen steps)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2_tts_tpu.ops import ode as jode
from e2_tts_tpu.ops.rotary import apply_rotary_packed as jax_apply_rotary_packed
from e2_tts_tpu.ops.rotary import rotary_freqs as jax_rotary_freqs
from e2_tts_tpu.text import tokenizer as jtok
from e2_tts_tpu.utils import masking as jmask
from e2_tts_tpu.utils.tensor import project as jax_project

from e2_tts_tpu_torch.ops import ode
from e2_tts_tpu_torch.ops.rotary import apply_rotary_packed, rotary_tables
from e2_tts_tpu_torch.text import tokenizer as tok
from e2_tts_tpu_torch.utils import masking
from e2_tts_tpu_torch.utils.tensor import project


def test_char_tokenizer_matches_jax(monkeypatch):
    texts = ['hello', 'héllo wörld', '', '日本']
    np.testing.assert_array_equal(tok.list_str_to_ids(texts), jtok.list_str_to_ids(texts))
    fn, vocab = tok.resolve_tokenizer('char_utf8')
    assert vocab == 256 and fn is tok.list_str_to_ids
    monkeypatch.setitem(sys.modules, 'g2p_en', None)          # the optional package absent
    for resolve in (tok.resolve_tokenizer, jtok.resolve_tokenizer):
        with pytest.raises(ImportError, match='g2p_en'):
            resolve('phoneme_en')
    with pytest.raises(ValueError):
        tok.resolve_tokenizer('bogus')


def test_masks_match_jax():
    lens = np.array([3, 0, 7], np.int64)
    np.testing.assert_array_equal(masking.lens_to_mask(torch.from_numpy(lens), 8).numpy(),
                                  np.asarray(jmask.lens_to_mask(jnp.asarray(lens), 8)))
    t = np.arange(10).reshape(2, 5)
    for length in (3, 5, 8):
        np.testing.assert_array_equal(
            masking.pad_to_length(torch.from_numpy(t), length, value=-1).numpy(),
            np.asarray(jmask.pad_to_length(jnp.asarray(t), length, value=-1)))


def test_maybe_masked_mean_matches_jax():
    rng = np.random.default_rng(2)
    t = rng.standard_normal((3, 6, 4)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [0] * 6, [1] * 6], bool)
    for m in (None, mask):
        np.testing.assert_allclose(
            masking.maybe_masked_mean(torch.from_numpy(t),
                                      None if m is None else torch.from_numpy(m)).numpy(),
            np.asarray(jmask.maybe_masked_mean(jnp.asarray(t),
                                               None if m is None else jnp.asarray(m))),
            atol=1e-6, rtol=1e-6)


def test_project_matches_jax():
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((2, 5, 7)).astype(np.float32), \
        rng.standard_normal((2, 5, 7)).astype(np.float32)
    for a, b in zip(project(torch.from_numpy(x), torch.from_numpy(y)),
                    jax_project(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


def test_rotary_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.standard_normal((2, 17, 4 * 32)).astype(np.float32)
    np.testing.assert_allclose(
        apply_rotary_packed(torch.from_numpy(t), rotary_tables(17, 32)).numpy(),
        np.asarray(jax_apply_rotary_packed(jnp.asarray(t), jax_rotary_freqs(17, 32))),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('method', ['euler', 'midpoint', 'rk4'])
def test_fixed_grid_ode_matches_jax(method):
    a = np.array([[0.3, -1.0], [1.0, 0.2]], np.float32)
    y0 = np.array([[1.0, 0.5]], np.float32)
    t = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    jy = jode.odeint(lambda s, y: (y @ a) * s, jnp.asarray(y0), jnp.asarray(t), method=method)
    py = ode.odeint(lambda s, y: (y @ torch.from_numpy(a)) * float(s), torch.from_numpy(y0),
                    t, method=method)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


def test_ode_keeps_state_dtype_and_raises_on_adaptive():
    """Every method keeps the state's dtype (the adaptive ones, ported since
    build, no longer raise: tests/test_torch_ode_adaptive.py); an unknown
    method raises."""
    y0 = torch.ones(3, dtype=torch.bfloat16)
    for method, expected in (('midpoint', 0.625 ** 2), ('dopri5', np.exp(-1.0))):
        out = ode.odeint(lambda s, y: -y, y0, [0.0, 0.5, 1.0], method=method)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), expected, rtol=1e-2)
    with pytest.raises(ValueError):
        ode.odeint(lambda s, y: y, y0, [0.0, 1.0], method='bogus')
