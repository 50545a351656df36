"""The input-side options in training — ``concat_cond``,
``interpolated_text`` and the FANformer input map
(``attn_fourier_embed_input``) — and the interpolation helpers behind
interpolated text: the port against the JAX package on the CPU (shared
parts and tolerances: tests/_torch_options_helpers.py; the helpers within
1e-6 in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e2_tts_tpu.utils import tensor as jtensor

from _torch_options_helpers import check_cfg_both_modes, check_loss_and_grads, cpu_test_settings
from e2_tts_tpu_torch.utils import tensor

settings = pytest.fixture(scope='module', autouse=True)(cpu_test_settings)


@pytest.mark.parametrize('option', ['concat_cond', 'fourier_input', 'interpolated_text'])
def test_loss_and_every_grad_match_jax_with_dropout(option, monkeypatch):
    check_loss_and_grads(option, monkeypatch)


@pytest.mark.parametrize('n,length', [(1, 5), (5, 1), (7, 19), (19, 7), (6, 6)])
def test_interpolate_1d_matches_jax(n, length):
    x = np.random.default_rng(n * 31 + length).standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_allclose(tensor.interpolate_1d(torch.from_numpy(x), length).numpy(),
                               np.asarray(jtensor.interpolate_1d(jnp.asarray(x), length)),
                               rtol=0, atol=1e-6)


def test_masked_interpolate_1d_matches_jax():
    """Ragged sources and targets in one batch: a source of length 1, a
    target of length 1, one longer than the other either way, an empty
    target."""
    rng = np.random.default_rng(41)
    x = rng.standard_normal((5, 9, 4)).astype(np.float32)
    src = np.array([1, 9, 4, 7, 3], np.int32)
    tgt = np.array([6, 1, 11, 5, 0], np.int32)
    out_p = tensor.masked_interpolate_1d(torch.from_numpy(x), torch.from_numpy(src).long(),
                                         torch.from_numpy(tgt).long(), 12)
    out_j = jtensor.masked_interpolate_1d(jnp.asarray(x), jnp.asarray(src), jnp.asarray(tgt), 12)
    assert out_p.shape == (5, 12, 4)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out_p[0, :6].numpy(), np.repeat(x[0, :1], 6, axis=0))


@pytest.mark.parametrize('option', ['concat_cond', 'fourier_input', 'interpolated_text'])
def test_cfg_evaluation_both_modes(option):
    check_cfg_both_modes(option)
