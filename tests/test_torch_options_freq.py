"""The frequency axis in training and in the duration predictor: the port
against the JAX package on the CPU (shared parts and tolerances:
tests/_torch_options_helpers.py).

``num_freq_tokens=2`` with the frequency attention at ``freq_dim_head`` 32
(the port's K1 route, which takes 32, 64 or 128) and 8 (the JAX tests'
value, K8's route): the loss and every grad with dropout 0.1; the duration
predictor with two frequency tokens (its prediction and its loss, the
random prefix drawn from the JAX key); a backbone with the axis takes only
4-dim inputs, one without it only 3-dim.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor

from _torch_options_helpers import check_cfg_both_modes, check_loss_and_grads, cpu_test_settings
from _torch_port_helpers import SMALL_TF, flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.transformer import Transformer

settings = pytest.fixture(scope='module', autouse=True)(cpu_test_settings)


@pytest.mark.parametrize('option', ['freq_k1', 'freq_k8'])
def test_loss_and_every_grad_match_jax_with_dropout(option, monkeypatch):
    check_loss_and_grads(option, monkeypatch)


def test_duration_predictor_with_freq_axis_matches_jax():
    j = perturb(JaxDurationPredictor(transformer=dict(SMALL_TF, attn_backend='xla'),
                                     num_freq_tokens=2, rngs=nnx.Rngs(0)), seed=31)
    j.eval()
    p = DurationPredictor(transformer=dict(SMALL_TF), num_freq_tokens=2, device='cpu')
    load_jax_params(p, flat_state(j))
    p.eval()
    assert p.transformer.has_freq_axis and p.proj_in.weight.shape == (2 * SMALL_TF['dim'], 100)
    rng = np.random.default_rng(32)
    mel = rng.standard_normal((2, 20, 100)).astype(np.float32)
    lens = np.array([20, 13], np.int32)
    text = np.asarray(j.tokenizer(['hello there', 'ok']))
    key = jax.random.key(33)
    pred_j = j(jnp.asarray(mel), text=jnp.asarray(text), lens=jnp.asarray(lens),
               return_loss=False)
    loss_j = j(jnp.asarray(mel), text=jnp.asarray(text), lens=jnp.asarray(lens), key=key)
    rand_frac = torch.from_numpy(np.array(jax.random.uniform(key, (2,))))
    with torch.no_grad():
        pred_p = p(torch.from_numpy(mel), text=torch.from_numpy(text).long(),
                   lens=torch.from_numpy(lens).long(), return_loss=False)
        loss_p = p(torch.from_numpy(mel), text=torch.from_numpy(text).long(),
                   lens=torch.from_numpy(lens).long(), rand_frac=rand_frac)
    np.testing.assert_allclose(pred_p.numpy(), np.asarray(pred_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)


def test_input_rank_follows_the_freq_axis():
    tf = dict(SMALL_TF, depth=2)
    with_axis = Transformer(**tf, has_freq_axis=True, device='cpu').eval()
    without = Transformer(**tf, device='cpu').eval()
    x4 = torch.randn(1, 2, 8, tf['dim'])
    times = torch.tensor([0.5])
    with torch.no_grad():
        assert with_axis(x4, times=times).shape == x4.shape
        assert without(x4[:, 0], times=times).shape == x4[:, 0].shape
        with pytest.raises(ValueError, match='has_freq_axis'):
            with_axis(x4[:, 0], times=times)
        with pytest.raises(ValueError, match='has_freq_axis'):
            without(x4, times=times)


@pytest.mark.parametrize('option', ['freq_k1', 'freq_k8'])
def test_cfg_evaluation_both_modes(option):
    check_cfg_both_modes(option)
