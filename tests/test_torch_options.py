"""The backbone's and the model's options all together, their CFG
evaluations and sampling, and the weight bridge's new parameters: the port against the JAX package on the CPU.
Each option alone: tests/test_torch_options_freq.py and
tests/test_torch_options_inputs.py; selective remat's policy names:
tests/test_torch_remat_policies.py (shared parts and tolerances:
tests/_torch_options_helpers.py).

The options: the frequency axis (``num_freq_tokens=2``), ``concat_cond``,
``interpolated_text``, the FANformer input map
(``attn_fourier_embed_input``) and selective remat
(``remat='dots_with_no_batch_dims_saveable'``), at the port's test widths
(tests/_torch_port_helpers.py::SMALL_TF). The evaluations run JAX with
``attn_backend='xla'`` (no dropout in eval mode).

Tolerances (f32): a sample 1e-4 (as the sampler in
tests/test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.training.adopt import adopt as jax_adopt
from e2_tts_tpu.training.ema import EMA as JaxEMA
from e2_tts_tpu.training.trainer import linear_warmup_decay_schedule as jax_schedule

from _torch_options_helpers import (OPTIONS, check_cfg_both_modes, check_loss_and_grads, flat,
                                    cpu_test_settings)
from _torch_port_helpers import SMALL_TF, flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params, load_jax_train_state, map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.training.trainer import E2Trainer

settings = pytest.fixture(scope='module', autouse=True)(cpu_test_settings)

def test_all_options_loss_and_every_grad_match_jax_with_dropout(monkeypatch):
    check_loss_and_grads('all', monkeypatch)


@pytest.fixture(scope='module')
def all_options_eval():
    return check_cfg_both_modes('all')


def test_all_options_cfg_evaluation_both_modes(all_options_eval):
    assert all_options_eval[1].transformer.has_freq_axis


def test_sample_all_options_matches_jax(all_options_eval):
    """steps=3 midpoint with every option; the port's noise is JAX's own
    y0 draw. The JAX model samples without its remat policy: its sampler
    cannot run a remat layer inside its `lax.scan` (nnx.remat updates the
    RNG count from another trace level); the port's layers checkpoint only
    under autograd, so its model keeps the policy."""
    j_remat, p = all_options_eval
    e2_kw, tf_kw = OPTIONS['all']
    j = JaxE2TTS(transformer=dict(SMALL_TF, dropout=0.0, attn_backend='xla',
                                  **dict(tf_kw, remat=False)),
                 use_vocos=False, rngs=nnx.Rngs(0), **e2_kw)
    nnx.update(j, nnx.state(j_remat, nnx.Param))
    j.eval()
    rng = np.random.default_rng(52)
    prompt = rng.standard_normal((2, 12, 100)).astype(np.float32)
    key = jax.random.key(53)
    kw = dict(text=['hello', 'a longer one'], duration=24, steps=3, cfg_strength=1.0,
              duration_bucket=32)
    out_j = j.sample(jnp.asarray(prompt), key=key, return_raw_output=True, **kw)
    noise = np.array(jax.random.normal(key, (2, 32, 100), dtype=jnp.float32))
    out_p = p.sample(torch.from_numpy(prompt), noise=torch.from_numpy(noise),
                     return_raw_output=True, **kw)
    assert out_p.shape == (2, 24, 100)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-4, rtol=1e-4)


# -- the weight bridge -------------------------------------------------------------

NEW_PARAMS = (
    'transformer.speech_layers.0.freq_attn.to_qkv.weight',
    'transformer.speech_layers.1.freq_attn.to_out.weight',
    'transformer.speech_layers.0.freq_attn_norm.to_gamma.weight',
    'transformer.speech_layers.1.freq_attn_adaln_zero.to_gamma.bias',
    'transformer.speech_hcs.0.3.static_alpha',
    'transformer.speech_hcs.1.3.dynamic_beta_fn',
    'transformer.speech_layers.0.attn_input_fourier_embed.linear.weight',
    'embed_text.embed.weight', 'embed_text.pos_in.weight', 'embed_text.pos_out.bias',
)


def test_bridge_carries_every_new_parameter():
    """A JAX model with every option loads into the port with no array left
    over on either side (the bridge is strict), and each new parameter
    holds JAX's values; then a JAX training state of that model (clip +
    ADOPT, EMA) loads into an `E2Trainer`."""
    e2_kw, tf_kw = OPTIONS['all']
    j = perturb(JaxE2TTS(transformer=dict(SMALL_TF, **tf_kw), use_vocos=False,
                         rngs=nnx.Rngs(0), **e2_kw), seed=71)
    jflat = flat_state(j)
    p = E2TTS(transformer=dict(SMALL_TF, **tf_kw), device='cpu', **e2_kw)
    state = p.state_dict()
    mapped = map_jax_tree(jflat, {n: t.shape for n, t in state.items()})
    assert set(mapped) == set(state)
    assert all(name in state for name in NEW_PARAMS)
    assert not any(name.startswith('cond_proj_in') for name in state)
    dim, dim_text = SMALL_TF['dim'], SMALL_TF['dim'] // 2
    assert state['proj_in.weight'].shape == (2 * dim, 2 * 100)       # f tokens, 2C in
    assert state['embed_text.embed.weight'].shape == (256, dim_text)  # no filler row
    assert state['embed_text.pos_in.weight'].shape == (dim_text, 1)
    load_jax_params(p, jflat)
    for name in NEW_PARAMS + ('proj_in.weight',):
        np.testing.assert_array_equal(p.state_dict()[name].numpy(), mapped[name], err_msg=name)

    opt = nnx.Optimizer(j, optax.chain(optax.clip_by_global_norm(1.0),
                                       jax_adopt(jax_schedule(1e-3, 0, 100))), wrt=nnx.Param)
    jema = JaxEMA(j, update_after_step=0, update_every=1)
    tree = dict(model=jflat, opt=flat_state(opt), ema=flat_state(jema), step=5)
    trainer = E2Trainer(E2TTS(transformer=dict(SMALL_TF, **tf_kw), device='cpu', **e2_kw),
                        learning_rate=1e-3, num_warmup_steps=0, total_steps=100,
                        ema_kwargs=dict(update_after_step=0, update_every=1))
    assert load_jax_train_state(trainer, tree) == 5
    ema_state = trainer.ema.ema_model.state_dict()
    for name in NEW_PARAMS:
        np.testing.assert_array_equal(ema_state[name].numpy(), mapped[name], err_msg=name)
    params = dict(trainer.model.named_parameters())
    assert all(trainer.optimizer.state[params[name]]['m'].shape == params[name].shape
               for name in NEW_PARAMS)
