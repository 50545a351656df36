"""The training state of an `E2TTS` whose backbone is built with
``scan_layers`` (depth 6) through `convert.load_jax_train_state`: the
stacked layout in the model, ADOPT's moments, the EMA weights and the
MultiSteps accumulator, and a trained scan duration predictor's pair; then
the next clip + ADOPT + EMA step against the JAX package's. As in
tests/test_torch_trainer_stack.py, the JAX step's draws (span, x0, t) are
made from its key and handed to the port. Attention on XLA and no dropout
(the dropout path: tests/test_torch_scan_dropout.py).

Tolerances (f32): parameters and EMA weights after the step 1e-6
absolute, the predictor's weights and ADOPT moments loaded bit for bit
(tests/test_torch_trainer_stack.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import nnx

from e2_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.training.adopt import adopt as jax_adopt
from e2_tts_tpu.training.ema import EMA as JaxEMA
from e2_tts_tpu.training.trainer import E2Trainer as JaxE2Trainer
from e2_tts_tpu.training.trainer import linear_warmup_decay_schedule as jax_schedule

from _torch_options_helpers import loss_draws
from _torch_port_helpers import (SMALL_TF, assert_params_close, flat_state, flat_values,
                                 perturb_np)
from _torch_scan_helpers import one_torch_thread
from e2_tts_tpu_torch.convert import load_jax_train_state, map_jax_tree, scan_plans
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.training.trainer import E2Trainer

settings = pytest.fixture(scope='module', autouse=True)(one_torch_thread)

TF = dict(SMALL_TF, depth=6, scan_layers=True)
DP_TF = dict(SMALL_TF, depth=6, text_depth=3, scan_layers=True)
B, N = 2, 24                      # loss_draws' batch
LENS = np.array([24, 17], np.int32)
TEXTS = ['hello there', 'ok']
LR = 1e-3
EMA_KW = dict(update_after_step=0, update_every=1)


@pytest.fixture(scope='module')
def jax_model():
    j = perturb_np(JaxE2TTS(transformer=dict(TF, attn_backend='xla'), use_vocos=False,
                            rngs=nnx.Rngs(0)), seed=51)
    return j, nnx.state(j)


@nnx.jit
def _jax_grads(model, mel, lens, text, key):
    def loss_fn(m):
        return m(mel, text=text, lens=lens, key=key, drop_text_cond=False).loss
    return nnx.grad(loss_fn)(model)


@nnx.jit
def _jax_update(model, optimizer, ema, grads):
    optimizer.update(model, grads)
    ema.update(model)


def _tx(k):
    tx = optax.chain(optax.clip_by_global_norm(1.0), jax_adopt(jax_schedule(LR, 0, 100)))
    return optax.MultiSteps(tx, k) if k > 1 else tx


@pytest.fixture(scope='module')
def jax_dp():
    """A trained JAX scan duration predictor (one step of the JAX trainer's
    predictor step) and its optimizer's state."""
    jdp = perturb_np(JaxDurationPredictor(transformer=dict(DP_TF, attn_backend='xla'),
                                          rngs=nnx.Rngs(1)), seed=55)
    opt = nnx.Optimizer(jdp, _tx(1), wrt=nnx.Param)
    mel = np.random.default_rng(56).standard_normal((B, N, 100)).astype(np.float32)
    JaxE2Trainer._build_dp_step(None)(jdp, opt, jnp.asarray(mel), jnp.asarray(LENS),
                                       jax.random.key(57))
    return dict(duration_predictor=flat_state(jdp), dp_opt=flat_state(opt))


@pytest.mark.parametrize('k', [1, 2])
def test_scan_train_state_continues(jax_model, jax_dp, k):
    """Two JAX steps (clip + ADOPT, in MultiSteps(2) for k = 2, EMA every
    step) from the perturbed weights; the state after the first, carried
    into a freshly built port trainer (with k = 1 also a trained scan
    duration predictor's pair), then the second step on the port: the
    parameters and EMA weights are JAX's."""
    j, start = jax_model
    nnx.update(j, start)
    j.train()
    opt = nnx.Optimizer(j, _tx(k), wrt=nnx.Param)
    jema = JaxEMA(j, **EMA_KW)
    mel = np.random.default_rng(58).standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(j.tokenizer(TEXTS))
    tree = None
    for step in range(2):
        if step == 1:
            tree = dict(model=flat_state(j), opt=flat_state(opt), ema=flat_state(jema), step=1)
        grads = _jax_grads(j, *map(jnp.asarray, (mel, LENS, text)), jax.random.key(60 + step))
        _jax_update(j, opt, jema, grads)

    dp_kw = {}
    if k == 1:
        tree.update(jax_dp)
        dp_kw = dict(duration_predictor=DurationPredictor(transformer=dict(DP_TF), device='cpu'),
                     train_duration_predictor=True)
    trainer = E2Trainer(E2TTS(transformer=dict(TF), device='cpu', use_vocos=False),
                        learning_rate=LR, num_warmup_steps=0, total_steps=100,
                        grad_accumulation_steps=k, ema_kwargs=EMA_KW, **dp_kw)
    assert load_jax_train_state(trainer, tree) == 1
    if k == 1:
        dp = trainer.duration_predictor
        assert_params_close(jax_dp['duration_predictor'], dp, 'duration predictor', atol=0)
        shapes = {n: tuple(t.shape) for n, t in dp.named_parameters()}
        m = map_jax_tree({key[len('opt_state.1.0.m.'):]: v for key, v in jax_dp['dp_opt'].items()
                          if key.startswith('opt_state.1.0.m.')}, shapes, scan_plans(dp))
        for name, t in dp.named_parameters():
            np.testing.assert_array_equal(trainer.dp_optimizer.state[t]['m'].numpy(), m[name])
    else:
        assert trainer.accumulator.mini_step == 1
    trainer.train_step(mel, LENS, text, drop_text_cond=False, **loss_draws(jax.random.key(61)))
    assert_params_close(flat_values(nnx.state(j, nnx.Param)), trainer.model, 'params')
    assert_params_close(flat_values(nnx.state(jema.ema_model, nnx.Param)),
                        trainer.ema.ema_model, 'ema')
