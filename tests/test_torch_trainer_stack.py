"""The port's optimizer state against the JAX package, on the CPU:
gradient accumulation against optax MultiSteps, and a JAX checkpoint
(written and read by the JAX package's orbax checkpointing, with and
without MultiSteps) carried into the port with
`convert.load_jax_train_state`. The rest of the training stack is held in
tests/test_torch_trainer_options.py (the duration predictor in the trainer,
the data path, TensorBoard tags, WAV files, against JAX) and
tests/test_torch_trainer_resume.py (the port's own checkpoints, resume,
prefetch and profiler window; no JAX), three files so that the stack's
JAX compiles (~15 s each here) spread over workers.

As in tests/test_torch_training.py, the JAX model is built with its own
initialisation, perturbed by seeded noise and copied into the port, and the
draws of each JAX step (span, x0, t) are made from its key and handed to
the port.

Tolerances: parameters and EMA weights after each micro-step 1e-6 absolute
(1% of the smallest per-element update, lr 1e-3 times ADOPT's bounded
step), as tests/test_torch_training.py; the accumulated mean grads at that
file's grad tolerance (1e-3 relative plus 1e-4 of the tensor's largest
|grad|: the backward sums in other orders), ADOPT's v (a squared grad) at
twice it.
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
from e2_tts_tpu.training.checkpointing import load_checkpoint as jax_load_checkpoint
from e2_tts_tpu.training.checkpointing import save_checkpoint as jax_save_checkpoint
from e2_tts_tpu.training.ema import EMA as JaxEMA
from e2_tts_tpu.training.trainer import linear_warmup_decay_schedule as jax_schedule
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_port_helpers import (SMALL_TF, assert_params_close, flat_state, flat_values,
                                 perturb_np)
from e2_tts_tpu_torch.convert import load_jax_params, load_jax_train_state, map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.training.trainer import E2Trainer

B, N = 2, 48
LENS = np.array([48, 37], np.int32)
TEXTS = ['hello there', 'ok']
LR = 1e-3
EMA_KW = dict(update_after_step=0, update_every=1)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: as fast alone at these widths, and it does not
    stall when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.default_rng(0)
    return rng.standard_normal((B, N, 100)).astype(np.float32)


def _draws(key):
    """The draws of JAX `E2TTS.forward` for this key (e2tts.py key split)."""
    k_frac, k_span, k_x0, k_time = jax.random.split(key, 4)
    lens = jnp.asarray(LENS)
    frac_lengths = jax.random.uniform(k_frac, (B,), minval=0.7, maxval=1.0)
    span = jax_span_mask(k_span, lens, frac_lengths, N) & jax_lens_to_mask(lens, length=N)
    x0 = jax.random.normal(k_x0, (B, N, 100), dtype=jnp.float32)
    times = jax.random.uniform(k_time, (B,), dtype=jnp.float32)
    return dict(times=torch.from_numpy(np.array(times)), noise=torch.from_numpy(np.array(x0)),
                rand_span_mask=torch.from_numpy(np.array(span)))


def _shapes(module):
    return {name: tuple(p.shape) for name, p in module.named_parameters()}


# -- one JAX run per accumulation factor: lockstep states and a checkpoint ----------

@nnx.jit
def _jax_grads(model, mel, lens, text, key):
    """The first half of the JAX trainer's jitted step (trainer.py:219-231):
    the loss's grads, the text kept, no velocity teacher."""
    def loss_fn(m):
        return m(mel, text=text, lens=lens, key=key, drop_text_cond=False).loss
    return nnx.grad(loss_fn)(model)


@nnx.jit
def _jax_update(model, optimizer, ema, grads):
    """Its second half (trainer.py:231-232): the optimizer, then the EMA."""
    optimizer.update(model, grads)
    ema.update(model)


@pytest.fixture(scope='module')
def jax_model():
    """One perturbed JAX model in train mode and its state: each run starts
    from that state on this one module, so `_jax_grads` compiles once."""
    j = perturb_np(JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=False, rngs=nnx.Rngs(0)),
                   seed=8)
    j.train()
    return j, nnx.state(j)


@pytest.fixture(scope='module', params=[1, 2], ids=['k1', 'k2'])
def jax_run(request, jax_model, tmp_path_factory):
    """Four micro-steps of the JAX trainer's step (clip 1.0 + ADOPT, wrapped
    in optax.MultiSteps(k) for k > 1; EMA every step) from the perturbed
    weights. Before the fourth, the state is saved with the JAX package's
    own `save_checkpoint`, restored with its `load_checkpoint` and
    flattened: the tree `load_jax_train_state` takes. With k = 2 that
    checkpoint is mid-accumulation (one micro-step in the mean)."""
    k = request.param
    j, start_state = jax_model
    nnx.update(j, start_state)
    tx = optax.chain(optax.clip_by_global_norm(1.0), jax_adopt(jax_schedule(LR, 0, 100)))
    if k > 1:
        tx = optax.MultiSteps(tx, k)
    opt = nnx.Optimizer(j, tx, wrt=nnx.Param)
    jema = JaxEMA(j, **EMA_KW)
    mel, text = _batch(), np.asarray(j.tokenizer(TEXTS))
    start = flat_state(j)
    states, tree = [], None
    for step in range(4):
        if step == 3:
            path = str(tmp_path_factory.mktemp(f'jax_ckpt_k{k}'))
            jax_save_checkpoint(path, model=j, optimizer=opt, ema=jema, step=3)
            jax_load_checkpoint(path, model=j, optimizer=opt, ema=jema)
            tree = dict(model=flat_state(j), opt=flat_state(opt), ema=flat_state(jema), step=3)
        grads = _jax_grads(j, jnp.asarray(mel), jnp.asarray(LENS), jnp.asarray(text),
                           jax.random.key(100 + step))
        _jax_update(j, opt, jema, grads)
        states.append(dict(params=flat_values(nnx.state(j, nnx.Param)),
                           ema=flat_values(nnx.state(jema.ema_model, nnx.Param)),
                           opt=flat_state(opt)))
    return dict(k=k, start=start, states=states, tree=tree, mel=mel, text=text)


def _port_trainer(k=1, **kw):
    p = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    return E2Trainer(p, learning_rate=LR, num_warmup_steps=0, total_steps=100,
                     grad_accumulation_steps=k, ema_kwargs=EMA_KW, **kw)


def test_accumulation_matches_jax_multisteps(jax_run):
    """k micro-steps of the port against optax.MultiSteps(k): after each
    micro-step the parameters, the EMA, ADOPT's v and (k > 1) the
    accumulated mean grads. ADOPT steps (and the schedule counts) once
    every k calls; the EMA ticks on every call."""
    k = jax_run['k']
    trainer = _port_trainer(k)
    load_jax_params(trainer.model, jax_run['start'])
    inner = 'opt_state.inner_opt_state.' if k > 1 else 'opt_state.'
    shapes = _shapes(trainer.model)
    for step, want in enumerate(jax_run['states']):
        trainer.train_step(jax_run['mel'], LENS, jax_run['text'], drop_text_cond=False,
                           **_draws(jax.random.key(100 + step)))
        assert_params_close(want['params'], trainer.model, f'params after micro-step {step + 1}')
        assert_params_close(want['ema'], trainer.ema.ema_model, f'ema after micro-step {step + 1}')
        assert trainer.ema.step == step + 1
        updates = (step + 1) // k
        sub = lambda prefix: {key[len(prefix):]: v for key, v in want['opt'].items()
                              if key.startswith(prefix)}
        assert int(want['opt'][inner + '1.0.count']) == updates
        states = list(trainer.optimizer.state.values())
        assert all(s['step'] == updates for s in states) and len(states) == (
            len(shapes) if updates else 0)
        if updates:
            v = map_jax_tree(sub(inner + '1.0.v.'), shapes)
            for name, p in trainer.model.named_parameters():
                np.testing.assert_allclose(trainer.optimizer.state[p]['v'].numpy(), v[name],
                                           rtol=2e-3, atol=2e-4 * float(v[name].max()) + 1e-30,
                                           err_msg=name)
        if k > 1:
            assert trainer.accumulator.mini_step == int(want['opt']['opt_state.mini_step'])
            acc = map_jax_tree(sub('opt_state.acc_grads.'), shapes)
            for name, mean in zip(shapes, trainer.accumulator.grads):
                np.testing.assert_allclose(mean.numpy(), acc[name], rtol=1e-3,
                                           atol=1e-4 * float(np.abs(acc[name]).max()) + 1e-12,
                                           err_msg=name)


def test_jax_checkpoint_continues_training(jax_run):
    """A JAX checkpoint (written and restored by the JAX package, with and
    without MultiSteps) carried into a freshly built port trainer, then one
    more step on both sides: parameters and EMA within 1e-6. With k = 2 the
    checkpoint holds a partial mean, and the step completes it."""
    k = jax_run['k']
    trainer = _port_trainer(k)
    assert load_jax_train_state(trainer, jax_run['tree']) == 3
    assert trainer.ema.step == 3 and trainer.ema.initted
    if k > 1:
        assert trainer.accumulator.mini_step == 1
    trainer.train_step(jax_run['mel'], LENS, jax_run['text'], drop_text_cond=False,
                       **_draws(jax.random.key(103)))
    want = jax_run['states'][3]
    assert_params_close(want['params'], trainer.model, 'params')
    assert_params_close(want['ema'], trainer.ema.ema_model, 'ema')


def test_load_jax_train_state_is_strict(jax_run):
    """A key the trainer does not take, a missing moment, the EMA without
    its counters, or the other accumulation's optimizer tree raises."""
    tree, k = jax_run['tree'], jax_run['k']
    trainer = _port_trainer(k)
    opt = dict(tree['opt'])
    opt.pop(next(key for key in opt if '.v.' in key))
    ema = {key: v for key, v in tree['ema'].items() if key != 'step_initted'}
    for bad, match in ((dict(tree, key=np.zeros(2)), 'tree has'),
                       (dict(tree, opt=opt), 'not set'),
                       (dict(tree, ema=ema), 'step_initted')):
        with pytest.raises(ValueError, match=match):
            load_jax_train_state(trainer, bad)
    with pytest.raises(ValueError, match='unused|has no'):
        load_jax_train_state(_port_trainer(3 - k), tree)
