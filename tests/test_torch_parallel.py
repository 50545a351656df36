"""The port's data-parallel trainer against the JAX package's sharded one,
on the CPU.

The JAX side is `E2Trainer(mesh=make_mesh(2), param_sharding='fsdp')` on
conftest.py's virtual CPU devices, its jitted step run on the batch sharded
over the ``data`` axis; the port side is two gloo ranks
(tests/_torch_parallel_worker.py, one spawn for the file), which train the
same weights as `E2Trainer(param_sharding='replicated')` (DDP) and
`'fsdp'` (FSDP2) through `train_step` on the global batch. As in
tests/test_torch_trainer_stack.py, dropout is 0 and the draws of each JAX
step (span, x0, t) are made from its key and handed to the port. The model
has a velocity-consistency weight: step 1 keeps the text and has no teacher
(the EMA has not ticked), step 2 drops the text and takes the EMA teacher
(the JAX trainer's ``use_velocity=True`` step): two JAX compiles, during
which the ranks run.

Tolerances, those of tests/test_torch_trainer_stack.py and
tests/test_torch_training.py: losses 1e-5 relative; parameters and EMA
weights 1e-6 absolute after each step; ADOPT's v 2e-3 relative plus 2e-4 of
the tensor's largest value (a squared grad), its m 1e-3 absolute (the
parameters' 1e-6 over the learning rate: a step moves a parameter by lr x m).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from e2_tts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from e2_tts_tpu.training.trainer import E2Trainer as JaxTrainer
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_parallel_worker import EMA_KW, LR, Ranks, write_steps
from _torch_port_helpers import SMALL_TF, flat_state, flat_values, perturb_np
from e2_tts_tpu_torch.convert import map_jax_tree

B, N = 4, 40
LENS = np.array([40, 29, 35, 18], np.int32)
TEXTS = ['hello there', 'ok', 'a longer line of text', 'hi']
VELOCITY_WEIGHT = 0.5
DROPS = (False, True)              # step 2 drops the text and has the teacher
SHARDINGS = ('replicated', 'fsdp')


def _draws(key):
    """The draws of JAX `E2TTS.__call__` for this key (its four-way split)."""
    k_frac, k_span, k_x0, k_time = jax.random.split(key, 4)
    lens = jnp.asarray(LENS)
    frac_lengths = jax.random.uniform(k_frac, (B,), minval=0.7, maxval=1.0)
    span = jax_span_mask(k_span, lens, frac_lengths, N) & jax_lens_to_mask(lens, length=N)
    x0 = jax.random.normal(k_x0, (B, N, 100), dtype=jnp.float32)
    times = jax.random.uniform(k_time, (B,), dtype=jnp.float32)
    return dict(times=np.asarray(times), noise=np.asarray(x0), rand_span_mask=np.asarray(span))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Two steps of the JAX package's sharded trainer, and the same two on
    two ranks of the port, replicated and FSDP, from the same weights."""
    tmp = tmp_path_factory.mktemp('parallel_jax')
    j = perturb_np(JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=False,
                            velocity_consistency_weight=VELOCITY_WEIGHT, rngs=nnx.Rngs(0)),
                   seed=8)
    np.savez(tmp / 'jax_state.npz', **flat_state(j))
    trainer = JaxTrainer(j, learning_rate=LR, num_warmup_steps=0, total_steps=100,
                         mesh=jax_make_mesh(2), param_sharding='fsdp', ema_kwargs=EMA_KW,
                         log_file=None)
    mel = np.random.default_rng(0).standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(j.tokenizer(TEXTS))
    batch = jax_shard_batch(dict(mel=jnp.asarray(mel), lens=jnp.asarray(LENS),
                                 text=jnp.asarray(text)), trainer.mesh)
    keys = [jax.random.key(100 + i) for i in range(len(DROPS))]
    write_steps(str(tmp / 'steps.npz'), [dict(mel=mel, lens=LENS, text=text, drop=drop,
                                              **_draws(key))
                                         for key, drop in zip(keys, DROPS)])
    ranks = Ranks(2, [dict(kind='steps', sharding=sharding, config=SMALL_TF, every_step=True,
                           velocity_weight=VELOCITY_WEIGHT,
                           jax_state=str(tmp / 'jax_state.npz'), steps=str(tmp / 'steps.npz'),
                           out=str(tmp / sharding))
                      for sharding in SHARDINGS], tmp)
    jax_losses, jax_states = [], []
    try:
        for i, (key, drop) in enumerate(zip(keys, DROPS)):
            loss, _, _ = trainer._train_step(j, trainer.optimizer, trainer.ema, batch['mel'],
                                             batch['lens'], batch['text'], key, drop, i > 0)
            jax_losses.append(float(loss))
            jax_states.append(dict(
                params=flat_values(nnx.state(j, nnx.Param)),
                ema=flat_values(nnx.state(trainer.ema.ema_model, nnx.Param)),
                opt=flat_state(trainer.optimizer)))
    finally:
        ranks.join()
    port = {s: dict(np.load(tmp / s / 'result.npz')) for s in SHARDINGS}
    return dict(jax_losses=jax_losses, jax_states=jax_states, port=port)


def _port(result, prefix):
    """``prefix.<name>`` entries of a rank-0 result as name -> array."""
    return {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}


@pytest.mark.parametrize('sharding', SHARDINGS)
def test_losses_match_jax(runs, sharding):
    """The global loss of each step (with text; text dropped, with the
    teacher) is the JAX sharded step's."""
    np.testing.assert_allclose(runs['port'][sharding]['losses'], runs['jax_losses'], rtol=1e-5)


@pytest.mark.parametrize('step', range(len(DROPS)))
@pytest.mark.parametrize('sharding', SHARDINGS)
def test_state_matches_jax(runs, sharding, step):
    """After each step, every parameter and EMA weight within 1e-6 and
    ADOPT's moments at their tolerances (module docstring)."""
    got, want = runs['port'][sharding], runs['jax_states'][step]
    params = _port(got, f'step{step}.param.')
    shapes = {name: value.shape for name, value in params.items()}
    for kind, tree in (('param', want['params']), ('ema', want['ema'])):
        mapped = map_jax_tree(tree, shapes)
        for name in shapes:
            np.testing.assert_allclose(got[f'step{step}.{kind}.{name}'], mapped[name], rtol=0,
                                       atol=1e-6, err_msg=f'{kind} {name}')
    sub = lambda prefix: {k[len(prefix):]: v for k, v in want['opt'].items()
                          if k.startswith(prefix)}
    for moment in ('v', 'm'):
        mapped = map_jax_tree(sub(f'opt_state.1.0.{moment}.'), shapes)
        for name in shapes:
            ref, mine = mapped[name], got[f'step{step}.{moment}.{name}']
            atol = (2e-4 * float(np.abs(ref).max()) + 1e-30) if moment == 'v' else 1e-3
            np.testing.assert_allclose(mine, ref, rtol=2e-3 if moment == 'v' else 0,
                                       atol=atol, err_msg=f'{moment} {name}')
