"""The loss and every grad of an `E2TTS` whose backbone is built with
``scan_layers`` (depth 6: two scan groups of two), dropout 0.1, against the
JAX package's scan model with ``attn_backend='pallas'`` (its attention
dropout is the counter hash there, in interpret mode on the CPU).

JAX's scan groups draw their dropout keys from the group's own split
stream, not from the model's shared stream in layer order as unrolled
layers do (tests/_torch_options_helpers.py), so the seeds are recorded,
not computed: while the JAX step is traced, the attention's seed
(``randint`` of its key, as the Pallas path draws it) and the feedforward's
(`_seed_from_key`) pass through an ordered ``jax.debug.callback``. The
forward's draws come first, in the port's order (per layer: text attention,
text feedforward, attention, feedforward); the port's `draw_seed` is fed
them, and seeds other than JAX's must move the port's loss.

Tolerances (f32): the loss 1e-5 relative, the prediction 1e-4, the grads
as tests/_torch_scan_helpers.py (its f64 arbiter for JAX's rounding).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import e2_tts_tpu.models.blocks as jblocks
import e2_tts_tpu.ops.dropout as jdropout
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS

from _torch_options_helpers import (LENS, TEXTS, cpu_test_settings, flat, loss_draws,
                                    port_loss_and_grads)
from _torch_port_helpers import SMALL_TF, flat_state, perturb_np
from _torch_scan_helpers import assert_grads_close
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree, scan_plans
from e2_tts_tpu_torch.models.e2tts import E2TTS

settings = pytest.fixture(scope='module', autouse=True)(cpu_test_settings)

DEPTH = 6
TF = dict(SMALL_TF, depth=DEPTH, dropout=0.1, scan_layers=True)


def _recording(seeds: list):
    """The JAX attention op and seed function, each passing the seeds it
    draws to ``seeds`` through an ordered callback."""
    attention, seed_from_key = jblocks.attention_packed_op, jdropout._seed_from_key

    def record(kind, seed):
        jax.debug.callback(lambda s: seeds.append((kind, int(s))), seed, ordered=True)

    def attention_op(*args, dropout_rng=None, dropout_rate=0.0, **kw):
        if dropout_rate > 0.0 and dropout_rng is not None:
            record('attn', jax.random.randint(dropout_rng, (1,), 0, jnp.iinfo(jnp.int32).max,
                                              dtype=jnp.int32)[0])
        return attention(*args, dropout_rng=dropout_rng, dropout_rate=dropout_rate, **kw)

    def seed_fn(key):
        seed = seed_from_key(key)
        record('ff', seed)
        return seed
    return attention_op, seed_fn


@pytest.fixture(scope='module')
def case():
    """The JAX step's loss, prediction, grads and recorded seeds, and the
    port with the JAX weights."""
    j = perturb_np(JaxE2TTS(transformer=dict(TF, attn_backend='pallas'), use_vocos=False,
                            rngs=nnx.Rngs(0)), seed=41)
    j.train()
    p = E2TTS(transformer=dict(TF), device='cpu', use_vocos=False)
    load_jax_params(p, flat_state(j))
    p.train()
    rng = np.random.default_rng(42)
    mel = rng.standard_normal((2, 24, 100)).astype(np.float32)
    text = np.asarray(j.tokenizer(TEXTS))
    key = jax.random.key(43)

    @nnx.jit
    def step(model, mel, text, lens, key):
        def loss_fn(m):
            out = m(mel, text=text, lens=lens, key=key, drop_text_cond=False)
            return out.loss, out.pred_flow
        return nnx.value_and_grad(loss_fn, has_aux=True)(model)

    seeds = []
    mp = pytest.MonkeyPatch()
    attention_op, seed_fn = _recording(seeds)
    mp.setattr(jblocks, 'attention_packed_op', attention_op)
    mp.setattr(jdropout, '_seed_from_key', seed_fn)
    try:
        (loss_j, pred_j), grads_j = step(j, *map(jnp.asarray, (mel, text, LENS)), key)
        jax.effects_barrier()
    finally:
        mp.undo()
    return dict(p=p, mel=mel, text=text, draws=loss_draws(key), seeds=seeds,
                loss=float(loss_j), pred=np.asarray(pred_j), grads=flat(grads_j))


def test_scan_seeds_are_recorded_in_order(case):
    """The forward draws four seeds a layer in the port's branch order;
    any later ones come from the backward's recompute of the remat'd
    groups."""
    kinds = [kind for kind, _ in case['seeds'][:4 * DEPTH]]
    assert kinds == ['attn', 'ff'] * (2 * DEPTH)
    forward = [s for _, s in case['seeds'][:4 * DEPTH]]
    assert len(set(forward)) == len(forward)


def test_scan_dropout_loss_and_grads_match_jax(case, monkeypatch):
    p, seeds = case['p'], [s for _, s in case['seeds'][:4 * DEPTH]]
    out, ported = port_loss_and_grads(p, case['mel'], case['text'], case['draws'], seeds,
                                      monkeypatch)
    np.testing.assert_allclose(float(out.loss.detach()), case['loss'], rtol=1e-5)
    np.testing.assert_allclose(out.pred_flow.detach().numpy(), case['pred'], atol=1e-4,
                               rtol=1e-4)
    wide = copy.deepcopy(p).double()
    draws = {k: v.double() if v.is_floating_point() else v for k, v in case['draws'].items()}
    _, exact = port_loss_and_grads(wide, case['mel'].astype(np.float64), case['text'], draws,
                                   seeds, monkeypatch)
    mapped = map_jax_tree(case['grads'], {k: v.shape for k, v in ported.items()}, scan_plans(p))
    assert_grads_close(ported, mapped, exact)
    other = [s ^ 0x5A5A5A5A for s in seeds]
    out_other, _ = port_loss_and_grads(p, case['mel'], case['text'], case['draws'], other,
                                       monkeypatch)
    assert abs(float(out_other.loss.detach()) - case['loss']) > 1e-4 * abs(case['loss'])
