"""The port's training path against the JAX package, on the CPU: the
flow-matching loss and every parameter's grad, clip + ADOPT + EMA steps,
the schedule, the batches, and `E2Trainer.train`.

The JAX model is built with its own initialisation, perturbed by seeded
noise, and copied into the port through `load_jax_params`. The loss's random
draws (span, x0, t) are made from the JAX key exactly as
`E2TTS.forward` splits it and handed to the port (`times`, `noise`,
`rand_span_mask`), so both sides see the same numbers. Model-level dropout
stays 0 here: the JAX model on the CPU draws its attention dropout with
`jax.random.bernoulli`, not the counter hash the kernels use; dropout is held
bit for bit at the kernel level (tests/test_torch_train_kernels.py), and the
port's dropout-0.1 model is checked for repeatability from its generator.

Tolerances (all f32): the loss 1e-5 relative; the prediction 1e-4 (as the
backbone in tests/test_torch_models.py); each grad 1e-3 relative plus 1e-4
of its tensor's largest |grad| (the backward adds a few dozen more layers of
f32 summation-order differences, and many grads are sums over every frame);
parameters and EMA weights after each optimizer step 1e-6 absolute, 1% of
the smallest per-element update (lr 1e-3 times ADOPT's bounded step).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.training import data as jdata
from e2_tts_tpu.training.adopt import adopt as jax_adopt
from e2_tts_tpu.training.ema import EMA as JaxEMA
from e2_tts_tpu.training.trainer import E2Trainer as JaxE2Trainer
from e2_tts_tpu.training.trainer import linear_warmup_decay_schedule as jax_schedule
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_port_helpers import SMALL_TF, flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.training import data
from e2_tts_tpu_torch.training.adopt import Adopt
from e2_tts_tpu_torch.training.ema import EMA
from e2_tts_tpu_torch.training.trainer import E2Trainer, linear_warmup_decay_schedule

B, N = 2, 48
LENS = np.array([48, 37], np.int32)
TEXTS = ['hello there', 'ok']
VC_WEIGHT = 0.1


def _jax_model(seed):
    j = perturb(JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=False,
                         velocity_consistency_weight=VC_WEIGHT, rngs=nnx.Rngs(0)), seed=seed)
    return j


def _port_of(j):
    p = E2TTS(transformer=dict(SMALL_TF), velocity_consistency_weight=VC_WEIGHT, device='cpu')
    load_jax_params(p, flat_state(j))
    return p


@pytest.fixture(scope='module')
def models():
    """The JAX student (train mode) and teacher (eval), their port copies,
    and one batch."""
    j = _jax_model(seed=8)
    j.train()
    jt = _jax_model(seed=9)
    jt.eval()
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(j.tokenizer(TEXTS))
    return dict(j=j, p=_port_of(j).train(), jt=jt, pt=_port_of(jt).eval(), mel=mel, text=text)


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


@partial(nnx.jit, static_argnames=('drop_text_cond',))
def _jax_loss_and_grads(model, teacher, mel, lens, text, key, drop_text_cond):
    def loss_fn(m):
        out = m(mel, text=text, lens=lens, key=key, drop_text_cond=drop_text_cond,
                velocity_consistency_model=teacher)
        return out.loss, out
    (loss, out), grads = nnx.value_and_grad(loss_fn, has_aux=True)(model)
    return loss, out.pred_flow, out.loss_breakdown.velocity_consistency, grads


def _flat(state):
    return {'.'.join(map(str, path)): np.asarray(var.get_value() if hasattr(var, 'get_value')
                                                 else var)
            for path, var in nnx.to_flat_state(state)}


def _param_shapes(module):
    return {name: tuple(p.shape) for name, p in module.named_parameters()}


def _port_grads(module):
    return {name: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for name, p in module.named_parameters()}


@pytest.mark.parametrize('case', ['text+velocity', 'drop_text'])
def test_loss_and_every_grad_match_jax(models, case):
    j, p = models['j'], models['p']
    velocity, drop = case == 'text+velocity', case == 'drop_text'
    key = jax.random.key(5 if velocity else 6)
    loss_j, pred_j, vel_j, grads_j = _jax_loss_and_grads(
        j, models['jt'] if velocity else None, jnp.asarray(models['mel']), jnp.asarray(LENS),
        jnp.asarray(models['text']), key, drop)

    p.zero_grad(set_to_none=True)
    out = p(torch.from_numpy(models['mel']), text=torch.from_numpy(models['text']).long(),
            lens=torch.from_numpy(LENS).long(), drop_text_cond=drop,
            velocity_consistency_model=models['pt'] if velocity else None, **_draws(key))
    out.loss.backward()

    np.testing.assert_allclose(float(out.loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(out.loss_breakdown.velocity_consistency.detach()),
                               float(vel_j), rtol=1e-5, atol=1e-9)
    assert (float(vel_j) > 0) == velocity
    np.testing.assert_allclose(out.pred_flow.detach().numpy(), np.asarray(pred_j),
                               atol=1e-4, rtol=1e-4)
    mapped = map_jax_tree(_flat(grads_j), _param_shapes(p))
    ported = _port_grads(p)
    assert set(mapped) == set(ported)
    for name, g in mapped.items():
        g = np.asarray(g)
        np.testing.assert_allclose(ported[name], g, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-12, err_msg=name)
    text_grads = [name for name in ported if name.startswith('embed_text.')]
    assert text_grads and all((np.abs(ported[n]).max() == 0) == drop for n in text_grads)


def test_train_steps_match_jax_clip_adopt_ema(models):
    """Three steps of the JAX trainer's jitted step (loss, grad, clip 1.0,
    ADOPT on the warmup/decay schedule, EMA tick; the velocity teacher once
    the EMA has ticked) against `E2Trainer.train_step` from the same weights,
    batches and draws. Step 1 moves nothing (ADOPT primes v); steps 2-3 move
    every parameter by about lr * 0.1 * atan2(g, sqrt v). atan2 of a grad
    near zero could take either sign in the two frameworks; the perturbed
    weights give every parameter a grad far from zero, and the check is
    elementwise at 1e-6, so a sign flip anywhere would fail it."""
    j = _jax_model(seed=8)
    j.train()
    p = _port_of(j)
    lr = 1e-3
    opt = nnx.Optimizer(j, optax.chain(optax.clip_by_global_norm(1.0),
                                       jax_adopt(jax_schedule(lr, 0, 100))), wrt=nnx.Param)
    jema = JaxEMA(j, update_after_step=0, update_every=1)
    jax_step = JaxE2Trainer._build_train_step(None)
    trainer = E2Trainer(p, learning_rate=lr, num_warmup_steps=0, total_steps=100,
                        ema_kwargs=dict(update_after_step=0, update_every=1))
    start = {name: t.detach().clone() for name, t in p.named_parameters()}
    shapes = _param_shapes(p)
    mel, text = models['mel'], models['text']
    for step in range(3):
        key = jax.random.key(100 + step)
        use_velocity = bool(jema.initted)
        jax_step(j, opt, jema, jnp.asarray(mel), jnp.asarray(LENS), jnp.asarray(text), key,
                 False, use_velocity)
        assert trainer.ema.initted == use_velocity
        loss, _, _ = trainer.train_step(mel, LENS, text, drop_text_cond=False, **_draws(key))
        assert torch.isfinite(loss)
        for label, jm, pm in (('params', j, p), ('ema', jema.ema_model, trainer.ema.ema_model)):
            mapped = map_jax_tree(_flat(nnx.state(jm, nnx.Param)), shapes)
            for name, t in pm.named_parameters():
                np.testing.assert_allclose(t.detach().numpy(), mapped[name], rtol=0, atol=1e-6,
                                           err_msg=f'{label} {name} after step {step + 1}')
        moved = max(float((t.detach() - start[n]).abs().max()) for n, t in p.named_parameters())
        assert (moved > 0) == (step > 0)


@pytest.mark.parametrize('weight_decay', [0.0, 0.1])
@pytest.mark.parametrize('use_atan2', [True, False])
def test_adopt_matches_jax(use_atan2, weight_decay):
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(4)]
    sched = jax_schedule(1e-2, 2, 10)
    tx = jax_adopt(sched, use_atan2=use_atan2, weight_decay=weight_decay)
    wj = jnp.asarray(w0)
    state = tx.init(wj)
    wp = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = Adopt([wp], lr=linear_warmup_decay_schedule(1e-2, 2, 10), use_atan2=use_atan2,
                weight_decay=weight_decay)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, wj)
        wj = optax.apply_updates(wj, upd)
        wp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(wp.detach().numpy(), np.asarray(wj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(opt.state[wp]['v'].numpy(), np.asarray(state[0].v), rtol=1e-6)


def test_ema_matches_jax():
    """Warmup copies, `update_every`, the ramp at step + 1 and the `initted`
    gate, on a linear layer's weights."""
    jlin = nnx.Linear(3, 4, rngs=nnx.Rngs(0))
    plin = torch.nn.Linear(3, 4)
    kw = dict(update_after_step=2, update_every=3, power=0.75)
    with torch.no_grad():
        plin.weight.copy_(torch.from_numpy(np.array(jlin.kernel.get_value()).T))
        plin.bias.copy_(torch.from_numpy(np.array(jlin.bias.get_value())))
    jema, pema = JaxEMA(jlin, **kw), EMA(plin, **kw)
    rng = np.random.default_rng(4)
    for step in range(12):
        dw = rng.standard_normal((3, 4)).astype(np.float32)
        jlin.kernel.set_value(jlin.kernel.get_value() + dw)
        with torch.no_grad():
            plin.weight.add_(torch.from_numpy(dw.T))
        jema.update(jlin)
        pema.update(plin)
        assert pema.initted == bool(jema.initted)
        np.testing.assert_allclose(pema.ema_model.weight.numpy().T,
                                   np.array(jema.ema_model.kernel.get_value()), atol=1e-6)
        np.testing.assert_allclose(pema.current_decay(), float(jema.current_decay()),
                                   atol=1e-7)
    assert not pema.ema_model.training
    pema.update_model_with_ema(plin)
    torch.testing.assert_close(plin.weight, pema.ema_model.weight)


def test_schedule_matches_jax():
    for warmup, total in ((0, 50), (5, 40), (20_000, 10)):
        js = jax_schedule(7.5e-5, warmup, total)
        ps = linear_warmup_decay_schedule(7.5e-5, warmup, total)
        for step in (0, 1, 2, 4, 5, 6, 20, 39, 40, 41, 100, 20_000, 20_005):
            # the JAX schedule computes in f32: its rounding near the peak
            # is ~1e-7 of it
            np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6, atol=7.5e-5 * 1e-6,
                                       err_msg=f'warmup {warmup} total {total} step {step}')


def test_batches_match_jax():
    rng = np.random.default_rng(5)
    mels = [rng.standard_normal((100, int(n))).astype(np.float32)
            for n in rng.integers(20, 140, size=11)]
    texts = [f'utterance {i}' for i in range(11)]
    for seed in (0, 3):
        got = list(data.iter_batches(data.ArrayDataset(mels, texts), 4, seed=seed))
        want = list(jdata.iter_batches(jdata.ArrayDataset(mels, texts), 4, seed=seed))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and a['text'] == b['text']
            for k in ('mel', 'mel_lengths', 'text_lengths'):
                np.testing.assert_array_equal(a[k], b[k])


def _toy_dataset(n=8, frames=40):
    rng = np.random.default_rng(6)
    mels = [(0.3 * rng.standard_normal((100, frames - 3 * (i % 3)))).astype(np.float32)
            for i in range(n)]
    return data.ArrayDataset(mels, ['hello world'] * n)


def test_trainer_train_on_cpu(tmp_path):
    p = E2TTS(transformer=dict(SMALL_TF, dropout=0.1), device='cpu')
    trainer = E2Trainer(p, learning_rate=1e-3, num_warmup_steps=1,
                        checkpoint_path=str(tmp_path / 'ckpt'), log_step=3, seed=1)
    assert trainer.device == torch.device('cpu')
    before = [t.detach().clone() for t in p.parameters()]
    history = trainer.train(_toy_dataset(), epochs=2, batch_size=4, save_step=100)
    assert [s for s, _ in history] == [0, 1, 2, 3]
    assert all(np.isfinite(loss) for _, loss in history)
    moved = sum(float((a - t.detach()).abs().sum()) for a, t in zip(before, p.parameters()))
    assert moved > 0


def test_trainer_unported_paths_raise():
    """Every option of the JAX trainer is accepted (held against JAX in
    tests/test_torch_trainer_stack.py, tests/test_torch_trainer_options.py
    and, for meshes, FSDP, TP and SP, tests/test_torch_parallel.py,
    tests/test_torch_tp.py and tests/test_torch_sp.py). A mesh that is not a
    DeviceMesh and an unknown sharding raise; without a mesh
    ``param_sharding='fsdp'`` is a single device, as the JAX trainer on one
    device."""
    p = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    for kw, error, match in ((dict(mesh=object()), TypeError, 'DeviceMesh'),
                             (dict(param_sharding='zero2'), ValueError, 'param_sharding')):
        with pytest.raises(error, match=match):
            E2Trainer(p, **kw)
    trainer = E2Trainer(p, param_sharding='fsdp')
    assert trainer.mesh is None and trainer._model_fn is p


def test_dropout_draws_from_the_given_generator():
    """Two dropout-0.1 losses from equal generators are equal, another seed
    gives another loss, and torch's global generator is neither read nor
    advanced."""
    p = E2TTS(transformer=dict(SMALL_TF, dropout=0.1), device='cpu').train()
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal((B, N, 100)).astype(np.float32))

    def loss(seed):
        out = p(mel, text=TEXTS, lens=torch.from_numpy(LENS).long(), drop_text_cond=False,
                generator=torch.Generator().manual_seed(seed))
        return float(out.loss.detach())

    state = torch.get_rng_state()
    a, b, c = loss(3), loss(3), loss(4)
    assert torch.equal(state, torch.get_rng_state())
    assert a == b and a != c
    with torch.no_grad():
        p.eval()
        assert loss(3) != a          # eval mode: no dropout, same other draws


def test_text_drop_coin_draws_from_the_given_generator():
    """Without ``drop_text_cond`` the text-drop coin comes from the forward's
    generator: equal seeds give equal losses whatever Python's global
    ``random`` holds, and the loss is that of one side of the coin."""
    import random
    p = E2TTS(transformer=dict(SMALL_TF), device='cpu', cond_drop_prob=0.5).train()
    rng = np.random.default_rng(8)
    with torch.no_grad():        # no zero-initialised gate keeps the text out
        for t in p.parameters():
            t.add_(torch.from_numpy(np.asarray(0.02 * rng.standard_normal(t.shape), np.float32)))
    mel = torch.from_numpy(rng.standard_normal((B, N, 100)).astype(np.float32))

    def loss(seed):
        with torch.no_grad():
            out = p(mel, text=TEXTS, lens=torch.from_numpy(LENS).long(),
                    generator=torch.Generator().manual_seed(seed))
        return float(out.loss)

    losses = []
    for seed in range(6):
        random.seed(seed)
        a = loss(seed)
        random.seed(seed + 100)
        assert loss(seed) == a
        losses.append(a)
    with torch.no_grad():
        dropped = [p(mel, text=TEXTS, lens=torch.from_numpy(LENS).long(), drop_text_cond=d,
                     generator=torch.Generator().manual_seed(0)).loss.item()
                   for d in (False, True)]
    assert dropped[0] != dropped[1]
    assert losses[0] in dropped


def test_map_jax_tree_round_trips_a_grad_tree(models):
    """Grads, ADOPT moments and weights share the parameters' paths: the
    mapping is the same relayout for each (so it is linear), and it is strict
    both ways."""
    j, p = models['j'], models['p']
    _, _, _, grads = _jax_loss_and_grads(
        j, None, jnp.asarray(models['mel']), jnp.asarray(LENS), jnp.asarray(models['text']),
        jax.random.key(7), False)
    g, w = _flat(grads), _flat(nnx.state(j, nnx.Param))
    shapes = _param_shapes(p)
    mg, mw = map_jax_tree(g, shapes), map_jax_tree(w, shapes)
    mix = map_jax_tree({k: w[k] + 0.5 * g[k] for k in g}, shapes)
    for name in shapes:
        np.testing.assert_allclose(mix[name], mw[name] + 0.5 * mg[name], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(mw[name], p.state_dict()[name].numpy())
    key = next(iter(g))
    with pytest.raises(ValueError, match='not set'):
        map_jax_tree({k: v for k, v in g.items() if k != key}, shapes)
    with pytest.raises(ValueError, match='unused'):
        map_jax_tree(dict(g, **{'transformer.bogus.kernel': np.zeros((2, 2))}), shapes)


def test_span_masks_match_jax():
    """`mask_from_start_end_indices` equals JAX's; `mask_from_frac_lengths`
    keeps JAX's formula: a span of int(frac * len) frames inside the row,
    drawn from the given generator."""
    from e2_tts_tpu.utils.masking import mask_from_start_end_indices as jax_start_end
    from e2_tts_tpu_torch.utils.masking import (mask_from_frac_lengths,
                                                mask_from_start_end_indices)
    start, end = np.array([0, 3, 7], np.int32), np.array([5, 3, 20], np.int32)
    np.testing.assert_array_equal(
        mask_from_start_end_indices(torch.from_numpy(start), torch.from_numpy(end), 16).numpy(),
        np.asarray(jax_start_end(jnp.asarray(start), jnp.asarray(end), 16)))
    lens = torch.tensor([40, 17, 33])
    frac = torch.tensor([0.7, 0.95, 1.0])
    masks = [mask_from_frac_lengths(lens, frac, 48, torch.Generator().manual_seed(s))
             for s in (0, 0, 1)]
    assert torch.equal(masks[0], masks[1])
    for m in masks:
        assert m.shape == (3, 48)
        assert m.sum(1).tolist() == (frac * lens).long().tolist()
        assert not (m & ~(torch.arange(48)[None] < lens[:, None])).any()


def test_chip_smoke_train_check_limits_cover_a_cpu_rehearsal():
    """`chip_smoke.py`'s card-against-CPU train check, rehearsed on the CPU
    with its own functions: the same depth-2 step at the flagship widths in
    bf16, and in f32 summed in another order (one thread), against the f32
    step. Each stays well inside its limit (TRAIN_CHECK_TOL); the printed
    gaps (``pytest -s``) are the reasons the limits give."""
    import chip_smoke as cs

    small = dict(depth=2, dropout=0.0)
    ref_model = cs.build_e2tts(torch, 'cpu', None, **small).train()
    batch = cs.train_check_batch(torch, ref_model)
    ref_loss, ref_grad = cs.step_loss_and_grads(torch, ref_model, batch)
    del ref_model
    threads = torch.get_num_threads()
    for label, dtype in (('bf16', torch.bfloat16), ('f32', None)):
        model = cs.build_e2tts(torch, 'cpu', dtype, **small).train()
        if label == 'f32':
            torch.set_num_threads(1)
        try:
            loss, grad = cs.step_loss_and_grads(torch, model, batch)
        finally:
            torch.set_num_threads(threads)
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        grad_rel = float((grad - ref_grad).norm() / ref_grad.norm())
        print(f'cpu rehearsal {label} vs f32: loss_rel={loss_rel:.3e} grad_rel_l2={grad_rel:.3e}')
        lim = cs.TRAIN_CHECK_TOL[label]
        assert loss_rel <= lim['loss'] / 2 and grad_rel <= lim['grad'] / 2
