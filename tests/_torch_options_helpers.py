"""Shared parts of the option parity tests (tests/test_torch_options*.py):
the options, the JAX / port model pairs, and the loss-and-grads parity
with dropout 0.1, its masks bit-identical on both sides.

The JAX model is built with ``attn_backend='pallas'``, so on the CPU its
attention runs the Pallas kernel in interpret mode with the counter hash,
and its GEGLU dropout is the same hash. Each draw of its ``dropout``
stream is ``fold_in(key, count)``; the attention takes its seed as
``randint(key_i)``, the feedforward as ``_seed_from_key(key_i)``.
`jax_dropout_seeds` computes those seeds in the JAX model's draw order
(per layer: text attention, text feedforward, attention, feedforward; the
frequency attention has no dropout) and `port_loss_and_grads` hands them to
the port's `draw_seed`, which the port calls in the same order. The loss's
draws (span, x0, t) come from the JAX key as in
tests/test_torch_training.py.

`check_cfg_both_modes` holds one CFG evaluation in both modes with JAX's
attention on XLA (eval mode has no dropout).

Tolerances (f32): the CFG evaluation 1e-4; the loss 1e-5 relative, the prediction 1e-4, the full
grad vector 1e-4 in relative L2 and each grad 1e-3 relative plus 1e-4 of
its tensor's largest |grad| (as tests/test_torch_training.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

import e2_tts_tpu.ops.flash_attention as jfa
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.ops.dropout import _seed_from_key
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_port_helpers import SMALL_TF, flat_state, perturb_np
import e2_tts_tpu_torch.models.transformer as port_transformer
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS

B, N = 2, 24
LENS = np.array([24, 17], np.int32)
TEXTS = ['hello there', 'ok']

# option name: (E2TTS kwargs, transformer kwargs)
OPTIONS = {
    'freq_k1': (dict(num_freq_tokens=2), dict()),
    'freq_k8': (dict(num_freq_tokens=2), dict(freq_dim_head=8)),
    'concat_cond': (dict(concat_cond=True), dict()),
    'interpolated_text': (dict(interpolated_text=True), dict()),
    'fourier_input': (dict(), dict(attn_fourier_embed_input=True)),
    'all': (dict(num_freq_tokens=2, concat_cond=True, interpolated_text=True),
            dict(attn_fourier_embed_input=True, remat='dots_with_no_batch_dims_saveable')),
}


def cpu_test_settings():
    """A generator for a module fixture: the JAX package's Pallas kernels in
    interpret mode, and one torch intra-op thread (as fast alone at these
    widths, and it does not stall when the suite's workers share the cores),
    while the module's tests run."""
    saved, threads = jfa._INTERPRET, torch.get_num_threads()
    jfa._INTERPRET = True
    torch.set_num_threads(1)
    yield
    jfa._INTERPRET = saved
    torch.set_num_threads(threads)


def build_pair(option, seed=21, dropout=0.1, backend='pallas'):
    """The JAX model of ``option`` (attention ``backend``), perturbed, and
    the port with its weights."""
    e2_kw, tf_kw = OPTIONS[option]
    tf = dict(SMALL_TF, dropout=dropout, **tf_kw)
    j = perturb_np(JaxE2TTS(transformer=dict(tf, attn_backend=backend), use_vocos=False,
                            rngs=nnx.Rngs(0), **e2_kw), seed=seed)
    p = E2TTS(transformer=dict(tf), device='cpu', **e2_kw)
    load_jax_params(p, flat_state(j))
    return j, p


def jax_dropout_seeds(model, depth, text_depth):
    """The seeds the JAX model's next `forward` draws, in its draw order.
    `forward` first draws its flow key even when it is given one
    (``default(key, self.rngs.flow())`` evaluates both arguments)."""
    stream = model.rngs.default
    key, count = stream.key[...], int(stream.count[...]) + 1
    kinds = []
    for ind in range(depth):
        kinds += (['attn', 'ff'] if ind < text_depth else []) + ['attn', 'ff']
    seeds = []
    for i, kind in enumerate(kinds):
        k = jax.random.fold_in(key, count + i)
        seeds.append(int(jax.random.randint(k, (1,), 0, jnp.iinfo(jnp.int32).max,
                                            dtype=jnp.int32)[0]) if kind == 'attn'
                     else int(_seed_from_key(k)))
    return seeds


def loss_draws(key):
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
def jax_loss_and_grads(model, mel, text, lens, key, drop_text_cond=False):
    def loss_fn(m):
        out = m(mel, text=text, lens=lens, key=key, drop_text_cond=drop_text_cond)
        return out.loss, out.pred_flow
    return nnx.value_and_grad(loss_fn, has_aux=True)(model)


def port_loss_and_grads(p, mel, text, draws, seeds, monkeypatch):
    it = iter(seeds)
    monkeypatch.setattr(port_transformer, 'draw_seed', lambda generator: next(it))
    p.zero_grad(set_to_none=True)
    out = p(torch.from_numpy(mel), text=torch.from_numpy(text).long(),
            lens=torch.from_numpy(LENS).long(), drop_text_cond=False, **draws)
    out.loss.backward()
    assert next(it, None) is None                   # every JAX draw was used
    grads = {name: (t.grad if t.grad is not None else torch.zeros_like(t)).numpy().copy()
             for name, t in p.named_parameters()}
    return out, grads


def flat(state):
    return {'.'.join(map(str, path)): np.asarray(var.get_value() if hasattr(var, 'get_value')
                                                 else var)
            for path, var in nnx.to_flat_state(state)}


def assert_grads_match(ported, grads_j):
    mapped = map_jax_tree(flat(grads_j), {k: v.shape for k, v in ported.items()})
    assert set(mapped) == set(ported)
    names = sorted(ported)
    vp = np.concatenate([ported[n].ravel() for n in names])
    vj = np.concatenate([np.asarray(mapped[n]).ravel() for n in names])
    assert np.linalg.norm(vp - vj) <= 1e-4 * np.linalg.norm(vj)
    for name in names:
        g = np.asarray(mapped[name])
        np.testing.assert_allclose(ported[name], g, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-12, err_msg=name)


def check_loss_and_grads(option, monkeypatch):
    """One option's loss, prediction and every grad against JAX's with
    dropout 0.1; other seeds must move the port's loss (the masks are
    drawn)."""
    j, p = build_pair(option)
    j.train()
    p.train()
    rng = np.random.default_rng(22)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(j.tokenizer(TEXTS))
    key = jax.random.key(23)
    tf = p.transformer
    seeds = jax_dropout_seeds(j, tf.depth, tf.text_depth)
    (loss_j, pred_j), grads_j = jax_loss_and_grads(j, *map(jnp.asarray, (mel, text, LENS)), key)

    out, ported = port_loss_and_grads(p, mel, text, loss_draws(key), seeds, monkeypatch)
    np.testing.assert_allclose(float(out.loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(out.pred_flow.detach().numpy(), np.asarray(pred_j),
                               atol=1e-4, rtol=1e-4)
    assert_grads_match(ported, grads_j)
    other = [s ^ 0x5A5A5A5A for s in seeds]
    out_other, _ = port_loss_and_grads(p, mel, text, loss_draws(key), other, monkeypatch)
    assert abs(float(out_other.loss.detach()) - float(loss_j)) > 1e-4 * abs(float(loss_j))
    return j, p


@nnx.jit
def _jax_cfg_both(model, x, cond, times, text, mask):
    kw = dict(text=text, mask=mask, cfg_strength=1.0)
    return (model.cfg_transformer_with_pred_head(x, cond, times, batched_cfg=False, **kw),
            model.cfg_transformer_with_pred_head(x, cond, times, batched_cfg=True, **kw))


def check_cfg_both_modes(option):
    """One CFG evaluation, sequential and batched, against JAX's at 1e-4
    (as the backbone in tests/test_torch_models.py); the JAX model's
    attention on XLA (eval mode has no dropout). Returns the eval-mode
    pair."""
    j, p = build_pair(option, backend='xla', dropout=0.0)
    j.eval()
    p.eval()
    rng = np.random.default_rng(51)
    x = rng.standard_normal((B, N, 100)).astype(np.float32)
    cond = (0.3 * rng.standard_normal((B, N, 100))).astype(np.float32)
    times = np.array([0.3, 0.7], np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 19:] = False
    text = np.asarray(j.tokenizer(TEXTS))
    outs_j = _jax_cfg_both(j, *map(jnp.asarray, (x, cond, times, text, mask)))
    for batched, out_j in zip((False, True), outs_j):
        with torch.no_grad():
            out_p = p.cfg_transformer_with_pred_head(
                *map(torch.from_numpy, (x, cond, times)), text=torch.from_numpy(text).long(),
                mask=torch.from_numpy(mask), cfg_strength=1.0, batched_cfg=batched)
        np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-4, rtol=1e-4,
                                   err_msg=f'batched_cfg={batched}')
    return j, p
