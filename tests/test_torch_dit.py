"""A DiT-geometry E2TTS (heads of 72, which only K8 / K9 take) with LASER
and per-layer remat: the port against the JAX package on the CPU, and the
port's remat against its own un-checkpointed layers.

The JAX model is built with ``attn_backend='pallas'`` so that on the CPU its
attention runs `flash_attention` (K8 / K9) in interpret mode, not XLA; it
is perturbed by seeded noise and copied into the port through
`load_jax_params`. The loss's draws (span, x0, t) come from the JAX key and
are handed to the port, as in tests/test_torch_training.py. Model-level
dropout stays 0 against JAX (the JAX model on the CPU draws its dropout with
`jax.random.bernoulli`, not the kernels' counter hash); dropout is held bit
for bit against JAX at the kernel level (tests/test_torch_flash_bhnd.py)
and, here, remat on against off at dropout 0.1.

Tolerances (f32): the CFG evaluation and the prediction 1e-4 (as the
backbone in tests/test_torch_models.py), the loss 1e-5 relative, each grad
1e-3 relative plus 1e-4 of its tensor's largest |grad| (as
tests/test_torch_training.py). Remat on against off: equal, since the
recompute runs the same CPU ops on the same inputs in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import e2_tts_tpu.ops.flash_attention as jfa
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_port_helpers import flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS

# DiT-XL's head geometry (16 x 72) cut to 2 heads and 2 layers
DIT_SMALL = dict(dim=128, depth=2, heads=2, dim_head=72, num_registers=4, max_seq_len=256,
                 kernel_size=7, dropout=0.0, remat=True, attn_laser=True)
B, N = 2, 24
LENS = np.array([24, 17], np.int32)
TEXTS = ['hello there', 'ok']


@pytest.fixture(scope='module')
def models():
    saved = jfa._INTERPRET
    jfa._INTERPRET = True
    j = perturb(JaxE2TTS(transformer=dict(DIT_SMALL, attn_backend='pallas'), use_vocos=False,
                         rngs=nnx.Rngs(0)), seed=11)
    p = E2TTS(transformer=dict(DIT_SMALL), device='cpu')
    load_jax_params(p, flat_state(j))
    yield j, p
    jfa._INTERPRET = saved


def test_bridge_needs_nothing_new():
    """dim_head 72, LASER and remat add no parameters: the model's names
    and shapes are those of the plain configuration."""
    shapes = lambda m: {k: tuple(v.shape) for k, v in m.named_parameters()}
    plain = dict(DIT_SMALL, remat=False, attn_laser=False)
    assert shapes(E2TTS(transformer=DIT_SMALL, device='cpu')) == \
        shapes(E2TTS(transformer=plain, device='cpu'))


def test_cfg_evaluation(models):
    j, p = models
    j.eval()
    p.eval()
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, N, 100)).astype(np.float32)
    cond = (0.3 * rng.standard_normal((B, N, 100))).astype(np.float32)
    times = np.array([0.3, 0.7], np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 19:] = False
    text = np.asarray(j.tokenizer(TEXTS))
    jo = nnx.jit(lambda m, *a: m.cfg_transformer_with_pred_head(
        *a[:3], text=a[3], mask=a[4], cfg_strength=1.0, batched_cfg=False))(
        j, *map(jnp.asarray, (x, cond, times, text, mask)))
    with torch.no_grad():
        po = p.cfg_transformer_with_pred_head(
            torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(times),
            text=torch.from_numpy(text).long(), mask=torch.from_numpy(mask),
            cfg_strength=1.0, batched_cfg=False)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4, rtol=1e-4)


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


def _flat(state):
    return {'.'.join(map(str, path)): np.asarray(var.get_value() if hasattr(var, 'get_value')
                                                 else var)
            for path, var in nnx.to_flat_state(state)}


def _port_loss_and_grads(p, mel, text, draws, generator=None):
    p.zero_grad(set_to_none=True)
    out = p(torch.from_numpy(mel), text=torch.from_numpy(text).long(),
            lens=torch.from_numpy(LENS).long(), drop_text_cond=False, generator=generator,
            **draws)
    out.loss.backward()
    grads = {name: (t.grad if t.grad is not None else torch.zeros_like(t)).numpy().copy()
             for name, t in p.named_parameters()}
    return out, grads


def test_loss_and_every_grad_match_jax(models):
    j, p = models
    j.train()
    p.train()
    rng = np.random.default_rng(13)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(j.tokenizer(TEXTS))
    key = jax.random.key(14)

    @nnx.jit
    def loss_and_grads(m, mel, text, lens, key):
        def loss_fn(m):
            out = m(mel, text=text, lens=lens, key=key, drop_text_cond=False)
            return out.loss, out.pred_flow
        return nnx.value_and_grad(loss_fn, has_aux=True)(m)
    (loss_j, pred_j), grads_j = loss_and_grads(j, *map(jnp.asarray, (mel, text, LENS)), key)

    out, ported = _port_loss_and_grads(p, mel, text, _draws(key))
    np.testing.assert_allclose(float(out.loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(out.pred_flow.detach().numpy(), np.asarray(pred_j),
                               atol=1e-4, rtol=1e-4)
    mapped = map_jax_tree(_flat(grads_j), {k: v.shape for k, v in ported.items()})
    assert set(mapped) == set(ported)
    for name, g in mapped.items():
        g = np.asarray(g)
        np.testing.assert_allclose(ported[name], g, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-12, err_msg=name)


def test_remat_matches_no_remat_at_dropout():
    """At dropout 0.1 the checkpointed layers recompute with the forward's
    seeds: the loss and every grad equal the un-checkpointed model's, and
    both models draw the same seeds from equal generators."""
    cfg = dict(DIT_SMALL, dropout=0.1)
    gen = lambda: torch.Generator().manual_seed(15)
    on = E2TTS(transformer=dict(cfg, remat=True), device='cpu', generator=gen()).train()
    off = E2TTS(transformer=dict(cfg, remat=False), device='cpu', generator=gen()).train()
    rng = np.random.default_rng(16)
    mel = rng.standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(on.tokenizer(TEXTS))
    draws = _draws(jax.random.key(17))
    g_on, g_off = gen(), gen()
    out_on, grads_on = _port_loss_and_grads(on, mel, text, draws, g_on)
    out_off, grads_off = _port_loss_and_grads(off, mel, text, draws, g_off)
    assert torch.equal(g_on.get_state(), g_off.get_state())
    loss = lambda out: float(out.loss.detach())
    assert loss(out_on) == loss(out_off)
    assert loss(out_on) != loss(_port_loss_and_grads(off, mel, text, draws,
                                                     gen().manual_seed(18))[0])
    for name, g in grads_on.items():
        np.testing.assert_array_equal(g, grads_off[name], err_msg=name)
