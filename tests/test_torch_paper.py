"""The port's E2TTS with ``hc_save_state=True`` against the JAX package on
the CPU: the JAX package's own test geometry (2 streams, heads of 16) in
training, and the E2-TTS paper's widths through the strict weight bridge.

The JAX model's hyper-connections take the kernel path on the CPU when
``_INTERPRET`` is set on the imported module, and the save-state kernels
when ``_SAVE_STATE`` is set too (both monkeypatched, never edited). The
loss's draws (span, x0, t) come from the JAX key as
tests/test_torch_training.py makes them.

Tolerances (f32): the loss 1e-5 relative; every grad 1e-4 relative L2 (a
backward through four layers of f32 summation-order differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import e2_tts_tpu.ops.hyper_conn_kernel as jhck
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS

from _torch_port_helpers import flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS

# the JAX package's own test geometry (tests/test_models.py SMALL_TF) in the
# port's arguments: speech width 64, text width 32, 2 heads of 16, 2 streams
TINY_TF = dict(dim=64, depth=4, heads=2, dim_head=16, ff_mult=2, num_registers=4,
               max_seq_len=256, kernel_size=7, dropout=0.0, num_residual_streams=2)


@pytest.fixture
def interpret():
    saved = jhck._INTERPRET
    jhck._INTERPRET = True
    yield
    jhck._INTERPRET = saved


@nnx.jit
def _jax_loss_and_grads(model, mel, lens, text, key):
    def loss_fn(m):
        return m(mel, text=text, lens=lens, key=key, drop_text_cond=False).loss
    return nnx.value_and_grad(loss_fn)(model)


def test_tiny_model_save_state_matches_jax_save_path(interpret, monkeypatch):
    """The JAX test geometry (2 streams at widths 64 and 32, 2 heads of 16)
    with ``hc_save_state=True``: the loss and every grad against the JAX
    model whose hyper-connections run the save-state kernels (``_SAVE_STATE``
    and ``_INTERPRET`` set), the draws handed over as in
    tests/test_torch_training.py."""
    monkeypatch.setattr(jhck, '_SAVE_STATE', True)
    j = perturb(JaxE2TTS(transformer=dict(TINY_TF, attn_backend='xla'), use_vocos=False,
                         rngs=nnx.Rngs(0)), seed=3)
    j.train()
    p = E2TTS(transformer=dict(TINY_TF, hc_save_state=True), device='cpu')
    load_jax_params(p, flat_state(j))
    p.train()
    b, n = 2, 24
    lens = np.array([24, 17], np.int32)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = np.asarray(j.tokenizer(['hi there', 'ok']))
    key = jax.random.key(4)
    loss_j, grads_j = _jax_loss_and_grads(j, jnp.asarray(mel), jnp.asarray(lens),
                                          jnp.asarray(text), key)

    from e2_tts_tpu.utils.masking import lens_to_mask, mask_from_frac_lengths
    k_frac, k_span, k_x0, k_time = jax.random.split(key, 4)
    frac = jax.random.uniform(k_frac, (b,), minval=0.7, maxval=1.0)
    span = mask_from_frac_lengths(k_span, jnp.asarray(lens), frac, n) \
        & lens_to_mask(jnp.asarray(lens), length=n)
    draws = dict(times=torch.from_numpy(np.array(jax.random.uniform(k_time, (b,)))),
                 noise=torch.from_numpy(np.array(jax.random.normal(k_x0, (b, n, 100)))),
                 rand_span_mask=torch.from_numpy(np.array(span)))
    out = p(torch.from_numpy(mel), text=torch.from_numpy(text).long(),
            lens=torch.from_numpy(lens).long(), drop_text_cond=False, **draws)
    out.loss.backward()
    assert abs(float(out.loss.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))

    flat = {'.'.join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(grads_j)}
    shapes = {name: tuple(t.shape) for name, t in p.named_parameters()}
    mapped = map_jax_tree(flat, shapes)
    hc_grads = 0
    for name, t in p.named_parameters():
        g = (t.grad if t.grad is not None else torch.zeros_like(t)).numpy().astype(np.float64)
        ref = np.asarray(mapped[name], np.float64)
        err = np.linalg.norm(g - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= 1e-4, (name, err)
        hc_grads += 'dynamic_alpha_fn' in name and np.abs(ref).max() > 0
    assert hc_grads >= 2 * 3 * 4          # every speech and text branch's router learns


def test_bridge_strict_at_the_paper_widths():
    """The E2-TTS paper's widths (1024, 16 x 64, text 512; depth 2, the
    smallest the backbone takes) load strictly from the JAX model's state
    tree (its shapes, zero-filled: `nnx.eval_shape` skips the random init)
    with the flag off and on: ``hc_save_state`` adds no parameter and no
    buffer."""
    cfg = dict(dim=1024, depth=2, heads=16, dim_head=64)
    abstract = nnx.eval_shape(lambda: JaxE2TTS(transformer=dict(cfg, attn_backend='xla'),
                                               use_vocos=False, rngs=nnx.Rngs(0)))
    state = {'.'.join(map(str, path)): np.zeros(var.get_value().shape,
                                                var.get_value().dtype)
             for path, var in nnx.to_flat_state(nnx.state(abstract))
             if 'rngs' not in path}
    keys = []
    for save in (False, True):
        p = E2TTS(transformer=dict(cfg, hc_save_state=save), device='cpu')
        load_jax_params(p, state)
        keys.append(sorted(p.state_dict()))
        assert p.transformer.speech_hcs[0][0].save_state == save
    assert keys[0] == keys[1]
