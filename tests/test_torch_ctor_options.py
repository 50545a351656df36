"""The constructor options the port took last, against the JAX package on the
CPU: the 'phoneme_en' tokenizer (through a stand-in ``g2p_en`` module, as
the optional package is not installed here), ``char_embed_kwargs`` on
`E2TTS` and `DurationPredictor`, the plain feedforward (``glu=False``) with
its counter-hash dropout, `HLGaussLayer`'s ``regress_activation``,
`Transformer`'s ``scale_residual`` (accepted and unused on both sides) and
checkpoints from before the fused attention q/k/v parameter through the
weight bridge.

Tolerances (f32): single modules 1e-5 (tests/test_torch_models.py); the
dropout masks and the migrated trees bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

import e2_tts_tpu.ops.dropout as jdropout
from e2_tts_tpu.models.blocks import FeedForward as JaxFeedForward
from e2_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.models.hl_gauss import HLGaussLayer as JaxHLGaussLayer
from e2_tts_tpu.models.transformer import Transformer as JaxTransformer
from e2_tts_tpu.text import tokenizer as jtok
from e2_tts_tpu.training.checkpointing import migrate_qkv_layout as jax_migrate_qkv_layout

from _torch_port_helpers import SMALL_TF, flat_state, perturb_np, stub_g2p_en
from e2_tts_tpu_torch.convert import load_jax_params, migrate_qkv_layout
from e2_tts_tpu_torch.models.blocks import FeedForward
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.models.hl_gauss import HLGaussLayer
from e2_tts_tpu_torch.models.transformer import Transformer
from e2_tts_tpu_torch.ops.dropout import hash_dropout
from e2_tts_tpu_torch.text import tokenizer as tok

TINY_TF = dict(dim=64, depth=2, heads=2, dim_head=32, num_registers=2, max_seq_len=64,
               kernel_size=7, dropout=0.0)
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)


def test_phoneme_tokenizer_matches_jax(monkeypatch):
    """The ids and the vocabulary size (the stand-in's phonemes plus the 17
    extended punctuation ids), and the embedding tables the models build
    from them."""
    stub_g2p_en(monkeypatch)
    texts = ['hello there', 'ok, go!', "it's \"x\" - y?", '']
    (encode, vocab), (jencode, jvocab) = (m.resolve_tokenizer('phoneme_en')
                                          for m in (tok, jtok))
    assert vocab == jvocab == 28 + 17
    np.testing.assert_array_equal(encode(texts), jencode(texts))
    assert encode(texts).min() == -1 and encode(texts).max() < vocab
    tf = dict(TINY_TF, attn_backend='xla')
    j = JaxE2TTS(transformer=tf, tokenizer='phoneme_en', use_vocos=False, rngs=nnx.Rngs(0))
    p = E2TTS(transformer=dict(TINY_TF), tokenizer='phoneme_en', device='cpu')
    assert p.embed_text.embed.weight.shape == j.embed_text.embed.embedding[...].shape
    jdp = JaxDurationPredictor(transformer=tf, tokenizer='phoneme_en', rngs=nnx.Rngs(0))
    dp = DurationPredictor(transformer=dict(TINY_TF), tokenizer='phoneme_en', device='cpu')
    assert dp.embed_text.embed.weight.shape == jdp.embed_text.embed.embedding[...].shape


@pytest.mark.parametrize('kwargs,error', [({}, None), ({'bogus': 1}, TypeError),
                                          ({'num_embeds': 10}, TypeError)],
                         ids=['empty', 'unknown', 'duplicate'])
def test_char_embed_kwargs_match_jax(kwargs, error):
    """``char_embed_kwargs`` reach the character embedding on both models
    as in the JAX package: an empty dict builds, a keyword the embedding
    does not take or one the model already passes raises TypeError."""
    tf = dict(TINY_TF, attn_backend='xla')
    builds = [lambda: JaxE2TTS(transformer=tf, char_embed_kwargs=kwargs, use_vocos=False,
                               rngs=nnx.Rngs(0)),
              lambda: E2TTS(transformer=dict(TINY_TF), char_embed_kwargs=kwargs, device='cpu'),
              lambda: JaxDurationPredictor(transformer=tf, char_embed_kwargs=kwargs,
                                           rngs=nnx.Rngs(0)),
              lambda: DurationPredictor(transformer=dict(TINY_TF), char_embed_kwargs=kwargs,
                                        device='cpu')]
    for build in builds:
        if error is None:
            assert build().embed_text is not None
        else:
            with pytest.raises(error):
                build()


@pytest.mark.parametrize('dropout', [0.0, 0.1])
def test_plain_feedforward_matches_jax(dropout, monkeypatch):
    """``FeedForward(glu=False)``: inner ``mult * dim`` rounded up to 64,
    exact GELU, then the counter-hash dropout with the seed the JAX module
    draws (recorded as it calls `_seed_from_key`); the masks are bit for
    bit `hash_dropout`'s."""
    j = perturb_np(JaxFeedForward(96, mult=3, dropout=dropout, glu=False, rngs=nnx.Rngs(0)),
                   seed=70)
    p = FeedForward(96, mult=3, dropout=dropout, glu=False)
    load_jax_params(p, flat_state(j))
    assert p.proj_in.weight.shape == (320, 96)
    x = np.random.default_rng(71).standard_normal((2, 12, 96)).astype(np.float32)
    seeds, seed_from_key = [], jdropout._seed_from_key
    monkeypatch.setattr(jdropout, '_seed_from_key',
                        lambda key: seeds.append(int(seed_from_key(key))) or seed_from_key(key))
    want = np.asarray(j(jnp.asarray(x)))
    assert len(seeds) == int(dropout > 0)
    with torch.no_grad():
        got = p(torch.from_numpy(x), dropout_seed=seeds[0] if seeds else None).numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)
    if dropout:
        key = jax.random.key(72)
        h = np.random.default_rng(73).standard_normal((2, 12, 320)).astype(np.float32)
        want = np.asarray(jdropout.hash_dropout(jnp.asarray(h), dropout, key))
        got = hash_dropout(torch.from_numpy(h), dropout, int(seed_from_key(key))).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.05 < (got == 0).mean() < 0.15


@pytest.mark.parametrize('activation', ['softplus', 'relu', 'identity'])
def test_regress_activation_matches_jax(activation):
    jax_fn, port_fn = dict(softplus=(jax.nn.softplus, F.softplus), relu=(jax.nn.relu, F.relu),
                           identity=(lambda t: t, lambda t: t))[activation]
    j = perturb_np(JaxHLGaussLayer(48, regress_activation=jax_fn, rngs=nnx.Rngs(0)), seed=74)
    p = HLGaussLayer(48, regress_activation=port_fn)
    load_jax_params(p, flat_state(j))
    rng = np.random.default_rng(75)
    embed = rng.standard_normal((5, 48)).astype(np.float32)
    target = rng.uniform(1, 9, 5).astype(np.float32)
    with torch.no_grad():
        for tgt in (None, target):
            want = j(jnp.asarray(embed), None if tgt is None else jnp.asarray(tgt))
            got = p(torch.from_numpy(embed), None if tgt is None else torch.from_numpy(tgt))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_scale_residual_is_accepted_and_unused():
    """Both packages take ``scale_residual`` and build the same state; the
    port's forward is the one without it, bit for bit."""
    j = JaxTransformer(**TINY_TF, scale_residual=True, attn_backend='xla', rngs=nnx.Rngs(0))
    p = Transformer(**TINY_TF, scale_residual=True, device='cpu').eval()
    load_jax_params(p, flat_state(j))
    plain = Transformer(**TINY_TF, device='cpu').eval()
    plain.load_state_dict(p.state_dict())
    x = torch.from_numpy(np.random.default_rng(76).standard_normal((1, 8, 64))
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(p(x, times=torch.tensor([0.5])), plain(x, times=torch.tensor([0.5])))


def _split_qkv(tree):
    """A pure state tree in the layout from before the fused q/k/v
    parameter (tests/test_trainer.py)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == 'to_qkv':
            kern = np.asarray(v['kernel'])
            for i, name in enumerate(('to_q', 'to_k', 'to_v')):
                out[name] = {'kernel': kern[..., i, :]}
        else:
            out[k] = _split_qkv(v)
    return out


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = np.asarray(v)
    return out


@pytest.mark.parametrize('scan', [False, True], ids=['unrolled', 'scan'])
def test_pre_fused_qkv_tree_matches_jax_migration(scan):
    """The bridge's own `migrate_qkv_layout` on the flat tree is the JAX
    package's migration of the nested one, bit for bit (stacked scan groups
    too), passes a fused tree through, and `load_jax_params` takes the old
    layout into the same weights as the new one."""
    tf = dict(SMALL_TF, depth=6 if scan else 2, scan_layers=scan, attn_backend='xla')
    # built under nnx.jit: one compile instead of an eager init op by op
    j = perturb_np(nnx.jit(lambda: JaxE2TTS(transformer=tf, use_vocos=False,
                                            rngs=nnx.Rngs(0)))(), seed=77)
    pure = jax.tree.map(np.asarray, nnx.to_pure_dict(nnx.state(j, nnx.Not(nnx.RngState))))
    old = _split_qkv(pure)
    old_flat = _flat(old)
    assert any('.to_q.' in k for k in old_flat) and not any('to_qkv' in k for k in old_flat)
    want = _flat(jax_migrate_qkv_layout(old))
    got = migrate_qkv_layout(old_flat)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    new_flat = _flat(pure)
    assert sorted(migrate_qkv_layout(new_flat)) == sorted(new_flat)
    build = lambda: E2TTS(transformer={k: v for k, v in tf.items() if k != 'attn_backend'},
                          device='cpu', use_vocos=False)
    from_old, from_new = build(), build()
    load_jax_params(from_old, old_flat)
    load_jax_params(from_new, new_flat)
    for (name, a), b in zip(from_old.state_dict().items(), from_new.state_dict().values()):
        assert torch.equal(a, b), name
