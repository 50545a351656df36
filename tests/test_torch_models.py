"""The port's modules, backbone and sampler against the JAX package on the
CPU, under the same weights through `load_jax_params`.

Every JAX module is built with its own initialisation, perturbed by seeded
noise (so zero-initialised gates, cross-conditions and dynamic
hyper-connection weights are live), and its state copied into the port.

Tolerances (all f32): single modules 1e-5 — the sides differ by summation
order and transcendental implementations only; the backbone and CFG
evaluations 1e-4 — those differences pass through a few dozen layers; the
sampler 1e-4 on outputs of order 1.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models import blocks as jblocks
from e2_tts_tpu.models import hyper_connections as jhc
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.models.transformer import Transformer as JaxTransformer
from e2_tts_tpu.ops.rotary import rotary_freqs

from _torch_port_helpers import SMALL_TF, flat_state, perturb, stub_g2p_en
from e2_tts_tpu_torch.convert import load_jax_params
from e2_tts_tpu_torch.models import blocks, hyper_connections as hc
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.models.transformer import Transformer
from e2_tts_tpu_torch.ops.rotary import rotary_tables
from e2_tts_tpu_torch.vocoder.vocos import Vocos

MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def _port(module_cls, jax_module, *args, **kwargs):
    port = module_cls(*args, **kwargs)
    load_jax_params(port, flat_state(jax_module))
    return port.eval()


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# -- blocks ------------------------------------------------------------------------

def test_hyper_connection_lazy_chain():
    """expand -> K5 -> branch -> K3 (lazy) -> branch -> materialize / reduce."""
    rng = np.random.default_rng(0)
    j1, j2 = (perturb(jhc.HyperConnection(64, 4, i, rngs=nnx.Rngs(0)), seed=i) for i in (0, 1))
    p1, p2 = (_port(hc.HyperConnection, j, 64, 4, i) for i, j in enumerate((j1, j2)))
    x = _np(rng, 2, 10, 64)
    f = _np(rng, 64, 64, scale=0.2)            # a fixed "branch" function

    jb, jadd = j1(jhc.expand_stream(jnp.asarray(x), 4))
    pb, padd = p1(hc.expand_stream(torch.from_numpy(x), 4))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **MODULE_TOL)
    jlazy, plazy = jadd(jb @ f), padd(pb @ torch.from_numpy(f))
    assert isinstance(plazy, hc.LazyStreams)

    jb2, jadd2 = j2(jlazy)
    pb2, padd2 = p2(plazy)
    np.testing.assert_allclose(pb2.numpy(), np.asarray(jb2), **MODULE_TOL)
    jout, pout = jadd2(jnp.tanh(jb2)), padd2(torch.tanh(pb2))
    np.testing.assert_allclose(hc.materialize(pout).numpy(),
                               np.asarray(jhc.materialize(jout)), **MODULE_TOL)
    np.testing.assert_allclose(hc.reduce_stream(pout).numpy(),
                               np.asarray(jhc.reduce_stream(jout)), **MODULE_TOL)


@pytest.mark.parametrize('with_residual', [False, True])
def test_attention(with_residual):
    rng = np.random.default_rng(1)
    kw = dict(heads=4, dim_head=32, gate_value_heads=True, softclamp_logits=True,
              learned_value_residual_mix=with_residual)
    j = perturb(jblocks.Attention(128, **kw, rngs=nnx.Rngs(0)), seed=2)
    p = _port(blocks.Attention, j, 128, **kw)
    b, n = 2, 40
    x, vres = _np(rng, b, n, 128), _np(rng, b, n, 128)
    mask = np.ones((b, n), bool)
    mask[1, 25:] = False
    j_out, j_vals = j(jnp.asarray(x), rotary_pos_emb=rotary_freqs(n, 32),
                      mask=jnp.asarray(mask),
                      value_residual=jnp.asarray(vres) if with_residual else None)
    p_out, p_vals = p(torch.from_numpy(x), rotary_pos_emb=rotary_tables(n, 32),
                      mask=torch.from_numpy(mask),
                      value_residual=torch.from_numpy(vres) if with_residual else None)
    np.testing.assert_allclose(p_out.detach().numpy(), np.asarray(j_out), **MODULE_TOL)
    np.testing.assert_allclose(p_vals.detach().numpy(), np.asarray(j_vals), **MODULE_TOL)


@pytest.mark.parametrize('dim', [128, 64])
def test_feedforward(dim):
    rng = np.random.default_rng(dim)
    j = perturb(jblocks.FeedForward(dim, mult=4, rngs=nnx.Rngs(0)))
    j.eval()
    p = _port(blocks.FeedForward, j, dim, mult=4)
    assert p.proj_out.weight.shape[1] == {128: 384, 64: 192}[dim]
    x = _np(rng, 2, 30, dim)
    np.testing.assert_allclose(p(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(j(jnp.asarray(x))), **MODULE_TOL)


def test_norms_conv_and_embeds():
    rng = np.random.default_rng(3)
    x, cond = _np(rng, 2, 20, 64), _np(rng, 2, 64)
    mask = np.ones((2, 20), bool)
    mask[0, 15:] = False
    cases = [
        (jblocks.RMSNorm(64), blocks.RMSNorm(64), lambda m, t: m(t(x))),
        (jblocks.AdaptiveRMSNorm(64, rngs=nnx.Rngs(0)), blocks.AdaptiveRMSNorm(64),
         lambda m, t: m(t(x), condition=t(cond))),
        (jblocks.AdaLNZero(64, rngs=nnx.Rngs(0)), blocks.AdaLNZero(64),
         lambda m, t: m(t(x), condition=t(cond))),
        (jblocks.DepthwiseConv(64, kernel_size=7, rngs=nnx.Rngs(0)),
         blocks.DepthwiseConv(64, kernel_size=7), lambda m, t: m(t(x), mask=t(mask))),
    ]
    for jm, pm, call in cases:
        perturb(jm, seed=4)
        load_jax_params(pm, flat_state(jm))
        np.testing.assert_allclose(call(pm, torch.from_numpy).detach().numpy(),
                                   np.asarray(call(jm, jnp.asarray)), **MODULE_TOL)

    jf = jblocks.RandomFourierEmbed(64, rngs=nnx.Rngs(0))
    pf = blocks.RandomFourierEmbed(64)
    load_jax_params(pf, flat_state(jf))
    t = np.array([0.0, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(pf(torch.from_numpy(t)).numpy(),
                               np.asarray(jf(jnp.asarray(t))), **MODULE_TOL)

    jc = jblocks.CharacterEmbed(32, rngs=nnx.Rngs(0))
    pc = blocks.CharacterEmbed(32)
    load_jax_params(pc, flat_state(jc))
    ids = np.array([[104, 105, -1, -1], [1, 2, 3, 4]], np.int32)
    np.testing.assert_allclose(pc(torch.from_numpy(ids).long(), 6).detach().numpy(),
                               np.asarray(jc(jnp.asarray(ids), 6)), **MODULE_TOL)


def test_text_audio_cross_condition_gate():
    rng = np.random.default_rng(5)
    j = perturb(jblocks.TextAudioCrossCondition(64, 32, rngs=nnx.Rngs(0)))
    p = _port(blocks.TextAudioCrossCondition, j, 64, 32)
    a, t = _np(rng, 4, 2, 10, 64), _np(rng, 4, 2, 10, 32)
    gate = np.array([1.0, 0.0], np.float32)[None, :, None, None]
    for ja, pa in zip(j(jnp.asarray(a), jnp.asarray(t), gate=jnp.asarray(gate)),
                      p(torch.from_numpy(a), torch.from_numpy(t), gate=torch.from_numpy(gate))):
        np.testing.assert_allclose(pa.detach().numpy(), np.asarray(ja), **MODULE_TOL)


# -- backbone ----------------------------------------------------------------------

@pytest.fixture(scope='module', params=[2, 1], ids=['text_depth=2', 'text_depth=1'])
def transformers(request):
    cfg = dict(SMALL_TF, text_depth=request.param)
    j = perturb(JaxTransformer(**cfg, rngs=nnx.Rngs(0)), seed=6)
    j.eval()
    p = Transformer(**cfg, device='cpu')
    load_jax_params(p, flat_state(j))
    return j, p.eval()


@pytest.mark.parametrize('mode', ['no_text', 'text', 'text_cond_gate'])
def test_transformer(transformers, mode):
    j, p = transformers
    rng = np.random.default_rng(7)
    b, n = 2, 24
    x, text = _np(rng, b, n, 128), _np(rng, b, n, 64)
    times = np.array([0.2, 0.9], np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 17:] = False
    kw_j = dict(times=jnp.asarray(times), mask=jnp.asarray(mask))
    kw_p = dict(times=torch.from_numpy(times), mask=torch.from_numpy(mask))
    if mode != 'no_text':
        kw_j['text_embed'], kw_p['text_embed'] = jnp.asarray(text), torch.from_numpy(text)
    if mode == 'text_cond_gate':
        gate = np.array([1.0, 0.0], np.float32)
        kw_j['text_cond_gate'], kw_p['text_cond_gate'] = jnp.asarray(gate), torch.from_numpy(gate)
    with torch.no_grad():
        out = p(torch.from_numpy(x), **kw_p)
    np.testing.assert_allclose(out.numpy(), np.asarray(j(jnp.asarray(x), **kw_j)), **MODEL_TOL)


# -- E2TTS ----------------------------------------------------------------------------

@pytest.fixture(scope='module')
def e2tts_pair():
    j = perturb(JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=False, rngs=nnx.Rngs(0)),
                seed=8)
    j.eval()
    p = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    load_jax_params(p, flat_state(j))
    return j, p.eval()


@pytest.mark.parametrize('batched_cfg', [False, True])
def test_cfg_evaluation(e2tts_pair, batched_cfg):
    j, p = e2tts_pair
    rng = np.random.default_rng(9)
    x, cond = _np(rng, 2, 24, 100), _np(rng, 2, 24, 100, scale=0.3)
    times = np.array([0.3, 0.7], np.float32)
    mask = np.ones((2, 24), bool)
    mask[1, 20:] = False
    text = np.asarray(j.tokenizer(['hello there', 'ok']))
    jo = j.cfg_transformer_with_pred_head(
        jnp.asarray(x), jnp.asarray(cond), jnp.asarray(times), text=jnp.asarray(text),
        mask=jnp.asarray(mask), cfg_strength=1.0, batched_cfg=batched_cfg)
    with torch.no_grad():
        po = p.cfg_transformer_with_pred_head(
            torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(times),
            text=torch.from_numpy(text).long(), mask=torch.from_numpy(mask),
            cfg_strength=1.0, batched_cfg=batched_cfg)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **MODEL_TOL)


@pytest.mark.parametrize('variant', ['cfg_strength_0', 'no_apg', 'keep_parallel_frac',
                                     'null_model'])
def test_cfg_variants(e2tts_pair, variant):
    """The guidance options: no guidance, plain CFG without APG, APG keeping
    part of the parallel component, an autoguidance null model."""
    j, p = e2tts_pair
    rng = np.random.default_rng(12)
    x, cond = _np(rng, 1, 16, 100), _np(rng, 1, 16, 100, scale=0.3)
    times = np.array([0.4], np.float32)
    text = np.asarray(j.tokenizer(['hi there']))
    kw = dict(cfg_strength=2.0, batched_cfg=False)
    j_kw, p_kw = {}, {}
    if variant == 'cfg_strength_0':
        kw['cfg_strength'] = 0.0
    elif variant == 'no_apg':
        kw['remove_parallel_component'] = False
    elif variant == 'keep_parallel_frac':
        kw['keep_parallel_frac'] = 0.5
    else:
        jnull = perturb(JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=False,
                                 rngs=nnx.Rngs(1)), seed=13)
        jnull.eval()
        pnull = E2TTS(transformer=dict(SMALL_TF), device='cpu')
        load_jax_params(pnull, flat_state(jnull))
        j_kw['cfg_null_model'], p_kw['cfg_null_model'] = jnull, pnull.eval()
    jo = j.cfg_transformer_with_pred_head(jnp.asarray(x), jnp.asarray(cond), jnp.asarray(times),
                                          text=jnp.asarray(text), **kw, **j_kw)
    po = p.cfg_transformer_with_pred_head(torch.from_numpy(x), torch.from_numpy(cond),
                                          torch.from_numpy(times),
                                          text=torch.from_numpy(text).long(), **kw, **p_kw)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **MODEL_TOL)


@pytest.mark.parametrize('batched_cfg', [False, True])
def test_sample_matches_jax(e2tts_pair, batched_cfg):
    """steps=4 midpoint; the port's noise is JAX's own y0 draw."""
    j, p = e2tts_pair
    rng = np.random.default_rng(10)
    prompt = _np(rng, 2, 12, 100)
    texts = ['hello', 'a longer one']
    key = jax.random.key(11)
    kw = dict(text=texts, duration=24, steps=4, cfg_strength=1.0, batched_cfg=batched_cfg,
              duration_bucket=32)
    jo = j.sample(jnp.asarray(prompt), key=key, return_raw_output=True, **kw)
    noise = np.array(jax.random.normal(key, (2, 32, 100), dtype=jnp.float32))
    po = p.sample(torch.from_numpy(prompt), noise=torch.from_numpy(noise),
                  return_raw_output=True, **kw)
    assert po.shape == jo.shape == (2, 24, 100)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **MODEL_TOL)
    np.testing.assert_array_equal(po[:, :12].numpy(), prompt)      # prompt kept


def test_sample_generator_is_deterministic(e2tts_pair):
    _, p = e2tts_pair
    prompt = torch.zeros(1, 8, 100)
    run = lambda: p.sample(prompt, text=['hi'], duration=16, steps=2,
                           generator=torch.Generator().manual_seed(3))
    a, b = run(), run()
    assert a.shape == (1, 16, 100) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b)


def test_unported_paths_raise(e2tts_pair, monkeypatch):
    _, p = e2tts_pair
    with pytest.raises(ValueError, match='save_to_filename'):      # audio files need a vocoder
        p.sample(torch.zeros(1, 8, 100), text=['hi'], duration=16, save_to_filename='a.wav')
    with pytest.raises(ValueError):
        p.sample(torch.zeros(1, 8, 100), text=['hi'])                 # no duration, no predictor
    with pytest.raises(ValueError, match='more than 512'):
        p(torch.zeros(1, 512), text=['hi'])                           # wave too short to centre
    # once raised as not ported; their parity: tests/test_torch_vocos_options.py,
    # tests/test_torch_ctor_options.py and tests/test_torch_scan_*.py
    monkeypatch.setitem(sys.modules, 'vocos', None)               # the package absent
    torch_vocos = E2TTS(transformer=dict(SMALL_TF), device='cpu', use_vocos=True,
                        vocos_backend='torch')
    assert torch_vocos.use_vocos and torch_vocos.vocos_backend == 'torch'
    with pytest.raises(ImportError):                              # loads at the first decode
        torch_vocos.vocos
    stub_g2p_en(monkeypatch)
    phonemes = E2TTS(transformer=dict(SMALL_TF), device='cpu', tokenizer='phoneme_en')
    assert phonemes.embed_text.embed.weight.shape[0] == 28 + 17 + 1
    assert phonemes.tokenizer(['ab, c']).tolist() == [[5, 6, 28 + 1, 28 + 0, 7]]
    with pytest.raises(ValueError, match='depth >= 4'):
        Transformer(**SMALL_TF, device='cpu', scan_layers=True)
    assert Transformer(**dict(SMALL_TF, depth=6), device='cpu', scan_layers=True) \
        .scan_plan == [('scan', 1, 2, True), ('scan', 3, 2, False)]
    # the options ported since build (their parity: tests/test_torch_options*.py)
    dim = SMALL_TF['dim']
    assert E2TTS(transformer=dict(SMALL_TF), device='cpu', concat_cond=True) \
        .proj_in.weight.shape == (dim, 200)
    freq = E2TTS(transformer=dict(SMALL_TF), device='cpu', num_freq_tokens=2)
    assert freq.transformer.has_freq_axis and freq.proj_in.weight.shape == (2 * dim, 100)
    assert isinstance(E2TTS(transformer=dict(SMALL_TF), device='cpu', interpolated_text=True)
                      .embed_text, blocks.InterpolatedCharacterEmbed)
    assert DurationPredictor(transformer=dict(SMALL_TF), num_freq_tokens=2,
                             device='cpu').transformer.has_freq_axis
    assert Transformer(**SMALL_TF, device='cpu', remat='dots_with_no_batch_dims_saveable') \
        .remat == 'dots_with_no_batch_dims_saveable'


# -- weight bridge and entry points ------------------------------------------------

def test_bridge_is_strict(e2tts_pair):
    j, _ = e2tts_pair
    flat = flat_state(j)
    fresh = lambda: E2TTS(transformer=dict(SMALL_TF), device='cpu')
    extra = dict(flat, **{'transformer.speech_layers.0.attn.bogus.kernel': np.zeros((2, 2))})
    with pytest.raises(ValueError, match='unused'):
        load_jax_params(fresh(), extra)
    missing = {k: v for k, v in flat.items() if not k.endswith('final_norm.gamma')}
    with pytest.raises(ValueError, match='final_norm.gamma'):
        load_jax_params(fresh(), missing)
    wrong = dict(flat, **{'to_pred.kernel': np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match='shape'):
        load_jax_params(fresh(), wrong)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E2TTS(transformer=dict(SMALL_TF))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(**SMALL_TF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DurationPredictor(transformer=dict(SMALL_TF))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Vocos(dim=32, num_layers=1)


def test_port_imports_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import e2_tts_tpu_torch as pkg\n'
        'for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'from e2_tts_tpu_torch import E2TTS, Transformer, E2Trainer, EMA, Adopt\n'
        'from e2_tts_tpu_torch import DurationPredictor, MelSpec, Vocos\n'
        'import e2_tts_tpu_torch.training.trainer, e2_tts_tpu_torch.training.data\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in\n'
        '       ("jax", "jaxlib", "flax", "optax", "orbax", "e2_tts_tpu")]\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
