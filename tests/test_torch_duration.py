"""The port's duration predictor, HL-Gauss head and raw-wave paths of
`E2TTS` against the JAX package on the CPU, under the same weights through
`load_jax_params`.

The JAX modules are built with their own initialisation, perturbed by
seeded noise, and copied into the port. The predictor's random prefix is
drawn from the JAX key (``jax.random.uniform(key, (b,))``) and handed to the
port as ``rand_frac``; the sampler's initial noise is JAX's own draw, handed
over as ``noise``; the flow-matching draws of a raw-wave loss are made from
the JAX key as `E2TTS.forward` splits it.

Tolerances (all f32): the HL-Gauss head, the predictor's prediction and
loss 1e-5 relative (summation order only); the predictor's grads, as one
vector, 1e-5 relative in L2, and each tensor 1e-4 relative plus 1e-4 of its
largest |grad| (the hyper-connections' scalar scales have grads that sum
some 10^4 products of both signs: the worst lands near 6e-5); the sampler's output and
a raw-wave loss 1e-4, as the sampler in tests/test_torch_models.py (the
mel frontend adds a 1e-6 difference to inputs of order 1). A predicted
duration is compared as a float; its integer part only where the float is
more than 1e-3 from an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.models.hl_gauss import HLGaussLayer as JaxHLGaussLayer
from e2_tts_tpu.utils.helpers import round_up_to_multiple
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_port_helpers import SMALL_TF, flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.models.hl_gauss import HLGaussLayer

REL = 1e-5
GRAD_REL = 1e-4
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
HL_GAUSS = dict(min_value=0.0, max_value=64.0, num_bins=16)
DP_CFG = dict(transformer=dict(SMALL_TF), hl_gauss_loss=HL_GAUSS, use_regression=False)
TEXTS = ['hello there', 'ok']
# one sequence shape everywhere (mels of 20 frames, waves of 5000 samples =
# 20 frames): the JAX side compiles each eager op once per shape
N, WAVE = 20, 5000
LENS = np.array([20, 13], np.int32)


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _rel_close(port, ref, rel=REL):
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(ref, np.float64),
                               rtol=rel, atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize('use_regression', [True, False], ids=['regression', 'classification'])
def test_hl_gauss_layer(use_regression):
    rng = np.random.default_rng(0)
    j = perturb(JaxHLGaussLayer(32, hl_gauss_loss=HL_GAUSS, use_regression=use_regression,
                                rngs=nnx.Rngs(0)), seed=1, scale=0.3)
    p = HLGaussLayer(32, hl_gauss_loss=HL_GAUSS, use_regression=use_regression)
    load_jax_params(p, flat_state(j))
    embed = _np(rng, 4, 32)
    target = np.array([3.0, 17.5, 40.0, 63.0], np.float32)
    with torch.no_grad():
        pred = p(torch.from_numpy(embed))
        loss = p(torch.from_numpy(embed), torch.from_numpy(target))
    _rel_close(pred.numpy(), j(jnp.asarray(embed)))
    _rel_close(loss.numpy(), j(jnp.asarray(embed), jnp.asarray(target)))


# the JAX side jitted: compiling the whole predictor once is several times
# cheaper on the CPU than compiling its eager ops one by one
@nnx.jit
def _jax_predict(model, x, text, lens):
    return model(x, text=text, lens=lens, return_loss=False)


@nnx.jit
def _jax_loss_and_grads(model, x, text, lens, key):
    return nnx.value_and_grad(lambda m: m(x, text=text, lens=lens, key=key))(model)


@pytest.fixture(scope='module')
def predictors():
    j = perturb(JaxDurationPredictor(**DP_CFG, rngs=nnx.Rngs(0)), seed=2)
    p = DurationPredictor(**DP_CFG, device='cpu')
    load_jax_params(p, flat_state(j))
    return j, p


@pytest.mark.parametrize('inp', ['mel', 'wave'])
def test_duration_predictor_prediction(predictors, inp):
    j, p = predictors
    j.eval()
    p.eval()
    rng = np.random.default_rng(3)
    x = _np(rng, 2, N, 100) if inp == 'mel' else _np(rng, 2, WAVE, scale=0.3)
    lens = LENS
    text = np.asarray(j.tokenizer(TEXTS))
    ref = _jax_predict(j, jnp.asarray(x), jnp.asarray(text), jnp.asarray(lens))
    with torch.no_grad():
        out = p(torch.from_numpy(x), text=TEXTS, lens=torch.from_numpy(lens).long(),
                return_loss=False)
    assert out.shape == (2,)
    _rel_close(out.numpy(), ref)


def test_duration_predictor_loss_and_grads(predictors):
    j, p = predictors
    j.train()
    p.train()
    rng = np.random.default_rng(4)
    x, lens = _np(rng, 2, N, 100), LENS
    text = np.asarray(j.tokenizer(TEXTS))
    key = jax.random.key(5)
    rand_frac = np.array(jax.random.uniform(key, (2,)))

    jloss, jgrads = _jax_loss_and_grads(j, jnp.asarray(x), jnp.asarray(text),
                                        jnp.asarray(lens), key)

    p.zero_grad(set_to_none=True)
    loss = p(torch.from_numpy(x), text=TEXTS, lens=torch.from_numpy(lens).long(),
             rand_frac=torch.from_numpy(rand_frac))
    loss.backward()
    _rel_close(loss.detach().numpy(), jloss)

    flat = {'.'.join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.to_flat_state(jgrads)}
    ref = map_jax_tree(flat, {n: tuple(t.shape) for n, t in p.named_parameters()})
    port_vec, ref_vec = [], []
    for name, t in p.named_parameters():
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        _rel_close(grad.numpy(), ref[name], rel=GRAD_REL)
        port_vec.append(grad.numpy().ravel())
        ref_vec.append(ref[name].ravel())
    port_vec, ref_vec = np.concatenate(port_vec), np.concatenate(ref_vec)
    assert np.linalg.norm(port_vec - ref_vec) <= REL * np.linalg.norm(ref_vec)


@pytest.fixture(scope='module')
def e2tts_pair():
    j = perturb(JaxE2TTS(transformer=dict(SMALL_TF), duration_predictor=dict(DP_CFG),
                         use_vocos=False, rngs=nnx.Rngs(0)), seed=6)
    j.eval()
    p = E2TTS(transformer=dict(SMALL_TF), duration_predictor=dict(DP_CFG), device='cpu')
    load_jax_params(p, flat_state(j))
    return j, p.eval()


def test_sample_without_duration_from_a_wave(e2tts_pair):
    """A raw-wave prompt and no duration: both sides run the mel frontend,
    ask their predictor, then sample (2 steps)."""
    j, p = e2tts_pair
    rng = np.random.default_rng(7)
    cond = _np(rng, 2, WAVE, scale=0.3)
    text = np.asarray(j.tokenizer(TEXTS))
    jmel = j._as_mel(jnp.asarray(cond))
    lens = jnp.maximum((jnp.asarray(text) != -1).sum(-1), jmel.shape[1])
    assert jmel.shape == (2, N, 100)
    jdur = np.asarray(j.duration_predictor(jmel, text=jnp.asarray(text), lens=lens,
                                           return_loss=False))
    with torch.no_grad():
        pdur = p.duration_predictor(p._as_mel(torch.from_numpy(cond)), text=TEXTS,
                                    lens=torch.tensor(np.asarray(lens)).long(),
                                    return_loss=False)
    _rel_close(pdur.numpy(), jdur)
    near = np.abs(jdur - np.round(jdur)) <= 1e-3
    np.testing.assert_array_equal(pdur.long().numpy()[~near], jdur.astype(np.int32)[~near])

    duration = np.maximum(np.asarray(lens) + 1, jdur.astype(np.int32))
    padded = round_up_to_multiple(int(duration.max()), 32)
    key = jax.random.key(8)
    noise = np.array(jax.random.normal(key, (2, padded, 100), dtype=jnp.float32))
    kw = dict(text=TEXTS, steps=2, cfg_strength=1.0, duration_bucket=32)
    jo = j.sample(jnp.asarray(cond), key=key, return_raw_output=True, **kw)
    po = p.sample(torch.from_numpy(cond), noise=torch.from_numpy(noise),
                  return_raw_output=True, **kw)
    assert po.shape == jo.shape == (2, int(duration.max()), 100)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **MODEL_TOL)


def test_raw_wave_loss(e2tts_pair):
    """`E2TTS.forward` on a raw-wave batch with the JAX key's draws."""
    j, p = e2tts_pair
    rng = np.random.default_rng(9)
    wave = _np(rng, 2, WAVE, scale=0.3)
    b, n = 2, N
    lens = jnp.asarray(LENS)
    key = jax.random.key(10)
    k_frac, k_span, k_x0, k_time = jax.random.split(key, 4)
    frac = jax.random.uniform(k_frac, (b,), minval=0.7, maxval=1.0)
    span = jax_span_mask(k_span, lens, frac, n) & jax_lens_to_mask(lens, length=n)
    x0 = jax.random.normal(k_x0, (b, n, 100), dtype=jnp.float32)
    times = jax.random.uniform(k_time, (b,), dtype=jnp.float32)
    text = np.asarray(j.tokenizer(TEXTS))
    ref = j(jnp.asarray(wave), text=jnp.asarray(text), lens=lens, key=key, drop_text_cond=False)
    with torch.no_grad():
        out = p(torch.from_numpy(wave), text=TEXTS, lens=torch.from_numpy(LENS).long(),
                times=torch.from_numpy(np.array(times)), noise=torch.from_numpy(np.array(x0)),
                rand_span_mask=torch.from_numpy(np.array(span)), drop_text_cond=False)
    np.testing.assert_allclose(out.loss.numpy(), np.asarray(ref.loss), **MODEL_TOL)
    np.testing.assert_allclose(out.cond.numpy(), np.asarray(ref.cond), **MODEL_TOL)
