"""An `E2TTS` whose backbone is built with ``scan_layers`` (depth 6): the CFG
evaluation in both modes against the JAX package's, and the port's scan
sampler against its unrolled one; a duration predictor whose backbone is
built with it (no time condition) against JAX's through
`load_jax_params`. The training state is held in
tests/test_torch_scan_train_state.py.

The JAX package's `E2TTS.sample` fails on a scan model on the CPU (a trace
level error from the RNG counts, as with ``remat``), so the sampler is held
against the port's unrolled model with the same weights: bit for bit, the
same CPU ops in the same order. Attention on XLA and no dropout (the
dropout path: tests/test_torch_scan_dropout.py).

Tolerances (f32): the CFG evaluation 1e-4 (tests/_torch_options_helpers.py);
the predictor's estimate 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS

from _torch_options_helpers import _jax_cfg_both
from _torch_port_helpers import SMALL_TF, flat_state, perturb_np
from _torch_scan_helpers import one_torch_thread
from e2_tts_tpu_torch.convert import load_jax_params, scan_plans
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.e2tts import E2TTS

settings = pytest.fixture(scope='module', autouse=True)(one_torch_thread)

TF = dict(SMALL_TF, depth=6, scan_layers=True)
B, N = 2, 24
TEXTS = ['hello there', 'ok']


@pytest.fixture(scope='module')
def jax_model():
    j = perturb_np(JaxE2TTS(transformer=dict(TF, attn_backend='xla'), use_vocos=False,
                            rngs=nnx.Rngs(0)), seed=51)
    return j, nnx.state(j)


@pytest.mark.parametrize('batched_cfg', [False, True])
def test_scan_cfg_evaluation_matches_jax(jax_model, batched_cfg):
    j, start = jax_model
    nnx.update(j, start)
    j.eval()
    p = E2TTS(transformer=dict(TF), device='cpu', use_vocos=False).eval()
    load_jax_params(p, flat_state(j))
    rng = np.random.default_rng(52)
    x = rng.standard_normal((B, N, 100)).astype(np.float32)
    cond = (0.3 * rng.standard_normal((B, N, 100))).astype(np.float32)
    times = np.array([0.3, 0.7], np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 19:] = False
    text = np.asarray(j.tokenizer(TEXTS))
    want = _jax_cfg_both(j, *map(jnp.asarray, (x, cond, times, text, mask)))[int(batched_cfg)]
    with torch.no_grad():
        got = p.cfg_transformer_with_pred_head(
            *map(torch.from_numpy, (x, cond, times)), text=torch.from_numpy(text).long(),
            mask=torch.from_numpy(mask), cfg_strength=1.0, batched_cfg=batched_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_scan_sample_equals_unrolled(jax_model):
    """The port's sampler on the scan model is its unrolled model's, bit
    for bit, with the same weights (the state dict's names are the same)."""
    j, start = jax_model
    nnx.update(j, start)
    scan = E2TTS(transformer=dict(TF), device='cpu', use_vocos=False).eval()
    load_jax_params(scan, flat_state(j))
    unrolled = E2TTS(transformer=dict(TF, scan_layers=False), device='cpu',
                     use_vocos=False).eval()
    unrolled.load_state_dict(scan.state_dict())
    prompt = torch.from_numpy(np.random.default_rng(53).standard_normal((B, 8, 100))
                              .astype(np.float32))
    outs = [m.sample(prompt, text=TEXTS, duration=20, steps=4,
                     generator=torch.Generator().manual_seed(54)) for m in (scan, unrolled)]
    assert torch.equal(*outs)


def test_scan_duration_predictor_matches_jax():
    """A duration predictor whose backbone is built with ``scan_layers``
    (depth 6, text depth 3) carries the JAX predictor's stacked state, and
    its estimate is JAX's."""
    tf = dict(SMALL_TF, depth=6, text_depth=3, scan_layers=True)
    j = perturb_np(JaxDurationPredictor(transformer=dict(tf, attn_backend='xla'),
                                        rngs=nnx.Rngs(0)), seed=31)
    j.eval()
    p = DurationPredictor(transformer=dict(tf), device='cpu').eval()
    assert scan_plans(p) == {'transformer.': (6, j.transformer.scan_plan)}
    load_jax_params(p, flat_state(j))
    rng = np.random.default_rng(32)
    mel = rng.standard_normal((2, 24, 100)).astype(np.float32)
    lens = np.array([24, 15], np.int32)
    text = np.asarray(j.tokenizer(['hello there', 'ok']))
    want = j(jnp.asarray(mel), text=jnp.asarray(text), lens=jnp.asarray(lens),
             return_loss=False)
    with torch.no_grad():
        got = p(torch.from_numpy(mel), text=torch.from_numpy(text).long(),
                lens=torch.from_numpy(lens).long(), return_loss=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
