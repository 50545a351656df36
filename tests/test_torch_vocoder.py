"""The port's Vocos (vocoder/vocos.py) against the JAX package's Vocos, the
committed golden fixture and the published checkpoint's key schema, on the
CPU; and `E2TTS.sample(use_vocos=True)` against the JAX package's
``vocos_backend='jax'``.

Tolerances (all f32): the port against JAX under the same weights 1e-4 of
the largest |sample| plus 1e-4 relative (the inverse-rFFT products sum 513
terms in another order); the golden fixture 5e-3, as the JAX package holds
it (tests/test_vocoder.py); the sampler's waveforms 1e-3 of the largest
|sample| plus 1e-3 relative (the mels agree to 1e-4 and pass through the
exp of the amplitude and eight ConvNeXt blocks).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.vocoder import Vocos as JaxVocos

from _torch_port_helpers import SMALL_TF, flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params, load_jax_vocos
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.vocoder.vocos import ISTFTHead, Vocos

FIXTURES = pathlib.Path(__file__).parent / 'fixtures'
SMALL = dict(input_channels=10, dim=32, intermediate_dim=96, num_layers=2, n_fft=64,
             hop_length=16)


def _close(port, ref, rel):
    np.testing.assert_allclose(port, ref, rtol=rel, atol=rel * float(np.abs(ref).max()))


def test_vocos_matches_jax():
    j = perturb(JaxVocos(**SMALL, rngs=nnx.Rngs(0)), seed=1, scale=0.05)
    p = Vocos(**SMALL, device='cpu')
    load_jax_vocos(p, flat_state(j))
    mel = (np.random.default_rng(2).standard_normal((2, 12, 10)) * 0.5).astype(np.float32)
    with torch.no_grad():
        out = p.decode(torch.from_numpy(mel)).numpy()
    ref = np.asarray(j.decode(jnp.asarray(mel)))
    assert out.shape == ref.shape == (2, 11 * 16)
    _close(out, ref, 1e-4)


def test_vocos_golden_fixture():
    """The committed torch-mirror weights, loaded as a plain state dict."""
    data = np.load(FIXTURES / 'vocos_golden.npz')
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith('sd.')}
    p = Vocos(**SMALL, device='cpu')
    result = p.load_state_dict(sd, strict=False)
    # the fixture has no window: the port's own periodic Hann stays
    assert result.missing_keys == ['head.istft.window'] and not result.unexpected_keys
    with torch.no_grad():
        out = p.decode(torch.from_numpy(data['mel'])).numpy()
    np.testing.assert_allclose(out, data['wav'], atol=5e-3, rtol=5e-3)


def test_flagship_state_dict_has_the_checkpoint_schema():
    schema = {k: tuple(v) for k, v in json.load(open(FIXTURES / 'vocos_mel24khz_schema.json')).items()}
    p = Vocos(device='cpu')
    want = {k: v for k, v in schema.items() if not k.startswith('feature_extractor.')}
    assert {k: tuple(v.shape) for k, v in p.state_dict().items()} == want
    rng = np.random.default_rng(3)
    sd = {k: torch.from_numpy((0.05 * rng.standard_normal(s)).astype(np.float32))
          for k, s in schema.items()}
    result = p.load_state_dict(sd, strict=False)
    assert not result.missing_keys
    assert sorted(result.unexpected_keys) == sorted(set(schema) - set(want))
    with torch.no_grad():
        wav = p.decode(torch.from_numpy(rng.standard_normal((1, 6, 100)).astype(np.float32)))
    assert wav.shape == (1, 5 * 256) and torch.isfinite(wav).all()


def test_istft_head_clamps_magnitude_after_exp():
    """A log-magnitude of 500 overflows exp to inf; the clamp brings it back
    to 1e2, so the waveform stays finite."""
    head = ISTFTHead(dim=8, n_fft=64, hop_length=16)
    with torch.no_grad():
        head.out.weight.zero_()
        head.out.bias.fill_(500.0)
        wav = head(torch.ones(1, 9, 8))
    assert torch.isfinite(wav).all() and float(wav.abs().max()) < 1e5


def test_sample_with_vocos_matches_jax():
    j = perturb(JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=True, vocos_backend='jax',
                         rngs=nnx.Rngs(0)), seed=4)
    j.eval()
    p = E2TTS(transformer=dict(SMALL_TF), use_vocos=True, device='cpu')
    load_jax_params(p, flat_state(j))
    load_jax_vocos(p.vocos, flat_state(j.vocos))
    p.eval()
    rng = np.random.default_rng(5)
    prompt = rng.standard_normal((2, 10, 100)).astype(np.float32)
    key = jax.random.key(6)
    noise = np.array(jax.random.normal(key, (2, 32, 100), dtype=jnp.float32))
    kw = dict(text=['hello', 'a longer one'], duration=torch.tensor([24, 19]), steps=2,
              duration_bucket=32)
    ref = j.sample(jnp.asarray(prompt), key=key, **dict(kw, duration=jnp.asarray([24, 19])))
    out = p.sample(torch.from_numpy(prompt), noise=torch.from_numpy(noise), **kw)
    assert [tuple(w.shape) for w in out] == [tuple(w.shape) for w in ref] == [(23 * 256,),
                                                                              (18 * 256,)]
    for w, r in zip(out, ref):
        _close(w.numpy(), np.asarray(r), 1e-3)
