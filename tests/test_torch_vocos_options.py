"""The vocoder options of `E2TTS` against the JAX package on the CPU:
`Vocos.load_torch_state_dict` (the published checkpoint's names and
shapes, tests/fixtures/vocos_mel24khz_schema.json, filled with seeded
random tensors), ``vocos_weights`` as a dict and as a path,
``use_vocos=None`` (on iff the torch ``vocos`` package imports), and
``vocos_backend='torch'``, which decodes each sample on the host through
the external package: here a stand-in ``vocos`` module in ``sys.modules``
(monkeypatched; the package is not installed here), through which both
packages decode; without the package both raise ImportError at the first
decode.

Tolerances (f32): the two Vocos loads decoding one mel, 1e-4 of the
largest |sample| plus 1e-4 relative (tests/test_torch_vocoder.py); the
stand-in's decodes 1e-6 (the same host arithmetic on mels that agree to
that).
"""

import importlib.machinery
import json
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.vocoder import Vocos as JaxVocos

from _torch_port_helpers import SMALL_TF
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.vocoder.vocos import Vocos

SCHEMA = pathlib.Path(__file__).parent / 'fixtures' / 'vocos_mel24khz_schema.json'
TF = dict(SMALL_TF)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def state_dict():
    """The published checkpoint's keys and shapes, seeded random values
    (0.02 N(0, 1); the layer scales and norms near their inits)."""
    rng = np.random.default_rng(80)
    shapes = json.loads(SCHEMA.read_text())
    sd = {}
    for key, shape in shapes.items():
        value = 0.02 * rng.standard_normal(shape)
        if key.endswith(('norm.weight', 'gamma')):
            value += 1.0 if 'norm' in key else 0.125
        sd[key] = torch.from_numpy(value.astype(np.float32))
    return sd


def _mel(n=16, b=2):
    return (0.5 * np.random.default_rng(81).standard_normal((b, n, 100))).astype(np.float32)


def test_vocos_torch_state_dict_matches_jax(state_dict):
    """Both loaders take the checkpoint (its ``feature_extractor.*`` mel
    buffers ignored) and decode one mel alike."""
    j = JaxVocos(rngs=nnx.Rngs(0)).load_torch_state_dict(state_dict)
    p = Vocos(device='cpu').load_torch_state_dict(state_dict)
    for key, value in p.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state_dict[key].numpy(), err_msg=key)
    mel = _mel()
    with torch.no_grad():
        got = p.decode(torch.from_numpy(mel)).numpy()
    want = np.asarray(j.decode(jnp.asarray(mel)))
    assert got.shape == want.shape == (2, 15 * 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_vocos_torch_state_dict_errors_match_jax(state_dict):
    """A missing key raises KeyError, a tensor of another shape (an
    untransposed conv) ValueError, on both; the window may be absent."""
    missing = {k: v for k, v in state_dict.items() if k != 'backbone.convnext.3.gamma'}
    bad = dict(state_dict, **{'backbone.embed.weight':
                              state_dict['backbone.embed.weight'].transpose(0, 2)})
    no_window = {k: v for k, v in state_dict.items() if k != 'head.istft.window'}
    for load in (lambda sd: JaxVocos(rngs=nnx.Rngs(0)).load_torch_state_dict(sd),
                 lambda sd: Vocos(device='cpu').load_torch_state_dict(sd)):
        with pytest.raises(KeyError):
            load(missing)
        with pytest.raises(ValueError):
            load(bad)
        load(no_window)


@pytest.mark.parametrize('as_path', [False, True], ids=['dict', 'path'])
def test_vocos_weights_load(state_dict, tmp_path, as_path):
    """``vocos_weights``, the state dict or the path of a ``torch.save``d
    one, loads into the on-device Vocos, which stays out of the model's
    parameters."""
    weights = state_dict
    if as_path:
        weights = str(tmp_path / 'pytorch_model.bin')
        torch.save(state_dict, weights)
    model = E2TTS(transformer=dict(TF), device='cpu', use_vocos=True, vocos_weights=weights)
    for key, value in model.vocos.state_dict().items():
        assert torch.equal(value, state_dict[key]), key
    assert not any(name.startswith('_vocos') for name in model.state_dict())


class _StubVocos:
    """The stand-in torch ``vocos.Vocos``: ``decode`` maps ``(1, 100, n)``
    to ``(1, 4 n)`` by a fixed host computation."""
    loaded = []

    @classmethod
    def from_pretrained(cls, path):
        cls.loaded.append(path)
        return cls()

    def decode(self, mel):
        assert mel.shape[0] == 1 and mel.shape[1] == 100
        return torch.tanh(mel[0].mean(0) - 1.0).repeat_interleave(4)[None]


def _install_stub(monkeypatch):
    module = types.ModuleType('vocos')
    module.__spec__ = importlib.machinery.ModuleSpec('vocos', None)   # as an installed one
    module.Vocos = _StubVocos
    monkeypatch.setitem(sys.modules, 'vocos', module)
    _StubVocos.loaded.clear()


def test_torch_backend_decodes_like_jax(monkeypatch):
    """Both packages load ``pretrained_vocos_path`` at the first decode and
    decode each sample's own frames on the host (``db_to_amplitude``
    first): the same lengths and waveforms."""
    _install_stub(monkeypatch)
    kw = dict(use_vocos=True, vocos_backend='torch', pretrained_vocos_path='some/vocos')
    j = JaxE2TTS(transformer=dict(TF, attn_backend='xla'), rngs=nnx.Rngs(0), **kw)
    p = E2TTS(transformer=dict(TF), device='cpu', **kw)
    assert not _StubVocos.loaded
    mels = _mel(n=12)
    mask = np.ones((2, 12), bool)
    mask[1, 7:] = False
    want = j._vocos_decode(jnp.asarray(mels), jnp.asarray(mask))
    got = p._vocos_decode(torch.from_numpy(mels), torch.from_numpy(mask))
    assert _StubVocos.loaded == ['some/vocos', 'some/vocos']
    assert [len(w) for w in got] == [len(w) for w in want] == [48, 28]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    out = p.sample(torch.from_numpy(mels[:, :4]), text=['hi', 'ok'], duration=8, steps=2)
    assert [len(w) for w in out] == [32, 32]


def test_auto_and_absent_vocos_match_jax(monkeypatch):
    """``use_vocos=None`` turns the vocoder on iff the package imports (the
    port then builds its own on-device Vocos, its default backend); with
    the package absent, the torch backend raises ImportError at its first
    decode on both sides."""
    build = lambda pkg, **kw: (JaxE2TTS(transformer=dict(TF, attn_backend='xla'),
                                        rngs=nnx.Rngs(0), **kw) if pkg == 'jax'
                               else E2TTS(transformer=dict(TF), device='cpu', **kw))
    monkeypatch.setitem(sys.modules, 'vocos', None)
    assert not build('jax').use_vocos and not build('port').use_vocos
    for pkg in ('jax', 'port'):
        with pytest.raises(ImportError):
            build(pkg, use_vocos=True, vocos_backend='torch').vocos
    _install_stub(monkeypatch)
    assert build('jax').use_vocos
    port = build('port')
    assert port.use_vocos and isinstance(port.vocos, Vocos) and not _StubVocos.loaded
