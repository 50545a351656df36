"""The trainer's other options and the data path against the JAX package,
on the CPU: the duration predictor's side loss and its own training step
(JAX `E2Trainer._build_dp_step`), `resample_audio` on its native and scipy
paths, `HFDataset`, the TensorBoard tag set, and the WAV writer's bytes.
Gradient accumulation and JAX checkpoints are in
tests/test_torch_trainer_stack.py.

The predictor's random prefix is JAX's draw from the step's key
(``jax.random.uniform(key, (b,))``), handed to the port as ``rand_frac``.
Tolerances: the predictor's loss 1e-5 relative, its parameters after each
step 1e-6 absolute (as tests/test_torch_training.py); resampling 1e-6; the
log-mel as tests/test_torch_mel.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from e2_tts_tpu import native as jax_native
from e2_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.parallel.mesh import make_mesh
from e2_tts_tpu.training import data as jdata
from e2_tts_tpu.training.adopt import adopt as jax_adopt
from e2_tts_tpu.training.trainer import E2Trainer as JaxE2Trainer
from e2_tts_tpu.training.trainer import linear_warmup_decay_schedule as jax_schedule
from e2_tts_tpu.utils import audio_io as jax_audio_io

from _torch_port_helpers import (SMALL_TF, assert_params_close, flat_state, flat_values,
                                 perturb_np)
from e2_tts_tpu_torch import native
from e2_tts_tpu_torch.convert import load_jax_params
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.training import data
from e2_tts_tpu_torch.training.trainer import E2Trainer
from e2_tts_tpu_torch.utils import audio_io

B, N = 2, 48
LENS = np.array([48, 37], np.int32)
LR = 1e-3
MEL_TOL = dict(atol=2e-3, rtol=1e-3)          # tests/test_torch_mel.py


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: as fast alone at these widths, and it does not
    stall when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.default_rng(0)
    return rng.standard_normal((B, N, 100)).astype(np.float32)


# -- the duration predictor in the trainer ------------------------------------------

@pytest.fixture(scope='module')
def jax_dp_run():
    """Three steps of the JAX trainer's duration-predictor step (`_build_dp_
    step`: loss without text, clip 1.0, ADOPT on the schedule) from
    perturbed weights; each step's loss (taken before its update) and the
    weights after it, and the prefix fraction each key draws."""
    jdp = perturb_np(JaxDurationPredictor(transformer=dict(SMALL_TF), rngs=nnx.Rngs(0)), seed=3)
    opt = nnx.Optimizer(jdp, optax.chain(optax.clip_by_global_norm(1.0),
                                         jax_adopt(jax_schedule(LR, 0, 100))), wrt=nnx.Param)
    step_fn = JaxE2Trainer._build_dp_step(None)
    mel = _batch()
    start = flat_state(jdp)
    steps = []
    for step in range(3):
        key = jax.random.key(200 + step)
        loss = step_fn(jdp, opt, jnp.asarray(mel), jnp.asarray(LENS), key)
        steps.append(dict(loss=float(loss), params=flat_values(nnx.state(jdp, nnx.Param)),
                          rand_frac=torch.from_numpy(np.array(jax.random.uniform(key, (B,))))))
    return dict(start=start, steps=steps, mel=mel)


def _dp_trainer(start, train_dp):
    dp = DurationPredictor(transformer=dict(SMALL_TF), device='cpu')
    load_jax_params(dp, start)
    return E2Trainer(E2TTS(transformer=dict(SMALL_TF), device='cpu'), learning_rate=LR,
                     num_warmup_steps=0, total_steps=100, duration_predictor=dp,
                     train_duration_predictor=train_dp)


def test_duration_predictor_side_loss_matches_jax(jax_dp_run):
    """Without ``train_duration_predictor`` the trainer takes the loss
    (no text) under no_grad and moves nothing."""
    trainer = _dp_trainer(jax_dp_run['start'], train_dp=False)
    assert trainer.dp_optimizer is None
    before = [t.clone() for t in trainer.duration_predictor.parameters()]
    first = jax_dp_run['steps'][0]
    loss = trainer.duration_step(jax_dp_run['mel'], LENS, rand_frac=first['rand_frac'])
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), first['loss'], rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(before, trainer.duration_predictor.parameters()))
    # drawn from the trainer's generator when not given
    state = trainer.generator.get_state()
    trainer.duration_step(jax_dp_run['mel'], LENS)
    assert not torch.equal(state, trainer.generator.get_state())


def test_trained_duration_predictor_matches_jax(jax_dp_run):
    trainer = _dp_trainer(jax_dp_run['start'], train_dp=True)
    for step, want in enumerate(jax_dp_run['steps']):
        loss = trainer.duration_step(jax_dp_run['mel'], LENS, rand_frac=want['rand_frac'])
        np.testing.assert_allclose(float(loss), want['loss'], rtol=1e-5)
        assert_params_close(want['params'], trainer.duration_predictor,
                             f'dp after step {step + 1}')
    assert all(s['step'] == 3 for s in trainer.dp_optimizer.state.values())


# -- data ------------------------------------------------------------------------------

def _wave(seconds, sr, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(int(seconds * sr))).astype(
        np.float32)


@pytest.mark.parametrize('path', ['native', 'scipy'])
def test_resample_audio_matches_jax(path, monkeypatch):
    if path == 'native':
        if native.load() is None or jax_native.load() is None:
            pytest.skip('the native library does not build here (no C++ compiler)')
    else:
        monkeypatch.setattr(native, 'resample', lambda *a: None)
        monkeypatch.setattr(jax_native, 'resample', lambda *a: None)
    for sr in (16_000, 22_050, 48_000):
        wave_in = _wave(0.4, sr)
        got = data.resample_audio(wave_in, sr, 24_000)
        want = jdata.resample_audio(wave_in, sr, 24_000)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert data.resample_audio(wave_in, 24_000, 24_000) is wave_in


class _Rows:
    """Duck-typed HF dataset (tests/test_text_and_data.py::_FakeRows)."""

    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _row(seconds, sr=24000, text='hi'):
    n = int(seconds * sr)
    return dict(audio=dict(array=np.random.default_rng(0).standard_normal(n) * 0.1,
                           sampling_rate=sr), transcript=text)


def test_hfdataset_matches_jax():
    """The rows of tests/test_text_and_data.py: too short, 1 s, too long,
    0.5 s at 48 kHz. Each index gives the JAX item (the skip to the next
    row, the resampling, the log-mel)."""
    rows = _Rows([_row(0.1), _row(1.0, text='ok'), _row(25.0),
                  _row(0.5, sr=48000, text='resampled')])
    got, want = data.HFDataset(rows, device='cpu'), jdata.HFDataset(rows)
    assert len(got) == len(want) == 4
    for i in range(4):
        a, b = got[i], want[i]
        assert a['text'] == b['text'] and a['mel_spec'].shape == b['mel_spec'].shape
        np.testing.assert_allclose(a['mel_spec'], b['mel_spec'], **MEL_TOL)
    with pytest.raises(RuntimeError, match='no sample'):
        data.HFDataset(_Rows([_row(0.1), _row(0.05)]), device='cpu')[0]


# -- logging and tracing -----------------------------------------------------------------

def _tags(log_dir) -> dict:
    """Each scalar and figure tag of the event files -> the steps it was
    logged at."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    tags = acc.Tags()
    return {**{t: [e.step for e in acc.Scalars(t)] for t in tags['scalars']},
            **{t: [e.step for e in acc.Images(t)] for t in tags['images']}}


def test_tensorboard_tags_match_jax(tmp_path, monkeypatch):
    """One epoch of each trainer with a duration predictor, two prefetch
    workers and a save within the run: the same scalar and figure tags at
    the same steps. The JAX trainer's loop runs with its two jitted steps
    and its orbax save replaced by stubs that return arrays of the right
    shapes (the tags and steps come from the loop; compiling the steps
    would cost ~25 s here)."""
    pytest.importorskip('tensorboard')
    # both trainers write through torch.utils.tensorboard, which imports
    # TensorFlow when it is installed (~12 s here); TensorBoard's own stub
    # writes the same events
    monkeypatch.setitem(sys.modules, 'tensorflow', None)

    rng = np.random.default_rng(1)
    mels = [rng.standard_normal((100, 20)).astype(np.float32) for _ in range(4)]
    kw = dict(learning_rate=LR, num_warmup_steps=0, use_tensorboard=True, log_step=1)

    jax_trainer = JaxE2Trainer(
        JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=False, rngs=nnx.Rngs(0)),
        duration_predictor=JaxDurationPredictor(transformer=dict(SMALL_TF), rngs=nnx.Rngs(1)),
        mesh=make_mesh(1), tensorboard_log_dir=str(tmp_path / 'jax_tb'), log_file=None, **kw)
    out = jnp.zeros((2, 64, 100))
    jax_trainer._train_step = lambda *args: (jnp.float32(1.0), out, out)
    jax_trainer._dp_eval_step = lambda *args: jnp.float32(0.5)
    jax_trainer.save_checkpoint = lambda *args, **kwargs: None
    jax_trainer.load_checkpoint = lambda: (0, None)
    jax_trainer.train(jdata.ArrayDataset(mels, ['ab', 'cd'] * 2), epochs=1, batch_size=2,
                      num_workers=2, save_step=2)

    trainer = E2Trainer(
        E2TTS(transformer=dict(SMALL_TF), device='cpu'),
        duration_predictor=DurationPredictor(transformer=dict(SMALL_TF), device='cpu'),
        checkpoint_path=str(tmp_path / 'ckpt'), tensorboard_log_dir=str(tmp_path / 'tb'), **kw)
    trainer.train(data.ArrayDataset(mels, ['ab', 'cd'] * 2), epochs=1, batch_size=2,
                  num_workers=2, save_step=2)

    want = _tags(tmp_path / 'jax_tb')
    assert set(want) == {'loss', 'lr', 'duration loss', 'epoch average loss',
                         'mel/target', 'mel/mask', 'mel/prediction'}
    assert want['loss'] == [0, 1] and want['mel/target'] == [2]
    assert _tags(tmp_path / 'tb') == want


# -- audio files -------------------------------------------------------------------------

def test_save_wav_bytes_match_jax(tmp_path):
    audio = np.concatenate([_wave(0.05, 24_000) * 20, [1.5, -1.5, 0.0]]).astype(np.float32)
    audio_io.save_wav(str(tmp_path / 'port.wav'), audio, 24_000)
    jax_audio_io.save_wav(str(tmp_path / 'jax.wav'), audio, 24_000)
    assert (tmp_path / 'port.wav').read_bytes() == (tmp_path / 'jax.wav').read_bytes()
    back, sr = audio_io.load_wav(str(tmp_path / 'port.wav'))
    assert sr == 24_000 and back.shape == audio.shape
    np.testing.assert_allclose(back, np.clip(audio, -1, 1), atol=1 / 32767)
