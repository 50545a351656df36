"""The port's own training stack on the CPU, without JAX: checkpoints
(round trip and resume, held bit for bit), `train`'s auto-resume and saves,
`prefetch` and ``num_workers``, the profiler window, the duration
predictor's compute dtype, and `E2TTS.sample(save_to_filename=)`. The
parity of each piece with the JAX package is in
tests/test_torch_trainer_stack.py; these tests import no JAX, so they run
beside it.

Every trainer here carries every piece of state a checkpoint holds: dropout
0.1 (the generator's draws matter), the velocity teacher (the EMA's
``initted`` matters), EMA blending from the first step (its ``step``
matters), a trained duration predictor and, with k = 2, gradient
accumulation saved mid-accumulation.
"""

import json
import os
import wave

import numpy as np
import pytest
import torch

from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.training import checkpointing, data
from e2_tts_tpu_torch.training.trainer import E2Trainer
from e2_tts_tpu_torch.utils import audio_io

# tests/_torch_port_helpers.py::SMALL_TF (that module imports JAX)
SMALL_TF = dict(dim=128, depth=2, heads=4, dim_head=32, num_registers=4,
                max_seq_len=256, kernel_size=7, dropout=0.0)
TINY = dict(dim=32, depth=2, heads=2, dim_head=16, num_registers=2, max_seq_len=64,
            kernel_size=3, dropout=0.0)
LR = 1e-3
EMA_KW = dict(update_after_step=0, update_every=1)
TEXTS = ['hello there', 'ok']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: as fast alone at these widths, and it does not
    stall when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_trainer(**kw):
    p = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    return E2Trainer(p, learning_rate=LR, num_warmup_steps=0, total_steps=100,
                     ema_kwargs=EMA_KW, **kw)


def test_dtype_sets_the_duration_predictor_compute_dtype():
    dp = DurationPredictor(transformer=dict(SMALL_TF), device='cpu')
    _port_trainer(duration_predictor=dp, dtype=torch.bfloat16)
    assert dp.proj_in.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in dp.parameters())



# -- the port's checkpoints: round trip and resume -----------------------------------

def _toy_dataset(n):
    rng = np.random.default_rng(6)
    mels = [(0.3 * rng.standard_normal((100, 40 - 3 * (i % 3)))).astype(np.float32)
            for i in range(n)]
    return data.ArrayDataset(mels, ['hello world', 'ok'] * (n // 2))


def _full_trainer(path, k=1, seed=1):
    """Dropout 0.1, the velocity teacher, a trained duration predictor and
    accumulation: every piece of state a checkpoint carries is live. The
    weights come from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    p = E2TTS(transformer=dict(SMALL_TF, dropout=0.1), velocity_consistency_weight=0.1,
              generator=gen, device='cpu')
    dp = DurationPredictor(transformer=dict(SMALL_TF, dropout=0.1), generator=gen,
                           device='cpu')
    return E2Trainer(p, duration_predictor=dp, train_duration_predictor=True,
                     grad_accumulation_steps=k, learning_rate=LR, num_warmup_steps=0,
                     total_steps=100, ema_kwargs=EMA_KW, checkpoint_path=str(path), seed=4)


def _state_diff(a, b) -> list[str]:
    """Names of every tensor or counter of the two trainers that is not
    bit-equal: model and EMA weights and counters, ADOPT's state, the
    predictor and its optimizer, the accumulator, the generator."""
    diff = []

    def tensors(label, x, y):
        if x.keys() != y.keys():
            diff.append(f'{label} keys')
        diff.extend(f'{label} {n}' for n in x if n in y and not torch.equal(x[n], y[n]))

    def opt_state(label, oa, ob):
        sa, sb = oa.state_dict()['state'], ob.state_dict()['state']
        if sa.keys() != sb.keys():
            diff.append(f'{label} keys')
        for i in sa.keys() & sb.keys():
            if sa[i]['step'] != sb[i]['step']:
                diff.append(f'{label} {i} step')
            tensors(f'{label} {i}', {'m': sa[i]['m'], 'v': sa[i]['v']},
                    {'m': sb[i]['m'], 'v': sb[i]['v']})

    tensors('model', a.model.state_dict(), b.model.state_dict())
    tensors('ema', a.ema.ema_model.state_dict(), b.ema.ema_model.state_dict())
    if (a.ema.step, a.ema.initted) != (b.ema.step, b.ema.initted):
        diff.append('ema counters')
    opt_state('opt', a.optimizer, b.optimizer)
    tensors('dp', a.duration_predictor.state_dict(), b.duration_predictor.state_dict())
    opt_state('dp_opt', a.dp_optimizer, b.dp_optimizer)
    assert (a.accumulator is None) == (b.accumulator is None)
    if a.accumulator is not None:
        if a.accumulator.mini_step != b.accumulator.mini_step:
            diff.append('accumulator mini_step')
        tensors('accumulator', dict(enumerate(a.accumulator.grads)),
                dict(enumerate(b.accumulator.grads)))
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        diff.append('generator')
    return diff


@pytest.mark.parametrize('k', [1, 2])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, k):
    """`train` saves at ``save_step`` (here the third micro-step: with k = 2
    mid-accumulation); a trainer built from other weights restores every
    tensor and counter bit for bit, and `resume` sets its generator to the
    saved state."""
    a = _full_trainer(tmp_path / 'ckpt', k)
    history = a.train(_toy_dataset(12), epochs=1, batch_size=4, save_step=3)
    assert [s for s, _ in history] == [0, 1, 2]
    assert os.listdir(tmp_path / 'ckpt') == [checkpointing.CHECKPOINT_FILE]
    b = _full_trainer(tmp_path / 'ckpt', k, seed=2)
    assert _state_diff(a, b)
    assert b.resume() == 3
    assert _state_diff(a, b) == []


def test_load_checkpoint_without_one(tmp_path):
    """A missing or empty directory is no checkpoint; a directory with other
    files raises."""
    model = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    assert checkpointing.load_checkpoint(str(tmp_path / 'none'), model=model) == (0, None)
    os.makedirs(tmp_path / 'empty')
    assert checkpointing.load_checkpoint(str(tmp_path / 'empty'), model=model) == (0, None)
    (tmp_path / 'empty' / 'other.bin').write_bytes(b'x')
    with pytest.raises(FileNotFoundError, match='holds no'):
        checkpointing.load_checkpoint(str(tmp_path / 'empty'), model=model)
    trainer = _port_trainer(checkpoint_path=str(tmp_path / 'none'), seed=7)
    trainer.generator.manual_seed(123)
    assert trainer.resume() == 0
    assert torch.equal(trainer.generator.get_state(),
                       torch.Generator().manual_seed(7).get_state())


def _edit_checkpoint(path, edit):
    target = os.path.join(path, checkpointing.CHECKPOINT_FILE)
    payload = torch.load(target, weights_only=True)
    edit(payload)
    torch.save(payload, target)


def _drop_adopt(payload):
    payload['opt']['state'] = {}


def _drop_ema_counters(payload):
    payload['ema'].update(step=0, initted=False)


@pytest.mark.parametrize('k', [1, 2])
def test_resume_then_step_equals_continue_then_step(tmp_path, k):
    """One trainer trains to its checkpoint and takes one more step (the
    predictor's and the model's); a fresh trainer resumes from the
    checkpoint and takes the same step: every tensor and counter bit-equal
    on the CPU. The same check fails, in the model's parameters, when the
    checkpoint lacks ADOPT's state or the EMA's counters. With k = 2 the
    checkpoint is mid-accumulation and the step completes an update."""
    n_steps = 2 if k == 1 else 3
    a = _full_trainer(tmp_path / 'ckpt', k)
    a.train(_toy_dataset(4 * n_steps), epochs=1, batch_size=4, save_step=n_steps)
    batch = a.prepare_batch(next(data.iter_batches(_toy_dataset(8), 4, seed=9)))

    def one_more_step(trainer):
        trainer.duration_step(*batch[:2])
        trainer.train_step(*batch, drop_text_cond=False)

    target = tmp_path / 'ckpt' / checkpointing.CHECKPOINT_FILE
    saved = target.read_bytes()
    one_more_step(a)
    b = _full_trainer(tmp_path / 'ckpt', k, seed=2)
    assert b.resume() == n_steps
    one_more_step(b)
    assert _state_diff(a, b) == []

    for fault in (_drop_adopt, _drop_ema_counters):
        target.write_bytes(saved)
        _edit_checkpoint(tmp_path / 'ckpt', fault)
        c = _full_trainer(tmp_path / 'ckpt', k, seed=2)
        c.resume()
        one_more_step(c)
        assert any(name.startswith('model ') for name in _state_diff(a, c)), fault.__name__


def test_trainer_resumes_in_train_and_saves_atomically(tmp_path):
    """`train` on a directory with a checkpoint starts from its step (the
    epoch loop from epoch 0, as in JAX) and each save replaces the file."""
    a = _full_trainer(tmp_path / 'ckpt')
    a.train(_toy_dataset(8), epochs=1, batch_size=4, save_step=2)
    b = _full_trainer(tmp_path / 'ckpt', seed=2)
    history = b.train(_toy_dataset(8), epochs=1, batch_size=4, save_step=2)
    assert [s for s, _ in history] == [2, 3]
    assert os.listdir(tmp_path / 'ckpt') == [checkpointing.CHECKPOINT_FILE]
    step, _ = checkpointing.load_checkpoint(str(tmp_path / 'ckpt'), model=b.model)
    assert step == 4



def test_prefetch_keeps_order_and_raises_the_producers_error():
    assert list(data.prefetch(iter(range(50)), size=3)) == list(range(50))
    assert list(data.prefetch(iter([]))) == []

    def failing():
        yield 1
        yield 2
        raise KeyError('row 3')

    got = []
    with pytest.raises(KeyError, match='row 3'):
        for item in data.prefetch(failing()):
            got.append(item)
    assert got == [1, 2]


def test_train_with_workers_matches_train_without(tmp_path):
    """``num_workers > 0`` prefetches the same batches: equal losses."""
    histories = []
    for workers in (0, 2):
        trainer = _full_trainer(tmp_path / f'ckpt{workers}')
        histories.append(trainer.train(_toy_dataset(8), epochs=1, batch_size=4,
                                       num_workers=workers, save_step=100))
    assert histories[0] == histories[1] and len(histories[0]) == 2



def test_profiler_window_writes_a_trace(tmp_path):
    trainer = E2Trainer(E2TTS(transformer=dict(TINY), device='cpu'), learning_rate=LR,
                        checkpoint_path=str(tmp_path / 'ckpt'),
                        profile_dir=str(tmp_path / 'prof'), profile_steps=(1, 2))
    rng = np.random.default_rng(2)
    mels = [rng.standard_normal((100, 20)).astype(np.float32) for _ in range(6)]
    trainer.train(data.ArrayDataset(mels, ['ab'] * 6), epochs=1, batch_size=2, save_step=100)
    files = os.listdir(tmp_path / 'prof')
    assert files == ['steps_1-2.trace.json']
    with open(tmp_path / 'prof' / files[0]) as f:
        events = json.load(f)['traceEvents']
    assert any('aten::' in e.get('name', '') for e in events)




def test_sample_save_to_filename_writes_one_file_per_sample(tmp_path):
    model = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    prompt = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 100))
                              .astype(np.float32))
    vocoder = lambda mel: 0.1 * torch.tanh(mel.mean(dim=1))     # (b, d, n) -> (b, n)
    target = tmp_path / 'out' / 'x.wav'
    out = model.sample(prompt, text=TEXTS, duration=24, steps=2, vocoder=vocoder,
                       save_to_filename=str(target), generator=torch.Generator().manual_seed(0))
    assert sorted(os.listdir(tmp_path / 'out')) == ['1.x.wav', '2.x.wav']
    for i in range(2):
        with wave.open(str(tmp_path / 'out' / f'{i + 1}.x.wav'), 'rb') as f:
            assert (f.getnchannels(), f.getsampwidth(), f.getframerate()) == (1, 2, 24_000)
        back, _ = audio_io.load_wav(str(tmp_path / 'out' / f'{i + 1}.x.wav'))
        np.testing.assert_allclose(back, out[i].numpy(), atol=1 / 32767)
    with pytest.raises(ValueError, match='save_to_filename'):
        model.sample(prompt, text=TEXTS, duration=24, steps=2, save_to_filename=str(target))
