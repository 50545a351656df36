"""The port's two-rank data-parallel steps against its own single device,
with dropout, on the CPU; the dropout bits by global batch row in the plain
kernels; checkpoints across world sizes.

Two gloo ranks (tests/_torch_parallel_worker.py, one spawn for the file)
train SMALL_TF widths with dropout 0.1 and a text stream of 4 heads x 16
(the speech attention on K1's plain version, the text attention on K8's)
through `E2Trainer.train_step` on a global batch of 4 ragged rows, whose
span counts differ by rank, beside a trained duration predictor
(`duration_step` before each step); the draws and the dropout seeds come
from the trainers' generators. The single-device trainer runs the same steps here.
A run matches when each of its losses is within 1e-6 of the single
device's (relative) and its parameters after the steps within 1e-6
relative L2 (f32 sums in other orders: ~1e-7). Two planted faults must fail that: every rank at batch offset 0
(its draws and dropout bits are then the first rows'), and each rank's loss
its own span's mean (the per-rank mean DDP would give).
"""

import numpy as np
import pytest
import torch

from _torch_parallel_worker import Ranks, build_model, build_predictor, full_state, \
    make_trainer, run_steps, run_train, write_steps
from _torch_port_helpers import SMALL_TF
from e2_tts_tpu_torch.ops.dropout import fold_batch_offset, hash_keep
from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.ops.geglu_kernel import geglu_dropout_backward_plain, geglu_dropout_plain
from e2_tts_tpu_torch.parallel import mesh as mesh_module
from e2_tts_tpu_torch.parallel.multihost import maybe_initialize_distributed
from e2_tts_tpu_torch.text.tokenizer import resolve_tokenizer
from e2_tts_tpu_torch.training import trainer as trainer_module

CONFIG = dict(SMALL_TF, dropout=0.1, text_dim_head=16)
B, N = 4, 40
LENS = np.array([40, 17, 33, 26], np.int64)
TEXTS = ['hello there', 'ok', 'a longer line of text', 'hi']
DP_CONFIG = dict(dim=64, depth=2, heads=2, dim_head=32, num_registers=4, max_seq_len=256,
                 kernel_size=7, dropout=0.1)
CLIP = 1e-3          # below the grad norm of the first step: the clip acts
TOL = 1e-6


def steps(drops):
    """One global batch a step (the same mels and texts), text dropped
    where ``drops`` says."""
    mel = np.random.default_rng(0).standard_normal((B, N, 100)).astype(np.float32)
    tokenizer, _ = resolve_tokenizer('char_utf8', None)
    ids = np.asarray(tokenizer(TEXTS))
    return [dict(mel=mel, lens=LENS, text=ids, drop=drop) for drop in drops]


TWO = steps((False, True))
FOUR = steps((False, True, False, False))


def single(drops_steps, *, record_after=None, save_to=None, dp_config=None, **kw):
    """The single-device trainer over the steps: (losses, norms, final
    state, state after ``record_after`` steps)."""
    norms = []
    clip = trainer_module.clip_by_global_norm_

    def clipping(grads, max_norm):
        norms.append(float(clip(grads, max_norm)))
        return norms[-1]
    trainer_module.clip_by_global_norm_ = clipping
    try:
        if dp_config:
            kw.update(duration_predictor=build_predictor(dp_config, seed=2),
                      train_duration_predictor=True)
        trainer = make_trainer(build_model(CONFIG), checkpoint_path=save_to, **kw)
        losses, mid = [], None
        for i, step in enumerate(drops_steps):
            losses += run_steps(trainer, [step])
            if record_after == i + 1:
                mid = full_state(trainer)
                if save_to:
                    trainer.save_checkpoint(i + 1)
        return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                    final=full_state(trainer), mid=mid)
    finally:
        trainer_module.clip_by_global_norm_ = clip


def _prefixed(result, prefix):
    return {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}


def mismatch(result, ref, prefix='final.') -> float:
    """The largest of each loss's relative gap (the model's and the
    predictor's losses differ in scale by 100x) and the parameters' relative
    L2 gap."""
    params = _prefixed(result, prefix + 'param.')
    got = np.concatenate([params[k].ravel() for k in sorted(params)])
    want = np.concatenate([ref['final'][f'param.{k}'].ravel() for k in sorted(params)])
    losses = np.abs(result['losses'] - ref['losses']) / np.abs(ref['losses'])
    return max(float(losses.max()), float(np.linalg.norm(got - want) / np.linalg.norm(want)))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The ranks' tasks, and the single-device references computed here while
    the ranks run (the accumulation run first: it writes the checkpoint the
    ranks resume from)."""
    tmp = tmp_path_factory.mktemp('parallel_dropout')
    torch.set_num_threads(1)
    refs = dict(accum=single(FOUR, grad_accumulation_steps=2, record_after=3,
                             save_to=str(tmp / 'single_ckpt')))
    dp = dict(dp_config=DP_CONFIG)
    two, four, last = (write_steps(str(tmp / f'{n}.npz'), s)
                       for n, s in (('two', TWO), ('four', FOUR), ('last', FOUR[3:])))
    task = lambda name, sharding, steps, **kw: dict(kind='steps', sharding=sharding,
                                                    config=CONFIG, steps=steps,
                                                    out=str(tmp / name), **kw)
    tasks = [task('replicated', 'replicated', two, **dp), task('fsdp', 'fsdp', two, **dp),
             task('offset0', 'replicated', two, fault='offset0', **dp),
             task('rank_mean', 'replicated', two, fault='rank_mean', **dp),
             task('clip', 'fsdp', two, trainer=dict(max_grad_norm=CLIP), **dp),
             dict(kind='train', sharding='fsdp', config=CONFIG, out=str(tmp / 'train'),
                  trainer=dict(checkpoint_path=str(tmp / 'train_ckpt'))),
             task('accum_replicated', 'replicated', four,
                  trainer=dict(grad_accumulation_steps=2)),
             task('accum_fsdp', 'fsdp', four, trainer=dict(grad_accumulation_steps=2),
                  save_after=3, save_to=str(tmp / 'fsdp_ckpt')),
             task('resume_fsdp', 'fsdp', last, trainer=dict(grad_accumulation_steps=2),
                  resume_from=str(tmp / 'single_ckpt'))]
    ranks = Ranks(2, tasks, tmp)
    try:
        refs.update(two=single(TWO, **dp), clip=single(TWO, max_grad_norm=CLIP, **dp),
                    train=run_train(make_trainer(build_model(CONFIG),
                                                 checkpoint_path=str(tmp / 'single_train'))))
    finally:
        ranks.join()
    load = lambda name, f='result.npz': dict(np.load(tmp / name / f))
    port = {t['out'].rsplit('/', 1)[1]: load(t['out'].rsplit('/', 1)[1]) for t in tasks}
    ranks = {name: [load(name, f'rank{r}.npz') for r in range(2)] for name in port}
    return dict(refs=refs, port=port, ranks=ranks, tmp=tmp)


@pytest.mark.parametrize('sharding', ['replicated', 'fsdp'])
def test_two_ranks_match_single_device(runs, sharding):
    """With text, then text dropped, beside a trained duration predictor:
    losses and parameters within 1e-6 of the single device; the two ranks'
    span counts differ."""
    counts = [r['counts'] for r in runs['ranks'][sharding]]
    assert not np.array_equal(counts[0], counts[1])
    assert mismatch(runs['port'][sharding], runs['refs']['two']) <= TOL


@pytest.mark.parametrize('fault', ['offset0', 'rank_mean'])
def test_planted_faults_fail(runs, fault):
    """Every rank at offset 0, or a per-rank mean loss, breaks the match."""
    assert mismatch(runs['port'][fault], runs['refs']['two']) > 100 * TOL


def test_fsdp_clip_matches_single_device(runs):
    """A clip that acts (global norm above ``max_grad_norm`` at every step):
    the FSDP ranks' norm is the whole gradient's, and the step the single
    device's."""
    ref_norms = runs['refs']['clip']['norms']
    assert (ref_norms > CLIP).all()
    for rank in runs['ranks']['clip']:
        np.testing.assert_allclose(rank['norms'], ref_norms, rtol=TOL)
    assert mismatch(runs['port']['clip'], runs['refs']['clip']) <= TOL


def test_train_loop_matches_single_device(runs):
    """`E2Trainer.train` on two FSDP ranks over two epochs of a ragged
    dataset, global batch 4, a checkpoint every step: its returned (global)
    losses and final parameters are the single device's; the checkpoint's
    step is the last."""
    got, ref = runs['port']['train'], runs['refs']['train']
    assert len(got['losses']) == len(ref['losses']) == 4
    assert mismatch(got, dict(losses=ref['losses'], final=_prefixed(ref, 'final.'))) <= TOL
    payload = torch.load(runs['tmp'] / 'train_ckpt' / 'checkpoint.pt', weights_only=True)
    assert payload['step'] == 4


@pytest.mark.parametrize('sharding', ['replicated', 'fsdp'])
def test_duration_predictor_matches_single_device(runs, sharding):
    """The trained duration predictor of those runs (its own DDP / FSDP2,
    dropout 0.1, no text stream in its loss): its parameters within 1e-6 of
    the single device's (its losses are in the runs' loss check). Its loss,
    a batch mean of per-sample terms, is each rank's share of it."""
    got, ref = runs['port'][sharding], runs['refs']['two']
    params = _prefixed(got, 'final.dp_param.')
    a = np.concatenate([params[k].ravel() for k in sorted(params)])
    b = np.concatenate([ref['final'][f'dp_param.{k}'].ravel() for k in sorted(params)])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= TOL


@pytest.mark.parametrize('sharding', ['replicated', 'fsdp'])
def test_accumulation_matches_single_device(runs, sharding):
    """``grad_accumulation_steps=2`` over four micro-steps (two ADOPT
    steps), the accumulator's mean grads too."""
    got, ref = runs['port'][f'accum_{sharding}'], runs['refs']['accum']
    assert mismatch(got, ref) <= TOL
    for key, want in ref['final'].items():
        if key.startswith('acc.'):
            np.testing.assert_allclose(got[f'final.{key}'], want, rtol=1e-5,
                                       atol=1e-6 * float(np.abs(want).max()), err_msg=key)


def test_fsdp_bytes_are_a_shard(runs):
    """Under FSDP each rank holds at most ``torch.chunk``'s piece of every
    parameter, EMA weight and ADOPT moment, about half of each, plus the
    0-d parameters FSDP2 leaves whole (on every rank)."""
    final = runs['port']['fsdp']
    shapes = [v.shape for k, v in final.items() if k.startswith('final.param.')]
    sharded = [s for s in shapes if len(s)]
    whole = (len(shapes) - len(sharded)) * 4
    total = sum(int(np.prod(s)) for s in sharded) * 4
    bound = sum(-(-s[0] // 2) * int(np.prod(s[1:])) for s in sharded) * 4 + whole
    assert whole < 0.001 * total and bound <= 0.51 * total
    for rank in runs['ranks']['fsdp']:
        assert rank['params'] <= bound and rank['ema'] <= bound
        assert rank['adopt'] <= 2 * bound
    assert sum(r['params'] for r in runs['ranks']['fsdp']) == total + 2 * whole


def _assert_state_equal(got: dict, want: dict, label: str):
    assert set(got) == set(want), label
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f'{label} {key}')


def test_fsdp_checkpoint_resumes_on_one_device(runs):
    """A checkpoint of the two-rank FSDP run, saved mid-accumulation after
    three micro-steps, loads on one process bit for bit (parameters, EMA,
    ADOPT, accumulator and counters); the next micro-step there is the
    FSDP run's."""
    saved = _prefixed(runs['port']['accum_fsdp'], 'saved.')
    trainer = make_trainer(build_model(CONFIG, seed=5), grad_accumulation_steps=2,
                           checkpoint_path=str(runs['tmp'] / 'fsdp_ckpt'))
    assert trainer.resume() == 3
    _assert_state_equal(full_state(trainer), saved, 'resumed')
    losses = run_steps(trainer, FOUR[3:])
    result = dict(losses=np.asarray(losses),
                  **{f'final.{k}': v for k, v in full_state(trainer).items()})
    port = runs['port']['accum_fsdp']
    assert mismatch(result, dict(losses=port['losses'][3:],
                                 final=_prefixed(port, 'final.'))) <= TOL


def test_single_device_checkpoint_resumes_on_fsdp(runs):
    """The reverse: the single device's mid-accumulation checkpoint resumed
    by two FSDP ranks is its state bit for bit, and their next micro-step is
    the single device's."""
    got, ref = runs['port']['resume_fsdp'], runs['refs']['accum']
    assert int(got['resumed_step']) == 3
    _assert_state_equal(_prefixed(got, 'resumed.'), ref['mid'], 'resumed')
    assert mismatch(got, dict(losses=ref['losses'][3:], final=ref['final'])) <= TOL


# -- the dropout bits by global batch row, in the plain kernels ----------------------

def test_keep_mask_offset_is_the_slice():
    """`dropout_keep_mask` with ``hash_b0`` draws the global mask's rows."""
    b, h, n, seed = 6, 3, 20, 1234
    full = fa.dropout_keep_mask(seed, b * h, n, 0.1)
    part = fa.dropout_keep_mask(seed, 2 * h, n, 0.1, hash_b0=3, heads=h)
    assert torch.equal(part, full[3 * h:5 * h])
    assert not torch.equal(fa.dropout_keep_mask(seed, 2 * h, n, 0.1, heads=h), part)


@pytest.mark.parametrize('packed', [True, False], ids=['K1-K2', 'K8-K9'])
def test_flash_plain_offset_is_the_slice(packed):
    """K1 / K2 (packed) and K8 / K9 (bhnd) plain versions on rows [b, 2b)
    with ``hash_b0 = b``: out, lse and the grads equal the whole batch's
    rows; at offset 0 (the planted fault) they do not."""
    g = torch.Generator().manual_seed(0)
    b, h, n, dh, seed, rate = 2, 2, 24, 16, 77, 0.1
    shape = (2 * b, n, h * dh) if packed else (2 * b, h, n, dh)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    mask = torch.ones(2 * b, n, dtype=torch.bool)
    mask[1, 20:] = mask[3, 15:] = False
    kw = dict(scale=dh ** -0.5, softclamp_value=50.0, dropout_rate=rate, dropout_seed=seed)
    if packed:
        fwd = lambda *a, **o: fa.flash_attention_packed_plain(*a, heads=h, **kw, **o)
        bwd = lambda *a, **o: fa.flash_attention_packed_backward_plain(*a, heads=h, **kw, **o)[:3]
    else:
        fwd = lambda *a, **o: fa.flash_attention_plain(*a, **kw, **o)
        bwd = lambda *a, **o: fa.flash_attention_backward_plain(*a, **kw, **o)
    out, lse = fwd(q, k, v, mask)
    grads = bwd(q, k, v, mask, out, lse, do)
    rows = slice(b, 2 * b)
    half = lambda t: t[rows]
    close = lambda x, y: torch.allclose(x, y, rtol=0, atol=1e-5)
    for b0, equal in ((b, True), (0, False)):
        o2, l2 = fwd(half(q), half(k), half(v), half(mask), hash_b0=b0)
        g2 = bwd(half(q), half(k), half(v), half(mask), o2, l2, half(do), hash_b0=b0)
        assert close(l2, lse[b * h:])          # the softmax's statistics: no dropout in them
        assert close(o2, out[rows]) == equal, b0
        assert all(close(x, y[rows]) == equal for x, y in zip(g2, grads)), b0


def test_geglu_seed_fold_is_the_slice():
    """`fold_batch_offset`: K6 / K7's plain versions (and `hash_keep`) on
    rows from b0 under the folded seed draw the whole batch's rows."""
    g = torch.Generator().manual_seed(1)
    h2, gout = torch.randn(5, 7, 2 * 24, generator=g), torch.randn(5, 7, 24, generator=g)
    seed, rate, b0 = 4321, 0.1, 3
    folded = fold_batch_offset(seed, b0)
    assert torch.equal(hash_keep((2, 7, 24), folded, rate),
                       hash_keep((5, 7, 24), seed, rate)[b0:])
    assert torch.equal(geglu_dropout_plain(h2[b0:], folded, rate),
                       geglu_dropout_plain(h2, seed, rate)[b0:])
    assert torch.equal(geglu_dropout_backward_plain(h2[b0:], gout[b0:], folded, rate),
                       geglu_dropout_backward_plain(h2, gout, seed, rate)[b0:])
    assert not torch.equal(geglu_dropout_plain(h2[b0:], seed, rate),
                           geglu_dropout_plain(h2, seed, rate)[b0:])


# -- the mesh and the process group, without ranks -----------------------------------

class _Mesh:
    """A stand-in for a 1-D DeviceMesh: its size and this rank's place."""

    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


def test_shard_batch_takes_the_ranks_rows():
    """Rank r of P takes rows [r B/P, (r+1) B/P) of every array (numpy and
    tensors, None kept); a batch P does not divide raises."""
    batch = dict(mel=np.arange(12).reshape(6, 2), lens=torch.arange(6), text=None)
    got = mesh_module.shard_batch(batch, _Mesh(3, 1))
    assert got['mel'].tolist() == [[4, 5], [6, 7]] and got['lens'].tolist() == [2, 3]
    assert got['text'] is None
    assert mesh_module.batch_rows(6, _Mesh(3, 2)) == (4, 6)
    with pytest.raises(ValueError, match='divisible'):
        mesh_module.shard_batch(batch, _Mesh(4, 0))
    with pytest.raises(ValueError, match='batch size'):
        mesh_module.shard_batch((np.zeros(4), np.zeros(6)), _Mesh(2, 0))


def test_initialization_needs_a_launch_and_never_falls_back(monkeypatch, tmp_path):
    """One process without torchrun's environment: no group (False). An
    NCCL group on a machine without a GPU raises, never drops to gloo; an
    explicit rendezvous without a rank raises."""
    for var in ('RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed() is False
    store = f'file://{tmp_path}/store'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='NCCL'):
            maybe_initialize_distributed(init_method=store, world_size=1, rank=0)
    with pytest.raises(ValueError, match='world_size and rank'):
        maybe_initialize_distributed(init_method=store, device='cpu')
    assert not torch.distributed.is_initialized()

