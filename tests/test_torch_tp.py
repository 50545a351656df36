"""The port's tensor parallelism on the CPU: against the JAX package's
(loss and grads, the sharded set), against the port's own single device
with dropout (train steps, planted faults, the sampler, checkpoints), and
the plain kernels' dropout bits by global head and GEGLU column.

Two spawns of gloo ranks (tests/_torch_parallel_worker.py), one of two
ranks and one of four, run at once while this process builds the
references; a rank's task that needs a file this process writes (the JAX
weights, a single-device checkpoint) waits for it.

**Against JAX.** JAX `shard_module_tp` on `make_2d_mesh(1, 2)` of
conftest.py's virtual CPU devices, dropout 0 and ``attn_backend='xla'``,
its loss and grads in one jitted ``nnx.value_and_grad``; the port at (data
1, model 2) and (2, 2) from the same weights (`load_jax_params`, then
`shard_module_tp`), the draws of the JAX key (span, x0, t) handed to it as
tests/test_torch_parallel.py does, one loss and backward on the global
batch, the grads summed over the data axis and gathered to the
single-device layout. Tolerances, the JAX package's own for its TP test
(tests/test_parallel.py): the loss 2e-5 relative, every grad 2e-4
absolute plus 2e-4 relative.

**Against the port's single device.** SMALL_TF widths (heads 4 x 32, inner
128, GEGLU inner 384, text GEGLU 192, so 2 and 4 divide everything) with
dropout 0.1, every weight (the value-head gates and value-residual mixes
too) perturbed off its init, sharded over (1, 2), (2, 2) and (1, 4), take
two `E2Trainer.train_step`s (with text, then text dropped) with a clip that
acts, ADOPT and the EMA. A run matches when each loss is within 1e-5 of
the single device's (relative), every parameter and EMA weight within
1e-6 (absolute) and each rank's clip norm within 1e-6 (relative). Three
planted faults must fail that: every rank drawing the attention bits of
heads [0, H/T) (``hash_h0 = 0``), ``proj_in`` cut as one block of rows
(one rank all the GEGLU's values, the other all its gates), and the
value-head gate's grads left unsummed over the model axis. Heads of 24
(both attentions on K8 / K9's plain versions) with two frequency tokens
(the frequency attention sharded too) hold the same limits at (1, 2). A
model with a duration predictor, both sharded over (2, 2), samples 4
midpoint steps from a seeded generator: each rank's mel within 1e-4 of
the single device's (relative L2) and bit for bit the others', the
predictor's estimate likewise. Checkpoints: the (2, 2) run's, saved after
its first step, loads into one process bit for bit and its next step there
is the run's; one process's, resumed by (1, 4) ranks, is their state bit
for bit, and their next step the single device's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.parallel.tp import _spec_for as jax_spec_for
from e2_tts_tpu.parallel.tp import make_2d_mesh as jax_make_2d_mesh
from e2_tts_tpu.parallel.tp import shard_module_tp as jax_shard_module_tp
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_parallel_worker import Ranks, build_model, full_state, make_trainer, run_steps, \
    sample_model, sample_run, write_steps
from _torch_port_helpers import SMALL_TF, flat_state, flat_values, perturb_np
from e2_tts_tpu_torch.convert import map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.ops.dropout import fold_batch_offset, fold_column_offset, hash_keep
from e2_tts_tpu_torch.ops.geglu_kernel import geglu_dropout_backward_plain, geglu_dropout_plain
from e2_tts_tpu_torch.parallel import tp
from e2_tts_tpu_torch.text.tokenizer import resolve_tokenizer
from e2_tts_tpu_torch.training import trainer as trainer_module

B, N = 4, 40
TEXTS = ['hello there', 'ok', 'a longer line of text', 'hi']
LENS = np.array([40, 17, 33, 26], np.int64)
DP_CONFIG = dict(dim=64, depth=2, heads=4, dim_head=16, num_registers=2, max_seq_len=64,
                 kernel_size=7, dropout=0.0)
JAX_SHAPES = ((1, 2), (2, 2))
LOSS_RTOL, GRAD_TOL = 2e-5, 2e-4
CONFIG = dict(SMALL_TF, dropout=0.1)
K8_CONFIG = dict(CONFIG, dim_head=24, text_dim_head=24)
K8_MODEL = dict(num_freq_tokens=2)
CLIP = 1e-3                     # below the grad norm of every step: the clip acts
LOSS_TOL, PARAM_TOL, NORM_TOL = 1e-5, 1e-6, 1e-6
SAMPLE_TOL = 1e-4
SAMPLE_FRAMES, SAMPLE_DURATION = 12, 24
SHAPES = ((1, 2), (2, 2), (1, 4))
FAULTS = ('hash_h0_zero', 'proj_in_rows', 'gate_grad')


def _draws(key):
    """The draws of JAX `E2TTS.__call__` for this key (its four-way split)."""
    k_frac, k_span, k_x0, k_time = jax.random.split(key, 4)
    lens = jnp.asarray(LENS)
    frac_lengths = jax.random.uniform(k_frac, (B,), minval=0.7, maxval=1.0)
    span = jax_span_mask(k_span, lens, frac_lengths, N) & jax_lens_to_mask(lens, length=N)
    x0 = jax.random.normal(k_x0, (B, N, 100), dtype=jnp.float32)
    times = jax.random.uniform(k_time, (B,), dtype=jnp.float32)
    return dict(times=np.asarray(times), noise=np.asarray(x0), rand_span_mask=np.asarray(span))


@nnx.jit
def _jax_loss_and_grads(model, mel, lens, text, key):
    loss_fn = lambda m: m(mel, text=text, lens=lens, key=key, drop_text_cond=False).loss
    return nnx.value_and_grad(loss_fn)(model)


def _jax_sharded_paths(module, n_model: int) -> list[str]:
    """The paths JAX `shard_module_tp` shards in ``module`` (an abstract
    one, from ``nnx.eval_shape``: no weights to place): its rule table
    (`_spec_for`) over the module's state, as `shard_module_tp` walks it."""
    paths = []

    def visit(path, x):
        path_str = '/'.join(str(getattr(k, 'key', k)) for k in path)
        spec, matched = jax_spec_for(path_str, x.shape, n_model)
        if matched and spec is not None:
            paths.append(path_str)
    jax.tree_util.tree_map_with_path(visit, nnx.to_pure_dict(nnx.state(module)))
    return sorted(paths)


def _steps():
    mel = np.random.default_rng(0).standard_normal((B, N, 100)).astype(np.float32)
    tokenizer, _ = resolve_tokenizer('char_utf8', None)
    ids = np.asarray(tokenizer(TEXTS))
    return [dict(mel=mel, lens=LENS, text=ids, drop=drop) for drop in (False, True)]


TWO = _steps()


def single(config, *, model_kw=None, save_to=None):
    """The single-device trainer over TWO: losses, clip norms, final state,
    and the state after the first step (saved to ``save_to`` when given)."""
    norms = []
    clip = trainer_module.clip_by_global_norm_

    def clipping(grads, max_norm, **kw):
        norms.append(float(clip(grads, max_norm, **kw)))
        return norms[-1]
    trainer_module.clip_by_global_norm_ = clipping
    try:
        trainer = make_trainer(build_model(config, **(model_kw or {})), max_grad_norm=CLIP,
                               checkpoint_path=save_to)
        losses = run_steps(trainer, TWO[:1])
        mid = full_state(trainer)
        if save_to:
            trainer.save_checkpoint(1)
        losses += run_steps(trainer, TWO[1:])
        return dict(losses=np.asarray(losses), norms=np.asarray(norms),
                    final=full_state(trainer), mid=mid)
    finally:
        trainer_module.clip_by_global_norm_ = clip


def _prefixed(result, prefix):
    return {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}


def gaps(result, ref, prefix='final.') -> dict:
    """The largest relative loss gap and the largest absolute gap of any
    parameter or EMA weight."""
    params = _prefixed(result, prefix)
    worst = max(float(np.abs(params[k] - ref['final'][k]).max()) for k in ref['final']
                if k.split('.')[0] in ('param', 'ema'))
    losses = np.abs(result['losses'] - ref['losses']) / np.abs(ref['losses'])
    return dict(loss=float(losses.max()), param=worst)


def holds(result, ref) -> bool:
    g = gaps(result, ref)
    return g['loss'] <= LOSS_TOL and g['param'] <= PARAM_TOL


def _sample_inputs():
    rng = np.random.default_rng(4)
    return rng.standard_normal((1, SAMPLE_FRAMES, 100)).astype(np.float32), ['hi there']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both spawns' tasks and every reference: the single device's steps
    (the checkpointed run first: the (1, 4) ranks resume from it), JAX's TP
    loss and grads (its weights written for the ranks' grads tasks), the
    sharded sets, the single device's K8 run and sample."""
    tmp = tmp_path_factory.mktemp('tp')
    torch.set_num_threads(1)
    jax_state = str(tmp / 'jax_state.npz')
    mel = np.random.default_rng(0).standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(resolve_tokenizer('char_utf8', None)[0](TEXTS))
    key = jax.random.key(100)
    jax_step = write_steps(str(tmp / 'jax_step.npz'), [dict(
        mel=mel, lens=LENS, text=text, drop=False, **_draws(key))])
    two, last = (write_steps(str(tmp / f'{n}.npz'), s) for n, s in (('two', TWO),
                                                                  ('last', TWO[1:])))
    prompt, sample_text = _sample_inputs()

    def task(name, shape, steps=two, config=CONFIG, **kw):
        return dict(kind='steps', sharding='replicated', config=config, steps=steps,
                    tp=shape, trainer=dict(max_grad_norm=CLIP), out=str(tmp / name), **kw)

    def grads(shape):
        return dict(kind='grads', tp=shape, config=SMALL_TF, steps=jax_step,
                    jax_state=jax_state, out=str(tmp / f'grads{shape[0]}x{shape[1]}'))
    two_rank = ([task('tp1x2', (1, 2))] + [task(f, (1, 2), fault=f) for f in FAULTS]
                + [task('k8', (1, 2), config=K8_CONFIG, model_kw=K8_MODEL),
                   dict(kind='paths', tp=(1, 2), config=SMALL_TF, dp_config=DP_CONFIG,
                        out=str(tmp / 'paths')),
                   dict(kind='fsdp', tp=(1, 2), config=SMALL_TF, out=str(tmp / 'fsdp')),
                   grads((1, 2))])
    four_rank = [task('tp2x2', (2, 2), save_after=1, save_to=str(tmp / 'tp_ckpt')),
                 task('tp1x4', (1, 4)),
                 dict(kind='sample', tp=(2, 2), config=CONFIG, dp_config=DP_CONFIG,
                      prompt=prompt.tolist(), text=sample_text, duration=SAMPLE_DURATION,
                      out=str(tmp / 'sample')),
                 task('resume1x4', (1, 4), steps=last, resume_from=str(tmp / 'single_ckpt')),
                 grads((2, 2))]
    spawns = []
    for world, tasks in ((2, two_rank), (4, four_rank)):
        (tmp / f'world{world}').mkdir()
        spawns.append(Ranks(world, tasks, tmp / f'world{world}'))
    try:
        refs = dict(main=single(CONFIG, save_to=str(tmp / 'single_ckpt')))
        # built under nnx.jit: one compile instead of an eager init op by op
        j = perturb_np(nnx.jit(lambda: JaxE2TTS(transformer=dict(SMALL_TF, attn_backend='xla'),
                                                use_vocos=False, rngs=nnx.Rngs(0)))(), seed=8)
        np.savez(str(tmp / 'jax_state.tmp.npz'), **flat_state(j))
        os.replace(tmp / 'jax_state.tmp.npz', jax_state)       # whole, for the waiting ranks
        mesh = jax_make_2d_mesh(1, 2)
        jax_shard_module_tp(j, mesh)
        loss, g = _jax_loss_and_grads(j, jnp.asarray(mel), jnp.asarray(LENS),
                                      jnp.asarray(text), key)
        refs['jax'] = dict(loss=float(loss), grads=flat_values(g),
                           j_paths=list(j._tp_sharded_paths))
        refs['jax']['paths'] = _jax_sharded_paths(nnx.eval_shape(lambda: JaxE2TTS(
            transformer=dict(SMALL_TF, attn_backend='xla'), use_vocos=False, num_freq_tokens=2,
            duration_predictor=dict(transformer=dict(DP_CONFIG, attn_backend='xla')),
            rngs=nnx.Rngs(1))), 2)
        refs.update(k8=single(K8_CONFIG, model_kw=K8_MODEL),
                    sample=sample_run(sample_model(CONFIG, DP_CONFIG), prompt, sample_text,
                                      SAMPLE_DURATION))
    finally:
        for spawn in spawns:
            spawn.join()
    load = lambda name, f='result.npz': dict(np.load(tmp / name / f))
    worlds = {t['out'].rsplit('/', 1)[1]: world
              for world, tasks in ((2, two_rank), (4, four_rank)) for t in tasks}
    kinds = {t['out'].rsplit('/', 1)[1]: t['kind'] for t in two_rank + four_rank}
    port = {name: load(name) for name, kind in kinds.items() if kind != 'sample'}
    # every rank writes its own file in the trainer's and the sampler's tasks
    ranks = {name: [load(name, f'rank{r}.npz') for r in range(worlds[name])]
             for name, kind in kinds.items() if kind in ('steps', 'sample')}
    return dict(refs=refs, port=port, ranks=ranks, tmp=tmp)


# -- against JAX ------------------------------------------------------------------

@pytest.mark.parametrize('shape', JAX_SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_tp_loss_and_grads_match_jax(runs, shape):
    """The port's TP loss and every grad, at (1, 2) and (2, 2), are JAX
    `shard_module_tp`'s (a grad missing its sum over the model axis cannot
    pass)."""
    got, ref = runs['port'][f'grads{shape[0]}x{shape[1]}'], runs['refs']['jax']
    np.testing.assert_allclose(float(got['loss']), ref['loss'], rtol=LOSS_RTOL)
    grads = {k[len('grad.'):]: v for k, v in got.items() if k.startswith('grad.')}
    mapped = map_jax_tree(ref['grads'], {name: g.shape for name, g in grads.items()})
    for name, g in grads.items():
        np.testing.assert_allclose(g, mapped[name], atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def _port_name(jax_path: str) -> str:
    parts = jax_path.split('/')
    return '.'.join(parts[:-1] + ['weight' if parts[-1] == 'kernel' else parts[-1]])


def test_sharded_set_matches_jax(runs):
    """The port's `_tp_sharded_paths` of a model with a duration predictor
    and two frequency tokens is JAX's, name for name: every speech and text
    layer's attention (q / k / v and out) and feedforward (in, its bias,
    out), the frequency attention's, the predictor's; the model-level
    ``proj_in`` is not in it. (JAX's rule walk over an abstract model is
    `shard_module_tp`'s own: on the weighted model of the grads case the two
    give the same set.)"""
    port = [str(p) for p in runs['port']['paths']['paths']]
    jax_paths = runs['refs']['jax']['paths']
    assert _jax_sharded_paths(nnx.eval_shape(lambda: JaxE2TTS(
        transformer=dict(SMALL_TF, attn_backend='xla'), use_vocos=False,
        rngs=nnx.Rngs(0))), 2) == runs['refs']['jax']['j_paths']
    assert port == sorted(port)
    assert set(port) == {_port_name(p) for p in jax_paths}
    assert len(port) == len(jax_paths) == 2 * (2 * 5 + 2) + 2 * 2 * 5
    assert 'proj_in.weight' not in port
    for must in ('transformer.speech_layers.0.freq_attn.to_qkv.weight',
                 'transformer.text_layers.1.ff.proj_in.bias',
                 'duration_predictor.transformer.speech_layers.1.attn.to_out.weight'):
        assert must in port, must


def test_fsdp_on_a_tp_mesh_raises(runs):
    """``param_sharding='fsdp'`` on a (data, model) mesh raises
    NotImplementedError naming its ROADMAP.md item."""
    error = str(runs['port']['fsdp']['error'])
    assert 'NotImplementedError' in error and 'ROADMAP.md' in error


@pytest.mark.parametrize('size,match', [(3, 'cannot divide'), (8, 'heads')])
def test_indivisible_raises(size, match):
    """A 3-way model axis cannot divide inner 128, an 8-way one the 4 heads
    (the port's own rule: it splits whole heads): ValueError, nothing cut."""
    model = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    before = {n: p.shape for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match=match):
        tp.cut_module_tp(model, tp.ModelAxis(None, size, 0))
    assert {n: p.shape for n, p in model.named_parameters()} == before


def test_no_match_raises():
    with pytest.raises(ValueError, match='NO parameters'):
        tp.cut_module_tp(torch.nn.Linear(4, 4), tp.ModelAxis(None, 2, 0))


def test_make_2d_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match='process group'):
        tp.make_2d_mesh(1, 2)


@pytest.mark.parametrize('layout', [(0, 3), (1, 1), (0, 2)])
def test_local_parts_join_to_the_whole(layout):
    """`local_part`'s pieces for every rank, joined (`join_parts`), are the
    tensor; each piece holds its rank's slice of every segment."""
    full = torch.arange(24 * 6, dtype=torch.float32).view(24, 6)
    if layout[0] == 1:
        full = full.T.contiguous()
    parts = [tp.local_part(full, layout, 2, r) for r in range(2)]
    assert torch.equal(tp.join_parts(parts, layout), full)
    dim, segments = layout
    seg = full.shape[dim] // segments
    first = torch.cat([full.narrow(dim, s * seg, seg // 2) for s in range(segments)], dim)
    assert torch.equal(parts[0], first)


# -- against the single device ----------------------------------------------------

@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_tp_steps_match_single_device(runs, shape):
    """With text, then text dropped, dropout 0.1, the clip acting: losses,
    parameters and EMA weights at their limits, and every rank's clip norm
    the single device's."""
    name = f'tp{shape[0]}x{shape[1]}'
    ref = runs['refs']['main']
    assert (ref['norms'] > CLIP).all()
    for rank in runs['ranks'][name]:
        np.testing.assert_allclose(rank['norms'], ref['norms'], rtol=NORM_TOL)
    g = gaps(runs['port'][name], ref)
    assert g['loss'] <= LOSS_TOL and g['param'] <= PARAM_TOL, g


@pytest.mark.parametrize('fault', FAULTS)
def test_planted_faults_fail(runs, fault):
    """Heads drawing the bits of heads [0, H/T), a plain row split of
    ``proj_in`` and an unsummed value-head gate grad each break the match."""
    g = gaps(runs['port'][fault], runs['refs']['main'])
    assert g['loss'] > 10 * LOSS_TOL or g['param'] > 100 * PARAM_TOL, g


def test_k8_heads_and_frequency_tokens_match_single_device(runs):
    """Heads of 24 (K8 / K9's plain versions) and two frequency tokens (the
    frequency attention sharded) at (1, 2)."""
    g = gaps(runs['port']['k8'], runs['refs']['k8'])
    assert g['loss'] <= LOSS_TOL and g['param'] <= PARAM_TOL, g


def test_tp_sample_matches_single_device_and_ranks_agree(runs):
    """The (2, 2) ranks' midpoint samples and duration estimates: within
    1e-4 of the single device's and bit for bit each other's."""
    ref = runs['refs']['sample']
    ranks = runs['ranks']['sample']
    for key in ('sample', 'duration'):
        got = ranks[0][key]
        assert got.shape == ref[key].shape and np.isfinite(got).all()
        assert np.linalg.norm(got - ref[key]) <= SAMPLE_TOL * np.linalg.norm(ref[key]), key
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[key], got, err_msg=key)


def _assert_state_equal(got: dict, want: dict, label: str):
    assert set(got) == set(want), label
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f'{label} {key}')


def test_tp_checkpoint_resumes_on_one_device(runs):
    """The (2, 2) run's checkpoint after one step, written in the
    single-device layout, loads into one process bit for bit (parameters,
    EMA, ADOPT, counters); its next step there is the run's."""
    trainer = make_trainer(build_model(CONFIG, seed=5), max_grad_norm=CLIP,
                           checkpoint_path=str(runs['tmp'] / 'tp_ckpt'))
    assert trainer.resume() == 1
    port = runs['port']['tp2x2']
    _assert_state_equal(full_state(trainer), _prefixed(port, 'saved.'), 'resumed')
    result = dict(losses=np.asarray(run_steps(trainer, TWO[1:])),
                  **{f'final.{k}': v for k, v in full_state(trainer).items()})
    assert holds(result, dict(losses=port['losses'][1:], final=_prefixed(port, 'final.')))


def test_single_device_checkpoint_resumes_on_tp(runs):
    """The reverse: one process's checkpoint after one step, resumed by
    (1, 4) ranks, is its state bit for bit, and their next step the single
    device's."""
    got, ref = runs['port']['resume1x4'], runs['refs']['main']
    assert int(got['resumed_step']) == 1
    _assert_state_equal(_prefixed(got, 'resumed.'), ref['mid'], 'resumed')
    assert holds(got, dict(losses=ref['losses'][1:], final=ref['final']))


# -- the dropout bits by global head and column, in the plain kernels ----------------

def test_keep_mask_head_offset_is_the_slice():
    """`dropout_keep_mask` with ``hash_h0`` of ``hash_heads`` draws the
    whole layer's heads (with ``hash_b0``, of its rows)."""
    b, h, n, seed, h0, b0 = 3, 4, 20, 1234, 2, 5
    full = fa.dropout_keep_mask(seed, b * h, n, 0.1, hash_b0=b0, heads=h).view(b, h, n, n)
    part = fa.dropout_keep_mask(seed, b * 2, n, 0.1, hash_b0=b0, heads=2, hash_h0=h0,
                                hash_heads=h).view(b, 2, n, n)
    assert torch.equal(part, full[:, h0:])
    assert not torch.equal(fa.dropout_keep_mask(seed, b * 2, n, 0.1, hash_b0=b0, heads=2,
                                                hash_heads=h).view(b, 2, n, n), part)


@pytest.mark.parametrize('packed', [True, False], ids=['K1-K2', 'K8-K9'])
def test_flash_plain_head_offset_is_the_slice(packed):
    """K1 / K2 (packed, gated) and K8 / K9 (bhnd) plain versions on heads
    [h0, h0 + H/T) with ``hash_h0 = h0``, ``hash_heads = H``, ``hash_b0 =
    2``: out, lse and the grads equal the whole launch's heads; at
    ``hash_h0 = 0`` (the planted fault) they do not."""
    g = torch.Generator().manual_seed(0)
    b, h, n, dh, seed, rate, T = 2, 4, 24, 16, 77, 0.1, 2
    shape = (b, n, h * dh) if packed else (b, h, n, dh)
    q, k, v, do = (torch.randn(shape, generator=g) for _ in range(4))
    gate = torch.randn(b, n, h, generator=g) if packed else None
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, 17:] = False
    kw = dict(scale=dh ** -0.5, softclamp_value=50.0, dropout_rate=rate, dropout_seed=seed,
              hash_b0=2)
    if packed:
        fwd = lambda q, k, v, gt, hh, **o: fa.flash_attention_packed_plain(
            q, k, v, mask, heads=hh, gate_logits=gt, **kw, **o)
        bwd = lambda q, k, v, gt, out, lse, do, hh, **o: \
            fa.flash_attention_packed_backward_plain(q, k, v, mask, out, lse, do, heads=hh,
                                                     gate_logits=gt, **kw, **o)
        heads_of = lambda t, h0, hl: t[..., h0 * dh:(h0 + hl) * dh]
        lse_of = lambda l, h0, hl: l.view(b, h, n)[:, h0:h0 + hl].reshape(b * hl, n)
    else:
        fwd = lambda q, k, v, gt, hh, **o: fa.flash_attention_plain(q, k, v, mask, **kw, **o)
        bwd = lambda q, k, v, gt, out, lse, do, hh, **o: fa.flash_attention_backward_plain(
            q, k, v, mask, out, lse, do, **kw, **o)
        heads_of = lambda t, h0, hl: t[:, h0:h0 + hl]
        lse_of = lambda l, h0, hl: l.view(b, h, n)[:, h0:h0 + hl].reshape(b * hl, n)
    out, lse = fwd(q, k, v, gate, h)
    grads = bwd(q, k, v, gate, out, lse, do, h)
    hl = h // T
    close = lambda x, y: torch.allclose(x, y, rtol=0, atol=1e-5)
    for r in range(T):
        h0 = r * hl
        part = lambda t: None if t is None else heads_of(t, h0, hl)
        gate_r = gate[..., h0:h0 + hl] if packed else None
        for hash_h0, equal in ((h0, True), (0, h0 == 0)):
            o2, l2 = fwd(part(q), part(k), part(v), gate_r, hl, hash_h0=hash_h0, hash_heads=h)
            g2 = bwd(part(q), part(k), part(v), gate_r, o2, l2, part(do), hl, hash_h0=hash_h0,
                     hash_heads=h)
            assert close(l2, lse_of(lse, h0, hl))    # no dropout in the statistics
            assert close(o2, part(out)) == equal, (r, hash_h0)
            assert all(close(x, part(y)) == equal for x, y in zip(g2[:3], grads[:3]))
            if packed:
                assert close(g2[3], grads[3][..., h0:h0 + hl]) == equal


def test_geglu_column_fold_is_the_slice():
    """`fold_column_offset`: K6 / K7's plain versions on a rank's value and
    gate columns from c0 under the folded seed (rows from b0 folded too)
    draw the whole layer's columns; unfolded they do not."""
    g = torch.Generator().manual_seed(1)
    b, n, inner, T, b0 = 3, 7, 24, 2, 4
    h2, gout = torch.randn(b, n, 2 * inner, generator=g), torch.randn(b, n, inner, generator=g)
    seed, rate = 4321, 0.1
    c = inner // T
    act, grad = geglu_dropout_plain(h2, seed, rate), geglu_dropout_backward_plain(h2, gout,
                                                                                 seed, rate)
    for r in range(T):
        c0 = r * c
        cols = lambda t, width: torch.cat((t[..., c0:c0 + c], t[..., width + c0:width + c0 + c]),
                                          -1)
        folded = fold_column_offset(seed, c0)
        assert torch.equal(hash_keep((b, n, c), folded, rate),
                           hash_keep((b, n, inner), seed, rate)[..., c0:c0 + c])
        assert torch.equal(geglu_dropout_plain(cols(h2, inner), folded, rate),
                           act[..., c0:c0 + c])
        assert torch.equal(geglu_dropout_backward_plain(cols(h2, inner), gout[..., c0:c0 + c],
                                                        folded, rate), cols(grad, inner))
        if c0:
            assert not torch.equal(geglu_dropout_plain(cols(h2, inner), seed, rate),
                                   act[..., c0:c0 + c])
    both = fold_column_offset(fold_batch_offset(seed, b0), c)
    whole = hash_keep((b0 + b, n, inner), seed, rate)
    assert torch.equal(hash_keep((b, n, c), both, rate), whole[b0:, :, c:2 * c])
