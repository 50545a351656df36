"""The port's sequence parallelism on the CPU: the ring against the port's
dense attention and against the JAX package's ring, the routed model's loss
and grads against the port's single device and the JAX package's dense
model, the trainer on (data, seq) meshes against the single device with
planted faults, the sampler, checkpoints and the errors.

Two spawns of gloo ranks (tests/_torch_parallel_worker.py), one of two
ranks and one of four, run at once while this process builds the
references, as in tests/test_torch_tp.py; a task that needs a file this
process writes (the JAX weights, a single-device checkpoint) waits for it.

**The ring** (`parallel.sp.ring_attention` on a `Loopback` of P = 2 and 4
shards, one process, the block code of the distributed ring) against the
port's dense `attention_packed` in f32: a ragged key mask with a row whose
last shards are wholly masked, softclamp 50, the value-head gate, LASER,
dropout 0.1, heads of 64 (K1 / K2's plain versions) and of 16 and 72 (K8 /
K9's): the output and the grads of q, k, v and the gate logits within
1e-5; the blocks' keep bits (`dropout_keep_mask` at the block's
``hash_r0`` / ``hash_c0``) bit for bit the dense mask's. Against the JAX
package's `ring_attention` on `make_seq_mesh(seq=4, data=2)` of conftest's
virtual devices, with the same uint32 seed: out within 1e-5, grads 2e-4.

**The model.** `E2TTS.forward`'s loss and grads, routed over (1, 2), (2, 2)
and (1, 4) ranks, from the perturbed weights of a JAX model (SMALL_TF, a
ragged batch of 4 x 44 frames: 48 packed rows, a wholly masked shard at
every P): against the port's single device (loss 1e-5 relative, grads 1e-5)
and against the JAX package's dense model (one compile: loss 2e-5
relative, grads 2e-4), the draws of the JAX key handed to both. Two
frequency tokens and a conv of kernel 31 (halo 15 of 24 rows a shard), each
at (1, 2), against the single device.

**The trainer.** `E2Trainer(sequence_parallel=2)` (the trainer builds the
(1, 2) mesh) and the (2, 2), (1, 4) and FSDP (2, 2) meshes: two clip + ADOPT
+ EMA steps (with text, then text dropped, dropout 0.1, a clip that acts);
each loss within 1e-5 of the single device's (relative), every parameter
and EMA weight within 1e-6. The velocity-consistency teacher at (1, 2)
likewise. Four planted faults must fail that after the first step: ring
blocks hashing rows and columns from 0, convs without the halo, rotary
tables from each shard's own positions, and each shard's error over its own
span count.

**The rest.** A sample of a routed model is bit for bit the dense one's
(`sp_paused`); the routing counts; the ring's and the trainer's
divisibility errors and the halo limit; checkpoints from the (1, 2) run to
one process and from one process to (2, 2) ranks, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS
from e2_tts_tpu.parallel.sp import make_seq_mesh as jax_make_seq_mesh
from e2_tts_tpu.parallel.sp import ring_attention as jax_ring_attention
from e2_tts_tpu.parallel.sp import shard_sequence as jax_shard_sequence
from e2_tts_tpu.utils.masking import lens_to_mask as jax_lens_to_mask
from e2_tts_tpu.utils.masking import mask_from_frac_lengths as jax_span_mask

from _torch_parallel_worker import Ranks, build_model, forward_grads, full_state, make_trainer, \
    run_steps, write_steps
from _torch_port_helpers import SMALL_TF, flat_state, flat_values, perturb_np
from e2_tts_tpu_torch.convert import map_jax_tree
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.ops import flash_attention as fa
from e2_tts_tpu_torch.ops.attention import attention_packed
from e2_tts_tpu_torch.ops.dropout import fold_batch_offset, fold_seq_offset, hash_keep
from e2_tts_tpu_torch.ops.geglu_kernel import geglu_dropout_backward_plain, geglu_dropout_plain
from e2_tts_tpu_torch.parallel import sp
from e2_tts_tpu_torch.text.tokenizer import resolve_tokenizer
from e2_tts_tpu_torch.training import trainer as trainer_module

B, N = 4, 44                       # 48 packed rows with SMALL_TF's 4 registers
LENS = np.array([44, 17, 33, 26], np.int64)
TEXTS = ['hello there', 'ok', 'a longer line of text', 'hi']
CONFIG = dict(SMALL_TF, dropout=0.1)
FREQ = dict(num_freq_tokens=2)
K31 = dict(CONFIG, kernel_size=31)
VELOCITY = 0.5
CLIP = 1e-3                        # below the grad norm of every step: the clip acts
LOSS_TOL, PARAM_TOL = 1e-5, 1e-6
GRAD_TOL = 1e-5                    # the port's grads against its single device
JAX_LOSS_RTOL, JAX_GRAD_TOL = 2e-5, 2e-4
RING_TOL, JAX_RING_GRAD_TOL = 1e-5, 2e-4
GRAD_SHAPES = ((1, 2), (2, 2), (1, 4))
FAULTS = ('offsets0', 'no_halo', 'local_rotary', 'local_span')


def _batch():
    mel = np.random.default_rng(0).standard_normal((B, N, 100)).astype(np.float32)
    text = np.asarray(resolve_tokenizer('char_utf8', None)[0](TEXTS))
    return mel, text


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


MEL, TEXT = _batch()
TWO = [dict(mel=MEL, lens=LENS, text=TEXT, drop=drop) for drop in (False, True)]


def single(config, *, velocity_weight=0.0, save_to=None):
    """The single-device trainer over TWO: losses, the state after the first
    step (saved to ``save_to`` when given) and the final state."""
    trainer = make_trainer(build_model(config, velocity_weight=velocity_weight),
                           max_grad_norm=CLIP, checkpoint_path=save_to)
    losses = run_steps(trainer, TWO[:1])
    mid = full_state(trainer)
    if save_to:
        trainer.save_checkpoint(1)
    losses += run_steps(trainer, TWO[1:])
    return dict(losses=np.asarray(losses), mid=mid, final=full_state(trainer))


def _prefixed(result, prefix):
    return {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}


def gaps(result, ref) -> dict:
    """The largest relative loss gap and the largest absolute gap of any
    parameter or EMA weight, against the reference after as many steps
    (``final``; after one step ``mid``)."""
    params = _prefixed(result, 'final.')
    want = ref['final'] if len(result['losses']) == len(ref['losses']) else ref['mid']
    worst = max(float(np.abs(params[k] - want[k]).max()) for k in want
                if k.split('.')[0] in ('param', 'ema'))
    steps = len(result['losses'])
    losses = np.abs(result['losses'] - ref['losses'][:steps]) / np.abs(ref['losses'][:steps])
    return dict(loss=float(losses.max()), param=worst)


def holds(result, ref) -> bool:
    g = gaps(result, ref)
    return g['loss'] <= LOSS_TOL and g['param'] <= PARAM_TOL


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread in this process (restored after): the ranks and
    the other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both spawns' tasks and every reference: the single device's steps
    (the checkpointed run first: the (2, 2) ranks resume from it), the JAX
    dense loss and grads (its weights written for the ranks), the single
    device's grads from those weights, with two frequency tokens and with
    kernel 31, and the velocity teacher's steps."""
    tmp = tmp_path_factory.mktemp('sp')
    jax_state = str(tmp / 'jax_state.npz')
    key = jax.random.key(100)
    grad_step = dict(mel=MEL, lens=LENS, text=TEXT, drop=False, **_draws(key))
    grad_steps = write_steps(str(tmp / 'grad_step.npz'), [grad_step])
    two, first, last = (write_steps(str(tmp / f'{n}.npz'), s) for n, s in (
        ('two', TWO), ('first', TWO[:1]), ('last', TWO[1:])))

    def task(name, shape, steps=two, **kw):
        return dict(kind='steps', sharding='replicated', config=CONFIG, steps=steps, sp=shape,
                    trainer=dict(max_grad_norm=CLIP), out=str(tmp / name), **kw)

    def grads(name, shape, **kw):
        return dict(kind='sp_grads', sp=shape, steps=grad_steps, out=str(tmp / name), **kw)
    two_rank = ([task('sp1x2', (1, 2), trainer_builds_mesh=True, save_after=1,
                      save_to=str(tmp / 'sp_ckpt'))]
                + [task(f, (1, 2), steps=first, fault=f) for f in FAULTS]
                + [task('velocity', (1, 2), velocity_weight=VELOCITY),
                   grads('grads1x2', (1, 2), config=SMALL_TF, jax_state=jax_state),
                   grads('freq', (1, 2), config=CONFIG, model_kw=FREQ),
                   grads('k31', (1, 2), config=K31)])
    four_rank = [task('sp2x2', (2, 2)), task('sp1x4', (1, 4)),
                 dict(task('fsdp2x2', (2, 2)), sharding='fsdp'),
                 task('resume2x2', (2, 2), steps=last, resume_from=str(tmp / 'single_ckpt')),
                 grads('grads2x2', (2, 2), config=SMALL_TF, jax_state=jax_state),
                 grads('grads1x4', (1, 4), config=SMALL_TF, jax_state=jax_state),
                 dict(kind='sp_errors', sp=(1, 4), config=CONFIG, steps=two,
                      out=str(tmp / 'errors'))]
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
        loss, g = _jax_loss_and_grads(j, jnp.asarray(MEL), jnp.asarray(LENS), jnp.asarray(TEXT),
                                      key)
        refs['jax'] = dict(loss=float(loss), grads=flat_values(g))
        refs['grads'] = forward_grads(build_model(SMALL_TF, jax_state=jax_state), grad_step)
        refs['freq'] = forward_grads(build_model(CONFIG, **FREQ), grad_step)
        refs['k31'] = forward_grads(build_model(K31), grad_step)
        refs['velocity'] = single(CONFIG, velocity_weight=VELOCITY)
    finally:
        for spawn in spawns:
            spawn.join()
    names = [t['out'].rsplit('/', 1)[1] for t in two_rank + four_rank]
    port = {name: dict(np.load(tmp / name / 'result.npz')) for name in names}
    return dict(refs=refs, port=port, tmp=tmp)


# -- the ring ----------------------------------------------------------------------------

def _ring_inputs(P, heads, dh, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, n = 2, 16 * P
    D = heads * dh
    q, k, v = (torch.randn(b, n, D, generator=g) for _ in range(3))
    gate = 2 * torch.randn(b, n, heads, generator=g)
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, n // P - 3:] = False                # row 1's later shards wholly masked
    mask[0, 5] = False
    return q, k, v, gate, mask


@pytest.mark.parametrize('dh', [64, 16, 72], ids=lambda d: f'dh{d}')
@pytest.mark.parametrize('P', [2, 4])
@pytest.mark.parametrize('laser', [False, True], ids=['plain', 'laser'])
def test_ring_matches_dense_attention(P, dh, laser):
    """`attention_packed` routed over a `Loopback` of P shards (the ring) is
    the dense `attention_packed`: out and the grads of q, k, v and the gate
    logits within 1e-5, with a mask whose row 1 has wholly masked shards,
    softclamp 50, dropout 0.1 and the gate (LASER too); heads of 64 run K1 /
    K2's plain versions, of 16 and 72 K8 / K9's."""
    heads = 2
    q, k, v, gate, mask = _ring_inputs(P, heads, dh)
    kw = dict(heads=heads, softclamp_value=50.0, laser=laser, dropout_rate=0.1,
              dropout_seed=1234, hash_b0=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, gate)]
    refs = [t.clone().requires_grad_() for t in (q, k, v, gate)]
    out = attention_packed(*leaves[:3], mask, gate_logits=leaves[3], sp_mesh=sp.Loopback(P), **kw)
    ref = attention_packed(*refs[:3], mask, gate_logits=refs[3], **kw)
    torch.testing.assert_close(out, ref, atol=RING_TOL, rtol=0)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    (out * w).sum().backward()
    (ref * w).sum().backward()
    for a, r, name in zip(leaves, refs, 'q k v gate'.split()):
        torch.testing.assert_close(a.grad, r.grad, atol=RING_TOL, rtol=0, msg=name)


@pytest.mark.parametrize('P', [2, 4])
def test_ring_block_keep_bits_are_the_dense_slices(P):
    """The keep mask a ring block draws at its ``hash_r0`` / ``hash_c0`` (with
    ``hash_b0``) is that block of the dense mask, bit for bit; at offsets 0
    (the planted fault) it is not, off the diagonal."""
    b, heads, n, seed, b0 = 2, 3, 8 * P, 77, 5
    nl = n // P
    dense = fa.dropout_keep_mask(seed, b * heads, n, 0.1, hash_b0=b0, heads=heads)
    for s in range(P):
        for o in range(P):
            block = fa.dropout_keep_mask(seed, b * heads, nl, 0.1, hash_b0=b0, heads=heads,
                                         hash_r0=s * nl, hash_c0=o * nl)
            assert torch.equal(block, dense[:, s * nl:(s + 1) * nl, o * nl:(o + 1) * nl])
            if s or o:
                zero = fa.dropout_keep_mask(seed, b * heads, nl, 0.1, hash_b0=b0, heads=heads)
                assert not torch.equal(zero, block)


def test_ring_matches_jax_ring_attention():
    """The port's ring (per data shard: a `Loopback` of 4, ``hash_b0`` the
    shard's first row) against JAX `ring_attention` on `make_seq_mesh(seq=4,
    data=2)`, mask and dropout 0.1 with the same uint32 seed: out within
    1e-5, the grads of q, k, v within 2e-4."""
    b, heads, n, dh, seed = 4, 2, 64, 32, 4321
    rng = np.random.default_rng(3)
    q, k, v, w = (rng.standard_normal((b, n, heads * dh)).astype(np.float32) for _ in range(4))
    mask = rng.random((b, n)) > 0.2
    mask[:, :4] = True
    mesh = jax_make_seq_mesh(seq=4, data=2)
    put = lambda x: jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec('data', 'seq')))

    def jax_loss(q, k, v, m):
        o = jax_ring_attention(q, k, v, m, mesh=mesh, heads=heads, dropout_rate=0.1,
                               dropout_seed=jnp.asarray([seed], jnp.int32))
        return (o * jnp.asarray(w)).sum(), o
    (_, j_out), j_grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
        *(jax_shard_sequence(jnp.asarray(t), mesh) for t in (q, k, v)), put(mask))
    half = b // 2
    for d in range(2):
        rows = slice(d * half, (d + 1) * half)
        leaves = [torch.from_numpy(t[rows]).requires_grad_() for t in (q, k, v)]
        out = sp.ring_attention(*leaves, torch.from_numpy(mask[rows]), mesh=sp.Loopback(4),
                                heads=heads, dropout_rate=0.1, dropout_seed=seed,
                                hash_b0=d * half)
        (out * torch.from_numpy(w[rows])).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out)[rows],
                                   atol=RING_TOL, rtol=0)
        for leaf, jg in zip(leaves, j_grads):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg)[rows],
                                       atol=JAX_RING_GRAD_TOL, rtol=JAX_RING_GRAD_TOL)


def test_ring_divisibility_raises():
    """A sequence the seq axis does not divide raises the JAX package's
    ValueError."""
    q = torch.zeros(1, 10, 64)
    with pytest.raises(ValueError, match='not divisible by the `seq` mesh axis'):
        sp.ring_attention(q, q, q, mesh=sp.Loopback(4), heads=2)


def test_geglu_sequence_fold_is_the_slice():
    """`fold_seq_offset`: K6 / K7's plain versions on a rank's frames from
    t0 (rows from b0 folded too) under the folded seed draw the whole
    sequence's bits; unfolded they do not."""
    g = torch.Generator().manual_seed(1)
    b, n, inner, P, b0, seed, rate = 3, 12, 16, 3, 4, 4321, 0.1
    h2, gout = torch.randn(b, n, 2 * inner, generator=g), torch.randn(b, n, inner, generator=g)
    act = geglu_dropout_plain(h2, seed, rate)
    grad = geglu_dropout_backward_plain(h2, gout, seed, rate)
    nl = n // P
    for s in range(P):
        rows = slice(s * nl, (s + 1) * nl)
        folded = fold_seq_offset(seed, s * nl)
        assert torch.equal(geglu_dropout_plain(h2[:, rows], folded, rate), act[:, rows])
        assert torch.equal(geglu_dropout_backward_plain(h2[:, rows], gout[:, rows], folded, rate),
                           grad[:, rows])
        if s:
            assert not torch.equal(geglu_dropout_plain(h2[:, rows], seed, rate), act[:, rows])
    both = fold_seq_offset(fold_batch_offset(seed, b0), nl)
    whole = hash_keep((b0 + b, n, inner), seed, rate)
    assert torch.equal(hash_keep((b, nl, inner), both, rate), whole[b0:, nl:2 * nl])


# -- routing, the sampler ----------------------------------------------------------------

def test_routing_counts_and_sample_pauses():
    """`enable_sequence_parallel` routes the speech and text attentions, not
    the frequency attentions or the duration predictor's; a sample of the
    routed model is bit for bit the dense one's, and the routing is back
    afterwards; `disable_sequence_parallel` counts every attention."""
    model = E2TTS(transformer=dict(CONFIG), num_freq_tokens=2,
                  duration_predictor=dict(transformer=dict(SMALL_TF)), device='cpu').eval()
    prompt = torch.randn(1, 10, 100, generator=torch.Generator().manual_seed(2))

    def sample():
        return model.sample(prompt, text=['hi there'], duration=20, steps=3,
                            generator=torch.Generator().manual_seed(1))
    dense = sample()
    loop = sp.Loopback(2)
    assert sp.enable_sequence_parallel(model, loop) == 4
    routed = sample()
    assert torch.equal(routed, dense)
    assert model.transformer.speech_layers[1].attn.sp_mesh is loop
    assert model.transformer.speech_layers[0].freq_attn.sp_mesh is None
    assert model.duration_predictor.transformer.speech_layers[0].attn.sp_mesh is None
    assert sp.disable_sequence_parallel(model) == 4 + 2 + 4
    assert model.transformer.speech_layers[1].attn.sp_mesh is None


# -- the model against the single device and JAX -------------------------------------------

def _grads(result):
    return {k[len('grad.'):]: v for k, v in result.items() if k.startswith('grad.')}


@pytest.mark.parametrize('shape', GRAD_SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_forward_loss_and_grads_match_single_device_and_jax(runs, shape):
    """The routed model's loss and every grad (summed over data x seq) are the
    port's single device's (1e-5) and the JAX dense model's (2e-5 / 2e-4)."""
    got, ref, j = runs['port'][f'grads{shape[0]}x{shape[1]}'], runs['refs']['grads'], \
        runs['refs']['jax']
    np.testing.assert_allclose(float(got['loss']), float(ref['loss']), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(got['loss']), j['loss'], rtol=JAX_LOSS_RTOL)
    grads, want = _grads(got), _grads(ref)
    mapped = map_jax_tree(j['grads'], {name: g.shape for name, g in grads.items()})
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], atol=GRAD_TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(g, mapped[name], atol=JAX_GRAD_TOL, rtol=JAX_GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize('case', ['freq', 'k31'])
def test_frequency_tokens_and_wide_conv_match_single_device(runs, case):
    """Two frequency tokens (the frequency attention on each shard's frames)
    and a conv of kernel 31 (a halo of 15), dropout 0.1, at (1, 2)."""
    got, ref = runs['port'][case], runs['refs'][case]
    np.testing.assert_allclose(float(got['loss']), float(ref['loss']), rtol=LOSS_TOL)
    want = _grads(ref)
    for name, g in _grads(got).items():
        np.testing.assert_allclose(g, want[name], atol=GRAD_TOL, rtol=0, err_msg=name)


# -- the trainer against the single device -----------------------------------------------

@pytest.mark.parametrize('name', ['sp1x2', 'sp2x2', 'sp1x4', 'fsdp2x2'])
def test_sp_steps_match_single_device(runs, name):
    """Two clip + ADOPT + EMA steps, with text then text dropped, dropout 0.1:
    `E2Trainer(sequence_parallel=2)` and the (2, 2), (1, 4) and FSDP (2, 2)
    meshes hold the losses to 1e-5 and every parameter and EMA weight to
    1e-6."""
    g = gaps(runs['port'][name], runs['refs']['main'])
    assert g['loss'] <= LOSS_TOL and g['param'] <= PARAM_TOL, g


def test_velocity_teacher_matches_single_device(runs):
    """The velocity-consistency teacher (the routed EMA copy) in the second
    step, at (1, 2)."""
    g = gaps(runs['port']['velocity'], runs['refs']['velocity'])
    assert g['loss'] <= LOSS_TOL and g['param'] <= PARAM_TOL, g


@pytest.mark.parametrize('fault', FAULTS)
def test_planted_faults_fail(runs, fault):
    """Ring blocks hashing from row and column 0, convs without the halo,
    rotary tables from each shard's own positions and a shard's own span
    count each break the match after the first step."""
    g = gaps(runs['port'][fault], runs['refs']['main'])
    assert g['loss'] > 10 * LOSS_TOL or g['param'] > 100 * PARAM_TOL, g


def test_errors(runs):
    """An indivisible batch raises the JAX trainer's ValueError; a shard of 12
    rows under a halo of 15 raises the port's."""
    errors = runs['port']['errors']
    assert 'needs (frames + num_registers) divisible by the seq axis' in str(errors['batch'])
    assert '47' in str(errors['batch'])
    assert 'shorter than the depthwise conv\'s halo of 15' in str(errors['halo'])


def test_trainer_checks_its_mesh():
    """Without a process group, ``sequence_parallel=2`` cannot divide a world
    of one; a mesh that is not a DeviceMesh raises."""
    model = E2TTS(transformer=dict(SMALL_TF), device='cpu')
    with pytest.raises(ValueError, match='must divide the number of ranks'):
        trainer_module.E2Trainer(model, sequence_parallel=2)
    with pytest.raises(RuntimeError, match='process group'):
        sp.make_seq_mesh(2)


# -- checkpoints ---------------------------------------------------------------------------

def _assert_state_equal(got: dict, want: dict, label: str):
    assert set(got) == set(want), label
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f'{label} {key}')


def test_sp_checkpoint_resumes_on_one_device(runs):
    """The (1, 2) run's checkpoint after one step loads into one process bit
    for bit (parameters, EMA, ADOPT, counters); its next step there is the
    run's."""
    trainer = make_trainer(build_model(CONFIG, seed=5), max_grad_norm=CLIP,
                           checkpoint_path=str(runs['tmp'] / 'sp_ckpt'))
    assert trainer.resume() == 1
    port = runs['port']['sp1x2']
    _assert_state_equal(full_state(trainer), _prefixed(port, 'saved.'), 'resumed')
    result = dict(losses=np.asarray(run_steps(trainer, TWO[1:])),
                  **{f'final.{k}': v for k, v in full_state(trainer).items()})
    assert holds(result, dict(losses=port['losses'][1:], final=_prefixed(port, 'final.')))


def test_single_device_checkpoint_resumes_on_sp(runs):
    """One process's checkpoint after one step, resumed by (2, 2) ranks, is
    its state bit for bit, and their next step the single device's."""
    got, ref = runs['port']['resume2x2'], runs['refs']['main']
    assert int(got['resumed_step']) == 1
    _assert_state_equal(_prefixed(got, 'resumed.'), ref['mid'], 'resumed')
    assert holds(got, dict(losses=ref['losses'][1:], final=ref['final']))
