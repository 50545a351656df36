"""A backbone built with ``scan_layers`` under tensor parallelism and FSDP, and
the plain (``glu=False``) feedforward under tensor parallelism, on two gloo
ranks (tests/_torch_parallel_worker.py) against the port's single device,
as tests/test_parallel.py holds the JAX package's scan model on a mesh.

The scan mode keeps the unrolled per-layer modules (its groups are
recomputed in the backward), so `parallel.tp.shard_module_tp` and FSDP2 act
on them as on the unrolled model. SMALL_TF widths at depth 6 (two scan
groups of two), dropout 0.1, every weight perturbed off its init (the JAX
scan model's weights, written for the ranks, for the grads); two
`E2Trainer.train_step`s (with text, then text dropped) with a clip that
acts, ADOPT and the EMA, at mesh (1, 2), and over ``data`` = 2 with
``param_sharding='fsdp'``; one loss and backward at (1, 2) (every grad
summed and gathered to the single-device layout); the plain feedforward's
``proj_in`` is cut as one segment (no value and gate halves), two steps at
(1, 2) at depth 2.

Tolerances: each loss within 1e-5 of the single device's (relative) and,
after the steps, every parameter and EMA weight within 1e-6 (absolute), as
tests/test_torch_tp.py, except the scan model's steps under tensor
parallelism: there ADOPT's second step, ``atan2(g1, |g0|)`` a weight, turns
the rounding of a grad at its floor into up to 1e-4 of movement, and one
weight of the last layer's feedforward output projection lands 2.6e-6 off
(the unrolled depth-6 model the same);
so that run is held on its losses, and the grads of one backward at (1, 2)
to the limits of tests/_torch_options_helpers.py (1e-3 relative plus 1e-4
of each tensor's largest |grad|: the hyper-connections' scalar scales and
small dynamic weights are sums over every token that move with the sums'
order).
"""

import os

import numpy as np
import pytest
import torch
from flax import nnx

from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS

from _torch_parallel_worker import Ranks, build_model, full_state, make_trainer, run_steps, \
    write_steps
from _torch_port_helpers import SMALL_TF, flat_state, perturb_np
from e2_tts_tpu_torch.text.tokenizer import resolve_tokenizer

B, N = 4, 40
TEXTS = ['hello there', 'ok', 'a longer line of text', 'hi']
LENS = np.array([40, 17, 33, 26], np.int64)
SCAN = dict(SMALL_TF, depth=6, dropout=0.1, scan_layers=True)
MLP = dict(SMALL_TF, dropout=0.1, ff_kwargs=dict(glu=False))
CLIP = 1e-3                     # below the grad norm of every step: the clip acts
LOSS_TOL, PARAM_TOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3     # of each tensor's largest |grad|; relative


def _steps():
    mel = np.random.default_rng(0).standard_normal((B, N, 100)).astype(np.float32)
    ids = np.asarray(resolve_tokenizer('char_utf8', None)[0](TEXTS))
    return [dict(mel=mel, lens=LENS, text=ids, drop=drop) for drop in (False, True)]


def _grad_step():
    """The first step with its draws (span, x0, t) made here."""
    rng = np.random.default_rng(1)
    frames = np.arange(N)[None]
    span = (frames >= 3) & (frames < LENS[:, None] - 2)
    return dict(_steps()[0], times=rng.uniform(size=B).astype(np.float32),
                noise=rng.standard_normal((B, N, 100)).astype(np.float32), rand_span_mask=span)


def _single(config) -> dict:
    trainer = make_trainer(build_model(config), max_grad_norm=CLIP)
    return dict(losses=np.asarray(run_steps(trainer, _steps())), final=full_state(trainer))


def _single_grads(jax_state: str) -> dict:
    """One loss and backward of the single device, as the ranks' ``grads``
    task makes it (the model's own generator draws the dropout seeds)."""
    model = build_model(SCAN, jax_state=jax_state)
    step = {k: torch.as_tensor(v) for k, v in _grad_step().items() if k != 'drop'}
    out = model(step['mel'], text=step['text'].long(), lens=step['lens'].long(),
                times=step['times'], noise=step['noise'], rand_span_mask=step['rand_span_mask'],
                drop_text_cond=False, batch_offset=0, global_batch=B)
    out.loss.backward()
    return dict(loss=out.loss.detach().numpy(),
                **{f'grad.{n}': p.grad.numpy() for n, p in model.named_parameters()})


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('scan_parallel')
    torch.set_num_threads(1)
    steps = write_steps(str(tmp / 'two.npz'), _steps())
    grad_step = write_steps(str(tmp / 'grad_step.npz'), [_grad_step()])
    jax_state = str(tmp / 'jax_state.npz')

    def task(name, config, **kw):
        return dict(dict(kind='steps', sharding='replicated', config=config, steps=steps,
                         trainer=dict(max_grad_norm=CLIP), out=str(tmp / name)), **kw)
    tasks = [task('scan_tp', SCAN, tp=(1, 2)), task('scan_fsdp', SCAN, sharding='fsdp'),
             task('mlp_tp', MLP, tp=(1, 2)),
             dict(kind='grads', tp=(1, 2), config=SCAN, steps=grad_step, jax_state=jax_state,
                  out=str(tmp / 'scan_tp_grads'))]
    spawn = Ranks(2, tasks, tmp)
    try:
        # built under nnx.jit: one compile instead of an eager init op by op
        j = perturb_np(nnx.jit(lambda: JaxE2TTS(transformer=dict(SCAN, attn_backend='xla'),
                                                use_vocos=False, rngs=nnx.Rngs(0)))(), seed=9)
        np.savez(str(tmp / 'jax_state.tmp.npz'), **flat_state(j))
        os.replace(tmp / 'jax_state.tmp.npz', jax_state)       # whole, for the waiting ranks
        refs = dict(scan=_single(SCAN), mlp=_single(MLP), grads=_single_grads(jax_state))
    finally:
        spawn.join()
    return dict(refs=refs, port={t['out'].rsplit('/', 1)[1]: dict(np.load(f"{t['out']}/result.npz"))
                                 for t in tasks})


@pytest.mark.parametrize('name,ref,params', [('scan_tp', 'scan', False),
                                             ('scan_fsdp', 'scan', True),
                                             ('mlp_tp', 'mlp', True)])
def test_two_ranks_match_single_device(runs, name, ref, params):
    got, want = runs['port'][name], runs['refs'][ref]
    np.testing.assert_allclose(got['losses'], want['losses'], rtol=LOSS_TOL)
    for key, value in want['final'].items():
        if params and key.split('.')[0] in ('param', 'ema'):
            np.testing.assert_allclose(got[f'final.{key}'], value, rtol=0, atol=PARAM_TOL,
                                       err_msg=f'{name} {key}')


def test_scan_tp_grads_match_single_device(runs):
    got, want = runs['port']['scan_tp_grads'], runs['refs']['grads']
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=LOSS_TOL)
    names = [k for k in want if k.startswith('grad.')]
    assert sorted(names) == sorted(k for k in got if k.startswith('grad.'))
    for key in names:
        g = want[key]
        np.testing.assert_allclose(got[key], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(g).max()), err_msg=key)
