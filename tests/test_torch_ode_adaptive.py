"""The port's adaptive ODE solvers (dopri5, bosh3, fehlberg2, adaptive_heun)
against the JAX package's on the CPU, and `E2TTS.sample` with dopri5.

Both sides record every evaluation of the vector field (JAX through an
ordered `jax.debug.callback` inside its `lax.while_loop`). A trial step
evaluates every stage, so the first stage's time of each trial gives the
accepted and rejected steps (a trial was rejected when the next one
starts where it started), and the port's calls must give JAX's counts,
with the same number of evaluations. Problems are the JAX package's own
(tests/test_models.py): the harmonic oscillator over one period at
atol = rtol = 1e-6, exponential decay over a grid at the default 1e-5,
the stiff y' = -50 (y - cos t), the NaN field that saturates the step cap
(the cap cut to 60 on both sides so the test is quick), and a field that
is NaN on a window of time, which the controller must step past as JAX's
does.

The step counts are held where the embedded error estimate stands above
f32 rounding. At the JAX test's atol = rtol = 1e-8 on the stiff problem
it does not: the estimate is a difference of stages equal to f32
rounding, a last-bit difference in one step's size (XLA's reductions and
`pow` are not torch's) changes it, and the sides then take other trial
steps (dopri5 there: 126 accepted both, 5 and 4 rejected). There the
outputs and the accepted count are held; the counts of every method on
the stiff problem are held at 1e-4.

Tolerances (f32): outputs and trajectories within 1e-6 of JAX's on the
short integrations (decay, the NaN window: 2.4e-7 at most); over the long
ones the step sizes drift apart by f32 ulps and the results move within
the solvers' own error: 2e-6 over the oscillator's period (1.5e-6 for
adaptive_heun's 3,246 steps), 2e-6 + 1e-5 |y| on the stiff problem (4.2e-6
at most, fehlberg2 at 1e-4); the evaluation times within 1e-3; the
sampler within 1e-4 of JAX's, as the fixed-grid sampler in
tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import e2_tts_tpu.ops.ode as jode
from e2_tts_tpu.models.e2tts import E2TTS as JaxE2TTS

from _torch_port_helpers import SMALL_TF, flat_state, perturb
from e2_tts_tpu_torch.convert import load_jax_params
from e2_tts_tpu_torch.models.e2tts import E2TTS
from e2_tts_tpu_torch.ops import ode

METHODS = ['dopri5', 'bosh3', 'fehlberg2', 'adaptive_heun']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: as fast alone at these widths, and it does not
    stall when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
STAGES = dict(dopri5=7, bosh3=4, fehlberg2=3, adaptive_heun=2)


def _window_nan(lo, hi):
    return (lambda t, y: jnp.where((t >= lo) & (t < hi), jnp.nan, -y),
            lambda t, y: -y * (float('nan') if lo <= t < hi else 1.0))


def _stiff():
    return (lambda t, y: -50.0 * (y - jnp.cos(t)),
            lambda t, y: -50.0 * (y - float(jnp.cos(t))), [0.0], np.linspace(0.0, 1.0, 2))


# name: (JAX field, port field, y0, grid, atol, rtol)
PROBLEMS = {
    'oscillator': (lambda t, y: jnp.stack([y[1], -y[0]]),
                   lambda t, y: torch.stack([y[1], -y[0]]),
                   [1.0, 0.0], np.linspace(0.0, 2.0 * np.pi, 2), 1e-6, 1e-6),
    'stiff': (*_stiff(), 1e-4, 1e-4),
    'stiff_tight': (*_stiff(), 1e-8, 1e-8),
    'decay': (lambda t, y: -y, lambda t, y: -y, [1.0, 1.0, 1.0], np.linspace(0.0, 1.0, 4),
              None, None),
    'nan_window': (*_window_nan(0.05, 0.0505), [1.0, 2.0], np.linspace(0.0, 1.0, 3), 1e-5, 1e-5),
}
# name: the output's (rtol, atol) against JAX's
OUT_TOL = {'decay': (0.0, 1e-6), 'nan_window': (0.0, 1e-6), 'oscillator': (0.0, 2e-6),
           'stiff': (1e-5, 2e-6)}


def _run_jax(problem, method, return_trajectory=False):
    fj, _, y0, grid, atol, rtol = PROBLEMS[problem]
    calls = []

    def fn(t, y):
        jax.debug.callback(lambda tt: calls.append(float(tt)), t, ordered=True)
        return fj(t, y)

    out = jode.odeint(fn, jnp.asarray(y0, jnp.float32), jnp.asarray(grid, jnp.float32),
                      method=method, atol=atol, rtol=rtol, return_trajectory=return_trajectory)
    return np.asarray(out), calls


def _run_port(problem, method, return_trajectory=False):
    _, fp, y0, grid, atol, rtol = PROBLEMS[problem]
    calls = []

    def fn(t, y):
        assert isinstance(t, np.float32)
        calls.append(float(t))
        return fp(t, y)

    out = ode.odeint(fn, torch.tensor(y0, dtype=torch.float32), np.asarray(grid, np.float32),
                     method=method, atol=atol, rtol=rtol, return_trajectory=return_trajectory)
    return out.numpy(), calls


def _step_counts(calls, stages):
    """(accepted, rejected) from the first stage's time of each trial."""
    assert len(calls) % stages == 0
    starts = calls[::stages]
    rejected = sum(a == b for a, b in zip(starts[:-1], starts[1:]))
    return len(starts) - rejected, rejected


@pytest.mark.parametrize('problem', ['decay', 'nan_window', 'oscillator', 'stiff'])
@pytest.mark.parametrize('method', METHODS)
def test_adaptive_matches_jax(method, problem):
    out_j, calls_j = _run_jax(problem, method)
    out_p, calls_p = _run_port(problem, method)
    rtol, atol = OUT_TOL[problem]
    np.testing.assert_allclose(out_p, out_j, rtol=rtol, atol=atol)
    assert np.isfinite(out_p).all()
    assert len(calls_p) == len(calls_j), (len(calls_p), len(calls_j))
    np.testing.assert_allclose(calls_p, calls_j, rtol=0, atol=1e-3)
    accepted, rejected = _step_counts(calls_j, STAGES[method])
    assert _step_counts(calls_p, STAGES[method]) == (accepted, rejected)
    assert accepted >= len(PROBLEMS[problem][3]) - 1
    if problem == 'nan_window':
        assert rejected > 0                  # the window forced rejections


def test_stiff_tight_tolerance_matches_jax():
    """The JAX test's dopri5 at atol = rtol = 1e-8: within 1e-6 of JAX's
    output and 1e-5 of a 4000-step rk4, with JAX's accepted steps."""
    out_j, calls_j = _run_jax('stiff_tight', 'dopri5')
    out_p, calls_p = _run_port('stiff_tight', 'dopri5')
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=1e-6)
    fj, fp, y0, _, _, _ = PROBLEMS['stiff_tight']
    ref = ode.odeint(fp, torch.tensor(y0), np.linspace(0, 1, 4001, dtype=np.float32),
                     method='rk4')
    np.testing.assert_allclose(out_p, ref.numpy(), rtol=0, atol=1e-5)
    assert (_step_counts(calls_p, STAGES['dopri5'])[0]
            == _step_counts(calls_j, STAGES['dopri5'])[0])


@pytest.mark.parametrize('method', METHODS)
def test_trajectory_matches_jax(method):
    traj_j, _ = _run_jax('decay', method, return_trajectory=True)
    traj_p, _ = _run_port('decay', method, return_trajectory=True)
    assert traj_p.shape == traj_j.shape == (4, 3)
    np.testing.assert_allclose(traj_p, traj_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(traj_p[0], np.ones(3))
    # fehlberg2's low-order estimate lets it drift furthest: 1.1e-3 here
    np.testing.assert_allclose(traj_p[-1], np.exp(-1.0) * np.ones(3), rtol=2e-3)


@pytest.mark.parametrize('method', ['midpoint', 'rk4'])
def test_fixed_grid_trajectory_matches_jax(method):
    y0, t = np.ones(2, np.float32), np.linspace(0.0, 1.0, 5, dtype=np.float32)
    jt = jode.odeint(lambda s, y: -y * s, jnp.asarray(y0), jnp.asarray(t), method=method,
                     return_trajectory=True)
    pt = ode.odeint(lambda s, y: -y * float(s), torch.from_numpy(y0), t, method=method,
                    return_trajectory=True)
    assert pt.shape == (5, 2)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)


def test_step_cap_fills_nan_as_jax(monkeypatch):
    """The JAX test's field, NaN past t = 0.5: the second interval's trials
    are rejected until h falls below t's ulp (where a step that does not
    move t passes), then the cap ends it, and the result is NaN on both
    sides after the same trial steps."""
    monkeypatch.setattr(jode, '_MAX_ADAPTIVE_STEPS', 60)
    monkeypatch.setattr(ode, '_MAX_ADAPTIVE_STEPS', 60)
    fj = lambda t, y: jnp.where(t > 0.5, jnp.nan, -y)
    fp = lambda t, y: -y * (float('nan') if t > 0.5 else 1.0)
    calls_j, calls_p = [], []

    def fn_j(t, y):
        jax.debug.callback(lambda tt: calls_j.append(float(tt)), t, ordered=True)
        return fj(t, y)

    def fn_p(t, y):
        calls_p.append(float(t))
        return fp(t, y)

    grid = np.linspace(0.0, 1.0, 3, dtype=np.float32)
    out_j = np.asarray(jode.odeint(fn_j, jnp.ones(3), jnp.asarray(grid), method='bosh3'))
    out_p = ode.odeint(fn_p, torch.ones(3), grid, method='bosh3').numpy()
    assert np.isnan(out_j).all() and np.isnan(out_p).all()
    assert len(calls_p) == len(calls_j)
    np.testing.assert_allclose(calls_p, calls_j, rtol=0, atol=1e-3)
    trials = len(calls_p) // 4
    assert 0 < trials - 60 < 60                     # the first interval finished


def test_state_dtype_kept_and_f32_inside():
    """A bf16 state integrates in f32 inside each interval and comes back
    bf16; the field sees the f32 state."""
    seen = []

    def fn(t, y):
        seen.append(y.dtype)
        return -y

    out = ode.odeint(fn, torch.ones(3, dtype=torch.bfloat16), [0.0, 0.5, 1.0], method='dopri5')
    assert out.dtype == torch.bfloat16
    assert set(seen) == {torch.float32}
    np.testing.assert_allclose(out.float().numpy(), np.exp(-1.0), rtol=1e-2)


@pytest.fixture(scope='module')
def e2tts_pair():
    odeint_kwargs = dict(method='dopri5', atol=1e-5, rtol=1e-5)
    j = perturb(JaxE2TTS(transformer=dict(SMALL_TF), use_vocos=False,
                         odeint_kwargs=odeint_kwargs, rngs=nnx.Rngs(0)), seed=8)
    j.eval()
    p = E2TTS(transformer=dict(SMALL_TF), odeint_kwargs=odeint_kwargs, device='cpu')
    load_jax_params(p, flat_state(j))
    return j, p.eval()


def test_sample_dopri5_matches_jax(e2tts_pair):
    """`E2TTS.sample` with dopri5 at the model's atol = rtol = 1e-5; the
    port's noise is JAX's own y0 draw. The port's sampler passes atol /
    rtol on: at the solver's default it would take other steps."""
    j, p = e2tts_pair
    rng = np.random.default_rng(10)
    prompt = rng.standard_normal((2, 12, 100)).astype(np.float32)
    texts = ['hello', 'a longer one']
    key = jax.random.key(11)
    kw = dict(text=texts, duration=24, steps=3, cfg_strength=1.0, duration_bucket=32)
    jo = j.sample(jnp.asarray(prompt), key=key, return_raw_output=True, **kw)
    noise = np.array(jax.random.normal(key, (2, 32, 100), dtype=jnp.float32))
    po = p.sample(torch.from_numpy(prompt), noise=torch.from_numpy(noise),
                  return_raw_output=True, **kw)
    assert po.shape == jo.shape == (2, 24, 100)
    assert torch.isfinite(po).all()
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(po[:, :12].numpy(), prompt)
