"""ODE integrators (counterpart of e2_tts_tpu/ops/ode.py).

`odeint(fn, y0, t, method=...)` mirrors the torchdiffeq call the reference
makes (for E2TTS over linspace(0, 1, steps)); ``atol`` / ``rtol`` apply to
the adaptive methods and are ignored by the fixed-grid ones, as in
torchdiffeq. The grid lives on the host as f32 numpy scalars, and so do
the step sizes: ``fn`` receives the time as an f32 numpy scalar. Each step
does its arithmetic in f32 — as the JAX package's f32 time scalars promote
a bf16 state — and the state returns to ``y0.dtype`` after each grid
interval.

Fixed grid: euler, midpoint, rk4, one step per grid interval.

Adaptive: dopri5, bosh3, fehlberg2 and adaptive_heun, embedded Runge-Kutta
pairs under torchdiffeq's controller: the error norm is the rms of
err / (atol + rtol * max(|y|, |y_new|)), a step is accepted when that
ratio is at most 1, and the next step is h * 0.9 * ratio^(-1/(order+1))
clamped to [0.2, 10] (10 where the ratio is at most 1e-10, 0.2 where it is
not finite, which also rejects the step). The solver integrates the grid
interval by interval, each restarting at h0 = span / 10, so the solution
lands on every grid point; every stage is evaluated (no first-same-as-last
reuse), as in the JAX package. Where the JAX package runs the trial steps
in a `lax.while_loop` on the device, here they are a host loop: each trial
step reads its error ratio on the host with one ``.item()``, a device
synchronisation per trial step. An interval that reaches
`_MAX_ADAPTIVE_STEPS` trial steps short of its end returns NaN (the JAX
package's traced stand-in for torchdiffeq's error), so truncation is
visible.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F32 = np.float32


def _euler_step(fn, t0, t1, y):
    h = t1 - t0
    return y.float() + float(h) * fn(t0, y).float()


def _midpoint_step(fn, t0, t1, y):
    h = t1 - t0
    half = y.float() + float(_F32(0.5) * h) * fn(t0, y).float()
    return y.float() + float(h) * fn(t0 + _F32(0.5) * h, half).float()


def _rk4_step(fn, t0, t1, y):
    h = t1 - t0
    half_h = _F32(0.5) * h
    yf = y.float()
    k1 = fn(t0, y).float()
    k2 = fn(t0 + half_h, yf + float(half_h) * k1).float()
    k3 = fn(t0 + half_h, yf + float(half_h) * k2).float()
    k4 = fn(t1, yf + float(h) * k3).float()
    return yf + float(h / _F32(6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)


_STEPPERS = {
    'euler': _euler_step,
    'midpoint': _midpoint_step,
    'rk4': _rk4_step,
}


# -- adaptive embedded Runge-Kutta pairs ---------------------------------------

class _Tableau:
    """Explicit embedded RK pair: c (nodes), a (strictly lower-triangular
    stage weights), b (high-order solution), b_err (b_high - b_low, the
    embedded error estimator), order of the propagated solution. Held in
    f32, the precision the steps use them in."""

    def __init__(self, c, a, b, b_err, order):
        self.c = [_F32(v) for v in c]
        self.a = [[_F32(v) for v in row] for row in a]
        self.b = [_F32(v) for v in b]
        self.b_err = [_F32(v) for v in b_err]
        self.order = order
        self.stages = len(self.c)


def _dopri5_tableau():
    c = [0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1, 1]
    a = [
        [],
        [1 / 5],
        [3 / 40, 9 / 40],
        [44 / 45, -56 / 15, 32 / 9],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
        [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
    ]
    b = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
    b_low = [5179 / 57600, 0, 7571 / 16695, 393 / 640, -92097 / 339200,
             187 / 2100, 1 / 40]
    b_err = [bh - bl for bh, bl in zip(b, b_low)]
    return _Tableau(c, a, b, b_err, order=5)


def _bosh3_tableau():
    c = [0, 1 / 2, 3 / 4, 1]
    a = [[], [1 / 2], [0, 3 / 4], [2 / 9, 1 / 3, 4 / 9]]
    b = [2 / 9, 1 / 3, 4 / 9, 0]
    b_low = [7 / 24, 1 / 4, 1 / 3, 1 / 8]
    b_err = [bh - bl for bh, bl in zip(b, b_low)]
    return _Tableau(c, a, b, b_err, order=3)


def _fehlberg2_tableau():
    c = [0, 1 / 2, 1]
    a = [[], [1 / 2], [1 / 256, 255 / 256]]
    b = [1 / 512, 255 / 256, 1 / 512]
    b_low = [1 / 256, 255 / 256, 0]
    b_err = [bh - bl for bh, bl in zip(b, b_low)]
    return _Tableau(c, a, b, b_err, order=2)


def _adaptive_heun_tableau():
    c = [0, 1]
    a = [[], [1]]
    b = [1 / 2, 1 / 2]
    b_low = [1, 0]
    b_err = [bh - bl for bh, bl in zip(b, b_low)]
    return _Tableau(c, a, b, b_err, order=2)


_ADAPTIVE_TABLEAUS = {
    'dopri5': _dopri5_tableau,
    'bosh3': _bosh3_tableau,
    'fehlberg2': _fehlberg2_tableau,
    'adaptive_heun': _adaptive_heun_tableau,
}

_MAX_ADAPTIVE_STEPS = 10_000


def _fma32(a, b, c):
    """f32 ``a * b + c`` with one rounding (host scalars)."""
    return _F32(float(a) * float(b) + float(c))


def _weighted_sum(y, h, weights, ks):
    """``y + sum_i (h * w_i) * k_i`` over the nonzero weights, in order, in
    f32, each term a fused multiply-add: the product is exact in f64 and
    the sum rounds once to f32."""
    for w, k in zip(weights, ks):
        if w != 0.0:
            y = (y.double() + float(h * w) * k.double()).float()
    return y


def _rk_trial(fn, tab: _Tableau, t, y, h):
    """One trial step of ``tab`` from (t, y) with step h: every stage, then
    the propagated solution and the embedded error estimate."""
    ks = []
    for i in range(tab.stages):
        yi = _weighted_sum(y, h, tab.a[i], ks)
        ks.append(fn(_fma32(tab.c[i], h, t), yi).float())
    return _weighted_sum(y, h, tab.b, ks), _weighted_sum(torch.zeros_like(y), h, tab.b_err, ks)


def _error_ratio(err, y, y_new, atol: float, rtol: float):
    """The rms of err / (atol + rtol * max(|y|, |y_new|)), read on the host
    as an f32 scalar (summed in f64)."""
    tol = (atol + rtol * torch.maximum(y.abs(), y_new.abs()).double()).float()
    r = (err / tol).double()
    return _F32(torch.sqrt(torch.mean(r * r)).item())


def _adaptive_interval(fn, t0, t1, y0, tab: _Tableau, atol: float,
                       rtol: float) -> torch.Tensor:
    """Integrate one interval [t0, t1] of the grid with the embedded pair
    ``tab``: a host loop over trial steps, each reading its error ratio with
    one ``.item()``."""
    t0, t1 = _F32(t0), _F32(t1)
    end = _F32(t1 - _F32(1e-9))
    t, y = t0, y0.float()
    h = _F32((t1 - t0) / _F32(10.0))   # a simple first step; the controller adapts fast
    exponent = _F32(-1.0 / (tab.order + 1.0))
    n = 0
    while t < end and n < _MAX_ADAPTIVE_STEPS:
        h = min(h, _F32(t1 - t))
        y_new, err = _rk_trial(fn, tab, t, y, h)
        ratio = _error_ratio(err, y, y_new, atol, rtol)
        # a non-finite error estimate (fn blew up) rejects the step and
        # shrinks h, keeping the controller's state finite
        finite = math.isfinite(ratio)
        if not finite:
            factor = _F32(0.2)
        elif ratio <= _F32(1e-10):
            factor = _F32(10.0)
        else:
            grow = _F32(0.9) * _F32(float(ratio) ** float(exponent))
            factor = _F32(min(max(grow, _F32(0.2)), _F32(10.0)))
        if finite and ratio <= 1.0:
            t, y = _F32(t + h), y_new
        h = _F32(h * factor)
        n += 1
    if t < end:                      # the step cap, short of t1
        y = torch.full_like(y, float('nan'))
    return y.to(y0.dtype)


def odeint(fn, y0: torch.Tensor, t, *, method: str = 'midpoint', atol: float | None = None,
           rtol: float | None = None, return_trajectory: bool = False) -> torch.Tensor:
    """Integrate dy/dt = fn(t, y) across the grid ``t`` (1-D, host values)
    and return y(t[-1]), or with ``return_trajectory`` the ``(steps,
    *y0.shape)`` trajectory as torchdiffeq does. ``atol`` / ``rtol``
    (default 1e-5 each) set the adaptive methods' error control."""
    if method in _ADAPTIVE_TABLEAUS:
        tab = _ADAPTIVE_TABLEAUS[method]()
        atol = 1e-5 if atol is None else float(atol)
        rtol = 1e-5 if rtol is None else float(rtol)
        step = lambda t0, t1, y: _adaptive_interval(fn, t0, t1, y, tab, atol, rtol)
    elif method in _STEPPERS:
        stepper = _STEPPERS[method]
        step = lambda t0, t1, y: stepper(fn, t0, t1, y).to(y0.dtype)
    else:
        raise ValueError(f'unknown ODE method {method!r}; choose from '
                         f'{sorted(_STEPPERS) + sorted(_ADAPTIVE_TABLEAUS)}')
    t = np.asarray(t, dtype=np.float32)
    y, ys = y0, [y0]
    for t0, t1 in zip(t[:-1], t[1:]):
        y = step(t0, t1, y)
        ys.append(y)
    return torch.stack(ys) if return_trajectory else y
