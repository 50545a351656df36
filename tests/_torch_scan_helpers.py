"""Shared parts of the ``scan_layers`` parity tests (tests/test_torch_scan_*.py).

`check_backbone` builds the JAX package's scan backbone (``scan_layers=True``,
its middle layers stacked), perturbs it, carries it into the port's
``Transformer(scan_layers=True)`` through `load_jax_params` (which unstacks
the groups by the port's own `scan_plan`) and holds the plan, the forward,
the input grads and every parameter grad (the JAX grads, stacked like the
parameters, mapped back by `map_jax_tree` with the port's plans) against
JAX's. Attention on XLA and no dropout: the dropout path is held in
tests/test_torch_scan_dropout.py.

Tolerances (f32): the forward 3e-6 absolute plus 1e-5 relative; the grads
1e-4 in relative L2 over the whole vector and each grad 1e-3 relative plus
1e-4 of its tensor's largest |grad| (as tests/_torch_options_helpers.py).
Where f32 cannot resolve that limit, it does not apply as written. The
value-head gates start saturated (bias 10, sigmoid 1 - 4.5e-5), and both
packages take their logit grad through ``1 - sigmoid`` in f32, ~1e-3
relative error per token; other grads are sums over every token with heavy
cancellation (a late layer's hyper-connection ``static_beta``). Summed in
other orders through six or eight layers, either side's f32 value of such
a grad can sit past the limit of the exact one (JAX's 2.6e-3 relative on a
``static_beta`` at depth 6, text depth 2; the port's 5e-3 on an element of
a gate weight). So for each tensor, JAX's and the port's f32 values are
measured against the port's f64 evaluation in units of the limit: where
both resolve it, every element is held to the limit of JAX's value; where
either does not (the value-head gate weights and a few hyper-connection
scales, not the bulk), the tensor is held to 1e-2 of JAX's in relative L2
(rounding, not a wrong formula) and the port's f32 value to 10 limits of
its f64 evaluation. The relative L2 bound of the whole vector against JAX
holds as stated.
"""

import copy

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from e2_tts_tpu.models.transformer import Transformer as JaxTransformer

from _torch_port_helpers import SMALL_TF, flat_state, flat_values, perturb_np
from e2_tts_tpu_torch.convert import load_jax_params, map_jax_tree, scan_plans
from e2_tts_tpu_torch.models.transformer import Transformer

# the port's test widths (SMALL_TF) without its depth
SCAN_CFG = {k: v for k, v in SMALL_TF.items() if k != 'depth'}
B, N = 2, 32
FWD_TOL = dict(atol=3e-6, rtol=1e-5)


def one_torch_thread():
    """A generator for a module fixture: one torch intra-op thread (as fast
    at these widths, and it does not stall when the suite's workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build_pair(depth: int, text_depth: int, seed: int = 3):
    """The perturbed JAX scan backbone and the port's, with its weights."""
    cfg = dict(SCAN_CFG, depth=depth, text_depth=text_depth)
    j = perturb_np(JaxTransformer(**cfg, scan_layers=True, attn_backend='xla',
                                  rngs=nnx.Rngs(1)), seed=seed)
    p = Transformer(**cfg, scan_layers=True, device='cpu')
    load_jax_params(p, flat_state(j))
    return j, p


def inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, SCAN_CFG['dim'])).astype(np.float32)
    te = rng.standard_normal((B, N, SCAN_CFG['dim'] // 2)).astype(np.float32)
    times = np.array([0.3, 0.7], np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 20:] = False
    w = rng.standard_normal((B, N, SCAN_CFG['dim'])).astype(np.float32)
    return x, te, times, mask, w


@nnx.jit
def jax_value_and_grads(model, x, te, times, mask, w):
    """The output, and the grads of ``sum(out * w)`` w.r.t. every
    parameter, ``x`` and the text embedding."""
    def loss(m, x, te):
        out = m(x, times=times, mask=mask, text_embed=te)
        return (out * w).sum(), out
    return nnx.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(model, x, te)


def port_value_and_grads(p, x, te, times, mask, w):
    p.zero_grad(set_to_none=True)
    xt, tet = torch.from_numpy(x).requires_grad_(), torch.from_numpy(te).requires_grad_()
    out = p(xt, times=torch.from_numpy(times), mask=torch.from_numpy(mask), text_embed=tet)
    (out * torch.from_numpy(w)).sum().backward()
    grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t)).numpy().copy()
             for n, t in p.named_parameters()}
    return out.detach().numpy(), xt.grad.numpy(), tet.grad.numpy(), grads


def port_f64_grads(p, *args) -> dict:
    """``p``'s parameter grads of `port_value_and_grads` evaluated in f64
    (a copy of the model, the inputs widened)."""
    wide = [a.astype(np.float64) if a.dtype == np.float32 else a for a in args]
    return port_value_and_grads(copy.deepcopy(p).double(), *wide)[3]


def _limit(ref):
    return 1e-3 * np.abs(ref) + 1e-4 * float(np.abs(ref).max()) + 1e-12


def assert_grads_close(ported: dict, mapped: dict, exact: dict):
    """Every grad of ``ported`` against JAX's ``mapped``, ``exact`` (the
    port's f64 grads) telling where f32 rounding cannot resolve the limit
    (module docstring)."""
    names = sorted(ported)
    assert set(mapped) == set(names)
    vp = np.concatenate([ported[n].ravel() for n in names])
    vj = np.concatenate([np.asarray(mapped[n]).ravel() for n in names])
    assert np.linalg.norm(vp - vj) <= 1e-4 * np.linalg.norm(vj)
    for name in names:
        got, g, e = ported[name], np.asarray(mapped[name]), exact[name]
        off = lambda v: float((np.abs(v - e) / _limit(e)).max())
        r, q = off(g), off(got)
        if max(r, q) <= 1.0:
            np.testing.assert_allclose(got, g, rtol=1e-3, atol=1e-4 * float(np.abs(g).max())
                                       + 1e-12, err_msg=name)
            continue
        rel_l2 = float(np.linalg.norm(got - g) / np.linalg.norm(g))
        assert rel_l2 <= 1e-2 and q <= 10.0, (
            f'{name}: JAX {r:.3g} and the port {q:.3g} limits off the f64 grad, relative L2 '
            f'against JAX {rel_l2:.3g}')


def check_backbone(j, p):
    """The plan, the forward, the input grads and every parameter grad of
    the port against the JAX scan backbone ``j``."""
    assert p.scan_plan == j.scan_plan
    args = inputs()
    ((_, out_j), (grads_j, gx_j, gte_j)) = jax_value_and_grads(j, *map(jnp.asarray, args))
    out_p, gx_p, gte_p, grads_p = port_value_and_grads(p, *args)
    np.testing.assert_allclose(out_p, np.asarray(out_j), **FWD_TOL)
    for got, want in ((gx_p, gx_j), (gte_p, gte_j)):
        want = np.asarray(want)
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * float(np.abs(want).max()))
    mapped = map_jax_tree(flat_values(grads_j), {k: v.shape for k, v in grads_p.items()},
                          scan_plans(p))
    assert_grads_close(grads_p, mapped, port_f64_grads(p, *args))
