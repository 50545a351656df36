"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The JAX package is the reference: a test builds a JAX module, perturbs its
parameters with seeded noise (zero-initialised branches would otherwise hide
whole code paths), flattens its state into the dict `load_jax_params` takes,
and feeds both sides the same numpy inputs.
"""

from __future__ import annotations

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
from flax import nnx

# the port's test configuration: packed-eligible attention (4 heads x 32 =
# 128), 4 registers, 4 hyper-connection streams, f32
SMALL_TF = dict(dim=128, depth=2, heads=4, dim_head=32, num_registers=4,
                max_seq_len=256, kernel_size=7, dropout=0.0)


def flat_state(module) -> dict:
    """``nnx.state(module)`` as dotted path -> numpy array (RNG keys as their
    raw key data: the bridge must ignore them)."""
    out = {}
    for path, var in nnx.to_flat_state(nnx.state(module)):
        value = var.get_value()
        if isinstance(var, nnx.RngKey):
            value = jax.random.key_data(value)
        out['.'.join(map(str, path))] = np.asarray(value)
    return out


def perturb(module, seed: int = 0, scale: float = 0.02):
    """Add ``scale * N(0, 1)`` (numpy seed) to every parameter in place."""
    rng = np.random.default_rng(seed)
    state = nnx.state(module, nnx.Param)
    state = jax.tree.map(
        lambda a: a + scale * jnp.asarray(rng.standard_normal(a.shape), a.dtype), state)
    nnx.update(module, state)
    return module


def to_np(x):
    return np.asarray(x.detach().cpu().float().numpy() if hasattr(x, 'detach') else x)


def perturb_np(module, seed: int = 0, scale: float = 0.02):
    """`perturb`'s noise added in numpy, in f32: the same sums without a JAX
    compile per parameter shape (~4 s of a fresh process here)."""
    rng = np.random.default_rng(seed)
    state = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + np.float32(scale)
                              * rng.standard_normal(a.shape).astype(np.float32)),
        nnx.state(module, nnx.Param))
    nnx.update(module, state)
    return module


def flat_values(state) -> dict:
    """An ``nnx.State`` (of parameters, grads, ...) as dotted path -> numpy
    array."""
    return {'.'.join(map(str, path)): np.asarray(var.get_value() if hasattr(var, 'get_value')
                                                 else var)
            for path, var in nnx.to_flat_state(state)}


def assert_params_close(jax_flat: dict, module, label: str, atol: float = 1e-6):
    """Every parameter of the port's ``module`` within ``atol`` of the JAX
    tree ``jax_flat`` (mapped by `convert.map_jax_tree`)."""
    from e2_tts_tpu_torch.convert import map_jax_tree, scan_plans
    mapped = map_jax_tree(jax_flat, {n: tuple(p.shape) for n, p in module.named_parameters()},
                          scan_plans(module))
    for name, t in module.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), mapped[name], rtol=0, atol=atol,
                                   err_msg=f'{label} {name}')


_STUB_PHONES = ('AA0', 'AE1', 'B', 'CH', 'D', 'EH1', 'F', 'G', 'HH', 'IY0', 'K', 'L', 'M', 'N',
                'OW1', 'P', 'R', 'S', 'T', 'UW1', 'V', 'W', 'Y', 'Z')


def stub_g2p_en(monkeypatch):
    """Put a stand-in ``g2p_en`` module in ``sys.modules`` (monkeypatched,
    so the test ends with the real state): its ``G2p`` has a small
    ``p2idx`` and maps each letter to a phoneme and keeps spaces and
    punctuation, so both packages' 'phoneme_en' tokenizers run without
    the optional package."""
    class G2p:
        p2idx = {p: i for i, p in enumerate(('<pad>', '<unk>', '<s>', '</s>') + _STUB_PHONES)}

        def __call__(self, text: str) -> list[str]:
            return [_STUB_PHONES[ord(c) % len(_STUB_PHONES)] if c.isalpha() else c
                    for c in text.lower()]

    module = types.ModuleType('g2p_en')
    module.G2p = G2p
    monkeypatch.setitem(sys.modules, 'g2p_en', module)
