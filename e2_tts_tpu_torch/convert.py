"""Weight bridge from the JAX package to the port.

`load_jax_params(model, flat)` takes the JAX model's state — ``nnx.state
(model)`` flattened to a dict of dotted path -> numpy array, e.g.
``'transformer.speech_layers.0.attn.to_qkv.kernel'`` — and copies it into
the port's module of the same structure (an `E2TTS` with its duration
predictor, a `DurationPredictor`, a `Transformer`, ...). `load_jax_vocos
(vocos, flat)` does the same for the JAX package's `Vocos`, whose weights
live outside the E2TTS state. `map_jax_tree(flat, targets)`
does the renaming and relayout for any tree with the parameters' paths
(weights, grads, ADOPT moments, EMA weights) and returns port name ->
array. The port never imports JAX: the caller builds the dict.

Layout rules:
- a linear ``kernel (in, out)`` becomes ``weight (out, in)``;
- ``to_qkv.kernel (dim, 3, inner)`` becomes ``to_qkv.weight (3*inner, dim)``
  with q, k, v in that order;
- a conv ``kernel (k, in/groups, out)`` becomes ``weight (out, in/groups,
  k)`` (no flip: both frameworks cross-correlate);
- an embedding table (``embedding``) becomes ``weight``;
- RMSNorm ``gamma``, the registers, the hyper-connection parameters and the
  RandomFourierEmbed ``weights`` buffer keep their names and layouts;
- in the Vocos tree, ``backbone.blocks`` is ``backbone.convnext``,
  ``backbone.final_norm`` is ``backbone.final_layer_norm``, ``head.window``
  is ``head.istft.window`` and a LayerNorm ``scale`` is its ``weight`` (the
  published torch checkpoint's names).

The bridge is strict: a JAX array the port does not use, a port tensor the
JAX tree does not set, or a shape that does not match raises. RNG state
(any path through ``rngs``) is ignored, and so are the port's
non-persistent buffers (tables built from the configuration, such as the
mel frontend's, which the JAX state does not hold).
"""

from __future__ import annotations

import numpy as np
import torch


def _is_rng_path(key: str) -> bool:
    return 'rngs' in key.split('.')


def _port_name_and_value(key: str, value: np.ndarray):
    parts = key.split('.')
    leaf = parts[-1]
    if leaf == 'embedding':
        return '.'.join(parts[:-1] + ['weight']), value
    if leaf != 'kernel':
        return key, value
    name = '.'.join(parts[:-1] + ['weight'])
    if value.ndim == 2:                      # linear (in, out) -> (out, in)
        return name, value.T
    if value.ndim == 3 and parts[-2] == 'to_qkv':
        dim, three, inner = value.shape      # (dim, 3, inner) -> (3*inner, dim)
        return name, value.reshape(dim, three * inner).T
    if value.ndim == 3:
        return name, value.transpose(2, 1, 0)  # conv (k, in/g, out) -> (out, in/g, k)
    raise ValueError(f'no layout rule for JAX kernel {key} of shape {value.shape}')


def map_jax_tree(flat: dict[str, np.ndarray], targets: dict[str, tuple]) -> dict[str, np.ndarray]:
    """A flat JAX tree with the parameters' paths -> ``{port name: array in
    the port's layout}``, strict against ``targets`` (port name -> shape):
    every non-RNG JAX path must map to a target of the same shape, and
    every target must be set."""
    out, unused = {}, []
    for key, value in flat.items():
        if _is_rng_path(key):
            continue
        name, arr = _port_name_and_value(key, np.asarray(value))
        if name not in targets:
            unused.append(key)
            continue
        if tuple(targets[name]) != tuple(arr.shape):
            raise ValueError(f'{key} -> {name}: shape {arr.shape} does not match '
                             f'the port\'s {tuple(targets[name])}')
        out[name] = arr
    missing = sorted(set(targets) - set(out))
    if unused or missing:
        raise ValueError(f'map_jax_tree: unused JAX arrays {sorted(unused)}; '
                         f'port tensors not set {missing}')
    return out


def load_jax_params(model: torch.nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Copy the JAX state ``flat`` into ``model``'s parameters and
    persistent buffers in place (strict)."""
    targets = model.state_dict(keep_vars=True)
    mapped = map_jax_tree(flat, {name: t.shape for name, t in targets.items()})
    with torch.no_grad():
        for name, arr in mapped.items():
            dst = targets[name]
            dst.copy_(torch.from_numpy(np.array(arr, copy=True)).to(dst.dtype))


_VOCOS_RENAMES = (('backbone.blocks.', 'backbone.convnext.'),
                  ('backbone.final_norm.', 'backbone.final_layer_norm.'),
                  ('head.window', 'head.istft.window'))


def load_jax_vocos(model: torch.nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Copy the JAX `Vocos` state ``flat`` (``nnx.state(vocos)`` flattened)
    into the port's `Vocos` in place (strict)."""
    renamed = {}
    for key, value in flat.items():
        for old, new in _VOCOS_RENAMES:
            key = key.replace(old, new)
        if key.endswith('.scale'):
            key = key[:-len('scale')] + 'weight'
        renamed[key] = value
    load_jax_params(model, renamed)
