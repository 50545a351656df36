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
array. `load_jax_train_state(trainer, tree)` carries a JAX training state
(model, ``nnx.Optimizer`` over clip + ADOPT, with or without
optax.MultiSteps, EMA, step, and the trained duration predictor's pair)
into an `E2Trainer`. The port never imports JAX: the caller builds the
dicts.

Layout rules:
- a linear ``kernel (in, out)`` becomes ``weight (out, in)``;
- ``to_qkv.kernel (dim, 3, inner)`` becomes ``to_qkv.weight (3*inner, dim)``
  with q, k, v in that order;
- a conv ``kernel (k, in/groups, out)`` becomes ``weight (out, in/groups,
  k)`` (no flip: both frameworks cross-correlate);
- an embedding table (``embedding``) becomes ``weight``;
- RMSNorm ``gamma``, the registers, the hyper-connection parameters and the
  RandomFourierEmbed ``weights`` buffer keep their names and layouts;
- the options' parameters follow the same rules: with the frequency axis
  each speech layer's ``freq_attn`` / ``freq_attn_norm`` /
  ``freq_attn_adaln_zero`` and its fourth hyper-connection
  (``speech_hcs.<layer>.3``), ``proj_in`` to ``dim * num_freq_tokens``;
  ``attn_input_fourier_embed.linear``; the interpolated text embedding's
  ``embed`` (``num_embeds`` rows), ``pos_in`` and ``pos_out``; with
  ``concat_cond`` a ``proj_in`` from twice the mel channels and no
  ``cond_proj_in`` on either side;
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

from e2_tts_tpu_torch.parallel.fsdp import is_sharded
from e2_tts_tpu_torch.parallel.tp import tp_axis
from e2_tts_tpu_torch.utils.helpers import exists


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
    persistent buffers in place (strict). Load before sharding: a model
    that FSDP already sharded (`parallel.fsdp.shard_module_fsdp`, as an
    `E2Trainer` with ``param_sharding='fsdp'`` does) raises."""
    if is_sharded(model) or exists(tp_axis(model)):
        raise ValueError('load_jax_params takes an unsharded model: load the JAX weights '
                         'first, then shard it (build the trainer after the load)')
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


def _adopt_from_jax(optimizer, module, flat: dict, accumulator=None) -> None:
    """Fill `Adopt`'s state over ``module``'s parameters from the flat
    state of an ``nnx.Optimizer`` over ``chain(clip, adopt(schedule))``,
    wrapped in optax.MultiSteps when ``accumulator`` is given: ADOPT's
    ``m``, ``v`` and ``count`` at ``opt_state[.inner_opt_state].1.0``, the
    schedule's ``count`` at ``.1.1``; with MultiSteps also ``acc_grads``,
    ``mini_step`` and ``gradient_step``. The optimizer's own ``step`` (its
    count of update calls) has no counterpart and is dropped."""
    rest = {k: v for k, v in flat.items() if k != 'step'}
    inner = 'opt_state.inner_opt_state.' if exists(accumulator) else 'opt_state.'

    def take(prefix: str) -> dict:
        sub = {k[len(prefix):]: rest.pop(k) for k in [k for k in rest if k.startswith(prefix)]}
        if not sub:
            raise ValueError(f'map_jax_tree: the optimizer tree has no {prefix!r}')
        return sub

    def scalar(key: str) -> int:
        if key not in rest:
            raise ValueError(f'map_jax_tree: the optimizer tree has no {key!r}')
        return int(np.asarray(rest.pop(key)))

    params = dict(module.named_parameters())
    targets = {name: tuple(p.shape) for name, p in params.items()}
    m = map_jax_tree(take(inner + '1.0.m.'), targets)
    v = map_jax_tree(take(inner + '1.0.v.'), targets)
    count, schedule_count = scalar(inner + '1.0.count'), scalar(inner + '1.1.count')
    if count != schedule_count:
        raise ValueError(f'ADOPT counted {count} updates and its schedule {schedule_count}: '
                         'the port keeps one count for both')
    if exists(accumulator):
        acc = map_jax_tree(take('opt_state.acc_grads.'), targets)
        mini_step, gradient_step = scalar('opt_state.mini_step'), scalar('opt_state.gradient_step')
        if gradient_step != count or not 0 <= mini_step < accumulator.every_k:
            raise ValueError(f'MultiSteps state (mini_step {mini_step}, gradient_step '
                             f'{gradient_step}) does not fit {count} ADOPT updates at k = '
                             f'{accumulator.every_k}')
    if rest:
        raise ValueError(f'map_jax_tree: unused JAX optimizer arrays {sorted(rest)}')

    as_param = lambda arr, p: torch.from_numpy(np.array(arr, copy=True)).to(p)
    optimizer.state.clear()
    for name, p in params.items():
        optimizer.state[p] = dict(step=count, m=as_param(m[name], p), v=as_param(v[name], p))
    if exists(accumulator):
        accumulator.load_state_dict(dict(
            grads=[as_param(acc[name], p) for name, p in params.items()], mini_step=mini_step))


def load_jax_train_state(trainer, tree: dict) -> int:
    """Carry a JAX training state into ``trainer`` (an `E2Trainer` whose
    optimizer is built: pass ``total_steps=``) in place; returns the global
    step. ``tree`` holds ``model``, ``opt`` and ``ema`` (each the flat
    ``nnx.state`` of the JAX model, its ``nnx.Optimizer`` and its `EMA`, as
    dotted path -> numpy array), ``step``, and, when the trainer trains its
    duration predictor, ``duration_predictor`` and ``dp_opt``. The trainer's
    ``grad_accumulation_steps`` must be the MultiSteps k of the JAX
    optimizer (1 without MultiSteps). Strict as `map_jax_tree`: an unused or
    a missing array raises. The JAX PRNG key has no counterpart: `train`
    seeds the generator from ``seed + step`` when no saved state exists.
    It loads before sharding, so a trainer whose model FSDP sharded
    (``param_sharding='fsdp'``) raises: load into a single-device trainer,
    save its checkpoint and let the sharded trainer resume from it
    (checkpoints move between world sizes)."""
    if is_sharded(trainer.model):
        raise ValueError('load_jax_train_state takes a trainer with an unsharded model')
    if not exists(trainer.optimizer):
        raise RuntimeError('build the trainer\'s optimizer first (total_steps=)')
    dp_keys = {'duration_predictor', 'dp_opt'} if trainer.train_duration_predictor else set()
    want = {'model', 'opt', 'ema', 'step'} | dp_keys
    if set(tree) != want:
        raise ValueError(f'load_jax_train_state: the tree has {sorted(tree)}, the trainer '
                         f'takes {sorted(want)}')
    load_jax_params(trainer.model, tree['model'])
    _adopt_from_jax(trainer.optimizer, trainer.model, tree['opt'], trainer.accumulator)

    ema = dict(tree['ema'])
    counters = {k: ema.pop(k, None) for k in ('step', 'step_initted')}
    if any(v is None for v in counters.values()):
        raise ValueError('map_jax_tree: the EMA tree has no step / step_initted')
    load_jax_params(trainer.ema.ema_model,
                    {k[len('ema_model.'):] if k.startswith('ema_model.') else k: v
                     for k, v in ema.items()})
    trainer.ema.step = int(np.asarray(counters['step']))
    trainer.ema.initted = bool(np.asarray(counters['step_initted']))

    if dp_keys:
        load_jax_params(trainer.duration_predictor, tree['duration_predictor'])
        _adopt_from_jax(trainer.dp_optimizer, trainer.duration_predictor, tree['dp_opt'])
    return int(np.asarray(tree['step']))
