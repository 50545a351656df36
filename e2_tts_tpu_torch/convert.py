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

Before those rules, two older or other layouts of the JAX tree are brought
to the unrolled one:
- a tree from before the fused attention parameter (sibling ``to_q`` /
  ``to_k`` / ``to_v`` subtrees) is merged into ``to_qkv``
  (`migrate_qkv_layout`, the JAX package's checkpoint migration);
- a backbone built with ``scan_layers=True`` stores its layers as
  ``layer_first`` (layer 0), ``scan_mid.<g>`` (segment ``g`` of the plan,
  `models.transformer.scan_plan`: a ``'scan'`` segment's leaves carry a
  leading axis of its layers, a ``'single'`` one's do not) and
  ``layer_last`` (layer ``depth - 1``), each with ``speech``, ``text``,
  ``speech_hcs.<j>`` and ``text_hcs.<j>``. These become ``speech_layers.<i>``,
  ``text_layers.<i>``, ``speech_hcs.<i>.<j>`` and ``text_hcs.<i>.<j>``
  (`unstack_scan_layers`). The plans come from the port model's own
  backbones (`scan_plans`), whose names are the unrolled ones.

The bridge is strict: a JAX array the port does not use, a port tensor the
JAX tree does not set, or a shape that does not match raises; so does a
scan-layout tree for a port backbone built without ``scan_layers``, an
unrolled tree for one built with it, and a stacked group whose leading
axis is not the plan's layer count. RNG state
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


def migrate_qkv_layout(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A flat tree from before the fused attention parameter: wherever
    ``<p>.to_q.<leaf>``, ``<p>.to_k.<leaf>`` and ``<p>.to_v.<leaf>`` stand
    (and no ``<p>.to_qkv``), they merge into ``<p>.to_qkv.<leaf>`` stacked
    on a new axis -2, the ``(dim, 3, inner)`` layout of the fused kernel
    (optimizer moments and stacked scan groups alike). Other paths, and
    trees in the fused layout, pass through."""
    names = ('to_q', 'to_k', 'to_v')
    out, groups, fused = {}, {}, set()
    for key, value in flat.items():
        parts = key.split('.')
        at = next((i for i, p in enumerate(parts) if p in names + ('to_qkv',)), None)
        if at is None or parts[at] == 'to_qkv':
            if at is not None:
                fused.add('.'.join(parts[:at]))
            out[key] = value
            continue
        groups.setdefault(('.'.join(parts[:at]), '.'.join(parts[at + 1:])), {})[parts[at]] = value
    for (prefix, leaf), group in groups.items():
        head = prefix + '.' if prefix else ''
        if set(group) == set(names) and prefix not in fused:
            out[f'{head}to_qkv.{leaf}'] = np.stack([np.asarray(group[n]) for n in names],
                                                   axis=-2)
        else:
            out.update({f'{head}{n}.{leaf}': v for n, v in group.items()})
    return out


_SCAN_GROUPS = ('layer_first', 'scan_mid', 'layer_last')
_SCAN_PARTS = {'speech': 'speech_layers', 'text': 'text_layers',
               'speech_hcs': 'speech_hcs', 'text_hcs': 'text_hcs'}


def scan_plans(module: torch.nn.Module) -> dict[str, tuple[int, list]]:
    """``{prefix: (depth, plan)}`` of every backbone in ``module`` built
    with ``scan_layers=True`` (``prefix`` its name in the state dict with a
    trailing dot, ``''`` for ``module`` itself)."""
    return {(name + '.' if name else ''): (m.depth, m.scan_plan)
            for name, m in module.named_modules() if getattr(m, 'scan_plan', None)}


def unstack_scan_layers(flat: dict[str, np.ndarray],
                        plans: dict[str, tuple[int, list]]) -> dict[str, np.ndarray]:
    """``flat`` with every ``scan_layers`` group of the backbones in
    ``plans`` (`scan_plans`) split into the unrolled per-layer paths (see
    the module docstring); strict both ways about the layout."""
    out = {}
    for key, value in flat.items():
        parts = key.split('.')
        at = next((i for i, p in enumerate(parts) if p in _SCAN_GROUPS), None)
        prefix = '.'.join(parts[:at]) + '.' if at else ''
        if at is None or _is_rng_path(key):
            for plan_prefix in plans:
                if key.startswith(plan_prefix + 'speech_layers.'):
                    raise ValueError(f'{key}: the JAX tree is unrolled, but the port\'s '
                                     f'backbone {plan_prefix!r} is built with scan_layers=True')
            out[key] = value
            continue
        if prefix not in plans:
            raise ValueError(f'{key}: the JAX tree is in the scan_layers layout; build the '
                             f'port\'s backbone {prefix!r} with scan_layers=True')
        depth, plan = plans[prefix]
        group, rest = parts[at], parts[at + 1:]
        stacked = False
        if group == 'layer_first':
            layers = [0]
        elif group == 'layer_last':
            layers = [depth - 1]
        else:
            g, rest = int(rest[0]), rest[1:]
            if g >= len(plan):
                raise ValueError(f'{key}: the port\'s plan has {len(plan)} segments')
            kind, start, count, _ = plan[g]
            layers, stacked = list(range(start, start + count)), kind == 'scan'
        if rest[0] not in _SCAN_PARTS:
            raise ValueError(f'{key}: no unrolled counterpart for {rest[0]!r}')
        value = np.asarray(value)
        if stacked and (value.ndim == 0 or value.shape[0] != len(layers)):
            raise ValueError(f'{key}: a stacked group of shape {value.shape}, but the port\'s '
                             f'plan puts {len(layers)} layers (from {layers[0]}) in it')
        for i, ind in enumerate(layers):
            name = prefix + '.'.join([_SCAN_PARTS[rest[0]], str(ind)] + rest[1:])
            out[name] = value[i] if stacked else value
    return out


def map_jax_tree(flat: dict[str, np.ndarray], targets: dict[str, tuple],
                 plans: dict[str, tuple[int, list]] | None = None) -> dict[str, np.ndarray]:
    """A flat JAX tree with the parameters' paths -> ``{port name: array in
    the port's layout}``, strict against ``targets`` (port name -> shape):
    every non-RNG JAX path must map to a target of the same shape, and
    every target must be set. ``plans`` (`scan_plans` of the port model)
    names the backbones built with ``scan_layers``; a tree from before the
    fused q/k/v parameter is migrated first."""
    flat = unstack_scan_layers(migrate_qkv_layout(flat), plans or {})
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
    mapped = map_jax_tree(flat, {name: t.shape for name, t in targets.items()},
                          scan_plans(model))
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
    plans = scan_plans(module)
    m = map_jax_tree(take(inner + '1.0.m.'), targets, plans)
    v = map_jax_tree(take(inner + '1.0.v.'), targets, plans)
    count, schedule_count = scalar(inner + '1.0.count'), scalar(inner + '1.1.count')
    if count != schedule_count:
        raise ValueError(f'ADOPT counted {count} updates and its schedule {schedule_count}: '
                         'the port keeps one count for both')
    if exists(accumulator):
        acc = map_jax_tree(take('opt_state.acc_grads.'), targets, plans)
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
