"""Checkpoint and resume (counterpart of e2_tts_tpu/training/checkpointing.py).

A checkpoint is one ``torch.save`` payload in a directory, as the JAX
package's orbax checkpoint is one pytree in a directory:

- ``model``: the model's ``state_dict``;
- ``opt``: the optimizer's ``state_dict`` (ADOPT's ``m``, ``v`` and
  per-parameter ``step``) without its callables: `Adopt`'s ``lr`` is a
  schedule, a pure function of the step, which neither pickles nor loads
  under ``weights_only``, so a load takes it back from the live optimizer;
- ``ema``: the EMA model's weights and its ``step`` and ``initted`` counters
  (without them a resumed run copies where it should blend and loses its
  velocity teacher);
- ``step``: the global step;
- ``generator``: the trainer's ``torch.Generator`` state, in place of the
  JAX train loop's PRNG key;
- when present: ``duration_predictor``, ``dp_opt`` and ``accumulation`` (the
  gradient accumulator's partial mean and its micro-step).

A save writes a temporary file in the directory and moves it over the
checkpoint with ``os.replace``, so a reader sees the old checkpoint or the
new one, never a part of either. A load reads with ``weights_only=True``.

Under a data ``mesh`` every rank calls both. A save gathers every
FSDP-sharded tensor to its full value (a collective; `fsdp.gather_full`),
rank 0 writes the same one-file payload as a single device does, and the
other ranks wait at a barrier until it is in place. A load reads the file on
every rank, and each rank copies its own part of each sharded tensor
(`fsdp.load_full_state_dict`, `fsdp.copy_full_`), so a checkpoint moves
between world sizes and between replicated and sharded runs unchanged.
Under a (data, model) mesh the tensor-parallel pieces (parameters, the EMA's
copy, ADOPT's moments, the accumulator's mean) are gathered over the model
axis into the single-device layout (`tp.full_state_dict`, `tp.full_tensor`)
and cut again at load (`tp.local_part`), so a checkpoint moves between a TP
run and one device either way.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from e2_tts_tpu_torch.parallel.fsdp import (
    gather_full, load_full_state_dict, shard_optimizer_state_,
)
from e2_tts_tpu_torch.parallel.tp import (
    full_state_dict, full_tensor, local_part, param_layouts, tp_axis,
)
from e2_tts_tpu_torch.utils.helpers import exists

CHECKPOINT_FILE = 'checkpoint.pt'


def _optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with every callable hyperparameter (a
    learning-rate schedule) left out of its parameter groups."""
    state = optimizer.state_dict()
    state['param_groups'] = [{k: v for k, v in group.items() if not callable(v)}
                             for group in state['param_groups']]
    return state


def _load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict, module) -> None:
    """`_optimizer_state`'s inverse: the callables come from the live
    optimizer's groups; each rank keeps its part of a sharded state."""
    groups = [dict(saved, **{k: v for k, v in live.items() if callable(v)})
              for saved, live in zip(state['param_groups'], optimizer.param_groups)]
    optimizer.load_state_dict(dict(_per_param(state, optimizer, module, cut=True),
                                   param_groups=groups))
    shard_optimizer_state_(optimizer)


def _per_param(state: dict, optimizer, module, cut: bool) -> dict:
    """``state`` (an optimizer's state dict) with each per-parameter tensor
    of a tensor-parallel parameter of ``module`` gathered to its full value
    (a collective), or, with ``cut``, a full one cut to this rank's piece."""
    layouts = param_layouts(module) if exists(module) else {}
    if not layouts:
        return state
    axis = tp_axis(module)
    params = [p for group in optimizer.param_groups for p in group['params']]

    def place(value, p):
        layout = layouts.get(p)
        if layout is None or not torch.is_tensor(value) or value.ndim != p.ndim:
            return value
        if cut:
            return local_part(value, layout, axis.size, axis.rank)
        return full_tensor(value, layout, axis)

    return dict(state, state={i: {k: place(v, params[i]) for k, v in s.items()}
                              for i, s in state['state'].items()})


def _accumulation(state: dict, module, cut: bool) -> dict:
    """The accumulator's state (mean grads in ``module.parameters()``
    order) with its tensor-parallel pieces gathered, or full ones cut."""
    layouts = param_layouts(module)
    if not layouts:
        return state
    axis = tp_axis(module)
    place = ((lambda g, layout: local_part(g, layout, axis.size, axis.rank)) if cut
             else (lambda g, layout: full_tensor(g, layout, axis)))
    return dict(state, grads=[place(g, layouts[p]) if p in layouts else g
                              for p, g in zip(module.parameters(), state['grads'])])


def save_checkpoint(path: str, *, model, optimizer=None, ema=None, step: int = 0,
                    duration_predictor=None, dp_optimizer=None, generator=None,
                    accumulator=None, mesh=None) -> str:
    """Write the checkpoint into the directory ``path``, atomically
    replacing any previous one; returns the file's path. With a data
    ``mesh`` every rank calls it: all gather, rank 0 writes, all return
    once the file is in place."""
    path = os.path.abspath(path)
    payload = dict(model=model.state_dict(), step=int(step))
    if exists(optimizer):
        payload['opt'] = _optimizer_state(optimizer)
    if exists(ema):
        payload['ema'] = ema.state_dict()
    if exists(duration_predictor):
        payload['duration_predictor'] = duration_predictor.state_dict()
    if exists(dp_optimizer):
        payload['dp_opt'] = _optimizer_state(dp_optimizer)
    if exists(generator):
        payload['generator'] = generator.get_state()
    if exists(accumulator):
        payload['accumulation'] = accumulator.state_dict()
    target = os.path.join(path, CHECKPOINT_FILE)
    if not exists(mesh):
        _write(payload, path, target)
        return target
    payload = gather_full(payload)
    for module, opt, key, opt_key in ((model, optimizer, 'model', 'opt'),
                                      (duration_predictor, dp_optimizer, 'duration_predictor',
                                       'dp_opt')):
        if key in payload:
            payload[key] = full_state_dict(module, payload[key])
        if opt_key in payload:
            payload[opt_key] = _per_param(payload[opt_key], opt, module, cut=False)
    if 'ema' in payload:
        payload['ema'] = dict(payload['ema'],
                              model=full_state_dict(ema.ema_model, payload['ema']['model']))
    if 'accumulation' in payload:
        payload['accumulation'] = _accumulation(payload['accumulation'], model, cut=False)
    if dist.get_rank() == 0:
        _write(payload, path, target)
    dist.barrier()
    return target


def _write(payload: dict, path: str, target: str) -> None:
    """``torch.save`` to a temporary file in ``path``, then moved over
    ``target``."""
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f'.{CHECKPOINT_FILE}.', dir=path)
    try:
        with os.fdopen(fd, 'wb') as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, *, model, optimizer=None, ema=None, duration_predictor=None,
                    dp_optimizer=None, accumulator=None, map_location=None):
    """Restore in place; returns ``(step, generator state)``: ``(0, None)``
    for a missing or empty directory, the state None for a checkpoint
    without one. A directory that holds other files but no checkpoint
    raises, as the JAX package's does: it may hold a partial or foreign
    state. Sharded modules and optimizers take their part of each full
    tensor."""
    path = os.path.abspath(path)
    if not os.path.exists(path) or not os.listdir(path):
        return 0, None
    target = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.isfile(target):
        raise FileNotFoundError(f'{path} is not empty but holds no {CHECKPOINT_FILE}: '
                                f'{sorted(os.listdir(path))}')
    payload = torch.load(target, map_location=map_location, weights_only=True)

    load_full_state_dict(model, payload['model'])
    if exists(duration_predictor) and 'duration_predictor' in payload:
        load_full_state_dict(duration_predictor, payload['duration_predictor'])
    for obj, key, module in ((optimizer, 'opt', model),
                             (dp_optimizer, 'dp_opt', duration_predictor)):
        if exists(obj) and key in payload:
            _load_optimizer_state(obj, payload[key], module)
    if exists(ema) and 'ema' in payload:
        ema.load_state_dict(payload['ema'])
    if exists(accumulator) and 'accumulation' in payload:
        accumulator.load_state_dict(_accumulation(payload['accumulation'], model, cut=True))
    generator_state = payload.get('generator')
    if exists(generator_state):
        generator_state = generator_state.cpu()
    return int(payload['step']), generator_state
