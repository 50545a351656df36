"""Fully sharded parameters (counterpart of e2_tts_tpu/parallel/fsdp.py).

The JAX package places each parameter with a ``NamedSharding`` that shards
its largest axis divisible by the mesh size over ``data`` (arrays under
1024 elements stay replicated), and XLA inserts the all-gathers and
reduce-scatters. The port uses FSDP2 (``fully_shard``), whose rule is
another: every parameter, whatever its size, is a ``DTensor`` sharded on
dim 0 in ``torch.chunk``'s P pieces (the last ranks' pieces shorter or
empty when P does not divide dim 0; FSDP2 pads its buffers), so each rank
holds about 1/P of the parameter bytes, plus at most one row of each
parameter. FSDP2 takes no 0-d parameter (the hyper-connections' dynamic
alpha and beta scales, two a connection): those stay whole on every rank,
outside FSDP (``ignored_params``), and the trainer averages their grads
over the ranks after each backward (`average_whole_grads_`), as DDP
would. The contract kept from the JAX package is the numbers (a
sharded step is the single-device step of the global batch) and the bytes.
`shard_module_fsdp` makes each speech and text layer one unit, whose
parameters are all-gathered around that layer's forward and again for its
backward, and the root (embeddings, projections, registers, the
hyper-connections, the time MLP, the final norm) one unit gathered for the
whole forward; grads are reduce-scattered and averaged over the ranks.
Buffers stay whole on every rank.

The optimizer (`Adopt`), the EMA, the gradient accumulator and the clip act
on each rank's local shard (`local`), with no all-gather; a checkpoint
gathers the full tensors (`gather_full`) and a load copies each rank's part
of them back (`load_full_state_dict`, `copy_full_`, `shard_like`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from e2_tts_tpu_torch.parallel.tp import local_state_dict, tp_layouts
from e2_tts_tpu_torch.utils.helpers import exists


def shard_module_fsdp(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """``fully_shard`` each speech and text layer of ``module.transformer``
    (an `E2TTS` or a `DurationPredictor`), then ``module`` itself, over the
    1-D data ``mesh`` (or a 2-D one: replicated over its first axis,
    sharded over its second), in place. An `E2TTS`'s ``transformer_with_pred_head``
    (the velocity teacher's pass) is registered as a forward, so calling it
    gathers the root's parameters as a call of the module does. Build the
    optimizer after this: FSDP2 replaces the parameters."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    whole = {p for p in module.parameters() if p.ndim == 0}
    transformer = module.transformer
    for layer in (*transformer.speech_layers, *transformer.text_layers):
        fully_shard(layer, mesh=mesh, ignored_params=whole & set(layer.parameters()) or None)
    fully_shard(module, mesh=mesh, ignored_params=whole or None)
    if hasattr(module, 'transformer_with_pred_head'):
        register_fsdp_forward_method(module, 'transformer_with_pred_head')
    return module


@torch.no_grad()
def average_whole_grads_(params, mesh) -> None:
    """Average over the ``mesh``'s ranks (a 2-D mesh's: the default
    group's), in place and in one all-reduce, the grads of the parameters in
    ``params`` that FSDP2 left whole (not DTensors); FSDP2 reduces the
    others itself."""
    grads = [p.grad for p in params if not isinstance(p, DTensor) and p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD)
    flat /= mesh.size()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def is_sharded(module: torch.nn.Module) -> bool:
    """True when any parameter of ``module`` is a DTensor (after
    `shard_module_fsdp`)."""
    return any(isinstance(p, DTensor) for p in module.parameters())


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writing to it writes the DTensor),
    any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def gather_full(obj):
    """``obj`` with every DTensor replaced by its full tensor, through dicts,
    lists and tuples. A collective: every rank of the mesh calls it on the
    same structure."""
    if isinstance(obj, DTensor):
        return obj.full_tensor()
    if isinstance(obj, dict):
        return type(obj)((k, gather_full(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(gather_full(v) for v in obj)
    return obj


def _local_part(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """The rows of ``full`` that this rank's shard of ``like`` holds
    (Shard: ``torch.chunk``'s piece, as FSDP2 cuts; Replicate: all)."""
    part, mesh = full, like.device_mesh
    for mesh_dim, placement in enumerate(like.placements):
        if placement.is_shard():
            pieces = torch.chunk(part, mesh.size(mesh_dim), dim=placement.dim)
            index = mesh.get_local_rank(mesh_dim)
            part = (pieces[index] if index < len(pieces)
                    else part.narrow(placement.dim, 0, 0))
        elif not placement.is_replicate():
            raise ValueError(f'cannot place a full tensor as {placement}')
    if part.shape != like.to_local().shape:
        raise ValueError(f'the full tensor of shape {tuple(full.shape)} does not cut to the '
                         f'local shard {tuple(like.to_local().shape)}')
    return part


@torch.no_grad()
def copy_full_(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy the full tensor ``full`` into ``dst`` in place: into a
    DTensor's local shard, the rows it holds."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(_local_part(full.to(dst.device), dst))
    else:
        dst.copy_(full)


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` placed as ``like``: a DTensor of ``like``'s mesh and
    placements holding this rank's part, or ``full`` itself when ``like``
    is not a DTensor."""
    if not isinstance(like, DTensor):
        return full
    part = _local_part(full.to(device=like.device, dtype=like.dtype), like)
    return DTensor.from_local(part.clone(), like.device_mesh, like.placements,
                              shape=like.shape, stride=like.stride())


def load_full_state_dict(module: torch.nn.Module, state: dict) -> None:
    """``module.load_state_dict(state)`` (strict) for a state of full
    tensors, into a sharded module too: each rank copies its part (of a
    tensor-parallel module, its piece: `tp.local_state_dict`)."""
    if tp_layouts(module):
        module.load_state_dict(local_state_dict(module, state))
        return
    if not is_sharded(module):
        module.load_state_dict(state)
        return
    targets = module.state_dict(keep_vars=True)
    missing, unexpected = sorted(set(targets) - set(state)), sorted(set(state) - set(targets))
    if missing or unexpected:
        raise RuntimeError(f'load_full_state_dict: missing keys {missing}, '
                           f'unexpected keys {unexpected}')
    for name, dst in targets.items():
        if tuple(state[name].shape) != tuple(dst.shape):
            raise RuntimeError(f'load_full_state_dict: {name} has shape '
                               f'{tuple(state[name].shape)}, the module {tuple(dst.shape)}')
        copy_full_(dst, state[name])


def shard_optimizer_state_(optimizer: torch.optim.Optimizer) -> None:
    """After ``optimizer.load_state_dict`` of full tensors: place each
    per-parameter state tensor of a parameter's shape as its parameter."""
    for group in optimizer.param_groups:
        for p in group['params']:
            state = optimizer.state.get(p)
            if not exists(state) or not isinstance(p, DTensor):
                continue
            for key, value in state.items():
                if torch.is_tensor(value) and not isinstance(value, DTensor) \
                        and value.shape == p.shape:
                    state[key] = shard_like(value, p)
