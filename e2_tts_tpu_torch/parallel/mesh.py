"""The data mesh (counterpart of e2_tts_tpu/parallel/mesh.py).

The reference trains with DDP through Accelerate. The JAX package carries
that as a 1-D ``data`` mesh with replicated (or FSDP-sharded, fsdp.py)
state and batches sharded on axis 0. Here the mesh is a 1-D
``DeviceMesh`` named ``('data',)`` over the default process group, one
rank per device; rank r holds rows ``[r B/P, (r + 1) B/P)`` of a global
batch of B, the rows ``jax.device_put(..., P('data'))`` gives device r.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from e2_tts_tpu_torch.utils.helpers import default

DATA_AXIS = 'data'


def init_mesh(shape: tuple[int, ...], names: tuple[str, ...], caller: str) -> DeviceMesh:
    """A DeviceMesh of ``shape`` named ``names`` spanning every rank of the
    default process group, on the backend's device type: CUDA for NCCL,
    the CPU for gloo (whose groups take CUDA tensors too). ``caller`` names
    the public function in the errors."""
    if not dist.is_initialized():
        raise RuntimeError(f'{caller} needs a process group: call '
                           f'multihost.maybe_initialize_distributed() first')
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f'a mesh of {" x ".join(map(str, shape))} does not span the world '
                         f'({world} ranks)')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_mesh(n: int | None = None) -> DeviceMesh:
    """The 1-D data mesh over every rank of the default process group
    (`multihost.maybe_initialize_distributed` starts it). ``n``, when
    given, must be the world size: a mesh over part of the world is not
    supported."""
    world = dist.get_world_size() if dist.is_initialized() else None
    return init_mesh((default(n, world),), (DATA_AXIS,), 'make_mesh')


def batch_rows(batch_size: int, mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's rows ``(start, stop)`` of a global batch of
    ``batch_size``; raises unless the mesh size divides it."""
    n = mesh.size()
    if batch_size % n:
        raise ValueError(f'batch size {batch_size} must be divisible by the number of '
                         f'ranks on the data axis ({n})')
    per = batch_size // n
    start = mesh.get_local_rank() * per
    return start, start + per


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of every array (numpy or tensor; None passes) in
    ``batch``, an array or a dict / list / tuple of them, all of one batch
    size."""
    sizes = set()

    def walk(x, fn):
        if isinstance(x, dict):
            return {k: walk(v, fn) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, fn) for v in x)
        return x if x is None else fn(x)

    walk(batch, lambda x: sizes.add(len(x)))
    if len(sizes) > 1:
        raise ValueError(f'the arrays of one batch differ in batch size: {sorted(sizes)}')
    if not sizes:
        return batch
    start, stop = batch_rows(sizes.pop(), mesh)
    return walk(batch, lambda x: x[start:stop])


@torch.no_grad()
def replicate_module(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Broadcast every parameter and buffer from the mesh's rank 0, in
    place, so that every rank starts from the same state (a 2-D mesh spans
    the default group)."""
    group = mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD
    src = dist.get_global_rank(group, 0)
    for t in (*module.parameters(), *module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module
