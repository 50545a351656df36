"""Process-group initialisation (counterpart of
e2_tts_tpu/parallel/multihost.py).

The JAX package wires ``jax.distributed`` from the TPU environment so that
``jax.devices()`` is global. Here the counterpart is torch.distributed's
default process group, one process per GPU: `maybe_initialize_distributed`
starts it from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from explicit
arguments, with NCCL on the GPUs, or with gloo on the CPU when the caller
asks for ``device='cpu'`` (the CPU tests do). Nothing here falls back: a
process group that fails to start raises, whatever the backend.

    torchrun --nproc_per_node=8 train.py      # train.py calls
    maybe_initialize_distributed()            # then E2Trainer(model) trains
                                              # over the data mesh of all 8
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def maybe_initialize_distributed(init_method: str | None = None,
                                 world_size: int | None = None,
                                 rank: int | None = None, device=None,
                                 timeout: float | None = None) -> bool:
    """Start the default process group when this process is one of a
    multi-process launch: torchrun's environment or an explicit
    ``init_method`` (``'tcp://host:port'`` or ``'file:///path'``) with
    ``world_size`` and ``rank``. Returns True when a group is up, False for
    a single process (neither given). Safe to call more than once.

    NCCL unless ``device`` is the CPU (then gloo); for NCCL the process
    takes the GPU ``LOCAL_RANK`` (explicit arguments: ``rank``) with
    ``torch.cuda.set_device``. ``timeout`` (seconds) bounds each collective
    and the rendezvous."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if 'RANK' not in env or 'WORLD_SIZE' not in env:
            return False                      # a single process: nothing to do
        init_method = 'env://'
    elif world_size is None or rank is None:
        raise ValueError('an explicit init_method needs world_size and rank')

    cpu = device is not None and torch.device(device).type == 'cpu'
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError('the NCCL process group needs a CUDA GPU and none is '
                               "available; pass device='cpu' for a gloo group on the CPU")
        local_rank = int(env.get('LOCAL_RANK', rank if rank is not None else env['RANK']))
        torch.cuda.set_device(local_rank)
    kwargs = dict(backend='gloo' if cpu else 'nccl', init_method=init_method)
    if world_size is not None:
        kwargs.update(world_size=int(world_size), rank=int(rank))
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(**kwargs)
    return True


def is_main_process() -> bool:
    """Rank 0, or the only process (the reference's
    ``accelerator.is_main_process``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    """The number of processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1
