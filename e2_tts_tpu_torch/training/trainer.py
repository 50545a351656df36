"""E2Trainer — the single-device trainer (counterpart of
e2_tts_tpu/training/trainer.py).

One train step is the JAX package's jitted step, run eagerly: the
flow-matching loss (with the velocity-consistency teacher once the EMA has
ticked, when the model's ``velocity_consistency_weight > 0``), backward
through the port's kernels (K2, K4, K5b, K7 and PyTorch's autograd for the
rest), a global-norm clip with optax's formula, ADOPT with a linear warmup
-> linear decay schedule, then the EMA tick. The text-drop coin is a host
``random.Random(seed)`` draw per step, as in the JAX trainer; every other
draw of a step (span, x0, t, dropout seeds, the duration predictor's
prefix) comes from the trainer's ``torch.Generator``.

Gradient accumulation is optax.MultiSteps over the clip and ADOPT: the
grads of ``grad_accumulation_steps`` micro-batches are averaged, and clip
plus ADOPT act on the mean once every k calls, so ADOPT's step (and the
schedule) counts updates; the EMA still ticks on every micro-step, and the
global step, ``save_step`` and the ``'lr'`` tag count micro-steps. With a
``duration_predictor`` each step also takes its loss on the batch (no text)
and logs it as ``'duration loss'``; with ``train_duration_predictor=True``
that loss is optimised by its own clip + ADOPT on the same schedule,
stepping on every micro-step (the JAX trainer's ``dp_tx`` has no
MultiSteps).

`train` resumes from the checkpoint in ``checkpoint_path`` when there is
one (training/checkpointing.py) and saves every ``save_step`` steps. Its
resume semantics are the JAX trainer's: the epoch loop starts again at
epoch 0 with the same per-epoch shuffles, so the batches an interrupted
epoch already consumed are not skipped, and the text-drop coin's
``random.Random(seed)`` is seeded anew at every `train`; the generator takes
the saved state, or ``seed + start step`` without one.

Data parallelism (the JAX trainer's ``mesh`` and ``param_sharding``): with a
data ``mesh`` (`parallel.mesh.make_mesh`; by default one over the world when
a process group of more than one rank is up), every rank runs this loop in
step. ``batch_size`` is the global batch; every rank draws the same
shuffled batches, tokenizes and pads the whole batch and keeps its rows
(`parallel.mesh.shard_batch`), and its trainer's generator and text-drop
coin stay in step with a single device's. The model sees its rows' place
in the global batch (``batch_offset``): its draws are the global draws'
rows, its dropout bits those rows' bits, and its loss its term of the
global loss, so the step is the single-device step of the global batch.
``param_sharding='replicated'`` wraps the model (and a trained duration
predictor) in DDP; ``'fsdp'`` shards them and the EMA copy with FSDP2
(`parallel.fsdp`), and ADOPT, the EMA, the accumulator and the clip then
act on each rank's shards (the clip's norm is the whole gradient's, one
all-reduce). Each rank backpropagates its loss term times the number of
ranks, since DDP and FSDP average the grads over the ranks. The logged loss
is the global loss. Logs, TensorBoard, figures and the profiler run on
rank 0 only; a checkpoint is written by rank 0 (training/checkpointing.py).

The text-drop step: the coin is the same on every rank, but a dropped
step's text stream gets no grads, which DDP's reducer by default takes for
a fault. The DDP wrapper is built with ``find_unused_parameters=True``
rather than reducing the grads by hand after `_grads` makes the zeros: it
keeps DDP's bucketed all-reduce overlapping the backward, at the price of
a walk of the autograd graph a step, and both ways give the same numbers,
since every rank leaves out the same parameters. FSDP2 needs neither: a
unit that takes no part in the step is not gathered or reduced, on any
rank.

Tensor parallelism (the JAX package's ``parallel.tp``): ``mesh`` may be the
2-D ``(data, model)`` mesh (`parallel.tp.make_2d_mesh`) of a model that
`parallel.tp.shard_module_tp` sharded over it. The trainer keeps that
placement (the JAX trainer re-places every array and so undoes it): rows
come from the ``data`` axis, DDP runs over the data axis' group, each rank's
ADOPT, EMA (a copy of the sharded model) and accumulator act on its pieces,
and the clip's norm sums the squared norms of the tensor-parallel grads over
the ``model`` axis and counts every whole parameter once. The grads of the
whole parameters of which each rank uses its heads' rows (the value-head
gate, the value-residual mix) are summed over the model axis after the
backward, in one all-reduce (`parallel.tp.sum_shared_grads_`). A checkpoint
is written in the
single-device layout. ``param_sharding='fsdp'`` on a (data, model) mesh
raises NotImplementedError (ROADMAP.md queue 3: the JAX trainer does not
compose FSDP with TP either, its placement undoes TP).

Sequence parallelism (the JAX trainer's ``sequence_parallel``):
``sequence_parallel=P`` builds the (data, seq) mesh of ``world / P`` x ``P``
ranks (`parallel.sp.make_seq_mesh`), or ``mesh`` is one; the trainer routes
the model's and the EMA copy's attentions (the velocity teacher's) over its
``seq`` axis (`parallel.sp.enable_sequence_parallel`). Rows come from the
``data`` axis: every rank of a seq group takes the same rows and draws, and
computes its rows of the sequence. Each rank's loss term is its frames'
error over the whole span count, so its parameter grads are partial sums,
and one reduction over data x seq (DDP over the whole mesh, the term times
its size) gives the global grad; the clip's norm is the single device's.
``param_sharding='fsdp'`` shards over ``data`` and replicates over ``seq``
(FSDP2 on the (seq, data) view of the mesh). A batch whose frames plus
registers ``P`` does not divide raises ValueError, as in the JAX trainer.
The duration predictor runs dense on every rank of a seq group, its grads
reduced over ``data``. A checkpoint is written by rank 0 in the
single-device layout.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from e2_tts_tpu_torch.parallel.fsdp import (
    average_whole_grads_, copy_full_, local, shard_module_fsdp,
)
from e2_tts_tpu_torch.parallel.mesh import (
    DATA_AXIS, batch_rows, make_mesh, replicate_module, shard_batch,
)
from e2_tts_tpu_torch.parallel.multihost import is_main_process, world_size
from e2_tts_tpu_torch.parallel.sp import SEQ_AXIS, enable_sequence_parallel, make_seq_mesh
from e2_tts_tpu_torch.parallel.tp import (
    MODEL_AXIS, param_layouts, shared_params, sum_shared_grads_, tp_axis)
from e2_tts_tpu_torch.training import checkpointing
from e2_tts_tpu_torch.training.adopt import Adopt
from e2_tts_tpu_torch.training.data import iter_batches, prefetch
from e2_tts_tpu_torch.training.ema import EMA
from e2_tts_tpu_torch.utils.helpers import default, exists

logger = logging.getLogger('e2_tts_tpu_torch')


def _linear_schedule(init_value: float, end_value: float,
                     transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``transition_steps``, held
    at init when ``transition_steps <= 0``."""
    def schedule(step: int) -> float:
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def linear_warmup_decay_schedule(peak_lr: float, num_warmup_steps: int,
                                 total_steps: int) -> Callable[[int], float]:
    """Linear 1e-8 -> 1 warmup then linear 1 -> 1e-8 decay of ``peak_lr``
    (the JAX package's optax.join_schedules of two linear schedules)."""
    decay_steps = max(total_steps - num_warmup_steps, 1)
    warmup = _linear_schedule(peak_lr * 1e-8, peak_lr, num_warmup_steps)
    decay = _linear_schedule(peak_lr, peak_lr * 1e-8, decay_steps)
    return lambda step: warmup(step) if step < num_warmup_steps else decay(
        step - num_warmup_steps)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float, tp_sharded=None,
                         tp_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: each grad becomes ``g / norm *
    max_norm`` when the global norm reaches ``max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm; no host sync.
    Sharded grads enter with their local pieces' squared norms summed over
    the ranks that hold the other pieces, in one all-reduce: FSDP's
    (DTensors) over each mesh dimension they are sharded on, and the grads
    flagged in ``tp_sharded`` (tensor-parallel pieces) over ``tp_group``;
    every other grad counts once. The norm is the whole gradient's, and each
    rank scales its own pieces."""
    norms = torch.stack([torch.linalg.vector_norm(local(g).float()) for g in grads])
    sharded = [isinstance(g, DTensor) or (exists(tp_sharded) and bool(tp_sharded[i]))
               for i, g in enumerate(grads)]
    if not any(sharded):
        norm = torch.linalg.vector_norm(norms)
    else:
        dtensor = next((g for g in grads if isinstance(g, DTensor)), None)
        groups = ([dtensor.device_mesh.get_group(dim) for dim, placement
                   in enumerate(dtensor.placements) if placement.is_shard()]
                  if exists(dtensor) else [tp_group])
        sharded = torch.tensor(sharded, device=norms.device)
        squares = norms * norms
        total = torch.where(sharded, squares, 0.0).sum()
        for group in groups:
            dist.all_reduce(total, group=group)
        norm = torch.sqrt(total + torch.where(sharded, 0.0, squares).sum())
    keep = norm < max_norm
    for g in map(local, grads):
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def _grads(params: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each parameter's grad, a zero one where the step did not reach it
    (the text stream when the text is dropped): in JAX such a grad is
    zero, and ADOPT still decays its moments."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


class GradientAccumulator:
    """optax.MultiSteps' accumulation (``use_grad_mean=True``): the running
    mean of each parameter's grad by Welford's update ``acc + (g - acc) /
    (n + 1)``, emitted and reset every ``every_k`` calls."""

    def __init__(self, params, every_k: int):
        self.every_k = int(every_k)
        self.grads = [torch.zeros_like(p) for p in params]
        self.mini_step = 0

    @torch.no_grad()
    def add(self, grads: list[torch.Tensor]) -> bool:
        """Fold one micro-step's grads into the mean; True when this call
        completes the k-th, and ``self.grads`` then holds the mean. Sharded
        grads fold shard by shard."""
        n = self.mini_step
        for acc, g in zip(map(local, self.grads), map(local, grads)):
            acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        return self.mini_step == 0

    @torch.no_grad()
    def reset(self):
        for acc in self.grads:
            acc.zero_()

    def state_dict(self) -> dict:
        return dict(grads=list(self.grads), mini_step=self.mini_step)

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if len(state['grads']) != len(self.grads):
            raise ValueError(f'{len(state["grads"])} accumulated grads for '
                             f'{len(self.grads)} parameters')
        for acc, saved in zip(self.grads, state['grads']):
            copy_full_(acc, saved)
        self.mini_step = int(state['mini_step'])


class E2Trainer:

    def __init__(
        self,
        model,
        optimizer: torch.optim.Optimizer | None = None,
        learning_rate: float = 7.5e-5,
        num_warmup_steps: int = 20_000,
        total_steps: int | None = None,
        grad_accumulation_steps: int = 1,
        duration_predictor=None,
        train_duration_predictor: bool = False,
        checkpoint_path: str | None = None,
        log_file: str | None = None,
        max_grad_norm: float = 1.0,
        sample_rate: int = 24_000,
        tensorboard_log_dir: str = 'runs/e2_tts_experiment',
        mesh=None,
        param_sharding: str = 'replicated',
        sequence_parallel: int = 1,
        ema_kwargs: dict = dict(),
        use_switch_ema: bool = False,
        use_tensorboard: bool = False,
        profile_dir: str | None = None,
        profile_steps: tuple[int, int] = (10, 15),
        dtype=None,
        log_step: int = 10,
        seed: int = 0,
    ):
        """``optimizer``: a ready optimizer over ``model``'s parameters
        (default: `Adopt` on the warmup/decay schedule). ``total_steps``
        fixes the schedule's horizon; None derives it from the dataset at
        `train`. ``dtype`` sets the compute dtype of every submodule of the
        model and of the duration predictor (parameters stay f32).
        ``profile_dir``: a torch.profiler Chrome trace of the global steps
        in ``[profile_steps[0], profile_steps[1])`` is written there (on
        rank 0). The trainer runs on the model's device.

        ``mesh``: a 1-D data mesh (`parallel.mesh.make_mesh`), the 2-D
        (data, model) mesh (`parallel.tp.make_2d_mesh`) that
        `parallel.tp.shard_module_tp` sharded the model over, or a (data,
        seq) mesh (`parallel.sp.make_seq_mesh`); None means, with
        ``sequence_parallel=P > 1``, the (data, seq) mesh of ``world / P`` x
        ``P`` ranks, else a 1-D mesh over the world when a process group of
        more than one rank is up, else a single device. Under a mesh,
        ``param_sharding`` is ``'replicated'`` (DDP) or, on a 1-D or a
        (data, seq) mesh, ``'fsdp'`` (FSDP2 over ``data``); every rank
        starts from rank 0's weights. Build the trainer after loading
        weights: FSDP replaces the model's parameters, so a ready
        ``optimizer`` cannot be taken with ``'fsdp'``."""
        if param_sharding not in ('replicated', 'fsdp'):
            raise ValueError(f"param_sharding must be 'replicated' or 'fsdp', "
                             f'got {param_sharding!r}')
        if sequence_parallel < 1:
            raise ValueError(f'sequence_parallel must be >= 1, got {sequence_parallel}')
        if mesh is None and sequence_parallel > 1:
            if world_size() % sequence_parallel:
                raise ValueError(f'sequence_parallel={sequence_parallel} must divide the '
                                 f'number of ranks ({world_size()})')
            mesh = make_seq_mesh(sequence_parallel, world_size() // sequence_parallel)
        if mesh is None and world_size() > 1:
            mesh = make_mesh()
        if exists(mesh) and not (isinstance(mesh, DeviceMesh) and (
                mesh.ndim == 1 or mesh.mesh_dim_names in ((DATA_AXIS, MODEL_AXIS),
                                                          (DATA_AXIS, SEQ_AXIS)))):
            raise TypeError(f'mesh must be a 1-D DeviceMesh (parallel.mesh.make_mesh), a '
                            f'(data, model) one (parallel.tp.make_2d_mesh) or a (data, seq) '
                            f'one (parallel.sp.make_seq_mesh), got {mesh!r}')
        seq_mesh = exists(mesh) and mesh.mesh_dim_names == (DATA_AXIS, SEQ_AXIS)
        if sequence_parallel > 1 and not (seq_mesh
                                          and mesh[SEQ_AXIS].size() == sequence_parallel):
            raise ValueError(f'sequence_parallel={sequence_parallel} needs a mesh with a `seq` '
                             f'axis of that size (parallel.sp.make_seq_mesh)')
        if seq_mesh and mesh.size() != world_size():
            # the model's DDP, its replication and the whole grads' sums run
            # over every rank
            raise ValueError(f'a (data, seq) mesh must span every rank: {mesh.size()} of '
                             f'{world_size()}')
        tp_meshes = {getattr(tp_axis(m), 'mesh', None)
                     for m in filter(exists, (model, duration_predictor))} - {None}
        if exists(mesh) and mesh.ndim == 2 and not seq_mesh:
            if param_sharding == 'fsdp':
                raise NotImplementedError(
                    "param_sharding='fsdp' on a (data, model) mesh is not ported: the JAX "
                    'trainer does not compose FSDP with tensor parallelism either (ROADMAP.md '
                    'queue 3)')
            if tp_meshes != {mesh} or not exists(tp_axis(model)):
                raise ValueError('a (data, model) mesh takes a model (and predictor) that '
                                 'parallel.tp.shard_module_tp sharded over it')
        elif tp_meshes:
            raise ValueError('a tensor-parallel model trains on the (data, model) mesh it was '
                             'sharded over: pass it as mesh=')
        if exists(mesh) and param_sharding == 'fsdp' and exists(optimizer):
            raise ValueError("param_sharding='fsdp' replaces the model's parameters: let the "
                             'trainer build its optimizer')
        if grad_accumulation_steps < 1:
            raise ValueError(f'grad_accumulation_steps must be >= 1, got {grad_accumulation_steps}')
        self.is_main = is_main_process()
        if exists(log_file) and self.is_main:
            logger.addHandler(logging.FileHandler(log_file))

        if exists(dtype):
            for module in filter(exists, (model, duration_predictor)):
                for sub in module.modules():
                    if 'dtype' in vars(sub):
                        sub.dtype = dtype

        self.model = model
        self.device = model.device
        self.duration_predictor = duration_predictor
        self.train_duration_predictor = train_duration_predictor and exists(duration_predictor)
        self.need_velocity_consistent_loss = model.velocity_consistency_weight > 0.0
        self.mesh = mesh
        # the 1-D mesh of the data axis: the rows, DDP and the loss's sum
        self.data_mesh = mesh[DATA_AXIS] if exists(mesh) and mesh.ndim == 2 else mesh
        self.seq_mesh = mesh if seq_mesh else None
        self._tp = {}            # module -> its model axis, which params are pieces, shared
        self.param_sharding = param_sharding
        if exists(mesh):
            for module in filter(exists, (model, duration_predictor)):
                replicate_module(module, mesh if seq_mesh else self.data_mesh)
        if seq_mesh:
            enable_sequence_parallel(model, mesh)
        self.ema = EMA(model, **ema_kwargs)
        if seq_mesh:            # the velocity teacher rides the ring too
            enable_sequence_parallel(self.ema.ema_model, mesh)
        # FSDP2 shards over the data axis and, on a (data, seq) mesh,
        # replicates over seq: its (seq, data) view
        self._fsdp_mesh = (DeviceMesh(mesh.device_type, mesh.mesh.t().contiguous(),
                                      mesh_dim_names=(SEQ_AXIS, DATA_AXIS))
                           if seq_mesh and param_sharding == 'fsdp' else mesh)
        self._model_fn = self._place(model, whole_mesh=True)
        self._dp_fn = (self._place(duration_predictor) if self.train_duration_predictor
                       else duration_predictor)
        if exists(mesh) and param_sharding == 'fsdp':
            shard_module_fsdp(self.ema.ema_model, self._fsdp_mesh)
        self.use_switch_ema = use_switch_ema
        self.num_warmup_steps = num_warmup_steps
        self.max_grad_norm = max_grad_norm
        self.target_sample_rate = sample_rate
        self.grad_accumulation_steps = grad_accumulation_steps
        self.accumulator = (GradientAccumulator(model.parameters(), grad_accumulation_steps)
                            if grad_accumulation_steps > 1 else None)
        self.learning_rate = learning_rate
        self._user_optimizer = optimizer
        self.schedule = None
        self.optimizer = None
        self.dp_optimizer = None
        if exists(total_steps):
            self._build_optimizer(total_steps)

        self.checkpoint_path = default(checkpoint_path, 'e2tts_ckpt')
        self.seed = seed
        self.log_step = max(int(log_step), 1)
        self.generator = torch.Generator().manual_seed(seed)
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler = None

        self.writer = None
        if use_tensorboard and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(log_dir=tensorboard_log_dir)
            except ImportError:
                logger.warning('tensorboard unavailable; scalar logging disabled')

    def _place(self, module, whole_mesh: bool = False):
        """The callable a step runs ``module`` through: the module itself on
        one device or after FSDP2's in-place sharding, else its DDP wrapper,
        over the data axis or, with ``whole_mesh`` on a (data, seq) mesh (the
        model, whose grads are partial sums over seq), over every rank."""
        if not exists(self.mesh):
            return module
        if self.param_sharding == 'fsdp':
            return shard_module_fsdp(module, self._fsdp_mesh)
        from torch.nn.parallel import DistributedDataParallel
        device_ids = [self.device.index] if self.device.type == 'cuda' else None
        group = (dist.group.WORLD if whole_mesh and exists(self.seq_mesh)
                 else self.data_mesh.get_group())
        return DistributedDataParallel(module, device_ids=device_ids, process_group=group,
                                       broadcast_buffers=False, find_unused_parameters=True)

    def _check_seq_batch(self, frames: int):
        """The JAX trainer's check of a batch under sequence parallelism,
        with its words: the ring needs frames + registers divisible by the
        seq axis."""
        size, registers = self.seq_mesh[SEQ_AXIS].size(), self.model.transformer.num_registers
        attended = frames + registers
        if attended % size:
            raise ValueError(
                f'sequence_parallel={size} needs (frames + num_registers) divisible by the '
                f'seq axis; this batch has {frames} frames + {registers} registers = '
                f'{attended}. Pick `frame_bucket` so that (bucketed frames + num_registers) % '
                f'{size} == 0.')

    def _shards(self, whole_mesh: bool = False) -> int:
        """The number of ranks whose loss terms DDP and FSDP average a grad
        over: the data axis', or with ``whole_mesh`` on a (data, seq) mesh
        (the model, whose grads are partial sums over seq) every rank's. The
        duration predictor's grads are equal on a seq group's ranks, so its
        terms count once a data rank."""
        if not exists(self.mesh):
            return 1
        return self.mesh.size() if whole_mesh and exists(self.seq_mesh) else self.data_mesh.size()

    def _rows(self, *arrays):
        """This rank's rows of the global batch's ``arrays`` (None passes)
        and the keyword arguments that place them in it (none on one
        device)."""
        if not exists(self.mesh):
            return arrays, {}
        batch = len(arrays[0])
        start, _ = batch_rows(batch, self.data_mesh)
        return shard_batch(arrays, self.data_mesh), dict(batch_offset=start, global_batch=batch)

    def _tp_placement(self, module, params: list[torch.Tensor]):
        """``module``'s model axis (None: not tensor-parallel), which of
        ``params`` are tensor-parallel pieces, and its `shared_params`; the
        placement is fixed, so the module is walked once."""
        if module not in self._tp:
            axis = tp_axis(module)
            layouts = param_layouts(module) if exists(axis) else {}
            self._tp[module] = (axis, [p in layouts for p in params],
                                shared_params(module) if exists(axis) else [])
        return self._tp[module]

    def _reduced_grads(self, module, params: list[torch.Tensor]) -> list[torch.Tensor]:
        """`_grads`, then under FSDP the grads of the parameters it left
        whole averaged over the ranks (DDP and FSDP reduce the rest), and
        under TP the shared parameters' grads summed over the model axis."""
        grads = _grads(params)
        if exists(self.mesh) and self.param_sharding == 'fsdp':
            average_whole_grads_(params, self._fsdp_mesh)
        axis, _, shared = self._tp_placement(module, params)
        if exists(axis):
            sum_shared_grads_(shared, axis)
        return grads

    def _global_loss(self, term: torch.Tensor) -> torch.Tensor:
        """The global loss from this rank's term of it (the sum over the
        data axis' ranks), detached."""
        term = term.detach()
        if exists(self.mesh):
            term = term.clone()
            dist.all_reduce(term, group=self.data_mesh.get_group())
        return term

    def _clip(self, module, params: list[torch.Tensor]) -> torch.Tensor:
        """`clip_by_global_norm_` of ``params``' grads, the tensor-parallel
        ones' norms summed over the model axis."""
        grads = [p.grad for p in params]
        axis, sharded, _ = self._tp_placement(module, params)
        if not exists(axis):
            return clip_by_global_norm_(grads, self.max_grad_norm)
        return clip_by_global_norm_(grads, self.max_grad_norm, tp_sharded=sharded,
                                    tp_group=axis.group)

    def _build_optimizer(self, total_steps: int):
        self.schedule = linear_warmup_decay_schedule(
            self.learning_rate, self.num_warmup_steps, total_steps)
        self.optimizer = default(self._user_optimizer,
                                 Adopt(self.model.parameters(), lr=self.schedule))
        self.dp_optimizer = (Adopt(self.duration_predictor.parameters(), lr=self.schedule)
                             if self.train_duration_predictor else None)

    def _as_device(self, t, dtype):
        return torch.as_tensor(t, dtype=dtype).to(self.device)

    # -- one step --------------------------------------------------------------

    def prepare_batch(self, batch: dict):
        """A collated batch (`iter_batches`) -> ``(mel (b, n, d), mel_lens,
        text_ids)`` as `train_step` takes them: text tokenized and padded
        with -1 to a multiple of 32 characters, as the JAX trainer does."""
        model = self.model
        if batch['mel'].shape[1] != model.num_channels:
            raise ValueError(
                f"batch mel has {batch['mel'].shape[1]} channels, model expects "
                f'{model.num_channels}: dataset items must be (channels, frames) '
                'mel spectrograms')
        mel = np.ascontiguousarray(np.moveaxis(batch['mel'], 1, 2))   # b n d
        text_ids = model.tokenizer(batch['text'])
        pad_nt = -(-text_ids.shape[1] // 32) * 32
        text_ids = np.pad(text_ids, ((0, 0), (0, pad_nt - text_ids.shape[1])),
                          constant_values=-1)
        return mel, batch['mel_lengths'], text_ids

    def train_step(self, mel, mel_lens, text_ids, drop_text_cond: bool, *,
                   times=None, noise=None, rand_span_mask=None):
        """One micro-step on a batch: ``mel (b, n, num_channels)``,
        ``mel_lens (b,)``, ``text_ids (b, nt)`` (-1 padded). Loss, backward,
        then clip and ADOPT (on the accumulated mean, every
        ``grad_accumulation_steps``-th call), then the EMA tick. ``times``,
        ``noise`` and ``rand_span_mask`` replace the step's draws (see
        `E2TTS.forward`). Under a mesh every rank passes the same global
        batch (and draws) and takes its rows. Returns ``(loss, cond,
        pred_data)``, detached, with no host sync: the global batch's loss,
        and this rank's rows of the others."""
        if not exists(self.optimizer):
            raise RuntimeError('the optimizer is built at train() or from total_steps=')
        model = self.model
        if exists(self.seq_mesh):
            self._check_seq_batch(np.shape(mel)[1])
        model.train()
        teacher = (self.ema.ema_model
                   if self.need_velocity_consistent_loss and self.ema.initted else None)
        (mel, mel_lens, text_ids, times, noise, rand_span_mask), place = self._rows(
            mel, mel_lens, text_ids, times, noise, rand_span_mask)
        self.optimizer.zero_grad(set_to_none=True)
        out = self._model_fn(self._as_device(mel, torch.float32),
                             text=self._as_device(text_ids, torch.long),
                             lens=self._as_device(mel_lens, torch.long), times=times,
                             noise=noise, rand_span_mask=rand_span_mask,
                             drop_text_cond=drop_text_cond, velocity_consistency_model=teacher,
                             generator=self.generator, **place)
        # DDP and FSDP average the grads over the ranks: the loss term times
        # their number makes that average the global loss's grad
        (out.loss * self._shards(whole_mesh=True)).backward()
        if exists(teacher) and self.param_sharding == 'fsdp' and exists(self.mesh):
            # FSDP2 keeps a root's parameters gathered after its forward for
            # the backward; the teacher has none, so free them here
            teacher.reshard()
        params = list(model.parameters())
        grads = self._reduced_grads(model, params)
        acc = self.accumulator
        if acc is None or acc.add(grads):
            if exists(acc):             # the optimizer acts on the mean
                for p, mean in zip(params, acc.grads):
                    p.grad = mean
            self._clip(model, params)
            self.optimizer.step()
            if exists(acc):
                self.optimizer.zero_grad(set_to_none=True)
                acc.reset()
        self.ema.update(model)
        return self._global_loss(out.loss), out.cond, out.pred_data.detach()

    def duration_step(self, mel, mel_lens, *, rand_frac=None) -> torch.Tensor:
        """The duration predictor's loss on a batch without text (``mel (b,
        n, d)``, ``mel_lens (b,)``): with ``train_duration_predictor`` one
        step of its own (backward, clip, ADOPT), else under no_grad. The
        random prefix ``rand_frac (b,)`` is drawn from the trainer's
        generator unless given. Under a mesh the batch is the global one,
        as in `train_step`. Returns the global batch's loss, detached."""
        dp = self.duration_predictor
        if not exists(dp):
            raise RuntimeError('the trainer has no duration predictor')
        (mel, mel_lens, rand_frac), place = self._rows(mel, mel_lens, rand_frac)
        mel = self._as_device(mel, torch.float32)
        lens = self._as_device(mel_lens, torch.long)
        if not self.train_duration_predictor:
            with torch.no_grad():
                return self._global_loss(dp(mel, lens=lens, return_loss=True,
                                            rand_frac=rand_frac, generator=self.generator,
                                            **place))
        if not exists(self.dp_optimizer):
            raise RuntimeError('the optimizer is built at train() or from total_steps=')
        self.dp_optimizer.zero_grad(set_to_none=True)
        loss = self._dp_fn(mel, lens=lens, return_loss=True, rand_frac=rand_frac,
                           generator=self.generator, **place)
        (loss * self._shards()).backward()
        params = list(dp.parameters())
        self._reduced_grads(dp, params)
        self._clip(dp, params)
        self.dp_optimizer.step()
        return self._global_loss(loss)

    # -- checkpoints (JAX trainer.py:251-265) -------------------------------------

    def save_checkpoint(self, step: int) -> str:
        """Everything `train` needs to continue from ``step``, in
        ``checkpoint_path``; returns the file's path."""
        trained_dp = self.train_duration_predictor
        return checkpointing.save_checkpoint(
            self.checkpoint_path, model=self.model, optimizer=self.optimizer, ema=self.ema,
            step=step, duration_predictor=self.duration_predictor if trained_dp else None,
            dp_optimizer=self.dp_optimizer, generator=self.generator,
            accumulator=self.accumulator, mesh=self.mesh)

    def load_checkpoint(self):
        """Restore from ``checkpoint_path`` in place; returns ``(step,
        generator state)``, ``(0, None)`` when there is no checkpoint. The
        generator is not touched here: `train` sets it."""
        trained_dp = self.train_duration_predictor
        return checkpointing.load_checkpoint(
            self.checkpoint_path, model=self.model, optimizer=self.optimizer, ema=self.ema,
            duration_predictor=self.duration_predictor if trained_dp else None,
            dp_optimizer=self.dp_optimizer, accumulator=self.accumulator,
            map_location=self.device)

    def resume(self) -> int:
        """What `train` does first: restore the checkpoint, if there is one,
        and set the generator to its saved state, or to ``seed + step``
        without one (JAX trainer.py:318-320). Returns the step to start
        from."""
        start_step, generator_state = self.load_checkpoint()
        if exists(generator_state):
            self.generator.set_state(generator_state)
        else:
            self.generator.manual_seed(self.seed + start_step)
        return start_step

    # -- tracing and logging ----------------------------------------------------

    def _maybe_profile(self, global_step: int):
        """A torch.profiler trace of the steps in ``profile_steps``, written
        as a Chrome trace into ``profile_dir`` when the window closes (rank
        0 only)."""
        if not exists(self.profile_dir) or not self.is_main:
            return
        start, stop = self.profile_steps
        if global_step == start and not exists(self._profiler):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif global_step >= stop and exists(self._profiler):
            self._stop_profile(global_step)

    def _stop_profile(self, global_step: int):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(
            self.profile_dir, f'steps_{self.profile_steps[0]}-{global_step}.trace.json'))
        self._profiler = None

    def _log_info(self, msg: str):
        if self.is_main:
            logger.info(msg)

    def _log_scalar(self, tag, value, step):
        if exists(self.writer):
            self.writer.add_scalar(tag, float(value), step)

    def _log_figure(self, tag, mel, step):
        if not exists(self.writer):
            return
        try:
            from e2_tts_tpu_torch.utils.plotting import plot_spectrogram
            self.writer.add_figure(tag, plot_spectrogram(mel), step)
        except ImportError:
            pass

    # -- train loop (JAX trainer.py:299-452) --------------------------------------

    def train(self, train_dataset, epochs: int, batch_size: int, num_workers: int = 0,
              save_step: int = 1000, frame_bucket: int = 64) -> list[tuple[int, float]]:
        """Train over ``train_dataset`` (items ``dict(mel_spec=(d, n),
        text=str)``) for ``epochs``, resuming from ``checkpoint_path`` and
        saving there every ``save_step`` global steps. ``num_workers > 0``
        collates batches ahead in a background thread. Logs the loss every
        ``log_step`` steps and returns ``[(step, loss), ...]`` of this
        call. Under a mesh every rank calls it; ``batch_size`` is the global
        batch, which the data axis must divide."""
        model = self.model
        if batch_size % self._shards():
            raise ValueError(f'batch_size ({batch_size}) must be divisible by the number of '
                             f'ranks on the data axis ({self._shards()})')
        rng = random.Random(self.seed)
        steps_per_epoch = max(len(train_dataset) // batch_size, 1)
        if not exists(self.optimizer):
            self._build_optimizer(max(steps_per_epoch * epochs, self.num_warmup_steps + 1))

        global_step = self.resume()
        history = []
        for epoch in range(epochs):
            model.train()
            pending = []            # (step, loss, duration loss), device tensors
            epoch_losses = []

            def flush():
                for step, loss, dur_loss in pending:
                    loss = float(loss)
                    self._log_info(f'step {step + 1}: loss = {loss:.4f}')
                    history.append((step, loss))
                    epoch_losses.append(loss)
                    self._log_scalar('loss', loss, step)
                    if exists(dur_loss):
                        self._log_scalar('duration loss', dur_loss, step)
                    self._log_scalar('lr', self.schedule(step), step)
                pending.clear()

            batches = iter_batches(train_dataset, batch_size, shuffle=True,
                                   seed=self.seed + epoch, frame_bucket=frame_bucket)
            if num_workers > 0:
                batches = prefetch(batches, size=max(2, num_workers))
            for batch in batches:
                mel, mel_lens, text_ids = self.prepare_batch(batch)
                dur_loss = (self.duration_step(mel, mel_lens)
                            if exists(self.duration_predictor) else None)
                self._maybe_profile(global_step)
                drop_text_cond = rng.random() < model.cond_drop_prob
                loss, cond, pred_data = self.train_step(mel, mel_lens, text_ids, drop_text_cond)
                pending.append((global_step, loss, dur_loss))
                global_step += 1
                if len(pending) >= self.log_step:
                    flush()
                if global_step % save_step == 0:
                    flush()
                    self.save_checkpoint(global_step)
                    self._log_figure('mel/target', mel[0], global_step)
                    self._log_figure('mel/mask', cond[0].float().cpu().numpy(), global_step)
                    self._log_figure('mel/prediction', pred_data[0].float().cpu().numpy(),
                                     global_step)
            flush()
            if epoch_losses:
                avg = sum(epoch_losses) / len(epoch_losses)
                self._log_info(f'epoch {epoch + 1}/{epochs} - average loss = {avg:.4f}')
                self._log_scalar('epoch average loss', avg, epoch)

        if exists(self._profiler):
            self._stop_profile(global_step)
        if self.use_switch_ema:
            self.ema.update_model_with_ema(model)
        if exists(self.writer):
            self.writer.close()
        return history
