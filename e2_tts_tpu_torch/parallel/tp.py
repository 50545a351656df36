"""Tensor parallelism over a (data, model) mesh (counterpart of
e2_tts_tpu/parallel/tp.py).

The JAX package places each layer's attention and feedforward kernels with
a ``NamedSharding`` over a ``model`` axis (q / k / v and the GEGLU input
column-parallel, the output projections row-parallel) and lets GSPMD insert
the all-reduces. The port does the same split by hand, Megatron-style: a
rank of the model axis holds ``1/T`` of each matched layer as plain
tensors, computes its heads and GEGLU columns, and two collectives a layer
join the ranks:

- the layer's input enters through `ModelAxis.enter`: identity in the
  forward, its grad summed over the model axis in the backward (each rank's
  q, k, v or GEGLU columns see only their share of the input's grad);
- the row-parallel output projection's partial sums leave through
  `ModelAxis.exit`: all-reduced in the forward, identity in the backward;
  a bias is added after the sum.

What a rank holds (``T`` the model axis' size, ``r`` its rank):

- ``attn`` / ``freq_attn``: heads ``[h0, h0 + H/T)``, ``h0 = r H/T``: the
  rows ``[h0 dh, (h0 + H/T) dh)`` of each of the q, k and v segments of
  ``to_qkv.weight (3 inner, dim)``, and those columns of ``to_out.weight``.
  The value-head gate and the value-residual mix (dim -> heads) stay whole
  on every rank, as in the JAX package; a rank uses its heads' rows of
  them, so its grads hold only those rows' part: `sum_shared_grads_` sums
  them over the model axis after the backward, in one all-reduce. The
  attention kernels draw the dropout bits of global head ``(b0 + b) H + h0
  + h`` (``hash_h0 = h0``, ``hash_heads = H``).
- ``ff``: GEGLU columns ``[c0, c0 + I/T)``, ``c0 = r I/T``: the value rows
  ``[c0, c0 + I/T)`` and the gate rows ``[I + c0, I + c0 + I/T)`` of
  ``proj_in.weight (2 I, dim)`` and its bias (`geglu_dropout` splits its
  input in halves), and those columns of ``proj_out.weight``. K6 / K7 take
  the column offset folded into their seed (`fold_column_offset`).

Everything else (embeddings, convs, norms, hyper-connections, the time MLP,
the heads) is whole on every rank and computed alike by every rank of a
model group, from the same inputs and the same generator state.

The rule table is anchored on modules, not matched as substrings, as the
JAX package's: only an `Attention` named ``attn`` or ``freq_attn`` and a
`FeedForward` named ``ff`` split, so the model-level ``proj_in`` (the mel
projection) stays whole. A matched layer the mesh cannot divide raises
``ValueError``, and so does a module with no match. Unlike the JAX package
the port also raises when the model axis does not divide a layer's heads:
GSPMD would split a head's columns across ranks, and the port's kernels
take whole heads.

A sharded tensor has a layout ``(dim, segments)``: along ``dim`` it is
``segments`` equal segments, each cut in ``T`` pieces; rank ``r`` holds the
``r``-th piece of every segment, in order (`local_part`, `full_tensor`). A
checkpoint is written in the single-device layout (training/checkpointing.py
gathers through `full_state_dict`) and cut again at load
(`local_state_dict`), so a checkpoint moves between a TP run and one
device either way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from e2_tts_tpu_torch.models.blocks import Attention, FeedForward
from e2_tts_tpu_torch.parallel.mesh import DATA_AXIS, init_mesh
from e2_tts_tpu_torch.utils.helpers import exists

MODEL_AXIS = 'model'

# (module class, the names it is matched under, parameter, layout): each
# matched layer's parameters and their (dim, segments) layouts
_RULES = (
    (Attention, ('attn', 'freq_attn'), 'to_qkv.weight', (0, 3)),
    (Attention, ('attn', 'freq_attn'), 'to_out.weight', (1, 1)),
    (FeedForward, ('ff',), 'proj_in.weight', (0, 2)),
    (FeedForward, ('ff',), 'proj_in.bias', (0, 2)),
    (FeedForward, ('ff',), 'proj_out.weight', (1, 1)),
)


def make_2d_mesh(data: int, model: int):
    """The ``('data', 'model')`` DeviceMesh of ``data`` x ``model`` ranks over
    the default process group (`multihost.maybe_initialize_distributed`
    starts it); ``data * model`` must be the world size. Rank ``d model + m``
    is at ``(d, m)``: a model group is ``model`` consecutive ranks."""
    if data < 1 or model < 1:
        raise ValueError(f'a (data, model) mesh needs both axes >= 1, got {data} x {model}')
    return init_mesh((data, model), (DATA_AXIS, MODEL_AXIS), 'make_2d_mesh')


class ModelAxis:
    """A rank's place on the model axis: its group, the axis' size and its
    rank there, and the mesh it belongs to (its data axis' group sums the
    loss's span count). Shared, not copied, by a deep copy of the module
    (the EMA's)."""

    def __init__(self, group, size: int, rank: int, mesh=None):
        self.group, self.size, self.rank, self.mesh = group, size, rank, mesh
        self.data_group = mesh[DATA_AXIS].get_group() if exists(mesh) else None

    @classmethod
    def of(cls, mesh) -> 'ModelAxis':
        model = mesh[MODEL_AXIS]
        return cls(model.get_group(), model.size(), model.get_local_rank(), mesh)

    def __deepcopy__(self, memo):
        return self

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model axis, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; in the backward the grad is summed over the model axis."""
        return _Enter.apply(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model axis; identity in the backward."""
        return _Exit.apply(x, self)



class _Enter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad.contiguous().clone()), None


class _Exit(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _plain_mlp_layout(layer, param: str, layout):
    """A feedforward without GLU (``glu=False``) has no value and gate
    halves: its ``proj_in`` is one segment."""
    if isinstance(layer, FeedForward) and not layer.glu and param.startswith('proj_in'):
        return layout[0], 1
    return layout


def _targets(module: nn.Module):
    """``(path, layer, [(parameter name, layout)])`` of each layer the rules
    match, in ``named_modules`` order."""
    found = []
    for path, sub in module.named_modules():
        name = path.rsplit('.', 1)[-1]
        rules = [(param, _plain_mlp_layout(sub, param, layout))
                 for cls, names, param, layout in _RULES if isinstance(sub, cls) and name in names]
        if rules:
            found.append((path, sub, rules))
    return found


def _checked_targets(module: nn.Module, size: int):
    """`_targets`, each matched layer's widths (and, the port's own rule,
    its heads) divisible by the model axis' ``size``; else ValueError, as
    for a module with no match."""
    targets = _targets(module)
    if not targets:
        raise ValueError('tensor-parallel sharding matched NO parameters: the module has no '
                         'transformer attn / ff layers under the expected names')
    indivisible, heads = [], []
    for path, sub, rules in targets:
        for param, (dim, segments) in rules:
            shape = tuple(sub.get_parameter(param).shape)
            if shape[dim] % (segments * size):
                indivisible.append((f'{path}.{param}', shape))
        if isinstance(sub, Attention) and sub.heads % size:
            heads.append((path, sub.heads))
    if indivisible:
        raise ValueError(f'tensor-parallel rules matched parameters the {size}-way `model` '
                         f'mesh cannot divide (refusing to silently replicate): '
                         f'{indivisible[:8]}')
    if heads:
        raise ValueError(f'the {size}-way `model` mesh cannot divide the heads of {heads[:8]}: '
                         f'the port splits whole heads')
    return targets


def local_part(full: torch.Tensor, layout, size: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s piece of ``full`` under ``layout = (dim, segments)``:
    the ``rank``-th of ``size`` pieces of each segment, in order."""
    dim, segments = layout
    return torch.cat([seg.chunk(size, dim)[rank] for seg in full.chunk(segments, dim)], dim)


def join_parts(parts: list[torch.Tensor], layout) -> torch.Tensor:
    """`local_part`'s inverse: the full tensor from every rank's piece."""
    dim, segments = layout
    pieces = [p.chunk(segments, dim) for p in parts]
    return torch.cat([pieces[r][s] for s in range(segments) for r in range(len(parts))], dim)


def cut_module_tp(module: nn.Module, axis: ModelAxis) -> list[str]:
    """Replace each matched parameter of ``module`` by ``axis.rank``'s piece
    of it and place its layers on ``axis``, in place, with no collective;
    returns the sharded parameters' paths. `shard_module_tp` checks, then
    calls it; a single process may call it on a copy of a layer for each
    rank, with a `ModelAxis` whose sums it takes itself, to run the shards
    one after another. Raises as `shard_module_tp` does."""
    targets = _checked_targets(module, axis.size)
    paths = []
    for path, sub, rules in targets:
        for param, layout in rules:
            owner_name, _, leaf = param.rpartition('.')
            owner = sub.get_submodule(owner_name)
            old = getattr(owner, leaf)
            with torch.no_grad():
                piece = local_part(old.detach(), layout, axis.size, axis.rank).clone()
            setattr(owner, leaf, nn.Parameter(piece, requires_grad=old.requires_grad))
            paths.append(f'{path}.{param}' if path else param)
        sub.place_tp(axis)
    module._tp_sharded_paths = sorted(paths)
    return module._tp_sharded_paths


def shard_module_tp(module: nn.Module, mesh) -> nn.Module:
    """Tensor-parallel placement of every rule-matched layer of ``module``
    (an `E2TTS` with its duration predictor, a `DurationPredictor`, a
    `Transformer`) over the ``model`` axis of the 2-D ``mesh``
    (`make_2d_mesh`), in place; everything else stays whole. Every rank
    first takes the mesh's rank 0's parameters and buffers (one broadcast
    each), then keeps its piece. Raises ValueError if a matched layer cannot
    be divided by the mesh or nothing matched. Returns the module;
    ``module._tp_sharded_paths`` (a sorted list) records what was sharded.
    Load weights (`convert.load_jax_params`) before, and build the optimizer
    after."""
    if exists(tp_axis(module)):
        raise ValueError('the module is already tensor-parallel')
    if mesh.mesh_dim_names != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f'shard_module_tp takes a (data, model) mesh (make_2d_mesh), got '
                         f'{mesh.mesh_dim_names}')
    axis = ModelAxis.of(mesh)
    _checked_targets(module, axis.size)
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)
    cut_module_tp(module, axis)
    return module


def _placed(module: nn.Module):
    """``(path, layer)`` of each tensor-parallel layer in ``module``."""
    return [(path, sub) for path, sub in module.named_modules()
            if isinstance(sub, (Attention, FeedForward)) and exists(sub.tp)]


def tp_axis(module: nn.Module) -> ModelAxis | None:
    """The `ModelAxis` ``module``'s layers were placed on (None: not
    tensor-parallel); stops at the first placed layer."""
    return next((sub.tp for sub in module.modules()
                 if isinstance(sub, (Attention, FeedForward)) and exists(sub.tp)), None)


def tp_layouts(module: nn.Module) -> dict:
    """``{name: layout}`` of ``module``'s tensor-parallel parameters, by
    their names in ``module`` (an `E2TTS`, its duration predictor, a copy)."""
    return {f'{path}.{param}' if path else param: _plain_mlp_layout(sub, param, layout)
            for path, sub in _placed(module)
            for cls, _, param, layout in _RULES if isinstance(sub, cls)}


def param_layouts(module: nn.Module) -> dict:
    """``{parameter: layout}`` of ``module``'s tensor-parallel parameters."""
    layouts = tp_layouts(module)
    return {p: layouts[name] for name, p in module.named_parameters() if name in layouts}


def shared_params(module: nn.Module) -> list[nn.Parameter]:
    """The whole parameters of which each rank of the model axis uses part:
    every placed attention's value-head gate and value-residual mix
    (weights and biases), a rank taking its heads' rows."""
    return [p for _, sub in _placed(module) if isinstance(sub, Attention)
            for lin in (sub.to_v_head_gate, sub.to_value_residual_mix) if exists(lin)
            for p in lin.parameters()]


@torch.no_grad()
def sum_shared_grads_(params: list[nn.Parameter], axis: ModelAxis):
    """The grads of ``params`` (`shared_params`; a missing grad counts as
    zero) summed over ``axis`` in place, in one all-reduce: after the
    backward each rank's grad holds only its heads' rows' part."""
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = axis.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    for p, g, part in zip(params, grads, flat.split([g.numel() for g in grads])):
        p.grad = g.copy_(part.view_as(g))


def full_tensor(t: torch.Tensor, layout, axis: ModelAxis) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's piece under ``layout``
    (a collective over the model axis: every rank calls it)."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return join_parts(parts, layout)


def full_state_dict(module: nn.Module, state: dict) -> dict:
    """``state`` (``module``'s state dict, or one keyed alike) with every
    tensor-parallel entry gathered to its full value (a collective)."""
    layouts, axis = tp_layouts(module), tp_axis(module)
    return {name: full_tensor(v, layouts[name], axis) if name in layouts else v
            for name, v in state.items()}


def local_state_dict(module: nn.Module, state: dict) -> dict:
    """``state`` of full tensors with every tensor-parallel entry cut to
    this rank's piece (no collective)."""
    layouts, axis = tp_layouts(module), tp_axis(module)
    return {name: local_part(v, layouts[name], axis.size, axis.rank) if name in layouts else v
            for name, v in state.items()}
