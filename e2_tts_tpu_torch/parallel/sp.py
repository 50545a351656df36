"""Sequence parallelism: ring attention over the ``seq`` axis of a (data,
seq) mesh (counterpart of e2_tts_tpu/parallel/sp.py).

The JAX package shards activations on a ``seq`` mesh axis and lets GSPMD
run the backbone sequence-sharded; only attention is written out, as a
ring under ``shard_map``. PyTorch has no GSPMD, so the port shards the
sequence by hand: rank ``s`` of a seq group of ``P`` holds rows ``[s n/P,
(s + 1) n/P)`` of the packed sequence (registers first, so rank 0 holds the
registers), everything per token runs on those rows, and three things cross
ranks (models/transformer.py, models/blocks.py, models/e2tts.py):

- attention, as a ring (`ring_attention`): each rank's queries attend to
  the key / value block it holds, through K1 (dim_head 32, 64 or 128) or K8
  (any other), then the block moves one rank on; after ``P`` steps every
  query has seen every key. Each block's launch carries its place in the
  global sequence (``hash_r0`` / ``hash_c0``, with ``hash_b0`` the data
  rank's first row), so its dropout bits are the ones one launch over the
  whole sequence draws. The partial outputs combine by their log-sum-exps,
  ``out = sum_i exp(lse_i - lse) out_i`` with ``lse = logsumexp_i lse_i``,
  which is exact with dropout too (each block's denominator holds the
  un-dropped probabilities). The backward takes ``delta`` once from the
  combined output (K10, or a plain sum for K9's heads), then runs K2 / K9
  block by block against the global ``lse`` and ``delta``: dq adds up
  locally, and each block's dk / dv travel around the ring with it and end
  at their owner. The transport is ``batch_isend_irecv`` over the seq
  group, the next block's exchange posted before the current block's
  kernel;
- the depthwise conv, whose ``kernel_size // 2`` frames of halo each side
  come from the neighbours (`halo_pad`; zeros at the sequence's ends, as
  the conv's padding), the halo's grad going back to them;
- the loss: each rank's masked error over the global span count, summed
  over the seq group (`seq_sum`).

The gate and LASER apply after the ring's combine, as in the JAX package
(``ops/attention.py``). `enable_sequence_parallel` routes a model's
attentions (not the frequency attention, whose sequence is the frequency
tokens, and not a duration predictor's: it pools over the whole sequence,
so the port runs it dense on every rank of a seq group, where the JAX
package lets GSPMD reshard the pooling; the numbers are the same);
`sp_paused` turns the routing off around sampling. `Loopback` holds all
``P`` shards in one process and runs the same block code with the
transport a list rotation: the CPU tests and the card's kernel check use
it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from e2_tts_tpu_torch.ops.flash_attention import (
    NEG_INF, SUPPORTED_DIM_HEAD, _check_hash, _check_rate, _padded_dim_head, block_backward,
    block_delta, block_forward,
)
from e2_tts_tpu_torch.parallel.mesh import DATA_AXIS, init_mesh
from e2_tts_tpu_torch.utils.helpers import default, exists

SEQ_AXIS = 'seq'


def make_seq_mesh(seq: int, data: int = 1):
    """The ``('data', 'seq')`` DeviceMesh of ``data`` x ``seq`` ranks over the
    default process group; ``seq`` shards the sequence of activations. Rank
    ``d seq + s`` is at ``(d, s)``: a seq group is ``seq`` consecutive
    ranks."""
    if data < 1 or seq < 1:
        raise ValueError(f'a (data, seq) mesh needs both axes >= 1, got {data} x {seq}')
    return init_mesh((data, seq), (DATA_AXIS, SEQ_AXIS), 'make_seq_mesh')


def check_divisible(n: int, size: int, axis_name: str = SEQ_AXIS):
    """The ring's precondition, worded as the JAX package's."""
    if n % size:
        raise ValueError(
            f'ring_attention: sequence length {n} is not divisible by the '
            f'`{axis_name}` mesh axis ({size} shards). For the E2TTS '
            f'backbone the attended length is frames + num_registers — pick '
            f'a frame bucket so (frames + num_registers) % {size} == 0 '
            f'(e.g. E2Trainer(..., sequence_parallel={size}) validates '
            f'this per batch).')


class _Pending:
    """An exchange in flight: `wait` returns what arrived."""

    def __init__(self, received, finish=None):
        self.received, self.finish = received, finish

    def wait(self):
        if exists(self.finish):
            self.finish()
        return self.received


class SeqAxis:
    """A rank's place on the seq axis: its group, the axis' size and its rank
    there, the mesh (whose data axis' group sums the span count). The
    process holds one shard, its own. Shared, not copied, by a deep copy of
    a module (the EMA's)."""

    def __init__(self, group, size: int, rank: int, mesh=None):
        self.group, self.size, self.rank, self.mesh = group, size, rank, mesh
        self.data_group = mesh[DATA_AXIS].get_group() if exists(mesh) else None
        self._peers = {}

    @classmethod
    def of(cls, mesh, axis_name: str = SEQ_AXIS) -> 'SeqAxis':
        seq = mesh[axis_name]
        return cls(seq.get_group(), seq.size(), seq.get_local_rank(), mesh)

    def __deepcopy__(self, memo):
        return self

    @property
    def shards(self) -> list[int]:
        """The global indices of the shards this process holds."""
        return [self.rank]

    def split(self, x, dim: int = 1) -> list:
        return [x]

    def join(self, parts: list, dim: int = 1):
        return parts[0]

    def _peer(self, step: int) -> int:
        if step not in self._peers:
            self._peers[step] = dist.get_global_rank(self.group, (self.rank + step) % self.size)
        return self._peers[step]

    def start_shift(self, parts: list, step: int = 1) -> _Pending:
        """Post the exchange in which each shard sends its tensors (``parts``:
        one tuple a local shard) to shard ``s + step`` and receives shard ``s -
        step``'s (None entries stay None); returns the `_Pending` exchange.
        gloo's point-to-point calls take CPU tensors, so under gloo a CUDA
        tensor goes through host memory (here only)."""
        (tensors,) = parts
        if self.size == 1:
            return _Pending([tuple(tensors)])
        present = [t for t in tensors if exists(t)]
        staged = dist.get_backend(self.group) == 'gloo' and present[0].is_cuda
        send = [t.detach().contiguous() for t in present]
        if staged:
            send = [t.cpu() for t in send]
        recv = [torch.empty_like(t) for t in send]
        dst, src = self._peer(step), self._peer(-step)
        ops = ([dist.P2POp(dist.isend, t, dst, self.group, tag=i) for i, t in enumerate(send)]
               + [dist.P2POp(dist.irecv, t, src, self.group, tag=i)
                  for i, t in enumerate(recv)])
        reqs = dist.batch_isend_irecv(ops)
        out = []

        def finish():
            for req in reqs:
                req.wait()
            arrived = iter(r.to(present[0].device) if staged else r for r in recv)
            out.extend(next(arrived) if exists(t) else None for t in tensors)
        return _Pending([out], finish)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the seq axis, in place."""
        dist.all_reduce(t, group=self.group)
        return t


class Loopback:
    """All ``size`` shards of a seq axis in one process: `split` cuts a full
    tensor into the shards, `join` puts them back, and an exchange is a
    rotation of the shards' list. `ring_attention` on it runs the block code
    of the distributed ring, launch for launch, on full tensors."""

    def __init__(self, size: int):
        self.size = int(size)
        self.rank = 0
        self.shards = list(range(self.size))

    def split(self, x, dim: int = 1) -> list:
        check_divisible(x.shape[dim], self.size)
        return list(x.chunk(self.size, dim))

    def join(self, parts: list, dim: int = 1):
        return torch.cat(parts, dim)

    def start_shift(self, parts: list, step: int = 1) -> _Pending:
        return _Pending([parts[(j - step) % self.size] for j in range(self.size)])


def seq_comm(mesh, axis_name: str = SEQ_AXIS):
    """The seq axis of ``mesh`` (a DeviceMesh with an ``axis_name`` dim), or
    ``mesh`` itself when it is one (a `SeqAxis` or a `Loopback`). A
    DeviceMesh's axis is made once and kept on it."""
    if isinstance(mesh, (SeqAxis, Loopback)):
        return mesh
    cache = mesh.__dict__.setdefault('_e2_seq_axes', {})
    if axis_name not in cache:
        cache[axis_name] = SeqAxis.of(mesh, axis_name)
    return cache[axis_name]


# -- the ring ---------------------------------------------------------------------------

def _pad_heads(t, heads: int, dhp: int):
    """Packed ``(b, n, h*dh)`` -> ``(b, n, h*dhp)``, each head zero-padded."""
    dh = t.shape[-1] // heads
    if dhp == dh:
        return t
    return torch.nn.functional.pad(t.unflatten(-1, (heads, dh)), (0, dhp - dh)).flatten(-2)


def _as_bytes(mask):
    return None if mask is None else mask.view(torch.uint8)


def _as_mask(t):
    return None if t is None else t.view(torch.bool)


def _blocks(held):
    """(k, v, mask) of each local shard's held block, the mask back as bool."""
    return [(k, v, _as_mask(m)) for k, v, m in held]


def _merge(acc, lse, out, lse_b):
    """A block's output ``out (b, n, h, dh)`` (f32) and log-sum-exp ``lse_b
    (b, n, h)`` folded into the running ``(acc, lse)`` (None at the first
    block): ``acc`` rescaled by ``exp(lse - new)``, ``out`` by ``exp(lse_b
    - new)``, ``new = logaddexp(lse, lse_b)``."""
    if acc is None:
        return out, lse_b
    new = torch.logaddexp(lse, lse_b)
    return (acc * torch.exp(lse - new)[..., None] + out * torch.exp(lse_b - new)[..., None],
            new)


def _move_grads(comm, travel) -> _Pending:
    """Send each block's running dk / dv on with it, one shard on."""
    return comm.start_shift(travel)


def ring_forward(comm, qs, ks, vs, masks, cfg):
    """The ring's forward on the local shards' ``qs, ks, vs, masks`` (lists,
    one entry a shard): per step each shard's queries against the block it
    holds, the next block's exchange posted first; returns the combined
    outputs (f32: the blocks' outputs sum in f32 and round once, where the
    caller casts) and global log-sum-exps ``(b*h, n)``."""
    size, heads = comm.size, cfg['heads']
    nl = qs[0].shape[1]
    held = [(k, v, _as_bytes(m)) for k, v, m in zip(ks, vs, masks)]
    acc, lse = [None] * len(qs), [None] * len(qs)
    for i in range(size):
        pending = comm.start_shift(held) if i < size - 1 else None
        for j, ((k, v, m), s) in enumerate(zip(_blocks(held), comm.shards)):
            hash_kw = dict(cfg['hash'], hash_r0=s * nl, hash_c0=((s - i) % size) * nl)
            out_b, lse_b = block_forward(qs[j], k, v, m, heads=heads, scale=cfg['scale'],
                                         softclamp_value=cfg['softclamp'],
                                         dropout_rate=cfg['rate'], dropout_seed=cfg['seed'],
                                         hash_kw=hash_kw)
            b, n, D = out_b.shape
            acc[j], lse[j] = _merge(acc[j], lse[j], out_b.float().view(b, n, heads, D // heads),
                                    lse_b.view(b, heads, n).transpose(1, 2))
        if exists(pending):
            held = pending.wait()
    outs, lses = [], []
    for a, l in zip(acc, lse):
        # a row with no key in any block: each block gave the mean of its
        # values with weight 1 (every lse the finite NEG_INF); the dense
        # softmax gives the mean of all of them
        a = torch.where((l <= 0.5 * NEG_INF)[..., None], a / size, a)
        b, n, h, dh = a.shape
        outs.append(a.reshape(b, n, h * dh))
        lses.append(l.transpose(1, 2).reshape(b * h, n).contiguous())
    return outs, lses


def ring_backward(comm, qs, ks, vs, masks, outs, lses, douts, cfg):
    """The ring's backward: delta once per shard from its combined output,
    then each step K2 / K9 on the held block against the global ``lse`` and
    ``delta``; dq adds up in place, dk / dv travel with their block and
    arrive at its owner after the last exchange. Returns dq, dk, dv lists in
    q's dtype."""
    size, heads = comm.size, cfg['heads']
    nl = qs[0].shape[1]
    deltas = [block_delta(o, d, heads=heads) for o, d in zip(outs, douts)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    held = [(k, v, _as_bytes(m)) for k, v, m in zip(ks, vs, masks)]
    travel = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(k.shape, dtype=torch.float32, device=k.device)) for k in ks]
    moving = None
    for i in range(size):
        pending = comm.start_shift(held) if i < size - 1 else None
        grads = []
        for j, ((k, v, m), s) in enumerate(zip(_blocks(held), comm.shards)):
            hash_kw = dict(cfg['hash'], hash_r0=s * nl, hash_c0=((s - i) % size) * nl)
            grads.append(block_backward(qs[j], k, v, m, lses[j], deltas[j], douts[j], dqs[j],
                                        heads=heads, scale=cfg['scale'],
                                        softclamp_value=cfg['softclamp'],
                                        dropout_rate=cfg['rate'], dropout_seed=cfg['seed'],
                                        hash_kw=hash_kw))
        if exists(moving):
            travel = moving.wait()
        for (dk_acc, dv_acc), (dk, dv) in zip(travel, grads):
            dk_acc.add_(dk.float())
            dv_acc.add_(dv.float())
        moving = _move_grads(comm, travel)
        if exists(pending):
            held = pending.wait()
    travel = moving.wait()
    dt = qs[0].dtype
    return ([dq.to(dt) for dq in dqs], [dk.to(dt) for dk, _ in travel],
            [dv.to(dt) for _, dv in travel])


class _Ring(torch.autograd.Function):
    """The ring's forward and backward; saves this process's shards of q, k,
    v, the mask, the combined output (in q's dtype, for delta) and the global
    lse. Returns the combined output in f32."""

    @staticmethod
    def forward(ctx, q, k, v, mask, comm, cfg):
        parts = [comm.split(t) for t in (q, k, v)]
        masks = ([m.contiguous() for m in comm.split(mask)] if exists(mask)
                 else [None] * len(parts[0]))
        outs, lses = ring_forward(comm, *parts, masks, cfg)
        ctx.comm, ctx.cfg = comm, cfg
        ctx.save_for_backward(q, k, v, mask, *(o.to(q.dtype) for o in outs), *lses)
        return comm.join(outs)

    @staticmethod
    def backward(ctx, dout):
        comm, cfg = ctx.comm, ctx.cfg
        q, k, v, mask, *rest = ctx.saved_tensors
        count = len(rest) // 2
        parts = [comm.split(t) for t in (q, k, v)]
        masks = ([m.contiguous() for m in comm.split(mask)] if exists(mask)
                 else [None] * count)
        dq, dk, dv = ring_backward(comm, *parts, masks, rest[:count], rest[count:],
                                   [d.to(q.dtype).contiguous() for d in comm.split(dout)],
                                   cfg)
        return comm.join(dq), comm.join(dk), comm.join(dv), None, None, None


def ring_attention(q, k, v, mask=None, *, mesh, heads: int, scale: float | None = None,
                   softclamp_value: float | None = 50.0, dropout_rate: float = 0.0,
                   dropout_seed: int | None = None, axis_name: str = SEQ_AXIS,
                   hash_b0: int = 0, hash_h0: int = 0, hash_heads: int | None = None):
    """Sequence-parallel attention on packed ``(b, n, h*dh)`` shards: this
    rank's rows of q, k, v and of the key mask ``(b, n)`` (True = attend) on
    the ``axis_name`` axis of ``mesh`` (a DeviceMesh; or a `Loopback`, whose
    q, k, v are the full tensors). Returns this rank's rows of the output in
    f32 (the combine's sum unrounded: a gate or LASER after it rounds once),
    differentiable in q, k and v. Dropout (``dropout_rate > 0`` with a
    ``dropout_seed``) draws the bits one launch over the whole sequence
    draws, for the global batch rows from ``hash_b0`` (and heads from
    ``hash_h0`` of ``hash_heads``)."""
    comm = seq_comm(mesh, axis_name)
    dh = q.shape[-1] // heads
    scale = default(scale, dh ** -0.5)
    dropping = dropout_rate > 0.0 and exists(dropout_seed)
    cfg = dict(heads=heads, scale=scale, softclamp=softclamp_value,
               rate=_check_rate(dropout_rate) if dropping else 0.0,
               seed=int(dropout_seed) if dropping else 0,
               hash=_check_hash(hash_b0, hash_h0, hash_heads, heads))
    if dh in SUPPORTED_DIM_HEAD or q.device.type == 'cpu':
        return _Ring.apply(q, k, v, mask, comm, cfg)
    # K8 / K9 take dim_head a multiple of 8: zero columns add nothing to q k^T
    dhp = _padded_dim_head(dh)
    out = _Ring.apply(*(_pad_heads(t, heads, dhp) for t in (q, k, v)), mask, comm, cfg)
    return out.unflatten(-1, (heads, dhp))[..., :dh].flatten(-2)


# -- the rest of the backbone's cross-rank pieces ----------------------------------------

def _exchange(comm: SeqAxis, t: torch.Tensor, step: int) -> torch.Tensor:
    """``t`` sent to shard ``s + step``; returns shard ``s - step``'s."""
    return comm.start_shift([(t,)], step).wait()[0][0]


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, comm, width):
        ctx.comm, ctx.width = comm, width
        left, right = _exchange(comm, x[:, -width:], 1), _exchange(comm, x[:, :width], -1)
        if comm.rank == 0:
            left = torch.zeros_like(left)
        if comm.rank == comm.size - 1:
            right = torch.zeros_like(right)
        return torch.cat((left, x, right), dim=1)

    @staticmethod
    def backward(ctx, grad):
        comm, w = ctx.comm, ctx.width
        grad = grad.contiguous()
        gx = grad[:, w:-w].clone()
        # the left halo is the previous shard's last frames, the right halo
        # the next shard's first: their grads go back to them
        from_next, from_prev = _exchange(comm, grad[:, :w], -1), _exchange(comm, grad[:, -w:], 1)
        if comm.rank < comm.size - 1:
            gx[:, -w:] += from_next
        if comm.rank > 0:
            gx[:, :w] += from_prev
        return gx, None, None


def halo_pad(x: torch.Tensor, comm: SeqAxis, width: int) -> torch.Tensor:
    """This rank's rows ``x (b, n, d)`` with ``width`` frames of halo each
    side: the previous rank's last and the next rank's first (zeros at the
    sequence's ends, as a SAME conv's padding); differentiable, the halo's
    grad going back to its rank. Raises ValueError when a shard is shorter
    than the halo."""
    if width == 0:
        return x
    if x.shape[1] < width:
        raise ValueError(f'sequence parallelism: a shard of {x.shape[1]} rows is shorter than '
                         f'the depthwise conv\'s halo of {width} (kernel_size // 2); the port '
                         f'takes halos from the neighbouring shards only, so each shard needs '
                         f'at least kernel_size // 2 rows')
    return _Halo.apply(x, comm, width)


class _SeqSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def seq_sum(x: torch.Tensor, comm: SeqAxis) -> torch.Tensor:
    """``x`` summed over the seq axis; identity in the backward (each rank's
    term keeps its own grad, and the data x seq reduction of the parameter
    grads sums them)."""
    return _SeqSum.apply(x, comm)


def shard_sequence(x: torch.Tensor, mesh, axis_name: str = SEQ_AXIS) -> torch.Tensor:
    """This rank's rows of a full ``(b, n, ...)`` tensor on ``axis_name``."""
    comm = seq_comm(mesh, axis_name)
    check_divisible(x.shape[1], comm.size, axis_name)
    nl = x.shape[1] // comm.size
    return x[:, comm.rank * nl:(comm.rank + 1) * nl]


# -- routing ------------------------------------------------------------------------------

def _attentions(model):
    """``(path, attention)`` of each `Attention` of ``model``, the frequency
    attentions and a duration predictor's left out."""
    from e2_tts_tpu_torch.models.blocks import Attention
    from e2_tts_tpu_torch.models.duration import DurationPredictor
    skip = {id(a) for m in model.modules() if isinstance(m, DurationPredictor)
            for a in m.modules()}
    return [(path, m) for path, m in model.named_modules()
            if isinstance(m, Attention) and 'freq_attn' not in path and id(m) not in skip]


def enable_sequence_parallel(model, mesh, axis_name: str = SEQ_AXIS) -> int:
    """Route every `Attention` of ``model`` (an `E2TTS`, a `Transformer`)
    through ring attention over ``axis_name`` of ``mesh``, and with them the
    backbone: its `Transformer` then runs on this rank's rows of the
    sequence. The frequency attentions and a duration predictor's stay
    dense. Returns the number of attentions routed."""
    routed = _attentions(model)
    for _, module in routed:
        module.sp_mesh = mesh
        module.sp_axis = axis_name
    return len(routed)


class sp_paused:
    """Context manager: route ``models``' attentions densely for its body
    (`E2TTS.sample` runs in it: sampling lengths rarely divide the seq
    axis), restoring the routing on exit, also on error."""

    def __init__(self, *models):
        self.models = [m for m in models if exists(m)]
        self._saved = []

    def __enter__(self):
        from e2_tts_tpu_torch.models.blocks import Attention
        for model in self.models:
            for module in model.modules():
                if isinstance(module, Attention) and exists(module.sp_mesh):
                    self._saved.append((module, module.sp_mesh, module.sp_axis))
                    module.sp_mesh = None
        return self

    def __exit__(self, *exc):
        for module, mesh, axis in self._saved:
            module.sp_mesh, module.sp_axis = mesh, axis
        self._saved.clear()
        return False


def disable_sequence_parallel(model) -> int:
    """Undo `enable_sequence_parallel`; returns the number of attentions of
    ``model``."""
    from e2_tts_tpu_torch.models.blocks import Attention
    n = 0
    for module in model.modules():
        if isinstance(module, Attention):
            module.sp_mesh = None
            n += 1
    return n
