"""Dual-stream ("multistream") transformer backbone (counterpart of
e2_tts_tpu/models/transformer.py, unrolled path).

A speech stream (dim) and a smaller text stream (dim_text) run side by side
and cross-condition at every text layer; UNet-style skips join the first and
second halves of the speech stack; register tokens are prepended to both
streams; residuals route through hyper-connections; time conditioning enters
through AdaptiveRMSNorm + AdaLNZero gates. With ``cond_on_time=False`` (the
duration predictor's backbone) the norms are plain RMSNorms, the gates are
identities, there is no time MLP and ``times`` is not passed.

Per layer the hot path is four kernels: K5 (the first width connection of a
chain, after expansion / cross-condition / skip), K3 (each chained width
connection), K1 or K8 (attention: K1 for dim_head 32, 64 or 128, K8 for any
other dim_head up to 256) and K6 (GEGLU). Large GEMMs stay ``F.linear`` and
the depthwise conv ``F.conv1d``. ``hc_save_state=True`` hands every
hyper-connection ``save_state``: in training the width connections run
K5s / K3s and their adjoints K5bs / K4s, which keep the forward's rms
reciprocal and tanh instead of recomputing them (default off, as in the
JAX package).

``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the counterpart of ``nnx.remat``): a layer
keeps only its inputs, at the cost of a second forward. ``remat`` given the
name of an argument-free ``jax.checkpoint_policies`` policy is selective
remat (`checkpoint_policy`): the layer is checkpointed under
``torch.utils.checkpoint.create_selective_checkpoint_contexts``, which
keeps the outputs the policy saves and recomputes the rest. A "dot" is
``aten.mm`` / ``addmm`` / ``bmm`` / ``baddbmm``, one with no batch dims
``mm`` / ``addmm``. The hand kernels run through ctypes, outside the
dispatcher, so every policy recomputes them, as JAX recomputes a
``pallas_call`` under a dots policy. A layer's dropout seeds are drawn
before the layer and handed in, so any recompute draws the forward's
masks.

With ``has_freq_axis`` the input is ``(b, f, n, d)``: ``f`` frequency
tokens a frame. The stack runs on the ``(b f)`` folded batch (text, mask,
text gate and time condition repeated), and each speech layer adds, between
its attention and its feedforward, attention across the ``f`` tokens of
each frame (`SpeechLayer.freq_attn`: no softclamp, gate, dropout or
learned value mix, rotary over f) behind a fourth hyper-connection, which
joins the layer's depth-fused chain (one K5 launch, then one K3 launch for
each later connection). ``attn_fourier_embed_input`` maps the speech
attention's normed input through `LinearFourierEmbed`.

Sequence parallelism (parallel/sp.py): once `enable_sequence_parallel` has
routed its attentions over a seq axis of ``P`` ranks, the forward runs on
this rank's rows of the packed sequence: after the absolute positions are
added and the registers prepended (so rank 0 holds the registers), rank
``s`` keeps rows ``[s N/P, (s + 1) N/P)`` of the ``N`` packed rows of both
streams, with those rows of the rotary tables and the key mask; the
attentions run as rings, the convs take their halos from the neighbours,
and the GEGLU folds the rows' first place into its seed. Hyper-connections,
norms, skips, value residuals and feedforwards are per token. It returns
this rank's frames (`frame_slice`): the registers are dropped where they
are. The frequency axis is cut on the frames; the frequency attention
stays local.

``scan_layers=True`` is the JAX package's stacked mode (``depth >= 4``).
There it stores the homogeneous middle layers stacked (``layer_first``,
``scan_mid.<g>``, ``layer_last``) and runs them under ``nnx.scan``; eager
PyTorch traces nothing, so here the layers stay the unrolled model's
modules and ``state_dict()`` has the unrolled names: `convert` unstacks a
JAX scan-layout tree by `scan_plan`. What the mode keeps is its memory
behaviour: under autograd every layer of a ``'scan'`` group of the plan
is recomputed in the backward (full checkpoint) whatever ``remat`` says,
while the first and last layers and the ``'single'`` segments follow
``remat``. Without grad the forward is the unrolled one. The dropout
seeds are drawn in the unrolled order.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from e2_tts_tpu_torch.models.blocks import (
    AdaLNZero, AdaptiveRMSNorm, Attention, DepthwiseConv, FeedForward, Identity, Linear,
    LinearFourierEmbed, RandomFourierEmbed, RMSNorm, TextAudioCrossCondition, cast, draw_seed,
)
from e2_tts_tpu_torch.models.hyper_connections import (
    HyperConnection, expand_stream, materialize, reduce_stream,
)
from e2_tts_tpu_torch.ops.rotary import rotary_tables
from e2_tts_tpu_torch.parallel.sp import check_divisible, seq_comm
from e2_tts_tpu_torch.utils.helpers import default, divisible_by, exists, resolve_device


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCHED_DOTS = _DOTS + (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)

# the argument-free jax.checkpoint_policies, by name: which ops' outputs a
# layer keeps (None: every op's)
_SAVED_OPS = {
    'everything_saveable': None,
    'nothing_saveable': (),
    'dots_saveable': _BATCHED_DOTS,
    'checkpoint_dots': _BATCHED_DOTS,
    'dots_with_no_batch_dims_saveable': _DOTS,
    'checkpoint_dots_with_no_batch_dims': _DOTS,
}


def checkpoint_policy(name: str):
    """The selective-checkpoint policy function of a ``jax.checkpoint_policies``
    name: MUST_SAVE for the ops it saves, PREFER_RECOMPUTE for the rest. The
    module's factories (``save_only_these_names`` and the like) build a
    policy from arguments, so their bare names raise here (JAX takes them
    and fails at the first grad)."""
    if name not in _SAVED_OPS:
        raise ValueError(f'remat={name!r} is not an argument-free jax.checkpoint_policies '
                         f'policy; the port takes {sorted(_SAVED_OPS)}, e.g. '
                         f"'dots_with_no_batch_dims_saveable'")
    saved = _SAVED_OPS[name]

    def policy(ctx, op, *args, **kwargs):
        keep = saved is None or op in saved
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


class SpeechLayer(nn.Module):
    """Per-layer speech-stream modules; with ``has_freq_axis`` also the
    attention across frequency tokens, its norm and its gate. Its forward is
    the layer's speech half, so that FSDP2 (parallel/fsdp.py) gathers a
    layer's parameters around it."""

    def __init__(self, *, dim, heads, dim_head, ff_mult, kernel_size, dropout,
                 is_first_block, is_later_half, has_freq_axis, freq_heads, freq_dim_head,
                 cond_on_time, attn_fourier_embed_input, attn_fourier_embed_input_frac,
                 attn_kwargs, ff_kwargs, dtype, generator):
        super().__init__()
        norm = (lambda: AdaptiveRMSNorm(dim, dtype=dtype)) if cond_on_time else (
            lambda: RMSNorm(dim))
        gate = (lambda: AdaLNZero(dim, dtype=dtype)) if cond_on_time else Identity
        self.skip_proj = (Linear(dim * 2, dim, bias=False, dtype=dtype, generator=generator)
                          if is_later_half else None)
        self.conv = DepthwiseConv(dim, kernel_size=kernel_size, dtype=dtype,
                                  generator=generator)
        self.attn_norm = norm()
        self.attn_input_fourier_embed = (
            LinearFourierEmbed(dim, p=attn_fourier_embed_input_frac, dtype=dtype,
                               generator=generator)
            if attn_fourier_embed_input else Identity())
        self.attn = Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout,
                              learned_value_residual_mix=not is_first_block,
                              dtype=dtype, generator=generator, **attn_kwargs)
        self.attn_adaln_zero = gate()
        self.ff_norm = norm()
        self.ff = FeedForward(dim, mult=ff_mult, dropout=dropout, dtype=dtype,
                              generator=generator, **ff_kwargs)
        self.ff_adaln_zero = gate()
        self.freq_attn_norm = self.freq_attn = self.freq_attn_adaln_zero = None
        if has_freq_axis:
            self.freq_attn_norm = norm()
            self.freq_attn = Attention(dim, heads=freq_heads, dim_head=freq_dim_head,
                                       dtype=dtype, generator=generator)
            self.freq_attn_adaln_zero = gate()

    def forward(self, x, hcs, *, skip, mask, rotary, freq_rotary, cond, freq_cond,
                value_residual, freq_value_residual, seeds, orig_batch, batch_offset,
                seq=None, seq_offset=0):
        """The speech half of a layer on ``x ((b f), n, dim)``: the UNet skip,
        then the conv, attention, (frequency attention) and feedforward
        branches behind the hyper-connections ``hcs``. ``seeds``: the
        attention's and the feedforward's dropout seeds, or empty.
        ``batch_offset``: ``x``'s first row in the global (folded) batch;
        ``seq``: the seq axis of a sequence-parallel rank, whose ``x`` holds
        the rows from ``seq_offset``. Returns ``(x, values, freq_values)``."""
        attn_seed, ff_seed = seeds or (None, None)
        if exists(skip):
            x = self.skip_proj(torch.cat((x, skip), dim=-1))

        conv_hc, attn_hc, ff_hc = hcs[:3]
        b_in, add_residual = conv_hc(x)
        x = add_residual(self.conv(b_in, mask=mask, seq=seq))

        b_in, add_residual = attn_hc(x)
        h = self.attn_input_fourier_embed(self.attn_norm(b_in, condition=cond))
        attn_out, values = self.attn(h, rotary_pos_emb=rotary, mask=mask,
                                     value_residual=value_residual, dropout_seed=attn_seed,
                                     batch_offset=batch_offset)
        x = add_residual(self.attn_adaln_zero(attn_out, condition=cond))

        freq_values = None
        if exists(self.freq_attn):
            # attention across the f tokens of each frame: (b f) n d -> (b n) f d
            b_in, add_residual = hcs[3](x)
            bf, n, d = b_in.shape
            f = bf // orig_batch
            h = b_in.reshape(orig_batch, f, n, d).transpose(1, 2).reshape(orig_batch * n, f, d)
            f_out, freq_values = self.freq_attn(
                self.freq_attn_norm(h, condition=freq_cond), rotary_pos_emb=freq_rotary,
                value_residual=freq_value_residual, batch_offset=batch_offset // f * n)
            f_out = self.freq_attn_adaln_zero(f_out, condition=freq_cond)
            f_out = f_out.reshape(orig_batch, n, f, d).transpose(1, 2).reshape(bf, n, d)
            x = add_residual(f_out)

        b_in, add_residual = ff_hc(x)
        ff_out = self.ff(self.ff_norm(b_in, condition=cond), dropout_seed=ff_seed,
                         batch_offset=batch_offset, seq_offset=seq_offset)
        x = add_residual(self.ff_adaln_zero(ff_out, condition=cond))
        return materialize(x), values, freq_values


class TextLayer(nn.Module):
    """Per-layer text-stream modules; its forward is the layer's text half
    and the cross-condition."""

    def __init__(self, *, dim, dim_text, heads, dim_head, ff_mult, kernel_size,
                 dropout, is_first_block, is_last_text_layer, attn_kwargs,
                 ff_kwargs, dtype, generator):
        super().__init__()
        self.conv = DepthwiseConv(dim_text, kernel_size=kernel_size, dtype=dtype,
                                  generator=generator)
        self.attn_norm = RMSNorm(dim_text)
        self.attn = Attention(dim_text, heads=heads, dim_head=dim_head, dropout=dropout,
                              learned_value_residual_mix=not is_first_block,
                              dtype=dtype, generator=generator, **attn_kwargs)
        self.ff_norm = RMSNorm(dim_text)
        self.ff = FeedForward(dim_text, mult=ff_mult, dropout=dropout, dtype=dtype,
                              generator=generator, **ff_kwargs)
        self.cross_condition = TextAudioCrossCondition(
            dim, dim_text, cond_audio_to_text=not is_last_text_layer, dtype=dtype)

    def forward(self, text_embed, x, hcs, *, mask, rotary, value_residual, gate, seeds,
                batch_offset, seq=None, seq_offset=0):
        """The text half of a layer (conv, attention and feedforward behind
        the hyper-connections ``hcs``), then the cross-condition with the
        speech stream ``x``. ``seeds``: the attention's and the feedforward's
        dropout seeds, or empty. Returns ``(x, text_embed, values)``."""
        attn_seed, ff_seed = seeds or (None, None)
        conv_hc, attn_hc, ff_hc = hcs
        t_in, add_residual = conv_hc(text_embed)
        text_embed = add_residual(self.conv(t_in, mask=mask, seq=seq))

        t_in, add_residual = attn_hc(text_embed)
        t_out, values = self.attn(self.attn_norm(t_in), rotary_pos_emb=rotary, mask=mask,
                                  value_residual=value_residual, dropout_seed=attn_seed,
                                  batch_offset=batch_offset)
        text_embed = add_residual(t_out)

        t_in, add_residual = ff_hc(text_embed)
        text_embed = add_residual(self.ff(self.ff_norm(t_in), dropout_seed=ff_seed,
                                          batch_offset=batch_offset, seq_offset=seq_offset))
        x, text_embed = self.cross_condition(materialize(x), materialize(text_embed), gate=gate)
        return x, text_embed, values


def scan_plan(depth: int, text_depth: int) -> list[tuple[str, int, int, bool]]:
    """The JAX package's ``scan_layers`` plan of the middle layers ``[1,
    depth - 1)``: ``(kind, first layer, count, pushes a skip)`` per segment,
    ``'scan'`` for a run of two or more homogeneous layers, ``'single'``
    for one. Segments break where a layer flag changes: the half boundary
    (skip push or pop), the text / speech-only boundary and the last text
    layer."""
    if depth < 4:
        raise ValueError('scan_layers needs depth >= 4')
    t = text_depth
    bks = sorted({1, depth // 2, depth - 1} | ({t - 1, t} & set(range(2, depth - 1))))
    return [('single' if b - a == 1 else 'scan', a, b - a, b <= depth // 2)
            for a, b in zip(bks[:-1], bks[1:])]


class Transformer(nn.Module):

    def __init__(
        self,
        *,
        dim: int,
        dim_text: int | None = None,
        depth: int = 8,
        heads: int = 8,
        dim_head: int = 64,
        ff_mult: int = 4,
        text_depth: int | None = None,
        text_heads: int | None = None,
        text_dim_head: int | None = None,
        text_ff_mult: int | None = None,
        has_freq_axis: bool = False,
        freq_heads: int | None = None,
        freq_dim_head: int | None = None,
        cond_on_time: bool = True,
        abs_pos_emb: bool = True,
        max_seq_len: int = 8192,
        kernel_size: int = 31,
        dropout: float = 0.1,
        num_registers: int = 32,
        scale_residual: bool = False,
        attn_laser: bool = False,
        attn_laser_softclamp_value: float = 15.0,
        attn_fourier_embed_input: bool = False,
        attn_fourier_embed_input_frac: float = 0.25,
        num_residual_streams: int = 4,
        hc_save_state: bool = False,
        attn_kwargs: dict = dict(gate_value_heads=True, softclamp_logits=True),
        ff_kwargs: dict = dict(),
        remat: bool | str = False,
        scan_layers: bool = False,
        dtype=None,
        generator: torch.Generator | None = None,
        device=None,
    ):
        """``scale_residual`` is accepted and unused, as in the JAX package
        (and the reference it follows)."""
        super().__init__()
        self.checkpoint_policy = checkpoint_policy(remat) if isinstance(remat, str) else None
        if not divisible_by(depth, 2):
            raise ValueError('depth needs to be even')
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        self.dim = dim
        self.depth = depth
        self.dropout = dropout
        self.remat = remat if isinstance(remat, str) else bool(remat)
        self.has_freq_axis = has_freq_axis
        self.max_seq_len = max_seq_len
        self.num_registers = num_registers
        self.dtype = dtype
        dim_text = default(dim_text, dim // 2)
        self.dim_text = dim_text
        text_heads = default(text_heads, heads)
        text_dim_head = default(text_dim_head, dim_head)
        text_ff_mult = default(text_ff_mult, ff_mult)
        text_depth = default(text_depth, depth)
        if not 1 <= text_depth <= depth:
            raise ValueError('text_depth must be in [1, depth]')
        self.text_depth = text_depth
        self.scan_plan = scan_plan(depth, text_depth) if scan_layers else None
        self.scanned = frozenset(ind for kind, start, count, _ in self.scan_plan or ()
                                 if kind == 'scan' for ind in range(start, start + count))
        self.dim_head = dim_head
        self.text_dim_head = text_dim_head
        freq_heads = default(freq_heads, heads)
        self.freq_dim_head = freq_dim_head = default(freq_dim_head, dim_head)
        self.cond_on_time = cond_on_time

        self.abs_pos_emb = None
        if abs_pos_emb:
            self.abs_pos_emb = nn.Embedding(max_seq_len, dim)
            with torch.no_grad():
                self.abs_pos_emb.weight.normal_(0.0, max_seq_len ** -0.5, generator=generator)

        self.registers = nn.Parameter(torch.randn(num_registers, dim, generator=generator) * 0.02)
        self.text_registers = nn.Parameter(
            torch.randn(num_registers, dim_text, generator=generator) * 0.02)

        self.num_residual_streams = num_residual_streams
        self.time_fourier = self.time_mlp = None
        if cond_on_time:
            self.time_fourier = RandomFourierEmbed(dim, generator=generator)
            self.time_mlp = Linear(dim + 1, dim, dtype=dtype, generator=generator)

        common = dict(attn_kwargs=dict(attn_kwargs, laser=attn_laser,
                                       laser_softclamp_value=attn_laser_softclamp_value),
                      ff_kwargs=dict(ff_kwargs), dtype=dtype, generator=generator)
        self.speech_layers = nn.ModuleList()
        self.text_layers = nn.ModuleList()     # one per layer < text_depth
        self.speech_hcs = nn.ModuleList()      # per layer: [conv, attn, ff, (freq)]
        self.text_hcs = nn.ModuleList()        # per text layer: [conv, attn, ff]
        hc_index = 0                           # branch counter, in creation order

        def make_hcs(d, count):
            nonlocal hc_index
            hcs = nn.ModuleList()
            for _ in range(count):
                hcs.append(HyperConnection(d, num_residual_streams, hc_index,
                                           save_state=hc_save_state))
                hc_index += 1
            return hcs

        for ind in range(depth):
            self.speech_layers.append(SpeechLayer(
                dim=dim, heads=heads, dim_head=dim_head, ff_mult=ff_mult,
                kernel_size=kernel_size, dropout=dropout, is_first_block=ind == 0,
                is_later_half=ind >= depth // 2, has_freq_axis=has_freq_axis,
                freq_heads=freq_heads, freq_dim_head=freq_dim_head, cond_on_time=cond_on_time,
                attn_fourier_embed_input=attn_fourier_embed_input,
                attn_fourier_embed_input_frac=attn_fourier_embed_input_frac, **common))
            self.speech_hcs.append(make_hcs(dim, 3 + int(has_freq_axis)))
            if ind < text_depth:
                self.text_layers.append(TextLayer(
                    dim=dim, dim_text=dim_text, heads=text_heads, dim_head=text_dim_head,
                    ff_mult=text_ff_mult, kernel_size=kernel_size, dropout=dropout,
                    is_first_block=ind == 0, is_last_text_layer=ind == text_depth - 1,
                    **common))
                self.text_hcs.append(make_hcs(dim_text, 3))

        self.final_norm = RMSNorm(dim)
        self.to(device)

    def seq_axis(self):
        """The seq axis the attentions are routed over
        (`parallel.sp.enable_sequence_parallel`), None when they run dense."""
        attn = self.speech_layers[0].attn
        return seq_comm(attn.sp_mesh, attn.sp_axis) if exists(attn.sp_mesh) else None

    def seq_rows(self, frames: int) -> slice:
        """This rank's rows of the packed sequence (registers, then
        ``frames`` frames); all of them when the attentions run dense."""
        seq, packed = self.seq_axis(), frames + self.num_registers
        if not exists(seq):
            return slice(0, packed)
        check_divisible(packed, seq.size)
        rows = packed // seq.size
        return slice(seq.rank * rows, (seq.rank + 1) * rows)

    def frame_slice(self, frames: int) -> slice:
        """The frames of a sequence of ``frames`` the forward returns: this
        rank's rows without the registers (all frames when dense)."""
        rows, r = self.seq_rows(frames), self.num_registers
        return slice(max(rows.start - r, 0), max(rows.stop - r, 0))

    def _layer(self, ind, x, text_embed, skip, mask, rotary, text_rotary, freq_rotary, cond,
               freq_cond, attn_v, text_v, freq_v, text_gate, *, push_skip, seeds, orig_batch,
               batch_offset, seq=None, seq_offset=0):
        """One layer: the text half and cross-condition (`TextLayer`), then
        the speech half (`SpeechLayer`). ``seeds`` are its dropout seeds in
        the order the branches run (text attention, text feedforward,
        attention, feedforward; the frequency attention has no dropout),
        empty without dropout. Returns plain tensors (or None), never lazy
        streams, so it can be checkpointed."""
        has_text = exists(text_embed) and ind < self.text_depth
        text_seeds, seeds = (seeds[:2], seeds[2:]) if has_text and seeds else ((), seeds)
        if has_text:
            x, text_embed, t_values = self.text_layers[ind](
                text_embed, x, self.text_hcs[ind], mask=mask, rotary=text_rotary,
                value_residual=text_v, gate=text_gate, seeds=text_seeds,
                batch_offset=batch_offset, seq=seq, seq_offset=seq_offset)
            text_v = default(text_v, t_values)

        # UNet skips on the speech stream
        x = materialize(x)
        skip_out = x if push_skip else None
        x, values, f_values = self.speech_layers[ind](
            x, self.speech_hcs[ind], skip=skip, mask=mask, rotary=rotary,
            freq_rotary=freq_rotary, cond=cond, freq_cond=freq_cond, value_residual=attn_v,
            freq_value_residual=freq_v, seeds=seeds, orig_batch=orig_batch,
            batch_offset=batch_offset, seq=seq, seq_offset=seq_offset)
        attn_v = default(attn_v, values)
        freq_v = default(freq_v, f_values)
        return x, text_embed, skip_out, attn_v, text_v, freq_v

    def forward(self, x, times=None, mask=None, text_embed=None, text_cond_gate=None,
                generator: torch.Generator | None = None, batch_offset: int = 0):
        """``x (b, n, dim)``, or ``(b, f, n, dim)`` with ``has_freq_axis``;
        ``times (b,)`` or scalar (given iff the model is conditioned on
        time), ``mask (b, n)`` bool, ``text_embed (b, n, dim_text)``;
        ``text_cond_gate (b,)`` scales each sample's text->audio adds (0 = a
        text-free pass). ``generator`` draws the dropout seeds in training
        mode; ``batch_offset`` is ``x``'s first row in the global batch (a
        data-parallel rank's), for which the dropout bits are drawn. Returns
        the input's shape with ``dim`` features; with the attentions routed
        over a seq axis (`parallel.sp`), this rank's frames of it
        (`frame_slice`)."""
        if (x.ndim == 4) != self.has_freq_axis:
            raise ValueError('`has_freq_axis` must be set iff passing a 4-dim (b f n d) tensor')
        if exists(self.dtype):
            x = cast(x, self.dtype)
            if exists(text_embed):
                text_embed = cast(text_embed, self.dtype)

        orig_batch = x.shape[0]
        freq_len = 1
        if self.has_freq_axis:                       # fold: (b f) n d
            freq_len = x.shape[1]
            x = x.reshape(orig_batch * freq_len, *x.shape[2:])
            repeat = lambda t: t.repeat_interleave(freq_len, dim=0) if exists(t) else None
            text_embed, mask, text_cond_gate = map(repeat, (text_embed, mask, text_cond_gate))

        text_gate = text_cond_gate[None, :, None, None] if exists(text_cond_gate) else None
        batch, seq_len = x.shape[0], x.shape[1]

        if exists(times) != self.cond_on_time:
            raise ValueError('`times` must be passed in iff `cond_on_time` is set')
        if exists(self.abs_pos_emb):
            if seq_len > self.max_seq_len:
                raise ValueError(f'{seq_len} exceeds the set `max_seq_len` ({self.max_seq_len})')
            x = x + cast(self.abs_pos_emb.weight[:seq_len], x.dtype)

        r = self.num_registers
        x = torch.cat((cast(self.registers, x.dtype)[None].expand(batch, r, self.dim), x), dim=1)
        if exists(mask):
            mask = F.pad(mask, (r, 0), value=True)
        packed_len = x.shape[1]
        # sequence parallelism: this rank's rows of the packed sequence
        seq, rows = self.seq_axis(), self.seq_rows(seq_len)
        cut = (lambda t: t[:, rows]) if exists(seq) else (lambda t: t)
        x = cut(x)
        if exists(mask):
            mask = cut(mask).contiguous()
        local_len = x.shape[1]

        cond = freq_cond = None
        if exists(times):
            if times.ndim == 0:
                times = times.expand(orig_batch)
            cond = cast(F.silu(self.time_mlp(self.time_fourier(times))), x.dtype)
            if self.has_freq_axis:
                freq_cond = cond.repeat_interleave(local_len, dim=0)      # (b n), d
                cond = cond.repeat_interleave(freq_len, dim=0)            # (b f), d

        tables = lambda dh: tuple(t[rows] for t in rotary_tables(packed_len, dh,
                                                                 device=x.device))
        rotary = tables(self.dim_head)
        text_rotary = freq_rotary = None
        if exists(text_embed):
            text_rotary = tables(self.text_dim_head)
            text_registers = cast(self.text_registers, text_embed.dtype)[None]
            text_embed = cut(torch.cat(
                (text_registers.expand(batch, r, self.dim_text), text_embed), dim=1))
        if self.has_freq_axis:
            freq_rotary = rotary_tables(freq_len, self.freq_dim_head, device=x.device)

        s = self.num_residual_streams
        x = expand_stream(x, s)
        if exists(text_embed):
            text_embed = expand_stream(text_embed, s)

        dropping = self.training and self.dropout > 0.0
        remat = bool(self.remat) and torch.is_grad_enabled()
        checkpoint_kw = dict(use_reentrant=False, preserve_rng_state=False)
        if exists(self.checkpoint_policy):
            checkpoint_kw['context_fn'] = partial(create_selective_checkpoint_contexts,
                                                  self.checkpoint_policy)
        skips = []
        attn_v = text_v = freq_v = None
        for ind in range(self.depth):
            is_first_half = ind + 1 <= self.depth // 2
            skip_in = None if is_first_half else skips.pop()
            branches = 4 if exists(text_embed) and ind < self.text_depth else 2
            seeds = tuple(draw_seed(generator) for _ in range(branches)) if dropping else ()
            layer = partial(self._layer, ind, push_skip=is_first_half, seeds=seeds,
                            orig_batch=orig_batch, batch_offset=batch_offset * freq_len,
                            seq=seq, seq_offset=rows.start)
            args = (x, text_embed, skip_in, mask, rotary, text_rotary, freq_rotary, cond,
                    freq_cond, attn_v, text_v, freq_v, text_gate)
            # nothing in a layer reads torch's global generators: no RNG state to keep
            if ind in self.scanned and torch.is_grad_enabled():
                out = checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
            elif remat:
                out = checkpoint(layer, *args, **checkpoint_kw)
            else:
                out = layer(*args)
            x, text_embed, skip_out, attn_v, text_v, freq_v = out
            if is_first_half:
                skips.append(skip_out)
        assert len(skips) == 0

        x = reduce_stream(x[:, :, min(max(r - rows.start, 0), local_len):, :])
        if self.has_freq_axis:
            x = x.reshape(orig_batch, freq_len, *x.shape[1:])
        return self.final_norm(x)
