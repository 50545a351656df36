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
keeps only its inputs, at the cost of a second forward. Its dropout seeds
are drawn before the layer and handed in, so the recompute draws the
forward's masks.

Not ported yet (each raises): the frequency axis, ``scan_layers``, ``remat``
given a ``jax.checkpoint_policies`` name, the FANformer input embedding.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from e2_tts_tpu_torch.models.blocks import (
    AdaLNZero, AdaptiveRMSNorm, Attention, DepthwiseConv, FeedForward, Identity, Linear,
    RandomFourierEmbed, RMSNorm, TextAudioCrossCondition, cast, draw_seed,
)
from e2_tts_tpu_torch.models.hyper_connections import (
    HyperConnection, expand_stream, materialize, reduce_stream,
)
from e2_tts_tpu_torch.ops.rotary import rotary_tables
from e2_tts_tpu_torch.utils.helpers import default, divisible_by, exists, resolve_device


class SpeechLayer(nn.Module):
    """Per-layer speech-stream modules."""

    def __init__(self, *, dim, heads, dim_head, ff_mult, kernel_size, dropout,
                 is_first_block, is_later_half, cond_on_time, attn_kwargs, ff_kwargs,
                 dtype, generator):
        super().__init__()
        norm = (lambda: AdaptiveRMSNorm(dim, dtype=dtype)) if cond_on_time else (
            lambda: RMSNorm(dim))
        gate = (lambda: AdaLNZero(dim, dtype=dtype)) if cond_on_time else Identity
        self.skip_proj = (Linear(dim * 2, dim, bias=False, dtype=dtype, generator=generator)
                          if is_later_half else None)
        self.conv = DepthwiseConv(dim, kernel_size=kernel_size, dtype=dtype,
                                  generator=generator)
        self.attn_norm = norm()
        self.attn = Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout,
                              learned_value_residual_mix=not is_first_block,
                              dtype=dtype, generator=generator, **attn_kwargs)
        self.attn_adaln_zero = gate()
        self.ff_norm = norm()
        self.ff = FeedForward(dim, mult=ff_mult, dropout=dropout, dtype=dtype,
                              generator=generator, **ff_kwargs)
        self.ff_adaln_zero = gate()


class TextLayer(nn.Module):
    """Per-layer text-stream modules."""

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
        cond_on_time: bool = True,
        abs_pos_emb: bool = True,
        max_seq_len: int = 8192,
        kernel_size: int = 31,
        dropout: float = 0.1,
        num_registers: int = 32,
        attn_laser: bool = False,
        attn_laser_softclamp_value: float = 15.0,
        attn_fourier_embed_input: bool = False,
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
        super().__init__()
        for flag, what in ((has_freq_axis, 'the frequency axis (has_freq_axis)'),
                           (scan_layers, 'scan_layers'),
                           (isinstance(remat, str), f'remat={remat!r} (a checkpoint policy)'),
                           (attn_fourier_embed_input, 'attn_fourier_embed_input')):
            if flag:
                raise NotImplementedError(f'{what} is not ported to e2_tts_tpu_torch yet')
        if not divisible_by(depth, 2):
            raise ValueError('depth needs to be even')
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        self.dim = dim
        self.depth = depth
        self.dropout = dropout
        self.remat = bool(remat)
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
        self.dim_head = dim_head
        self.text_dim_head = text_dim_head
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
        self.speech_hcs = nn.ModuleList()      # per layer: [conv, attn, ff]
        self.text_hcs = nn.ModuleList()        # per text layer: [conv, attn, ff]
        hc_index = 0                           # branch counter, in creation order

        def make_hcs(d):
            nonlocal hc_index
            hcs = nn.ModuleList()
            for _ in range(3):
                hcs.append(HyperConnection(d, num_residual_streams, hc_index,
                                           save_state=hc_save_state))
                hc_index += 1
            return hcs

        for ind in range(depth):
            self.speech_layers.append(SpeechLayer(
                dim=dim, heads=heads, dim_head=dim_head, ff_mult=ff_mult,
                kernel_size=kernel_size, dropout=dropout, is_first_block=ind == 0,
                is_later_half=ind >= depth // 2, cond_on_time=cond_on_time, **common))
            self.speech_hcs.append(make_hcs(dim))
            if ind < text_depth:
                self.text_layers.append(TextLayer(
                    dim=dim, dim_text=dim_text, heads=text_heads, dim_head=text_dim_head,
                    ff_mult=text_ff_mult, kernel_size=kernel_size, dropout=dropout,
                    is_first_block=ind == 0, is_last_text_layer=ind == text_depth - 1,
                    **common))
                self.text_hcs.append(make_hcs(dim_text))

        self.final_norm = RMSNorm(dim)
        self.to(device)

    def _layer(self, ind, x, text_embed, skip, mask, rotary, text_rotary, cond,
               attn_v, text_v, text_gate, *, push_skip, seeds):
        """One layer; ``seeds`` are its dropout seeds in the order the
        branches run (text attention, text feedforward, attention,
        feedforward), empty without dropout. Returns plain tensors (or
        None), never lazy streams, so it can be checkpointed."""
        sl = self.speech_layers[ind]
        seeds = iter(seeds)

        # text stream first, then cross-condition
        if exists(text_embed) and ind < self.text_depth:
            tl = self.text_layers[ind]
            t_conv_hc, t_attn_hc, t_ff_hc = self.text_hcs[ind]

            t_in, add_residual = t_conv_hc(text_embed)
            text_embed = add_residual(tl.conv(t_in, mask=mask))

            t_in, add_residual = t_attn_hc(text_embed)
            t_out, t_values = tl.attn(tl.attn_norm(t_in), rotary_pos_emb=text_rotary,
                                      mask=mask, value_residual=text_v, dropout_seed=next(seeds, None))
            text_embed = add_residual(t_out)
            text_v = default(text_v, t_values)

            t_in, add_residual = t_ff_hc(text_embed)
            text_embed = add_residual(tl.ff(tl.ff_norm(t_in), dropout_seed=next(seeds, None)))

            x, text_embed = tl.cross_condition(
                materialize(x), materialize(text_embed), gate=text_gate)

        # UNet skips on the speech stream
        x = materialize(x)
        skip_out = x if push_skip else None
        if exists(skip):
            x = sl.skip_proj(torch.cat((x, skip), dim=-1))

        conv_hc, attn_hc, ff_hc = self.speech_hcs[ind]
        b_in, add_residual = conv_hc(x)
        x = add_residual(sl.conv(b_in, mask=mask))

        b_in, add_residual = attn_hc(x)
        attn_out, values = sl.attn(sl.attn_norm(b_in, condition=cond), rotary_pos_emb=rotary,
                                   mask=mask, value_residual=attn_v, dropout_seed=next(seeds, None))
        x = add_residual(sl.attn_adaln_zero(attn_out, condition=cond))
        attn_v = default(attn_v, values)

        b_in, add_residual = ff_hc(x)
        ff_out = sl.ff(sl.ff_norm(b_in, condition=cond), dropout_seed=next(seeds, None))
        x = add_residual(sl.ff_adaln_zero(ff_out, condition=cond))

        return materialize(x), text_embed, skip_out, attn_v, text_v

    def forward(self, x, times=None, mask=None, text_embed=None, text_cond_gate=None,
                generator: torch.Generator | None = None):
        """``x (b, n, dim)``, ``times (b,)`` or scalar (given iff the model is
        conditioned on time), ``mask (b, n)`` bool,
        ``text_embed (b, n, dim_text)``; ``text_cond_gate (b,)`` scales each
        sample's text->audio adds (0 = a text-free pass). ``generator``
        draws the dropout seeds in training mode. Returns ``(b, n, dim)``."""
        if x.ndim != 3:
            raise NotImplementedError('the frequency axis (4-dim input) is not ported yet')
        if exists(self.dtype):
            x = cast(x, self.dtype)
            if exists(text_embed):
                text_embed = cast(text_embed, self.dtype)

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

        cond = None
        if exists(times):
            if times.ndim == 0:
                times = times.expand(batch)
            cond = cast(F.silu(self.time_mlp(self.time_fourier(times))), x.dtype)

        rotary = rotary_tables(packed_len, self.dim_head, device=x.device)
        text_rotary = None
        if exists(text_embed):
            text_rotary = rotary_tables(packed_len, self.text_dim_head, device=x.device)
            text_registers = cast(self.text_registers, text_embed.dtype)[None]
            text_embed = torch.cat(
                (text_registers.expand(batch, r, self.dim_text), text_embed), dim=1)

        s = self.num_residual_streams
        x = expand_stream(x, s)
        if exists(text_embed):
            text_embed = expand_stream(text_embed, s)

        dropping = self.training and self.dropout > 0.0
        remat = self.remat and torch.is_grad_enabled()
        skips = []
        attn_v = text_v = None
        for ind in range(self.depth):
            is_first_half = ind + 1 <= self.depth // 2
            skip_in = None if is_first_half else skips.pop()
            branches = 4 if exists(text_embed) and ind < self.text_depth else 2
            seeds = tuple(draw_seed(generator) for _ in range(branches)) if dropping else ()
            layer = partial(self._layer, ind, push_skip=is_first_half, seeds=seeds)
            args = (x, text_embed, skip_in, mask, rotary, text_rotary, cond, attn_v, text_v,
                    text_gate)
            # nothing in a layer reads torch's global generators: no RNG state to keep
            x, text_embed, skip_out, attn_v, text_v = (
                checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
                if remat else layer(*args))
            if is_first_half:
                skips.append(skip_out)
        assert len(skips) == 0

        x = reduce_stream(x[:, :, r:, :])
        return self.final_norm(x)
