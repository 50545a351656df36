"""Neural building blocks (counterpart of e2_tts_tpu/models/blocks.py).

Conventions, as in the JAX package:
- parameters are stored in f32; a module built with ``dtype`` computes in
  that dtype (weights cast at use), otherwise in the promoted dtype of its
  input and weights. Norm statistics and gates accumulate in f32.
- initialisation follows the JAX package's (lecun-normal linear and conv
  kernels, zero-init AdaLNZero / cross-condition weights, value-gate bias
  10), drawn from an explicit ``torch.Generator``.
- dropout seeds, too, come from the caller's ``torch.Generator``: the
  transformer draws each layer's seeds (`draw_seed`) and hands them to
  `Attention` / `FeedForward.forward` as ``dropout_seed``; torch's global
  generator is never used, so a training run repeats from its own
  generator. Their ``batch_offset`` is the first row's place in the
  global batch (a data-parallel rank's offset), so a rank draws the bits a
  single device draws for its rows: the attention kernels take it as
  ``hash_b0``, and the GEGLU folds it into its seed (`fold_batch_offset`).
- `Attention` and `FeedForward` run tensor-parallel after `place_tp`
  (parallel/tp.py cuts their weights): a rank computes its heads or GEGLU
  columns, its dropout bits those heads' and columns' of the whole layer
  (``hash_h0``; `fold_column_offset`), and the output projection's partial
  sums are summed over the model axis.
- Under sequence parallelism (parallel/sp.py) `Attention` runs as a ring
  once ``sp_mesh`` is set (`enable_sequence_parallel`), `DepthwiseConv`
  takes its halo from the neighbouring ranks (``seq=``), and `FeedForward`
  folds its rows' first place in the sequence into the GEGLU seed
  (``seq_offset``, `fold_seq_offset`).
- `load_jax_params` (convert.py) maps a JAX model's parameters onto these
  modules one to one; the names below mirror the JAX attribute paths.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from e2_tts_tpu_torch.ops.attention import attention_packed
from e2_tts_tpu_torch.ops.dropout import (
    fold_batch_offset, fold_column_offset, fold_seq_offset, hash_dropout,
)
from e2_tts_tpu_torch.ops.geglu_kernel import geglu_dropout
from e2_tts_tpu_torch.ops.rotary import apply_rotary_packed
from e2_tts_tpu_torch.parallel import sp
from e2_tts_tpu_torch.utils.helpers import (
    default, divisible_by, exists, round_up_to_multiple,
)
from e2_tts_tpu_torch.utils.masking import pad_to_length
from e2_tts_tpu_torch.utils.tensor import masked_interpolate_1d

# std of a unit normal truncated to [-2, 2]: lecun-normal divides by it
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
    return w


def cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def draw_seed(generator: torch.Generator | None) -> int:
    """A dropout seed drawn from ``generator``; dropout in training mode
    needs one (torch's global generator is never used)."""
    if generator is None:
        raise ValueError('dropout in training mode draws its seeds from an explicit '
                         'torch.Generator: pass generator=')
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


class Linear(nn.Module):
    """``x @ weight.T + bias`` in the module's compute dtype; weight stored
    (out, in) in f32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype=None, init: str = 'lecun', generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        if init == 'lecun':
            lecun_normal_(self.weight, in_features, generator)
        else:
            assert init == 'zeros'
            nn.init.zeros_(self.weight)

    def forward(self, x, reduce=None):
        """``reduce``: a row-parallel layer's sum of the ranks' partial
        products (`ModelAxis.exit`), taken before the bias is added."""
        ct = self.dtype if exists(self.dtype) else torch.promote_types(x.dtype, self.weight.dtype)
        bias = cast(self.bias, ct) if exists(self.bias) else None
        if not exists(reduce):
            return F.linear(cast(x, ct), cast(self.weight, ct), bias)
        out = reduce(F.linear(cast(x, ct), cast(self.weight, ct)))
        return out if bias is None else out + bias

    def rows(self, x, start: int, stop: int):
        """Output features ``[start, stop)`` of this layer on ``x``."""
        ct = self.dtype if exists(self.dtype) else torch.promote_types(x.dtype, self.weight.dtype)
        weight, bias = (cast(t[start:stop], ct) if exists(t) else None
                        for t in (self.weight, self.bias))
        return F.linear(cast(x, ct), weight, bias)


class Identity(nn.Module):
    """Stands in for a time-conditioned norm's gate when the transformer is
    not conditioned on time; ignores the condition."""

    def forward(self, x, **kwargs):
        return x


# norms ----------------------------------------------------------------------

class RMSNorm(nn.Module):
    """x / max(||x||, 1e-6) * sqrt(dim) * g: ``x * rsqrt(max(sum x^2,
    1e-12))`` in f32, not ``F.rms_norm`` with an eps."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x, **kwargs):
        xf = x.float()
        normed = xf * torch.rsqrt(torch.clamp((xf * xf).sum(-1, keepdim=True), min=1e-12))
        return (normed * self.scale * self.gamma.float()).to(x.dtype)


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm whose gain is (1 + Linear0(condition)) — time conditioning."""

    def __init__(self, dim: int, dim_condition: int | None = None, *,
                 dtype=None, generator=None):
        super().__init__()
        self.scale = dim ** 0.5
        self.to_gamma = Linear(default(dim_condition, dim), dim, bias=False,
                               dtype=dtype, init='zeros')

    def forward(self, x, *, condition):
        if condition.ndim == 2:
            condition = condition[:, None, :]
        glin = self.to_gamma(condition)
        xf = x.float()
        normed = xf * torch.rsqrt(torch.clamp((xf * xf).sum(-1, keepdim=True), min=1e-12))
        return (normed * self.scale * (glin.float() + 1.0)).to(x.dtype)


class AdaLNZero(nn.Module):
    """Post-branch gate x * sigmoid(Linear(cond)): zero weight, bias -2."""

    def __init__(self, dim: int, dim_condition: int | None = None,
                 init_bias_value: float = -2.0, *, dtype=None, generator=None):
        super().__init__()
        self.to_gamma = Linear(default(dim_condition, dim), dim, dtype=dtype, init='zeros')
        nn.init.constant_(self.to_gamma.bias, init_bias_value)

    def forward(self, x, *, condition):
        if condition.ndim == 2:
            condition = condition[:, None, :]
        gamma = torch.sigmoid(self.to_gamma(condition).float())
        return (x.float() * gamma).to(x.dtype)


# fourier / text embeddings --------------------------------------------------

class RandomFourierEmbed(nn.Module):
    """Time embedding with fixed random frequencies: (x, sin, cos) packed
    into dim + 1 features. The frequencies are a buffer, not a parameter."""

    def __init__(self, dim: int, *, generator=None):
        super().__init__()
        assert divisible_by(dim, 2)
        self.register_buffer('weights', torch.randn(dim // 2, generator=generator))

    def forward(self, x):  # x: (b,)
        xf = x[:, None].float()
        freqs = xf * self.weights[None, :] * 2 * math.pi
        return torch.cat((xf, freqs.sin(), freqs.cos()), dim=-1)


class LinearFourierEmbed(nn.Module):
    """FANformer pre-attention map (arXiv 2502.21309): a bias-free linear to
    ``int(p * dim)`` fourier features, sent out as their sin and cos, plus
    the rest of the width as is."""

    def __init__(self, dim: int, p: float = 0.5, *, dtype=None, generator=None):
        super().__init__()
        assert p <= 1.0
        dim_fourier = int(p * dim)
        dim_rest = dim - dim_fourier * 2
        self.dim_fourier = dim_fourier
        self.linear = Linear(dim, dim_fourier + dim_rest, bias=False, dtype=dtype,
                             generator=generator)

    def forward(self, x):
        hiddens = self.linear(x)
        fourier, rest = hiddens[..., :self.dim_fourier], hiddens[..., self.dim_fourier:]
        return torch.cat((fourier.sin(), fourier.cos(), rest), dim=-1)


class CharacterEmbed(nn.Module):
    """ids + 1 (0 = filler), truncate / right-pad to the mel length, embed."""

    def __init__(self, dim: int, num_embeds: int = 256, *, dtype=None, generator=None):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.embed = nn.Embedding(num_embeds + 1, dim)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, (num_embeds + 1) ** -0.5, generator=generator)

    def forward(self, text: torch.Tensor, max_seq_len: int, **kwargs):
        text = text + 1
        text = pad_to_length(text[:, :max_seq_len], max_seq_len, value=0)
        out = self.embed(text.clamp(min=0))
        return cast(out, self.dtype) if exists(self.dtype) else out


class InterpolatedCharacterEmbed(nn.Module):
    """Text embeddings resampled to each sample's audio length (bilinear,
    `masked_interpolate_1d`), plus an MLP over the interpolated absolute
    text position ``i * text_len / max(audio_len - 1, 1)``. Text ids are
    -1-padded; the table has ``num_embeds`` rows (no filler row). The audio
    length is ``mask``'s count, else ``max_seq_len``; frames outside the
    mask are zero."""

    def __init__(self, dim: int, num_embeds: int = 256, *, dtype=None, generator=None):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.embed = nn.Embedding(num_embeds, dim)
        with torch.no_grad():
            self.embed.weight.normal_(0.0, num_embeds ** -0.5, generator=generator)
        self.pos_in = Linear(1, dim, dtype=dtype, generator=generator)
        self.pos_out = Linear(dim, dim, dtype=dtype, generator=generator)

    def forward(self, text: torch.Tensor, max_seq_len: int, mask=None):
        src_lens = (text >= 0).sum(dim=-1)            # pads are a suffix
        tgt_lens = (mask.sum(dim=-1) if exists(mask) else
                    torch.full_like(src_lens, max_seq_len))
        embeds = self.embed(text.clamp(min=0))        # pads read id 0, never gathered
        if exists(self.dtype):
            embeds = cast(embeds, self.dtype)
        interp = masked_interpolate_1d(embeds, src_lens, tgt_lens, max_seq_len)

        i = torch.arange(max_seq_len, dtype=torch.float32, device=text.device)[None, :]
        denom = torch.clamp(tgt_lens.float() - 1.0, min=1.0)[:, None]
        abs_pos = i * (src_lens.float()[:, None] / denom)
        out = interp + self.pos_out(F.silu(self.pos_in(abs_pos[..., None])))
        if exists(mask):
            out = torch.where(mask[..., None], out, 0.0)
        return out


# multistream glue -----------------------------------------------------------

class TextAudioCrossCondition(nn.Module):
    """Zero-init bias-free linear mixing of the concatenated audio/text
    streams, added back to each stream. ``gate`` scales the text->audio add
    (0 makes a sample's audio stream evolve as if it had no text)."""

    def __init__(self, dim: int, dim_text: int, cond_audio_to_text: bool = True, *,
                 dtype=None, generator=None):
        super().__init__()
        self.text_to_audio = Linear(dim + dim_text, dim, bias=False, dtype=dtype, init='zeros')
        self.cond_audio_to_text = cond_audio_to_text
        self.audio_to_text = (Linear(dim + dim_text, dim_text, bias=False, dtype=dtype,
                                     init='zeros') if cond_audio_to_text else None)

    def forward(self, audio, text, gate=None):
        audio_text = torch.cat((audio, text), dim=-1)
        text_cond = self.text_to_audio(audio_text)
        if exists(gate):
            text_cond = text_cond * gate.to(text_cond.dtype)
        audio_cond = self.audio_to_text(audio_text) if self.cond_audio_to_text else 0.0
        return audio + text_cond, text + audio_cond


# conformer-ish positional conv ----------------------------------------------

class _DepthwiseConv1d(nn.Module):
    """Depthwise Conv1d with SAME padding on (b, n, d); weight (d, 1, k)."""

    def __init__(self, dim: int, kernel_size: int, *, dtype=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(dim))
        lecun_normal_(self.weight, kernel_size, generator)

    def forward(self, x, seq=None):
        """``seq``: the seq axis of a sequence-parallel rank, whose ``x`` is its
        rows of the sequence: the padding is the neighbours' frames
        (`parallel.sp.halo_pad`)."""
        ct = self.dtype if exists(self.dtype) else torch.promote_types(x.dtype, self.weight.dtype)
        k = self.weight.shape[-1]
        x, pad = cast(x, ct), k // 2
        if exists(seq):
            x, pad = sp.halo_pad(x, seq, k // 2), 0
        out = F.conv1d(x.transpose(1, 2), cast(self.weight, ct),
                       cast(self.bias, ct), padding=pad, groups=self.weight.shape[0])
        return out.transpose(1, 2)


class DepthwiseConv(nn.Module):
    """Masked depthwise Conv1d + SiLU, masking input AND output."""

    def __init__(self, dim: int, *, kernel_size: int, dtype=None, generator=None):
        super().__init__()
        assert not divisible_by(kernel_size, 2)
        self.conv = _DepthwiseConv1d(dim, kernel_size, dtype=dtype, generator=generator)

    def forward(self, x, mask=None, seq=None):
        if exists(mask):
            x = x.masked_fill(~mask[..., None], 0.0)
        out = F.silu(self.conv(x, seq=seq))
        if exists(mask):
            out = out.masked_fill(~mask[..., None], 0.0)
        return out


# feedforward ----------------------------------------------------------------

class FeedForward(nn.Module):
    """GLU feedforward: projection, GEGLU + dropout (kernel K6), down
    projection. The inner dim is 2/3 * mult * dim rounded up to a multiple
    of 64 (1408 for dim 512, 704 for the text stream's 256), as in the JAX
    package, so its weights load unchanged. ``glu=False`` is the plain MLP
    (inner ``mult * dim`` rounded up to 64, exact GELU, the counter-hash
    dropout of `ops.dropout.hash_dropout`), plain PyTorch as the JAX
    package runs it on XLA."""

    def __init__(self, dim: int, mult: float = 4.0, dropout: float = 0.0, glu: bool = True, *,
                 dtype=None, generator=None):
        super().__init__()
        self.glu = glu
        inner = round_up_to_multiple(int(dim * mult * 2 / 3) if glu else int(dim * mult), 64)
        self.proj_in = Linear(dim, inner * 2 if glu else inner, dtype=dtype,
                              generator=generator)
        self.proj_out = Linear(inner, dim, dtype=dtype, generator=generator)
        self.dropout_rate = dropout
        self.inner = inner
        self.tp = None          # the model axis (place_tp)
        self.col0 = 0           # this rank's first GEGLU column

    def place_tp(self, axis):
        """Run on ``axis.rank``'s GEGLU columns of the model axis ``axis``
        (parallel/tp.py has cut the weights)."""
        self.tp = axis
        self.col0 = axis.rank * (self.inner // axis.size)

    def forward(self, x, dropout_seed: int | None = None, batch_offset: int = 0,
                seq_offset: int = 0):
        """``batch_offset``: ``x``'s first row in the global batch,
        ``seq_offset`` its first frame's place in the sequence (a
        sequence-parallel rank's); K6 hashes (row, frame, column), so the
        offsets (and a tensor-parallel rank's first column) fold into the
        seed."""
        tp = self.tp
        if exists(tp):
            x = tp.enter(x)
        h = self.proj_in(x)
        rate = self.dropout_rate if self.training else 0.0
        if rate > 0.0 and dropout_seed is None:
            raise ValueError('dropout in training mode needs a dropout_seed')
        seed = 0
        if rate > 0.0:
            seed = fold_column_offset(fold_seq_offset(fold_batch_offset(
                dropout_seed, batch_offset), seq_offset), self.col0)
        h = geglu_dropout(h, seed, rate) if self.glu else hash_dropout(F.gelu(h), rate, seed)
        return self.proj_out(h, reduce=tp.exit if exists(tp) else None)


# attention ------------------------------------------------------------------

class Attention(nn.Module):
    """Multi-head attention with the x-transformers flags the reference
    configures: tanh logit softclamp (50), per-head sigmoid value gates
    (folded into kernel K1 where it runs), the learned value-residual mix
    with the first layer's raw values, attention dropout, key-padding mask,
    RoPE, and LASER (exp-space values). dim_head 32, 64 or 128 runs on K1,
    any other dim_head up to 256 on K8 (ops/attention.py). With ``sp_mesh``
    set (`parallel.sp.enable_sequence_parallel`) the inputs are this rank's
    rows of the sequence and the core runs as ring attention over the
    mesh's ``sp_axis``.

    Returns ``(out, values)``: ``values`` are this layer's raw (pre-mix)
    value heads, fed forward as the value residual. Everything stays in the
    packed ``(b, n, h*dh)`` projection layout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, gate_value_heads: bool = False,
                 softclamp_logits: bool = False, softclamp_logits_value: float = 50.0,
                 laser: bool = False, laser_softclamp_value: float = 15.0,
                 learned_value_residual_mix: bool = False, *,
                 dtype=None, generator=None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.dropout_rate = dropout
        self.softclamp_value = softclamp_logits_value if softclamp_logits else None
        self.laser = laser
        self.laser_softclamp_value = laser_softclamp_value
        inner = heads * dim_head
        self.inner = inner
        self.tp = None          # the model axis (place_tp)
        self.head0 = 0          # this rank's first head, and its head count
        self.local_heads = heads
        self.sp_mesh = None     # sequence parallelism: the mesh and its seq axis
        self.sp_axis = 'seq'

        # q/k/v as one (3*inner, dim) weight: rows [0, inner) are q, then k, v
        # (the JAX package's (dim, 3, inner) kernel, transposed)
        self.to_qkv = Linear(dim, 3 * inner, bias=False, dtype=dtype, init='zeros')
        lecun_normal_(self.to_qkv.weight, dim, generator)
        self.to_out = Linear(inner, dim, bias=False, dtype=dtype, generator=generator)

        self.to_v_head_gate = None
        if gate_value_heads:
            # x-transformers init: zero weight, bias 10 — gates start open
            self.to_v_head_gate = Linear(dim, heads, dtype=dtype, init='zeros')
            nn.init.constant_(self.to_v_head_gate.bias, 10.0)
        self.to_value_residual_mix = (
            Linear(dim, heads, dtype=dtype, generator=generator)
            if learned_value_residual_mix else None)

    def place_tp(self, axis):
        """Run on ``axis.rank``'s heads of the model axis ``axis``
        (parallel/tp.py has cut the weights)."""
        self.tp = axis
        self.local_heads = self.heads // axis.size
        self.head0 = axis.rank * self.local_heads

    def _head_rows(self, linear, x):
        """A dim -> heads layer's rows of this rank's heads."""
        if not exists(self.tp):
            return linear(x)
        return linear.rows(x, self.head0, self.head0 + self.local_heads)

    def forward(self, x, rotary_pos_emb=None, mask=None, value_residual=None,
                dropout_seed: int | None = None, batch_offset: int = 0):
        """Tensor-parallel after `place_tp`: q, k, v, the returned values and
        ``value_residual`` are this rank's heads', and ``out`` is summed over
        the model axis."""
        tp = self.tp
        if exists(tp):
            x = tp.enter(x)
        h = self.local_heads
        inner = h * self.dim_head

        fused = self.to_qkv(x)                                   # (b, n, 3*inner)
        q, k, v = fused[..., :inner], fused[..., inner:2 * inner], fused[..., 2 * inner:]
        orig_values = v

        gate_logits = (self._head_rows(self.to_v_head_gate, x)
                       if exists(self.to_v_head_gate) else None)
        if exists(self.to_value_residual_mix) and exists(value_residual):
            mix = torch.sigmoid(self._head_rows(self.to_value_residual_mix, x))[..., None]
            v4 = v.unflatten(-1, (h, self.dim_head))
            vr4 = value_residual.to(v.dtype).unflatten(-1, (h, self.dim_head))
            v = (v4 * mix + vr4 * (1.0 - mix)).flatten(-2)

        if exists(rotary_pos_emb):
            q = apply_rotary_packed(q, rotary_pos_emb)
            k = apply_rotary_packed(k, rotary_pos_emb)

        training = self.training and self.dropout_rate > 0.0
        if training and dropout_seed is None:
            raise ValueError('dropout in training mode needs a dropout_seed')
        out = attention_packed(
            q, k, v, mask, heads=h, softclamp_value=self.softclamp_value,
            laser=self.laser, laser_softclamp_value=self.laser_softclamp_value,
            dropout_rate=self.dropout_rate if training else 0.0,
            dropout_seed=dropout_seed if training else None,
            gate_logits=gate_logits, hash_b0=batch_offset, hash_h0=self.head0,
            hash_heads=self.heads, sp_mesh=self.sp_mesh, sp_axis=self.sp_axis)
        return self.to_out(out, reduce=tp.exit if exists(tp) else None), orig_values
