"""E2TTS — conditional flow-matching TTS (counterpart of
e2_tts_tpu/models/e2tts.py).

Training (`forward`): mask-infilling flow matching. Noise x0, a time t ~
U(0, 1) and a random span of the mel to infill are drawn; the transformer
sees w = (1 - t) x0 + t x1 with the span zeroed in the condition and
predicts the flow x1 - x0; the MSE is restricted to the span. An optional
velocity-consistency term holds the prediction to an EMA teacher's at
t + delta. The draws come from a ``torch.Generator`` or are passed in
(``times``, ``noise``, ``rand_span_mask``); the same generator draws the
dropout seeds. A data-parallel rank trains on rows ``[batch_offset,
batch_offset + b)`` of a global batch of ``global_batch``: it draws the
global batch's tensors and keeps its rows, draws the dropout bits of those
rows, and its loss is its term of the global loss (`forward`). Under
sequence parallelism (parallel/sp.py) the draws and the text embedding stay
those of the whole sequence; the transformer returns this rank's frames,
and the loss is their error over the span count of the whole sequence,
summed over the seq axis. `sample` runs the attentions dense.

Inference integrates the learned velocity field from noise over a fixed
time grid (ops/ode.py) with classifier-free guidance, APG parallel-component
removal (arXiv 2410.02416) and an optional autoguidance null model. The CFG
pair runs as two sequential passes (the null pass runs no text stream at
all) or as one 2x-batched pass whose null half gates the text->audio adds
to zero.

Inputs and prompts are mels ``(b, n, num_channels)`` or raw waves ``(b,
nw)``, which the mel frontend (``mel_spec_kwargs``; ``mode='pallas'`` runs
kernel K11) turns into mels. Without a ``duration``, `sample` asks the
duration predictor. ``use_vocos=True`` decodes the sampled mels to
waveforms: with ``vocos_backend='jax'`` (the port's default) through the
port's own `Vocos` on the mels' device, which stays out of this module's
parameters (``vocos_weights``, the published checkpoint's state dict or a
path to it, loads into it); with ``'torch'`` through the external torch
``vocos`` package (``Vocos.from_pretrained(pretrained_vocos_path)``,
loaded at the first decode), one sample at a time on the host, as the JAX
package's default. ``use_vocos=None`` turns the vocoder on iff the
``vocos`` package is installed, as in the JAX package.

``save_to_filename`` writes each decoded waveform as a 16-bit mono WAV
``{i + 1}.{name}`` beside the path, as the JAX package does.

Options, as in the JAX package: ``num_freq_tokens > 1`` projects each
frame to ``num_freq_tokens`` tokens for a backbone with the frequency axis
and averages them before the prediction head; ``concat_cond`` concatenates
the condition to the input before one projection (no ``cond_proj_in``);
``interpolated_text`` resamples the text embeddings to each sample's
length (`InterpolatedCharacterEmbed`). The sampler takes
``odeint_kwargs``' method, ``atol`` and ``rtol`` (ops/ode.py: fixed-grid or
adaptive).
"""

from __future__ import annotations

import importlib.util
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from e2_tts_tpu_torch.models.blocks import CharacterEmbed, InterpolatedCharacterEmbed, Linear
from e2_tts_tpu_torch.models.duration import DurationPredictor
from e2_tts_tpu_torch.models.transformer import Transformer
from e2_tts_tpu_torch.ops.mel import MelSpec, as_mel, db_to_amplitude
from e2_tts_tpu_torch.ops.ode import odeint
from e2_tts_tpu_torch.parallel.sp import seq_sum, sp_paused
from e2_tts_tpu_torch.parallel.tp import tp_axis
from e2_tts_tpu_torch.text.tokenizer import resolve_tokenizer, tokenize_batch
from e2_tts_tpu_torch.utils.audio_io import save_wav
from e2_tts_tpu_torch.utils.helpers import default, exists, resolve_device, round_up_to_multiple
from e2_tts_tpu_torch.utils.masking import lens_to_mask, mask_from_frac_lengths
from e2_tts_tpu_torch.utils.tensor import project
from e2_tts_tpu_torch.vocoder.vocos import Vocos

LossBreakdown = namedtuple('LossBreakdown', ['flow', 'velocity_consistency'])

E2TTSReturn = namedtuple('E2TTS', ['loss', 'cond', 'pred_flow', 'pred_data', 'loss_breakdown'])


def masked_mse(pred, target, span_mask, span_count=None):
    """Mean squared error over the span's frames and all channels (f32):
    the error sum over ``span_count * channels``, ``span_count`` the span's
    frame count unless given (a data-parallel rank gives the global
    batch's)."""
    err = (pred.float() - target.float()) ** 2
    err = torch.where(span_mask[..., None], err, 0.0)
    span_count = default(span_count, span_mask.float().sum())
    denom = torch.clamp(span_count * pred.shape[-1], min=1.0)
    return err.sum() / denom


def global_span_count(span_mask: torch.Tensor, group=None) -> torch.Tensor:
    """The span's frame count summed over the ranks of the data axis'
    ``group`` (None: the default process group, which a 1-D data mesh
    spans), without grad: the global batch's."""
    count = span_mask.float().sum().detach()
    dist.all_reduce(count, group=group)
    return count


class _StaticBox:
    """Keeps a module (the frozen vocoder) out of the surrounding module's
    parameters: not trained, EMA'd, checkpointed or moved with the model."""

    def __init__(self, value):
        self.value = value


class E2TTS(nn.Module):

    def __init__(
        self,
        transformer: dict | Transformer | None = None,
        duration_predictor: dict | DurationPredictor | None = None,
        odeint_kwargs: dict = dict(atol=1e-5, rtol=1e-5, method='midpoint'),
        cond_drop_prob: float = 0.25,
        num_channels: int | None = None,
        mel_spec_module: MelSpec | None = None,
        num_freq_tokens: int = 1,
        char_embed_kwargs: dict = dict(),
        mel_spec_kwargs: dict = dict(),
        frac_lengths_mask: tuple[float, float] = (0.7, 1.0),
        concat_cond: bool = False,
        interpolated_text: bool = False,
        text_num_embeds: int | None = None,
        tokenizer='char_utf8',
        use_vocos: bool | None = None,
        pretrained_vocos_path: str = 'charactr/vocos-mel-24khz',
        vocos_backend: str = 'jax',
        vocos_weights=None,
        sampling_rate: int | None = None,
        velocity_consistency_weight: float = 0.0,
        dtype=None,
        generator: torch.Generator | None = None,
        device=None,
    ):
        """``generator`` draws the initial weights and stays the default
        source of `forward`'s draws (as the JAX model's ``rngs``).
        ``use_vocos`` with ``vocos_backend='jax'`` builds the port's `Vocos`
        (random weights from a seed unless ``vocos_weights`` gives the
        published checkpoint's state dict or its path); with ``'torch'``
        the torch ``vocos`` package loads ``pretrained_vocos_path`` at the
        first decode (ImportError without the package)."""
        super().__init__()
        if num_freq_tokens < 1:
            raise ValueError(f'num_freq_tokens must be positive, got {num_freq_tokens}')
        if vocos_backend not in ('jax', 'torch'):
            raise ValueError(f"vocos_backend must be 'jax' or 'torch', got {vocos_backend!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        self.num_freq_tokens = num_freq_tokens
        self.has_freq_axis = num_freq_tokens > 1
        if isinstance(transformer, dict):
            transformer = dict(transformer)
            transformer.setdefault('has_freq_axis', self.has_freq_axis)
            transformer = Transformer(**transformer, dtype=dtype, generator=generator,
                                      device=device)
        if transformer.has_freq_axis != self.has_freq_axis:
            raise ValueError('the transformer needs has_freq_axis iff num_freq_tokens > 1')
        self.transformer = transformer
        if isinstance(duration_predictor, dict):
            duration_predictor = DurationPredictor(**duration_predictor, dtype=dtype,
                                                   generator=generator, device=device)
        self.duration_predictor = duration_predictor
        self.dim = dim = transformer.dim
        self.dim_text = transformer.dim_text
        self.odeint_kwargs = dict(odeint_kwargs)
        self.mel_spec = default(mel_spec_module, MelSpec(**mel_spec_kwargs))
        self.num_channels = num_channels = default(num_channels, self.mel_spec.n_mel_channels)
        self.sampling_rate = default(sampling_rate, self.mel_spec.sampling_rate)

        # the condition: concatenated to the input before one projection, or
        # projected on its own and added
        self.concat_cond = concat_cond
        self.proj_in = Linear(num_channels * (2 if concat_cond else 1), dim * num_freq_tokens,
                              dtype=dtype, generator=generator)
        self.cond_proj_in = None if concat_cond else Linear(
            num_channels, dim * num_freq_tokens, dtype=dtype, generator=generator)
        self.to_pred = Linear(dim, num_channels, dtype=dtype, generator=generator)

        self.tokenizer, text_num_embeds = resolve_tokenizer(tokenizer, text_num_embeds)
        self.cond_drop_prob = cond_drop_prob
        embed_cls = InterpolatedCharacterEmbed if interpolated_text else CharacterEmbed
        self.embed_text = embed_cls(self.dim_text, num_embeds=text_num_embeds, dtype=dtype,
                                    generator=generator, **char_embed_kwargs)
        self.frac_lengths_mask = tuple(frac_lengths_mask)
        self.velocity_consistency_weight = velocity_consistency_weight
        self.generator = generator
        if use_vocos is None:
            use_vocos = importlib.util.find_spec('vocos') is not None
        self.use_vocos = use_vocos
        self.pretrained_vocos_path = pretrained_vocos_path
        self.vocos_backend = vocos_backend
        self._vocos = None
        if use_vocos and vocos_backend == 'jax':
            vocos = Vocos(input_channels=num_channels, device=device)
            if exists(vocos_weights):
                if isinstance(vocos_weights, (str, bytes, Path)):
                    vocos_weights = torch.load(vocos_weights, map_location='cpu')
                vocos.load_torch_state_dict(vocos_weights)
            self._vocos = _StaticBox(vocos)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.proj_in.weight.device

    @property
    def vocos(self):
        """The port's `Vocos` (``vocos_backend='jax'``), the torch
        package's, loaded on first use (``'torch'``), or None."""
        if not self.use_vocos:
            return None
        if not exists(self._vocos):
            from vocos import Vocos as TorchVocos    # the external package, host decode
            self._vocos = _StaticBox(TorchVocos.from_pretrained(self.pretrained_vocos_path))
        return self._vocos.value

    def _as_mel(self, inp: torch.Tensor) -> torch.Tensor:
        return as_mel(self.mel_spec, inp, self.num_channels)

    def _project_input(self, x, cond):
        """The projected input ``(b, n, dim)``, or with the frequency axis
        ``(b, f, n, dim)``."""
        if self.concat_cond:
            x = self.proj_in(torch.cat((cond, x), dim=-1))
        else:
            x = self.proj_in(x) + self.cond_proj_in(cond)
        if not self.has_freq_axis:
            return x
        b, n, _ = x.shape
        return x.reshape(b, n, self.num_freq_tokens, self.dim).transpose(1, 2)

    def _head(self, embed):
        """The prediction head, after the mean over frequency tokens."""
        return self.to_pred(embed.mean(dim=1) if self.has_freq_axis else embed)

    def forward(self, inp: torch.Tensor, *, text=None, times=None, lens=None,
                noise=None, rand_span_mask=None, velocity_consistency_model=None,
                velocity_consistency_delta: float = 1e-5,
                drop_text_cond: bool | None = None,
                generator: torch.Generator | None = None, batch_offset: int = 0,
                global_batch: int | None = None) -> E2TTSReturn:
        """The flow-matching loss on mels ``inp (b, n, num_channels)`` or raw
        waves ``(b, nw)``.

        ``times (b,)``, ``noise`` (x0, the shape of ``inp``) and
        ``rand_span_mask (b, n)`` replace the draws from ``generator``
        (default: the model's), which are made in that order: the span's
        length fractions and starts, x0, t, and then, in training mode and
        without ``drop_text_cond``, the text-drop coin (probability
        ``cond_drop_prob``).
        ``velocity_consistency_model`` (an EMA teacher) adds the
        velocity-consistency term when ``velocity_consistency_weight > 0``.

        A data-parallel rank passes its rows' place in the global batch:
        ``inp`` is rows ``[batch_offset, batch_offset + b)`` of a batch of
        ``global_batch``. Each draw is then made at the global batch's size
        and sliced to these rows, so ranks whose generators are in step
        draw what one device draws for the whole batch; the dropout bits
        are those of these rows. With ``global_batch > b`` the losses are
        this rank's terms of the global ones: the error sums over the span
        count of the whole batch (`global_span_count`, a collective over the
        default process group), so the terms sum over the ranks to the
        global loss, and their grads to its grad.

        With the attentions routed over a seq axis (`parallel.sp`), every
        rank of a seq group takes the same rows and draws; the transformer
        returns this rank's frames (``pred_flow`` and ``pred_data`` are
        those frames), their error sums over the span count of the whole
        sequence, and the loss is that term summed over the seq axis (its
        grad each rank's term's: the parameter grads sum over data x seq)."""
        need_velocity_loss = (exists(velocity_consistency_model)
                              and self.velocity_consistency_weight > 0.0)
        device = self.device
        generator = default(generator, self.generator)
        gen_device = generator.device
        inp = self._as_mel(inp.to(device))
        batch, seq_len = inp.shape[0], inp.shape[1]
        dtype = inp.dtype
        total = default(global_batch, batch)
        if not 0 <= batch_offset <= total - batch:
            raise ValueError(f'rows [{batch_offset}, {batch_offset + batch}) are not in a '
                             f'global batch of {total}')
        rows = slice(batch_offset, batch_offset + batch)

        def rand():                   # a global (total,) draw, this rank's rows
            return torch.rand((total,), generator=generator, device=gen_device)[rows].to(device)

        text = self._tokenize(text, batch)
        if not exists(lens):
            lens = torch.full((batch,), seq_len, dtype=torch.long, device=device)
        lens = lens.to(device)
        mask = lens_to_mask(lens, length=seq_len)

        # random infill span
        if not exists(rand_span_mask):
            lo, hi = self.frac_lengths_mask
            frac_lengths = rand() * (hi - lo) + lo
            rand_span_mask = mask_from_frac_lengths(lens, frac_lengths, seq_len, rand=rand())
        rand_span_mask = rand_span_mask.to(device) & mask

        # flow matching: x0 noise, x1 data
        x1 = inp
        if exists(noise):
            x0 = noise.to(device=device, dtype=dtype)
        else:
            x0 = torch.randn((total, *x1.shape[1:]), generator=generator, device=gen_device,
                             dtype=dtype)[rows].to(device)
        if exists(times):
            times = times.to(device=device, dtype=torch.float32)
        else:
            times = rand()
        t = times[:, None, None].to(dtype)
        if need_velocity_loss:
            t = t * (1.0 - velocity_consistency_delta)

        w = (1.0 - t) * x0 + t * x1
        flow = x1 - x0

        # infill target: zero the span, keep the rest as conditioning
        cond = torch.where(rand_span_mask[..., None], torch.zeros_like(x1), x1)

        pred, did_drop_text_cond = self.transformer_with_pred_head(
            w, cond, times, text=text, mask=mask, drop_text_cond=drop_text_cond,
            return_drop_text_cond=True, generator=generator, batch_offset=batch_offset)

        span_count = (global_span_count(rand_span_mask, self._data_group())
                      if total > batch else None)
        seq, frames = self.transformer.seq_axis(), slice(None)
        if exists(seq):       # this rank's frames; the count of the whole sequence
            span_count = default(span_count, rand_span_mask.float().sum())
            frames = self.transformer.frame_slice(seq_len)
            flow, rand_span_mask = flow[:, frames], rand_span_mask[:, frames]
        velocity_loss = torch.zeros((), dtype=torch.float32, device=device)
        if need_velocity_loss:
            t_delta = t + velocity_consistency_delta
            w_delta = (1.0 - t_delta) * x0 + t_delta * x1
            with torch.no_grad():
                ema_pred = velocity_consistency_model.transformer_with_pred_head(
                    w_delta, cond, times + velocity_consistency_delta, text=text,
                    mask=mask, drop_text_cond=did_drop_text_cond, batch_offset=batch_offset)
            velocity_loss = masked_mse(pred, ema_pred, rand_span_mask, span_count)

        loss = masked_mse(pred, flow, rand_span_mask, span_count)
        if exists(seq):
            loss, velocity_loss = seq_sum(loss, seq), seq_sum(velocity_loss, seq)
        total = loss + velocity_loss * self.velocity_consistency_weight
        return E2TTSReturn(total, cond, pred, x0[:, frames] + pred,
                           LossBreakdown(loss, velocity_loss))

    def _data_group(self):
        """The data axis' group of a tensor- or sequence-parallel model's
        mesh (its model or seq groups compute the same rows), else None: the
        default group."""
        axis = default(tp_axis(self), self.transformer.seq_axis())
        return axis.data_group if exists(axis) else None

    def _tokenize(self, text, batch):
        return tokenize_batch(self.tokenizer, text, batch, self.device)

    # -- prediction heads ----------------------------------------------------

    def transformer_with_pred_head(self, x, cond, times, mask=None, text=None,
                                   drop_text_cond: bool | None = None,
                                   return_drop_text_cond: bool = False,
                                   generator: torch.Generator | None = None,
                                   batch_offset: int = 0):
        """Core prediction pass; ``drop_text_cond`` defaults, while training,
        to a coin with probability ``cond_drop_prob`` drawn from ``generator``
        (default: the model's), which in training mode also draws the dropout
        seeds, for the rows from ``batch_offset`` of the global batch."""
        seq_len = x.shape[-2]
        generator = default(generator, self.generator)
        if not exists(drop_text_cond):
            drop_text_cond = self.training and float(torch.rand(
                (), generator=generator, device=generator.device)) < self.cond_drop_prob

        x = self._project_input(x, cond)
        text_embed = None
        if exists(text) and not drop_text_cond:
            text_embed = self.embed_text(text, seq_len, mask=mask)

        pred = self._head(self.transformer(x, times=times, mask=mask, text_embed=text_embed,
                                           generator=generator, batch_offset=batch_offset))
        return (pred, drop_text_cond) if return_drop_text_cond else pred

    def _cfg_batched_preds(self, x, cond, times, *, text, mask):
        """The CFG cond and null passes as ONE 2x-batched forward: the null
        half gates the text->audio cross-condition adds to zero, which is
        exactly a pass with no text conditioning."""
        seq_len, batch = x.shape[-2], x.shape[0]
        x = self._project_input(x, cond)
        text_embed = self.embed_text(text, seq_len, mask=mask)
        dup = lambda t: torch.cat((t, t), dim=0) if exists(t) else None
        gate = torch.cat((torch.ones(batch), torch.zeros(batch))).to(x.device)
        embed = self.transformer(dup(x), times=dup(times), mask=dup(mask),
                                 text_embed=dup(text_embed), text_cond_gate=gate)
        pred2 = self._head(embed)
        return pred2[:batch], pred2[batch:]

    def cfg_transformer_with_pred_head(self, x, cond, times, *, text=None, mask=None,
                                       cfg_strength: float = 1.0, cfg_null_model=None,
                                       remove_parallel_component: bool = True,
                                       keep_parallel_frac: float = 0.0,
                                       batched_cfg: bool = True):
        """Classifier-free guidance with APG parallel-component removal and
        the autoguidance hook (``cfg_null_model``)."""
        if cfg_strength < 1e-5:
            return self.transformer_with_pred_head(x, cond, times, mask=mask, text=text,
                                                   drop_text_cond=False)

        if batched_cfg and not exists(cfg_null_model) and exists(text):
            pred, null_pred = self._cfg_batched_preds(x, cond, times, text=text, mask=mask)
        else:
            pred = self.transformer_with_pred_head(x, cond, times, mask=mask, text=text,
                                                   drop_text_cond=False)
            null_model = default(cfg_null_model, self)
            null_pred = null_model.transformer_with_pred_head(
                x, cond, times, mask=mask, text=text,
                drop_text_cond=not exists(cfg_null_model))

        cfg_update = pred - null_pred
        if remove_parallel_component:
            parallel, orthogonal = project(cfg_update, pred)
            cfg_update = orthogonal + parallel * keep_parallel_frac
        return pred + cfg_update * cfg_strength

    # -- sampling ------------------------------------------------------------

    @torch.no_grad()
    def sample(self, cond: torch.Tensor, *, text=None, lens=None, duration=None,
               steps: int = 32, cfg_strength: float = 1.0, cfg_null_model=None,
               max_duration: int = 4096, vocoder=None, return_raw_output: bool | None = None,
               save_to_filename: str | None = None, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None, duration_bucket: int = 128,
               batched_cfg: bool = False):
        """Zero-shot inference: prompt ``cond`` (mel ``(b, n, num_channels)``
        or raw wave ``(b, nw)``) + text -> infilled mel ``(b, max duration,
        num_channels)``, or what ``vocoder`` makes of it, or with
        ``use_vocos`` a list of per-sample waveforms of ``(duration - 1) *
        hop`` samples. Without ``duration`` the duration predictor sets it.
        ``noise`` replaces the initial state drawn from ``generator``; it
        has the padded generation shape ``(b, padded length, num_channels)``.
        ``save_to_filename`` also writes each waveform as ``{i + 1}.{name}``
        beside the path (16-bit mono WAV; it needs a vocoder)."""
        if exists(vocoder) and self.use_vocos:
            raise ValueError('`use_vocos` should not be on when passing a custom `vocoder`')
        if exists(save_to_filename) and not (exists(vocoder) or self.use_vocos):
            raise ValueError('`save_to_filename` needs audio: pass `vocoder=` or build the '
                             'model with `use_vocos=True`')
        was_training = self.training
        self.eval()
        try:
            # sampling lengths rarely divide a seq axis: the attentions run dense
            with sp_paused(self, cfg_null_model):
                out = self._sample(cond, text=text, lens=lens, duration=duration, steps=steps,
                                   cfg_strength=cfg_strength, cfg_null_model=cfg_null_model,
                                   max_duration=max_duration, vocoder=vocoder,
                                   return_raw_output=return_raw_output, noise=noise,
                                   generator=generator, duration_bucket=duration_bucket,
                                   batched_cfg=batched_cfg)
        finally:
            self.train(was_training)
        if exists(save_to_filename) and not return_raw_output:
            self._save_audio(out, save_to_filename)
        return out

    def _save_audio(self, audio, filename: str):
        """Each waveform of the batch as 16-bit mono WAV ``{i + 1}.{name}``
        beside ``filename`` (its directory made if missing), at the model's
        sampling rate."""
        path = Path(filename)
        path.parent.mkdir(exist_ok=True, parents=True)
        for ind, one in enumerate(audio):
            if isinstance(one, torch.Tensor):
                one = one.detach().float().cpu().numpy()
            save_wav(str(path.parent / f'{ind + 1}.{path.name}'), one, self.sampling_rate)

    def _sample(self, cond, *, text, lens, duration, steps, cfg_strength, cfg_null_model,
                max_duration, vocoder, return_raw_output, noise, generator,
                duration_bucket, batched_cfg):
        device = self.device
        cond = self._as_mel(cond.to(device))
        batch, cond_seq_len = cond.shape[0], cond.shape[1]

        if not exists(lens):
            lens = torch.full((batch,), cond_seq_len, dtype=torch.long, device=device)
        lens = lens.to(device)

        text = self._tokenize(text, batch)
        if exists(text):
            lens = torch.maximum((text != -1).sum(dim=-1).to(lens.dtype), lens)

        if isinstance(duration, int):
            duration = torch.full((batch,), duration, dtype=torch.long, device=device)
        elif not exists(duration):
            if not exists(self.duration_predictor):
                raise ValueError('`duration` must be given when no duration predictor is attached')
            duration = self.duration_predictor(cond, text=text, lens=lens,
                                               return_loss=False).to(torch.long)
        duration = torch.maximum(lens + 1, duration.to(device))  # at least one frame
        duration = duration.clamp(max=max_duration)
        if duration.shape != (batch,):
            raise ValueError(f'duration must be an int or a ({batch},) tensor')

        # padded generation length, bucketed as in the JAX package
        tmax = int(duration.max())
        padded_t = min(round_up_to_multiple(tmax, duration_bucket), max(max_duration, tmax))

        # truncate before padding: the prompt may be longer than the bucket
        cond = cond[:, :padded_t]
        cond = F.pad(cond, (0, 0, 0, padded_t - cond.shape[1]))
        cond_mask = lens_to_mask(lens, length=padded_t)[..., None]
        mask = lens_to_mask(duration, length=padded_t)

        if exists(noise):
            if noise.shape != cond.shape:
                raise ValueError(f'noise must have shape {tuple(cond.shape)}, '
                                 f'got {tuple(noise.shape)}')
            y0 = noise.to(device=device, dtype=cond.dtype)
        else:
            gen_device = generator.device if exists(generator) else device
            y0 = torch.randn(cond.shape, generator=generator, device=gen_device,
                             dtype=cond.dtype).to(device)

        step_cond = torch.where(cond_mask, cond, torch.zeros((), dtype=cond.dtype, device=device))

        def fn(t, x):
            times = torch.full((batch,), float(t), dtype=torch.float32, device=device)
            return self.cfg_transformer_with_pred_head(
                x, step_cond, times, text=text, mask=mask, cfg_strength=float(cfg_strength),
                cfg_null_model=cfg_null_model, batched_cfg=batched_cfg)

        t = np.linspace(0.0, 1.0, steps, dtype=np.float32)
        kw = self.odeint_kwargs
        sampled = odeint(fn, y0, t, method=kw.get('method', 'midpoint'), atol=kw.get('atol'),
                         rtol=kw.get('rtol'))
        out = torch.where(cond_mask, cond, sampled)[:, :tmax]

        if exists(return_raw_output) and return_raw_output:
            return out
        if exists(vocoder):
            return vocoder(out.transpose(1, 2))
        if self.use_vocos:
            return self._vocos_decode(out, mask[:, :tmax])
        return out

    def _vocos_decode(self, mels, mask):
        """The batch decoded at once, frames beyond each length zeroed (they
        would otherwise reach shorter samples' tails through the
        convolutions and the overlap-add), then each waveform trimmed to
        ``(len - 1) * hop``. The amplitude keeps the reference's
        ``DB_to_amplitude(mel, 1, 0.5)`` (it treats the ln-mel as dB). The
        torch package's Vocos decodes each sample's frames alone on the
        host instead."""
        if self.vocos_backend == 'torch':
            audio = []
            for mel, m in zip(mels.float().cpu(), mask.cpu()):
                amp = db_to_amplitude(mel[m], 1.0, 0.5)
                audio.append(self.vocos.decode(amp.T[None].contiguous())[0].to(mels.device))
            return audio
        vocos = self.vocos.to(mels.device)
        amp = db_to_amplitude(mels.float(), 1.0, 0.5)
        amp = torch.where(mask[..., None], amp, 0.0)
        wav = vocos.decode(amp)
        hop = vocos.head.hop_length
        lens = mask.sum(dim=-1).tolist()
        return [wav[i, :max(int(n) - 1, 0) * hop] for i, n in enumerate(lens)]
