"""Duration predictor (counterpart of e2_tts_tpu/models/duration.py).

mel (or raw wave) + optional text -> the total frame count. The backbone is
the dual-stream `Transformer` without time conditioning; the embedding is
pooled by a masked mean and read out by an HL-Gauss head (softplus
regression by default). For the loss the model sees a random prefix of each
sample: everything at or beyond ``int(rand_frac * len)`` is masked, and the
target is the full length. With ``num_freq_tokens > 1`` each frame is
projected to that many tokens for a backbone with the frequency axis, and
the tokens are averaged before pooling. A data-parallel rank passes its
rows' place in the global batch (`forward`): the prefix draw is the global
one sliced, the dropout bits are its rows', and its loss is its term of
the global batch mean.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from e2_tts_tpu_torch.models.blocks import CharacterEmbed, Linear
from e2_tts_tpu_torch.models.hl_gauss import HLGaussLayer
from e2_tts_tpu_torch.models.transformer import Transformer
from e2_tts_tpu_torch.ops.mel import MelSpec, as_mel
from e2_tts_tpu_torch.text.tokenizer import resolve_tokenizer, tokenize_batch
from e2_tts_tpu_torch.utils.helpers import default, exists, resolve_device
from e2_tts_tpu_torch.utils.masking import lens_to_mask, maybe_masked_mean


class DurationPredictor(nn.Module):

    def __init__(
        self,
        transformer: dict | Transformer,
        num_channels: int | None = None,
        mel_spec_kwargs: dict = dict(),
        char_embed_kwargs: dict = dict(),
        text_num_embeds: int | None = None,
        num_freq_tokens: int = 1,
        hl_gauss_loss: dict | None = None,
        use_regression: bool = True,
        tokenizer='char_utf8',
        dtype=None,
        generator: torch.Generator | None = None,
        device=None,
    ):
        """``generator`` draws the initial weights and stays the default
        source of the random prefix of `forward`. ``char_embed_kwargs`` go to
        the `CharacterEmbed`, as in the JAX package."""
        super().__init__()
        if num_freq_tokens < 1:
            raise ValueError(f'num_freq_tokens must be positive, got {num_freq_tokens}')
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_freq_tokens = num_freq_tokens
        self.has_freq_axis = num_freq_tokens > 1
        if isinstance(transformer, dict):
            transformer = dict(transformer)
            transformer.setdefault('has_freq_axis', self.has_freq_axis)
            transformer = Transformer(**transformer, cond_on_time=False, dtype=dtype,
                                      generator=generator, device=device)
        if transformer.cond_on_time:
            raise ValueError('the duration predictor takes a transformer with cond_on_time=False')
        if transformer.has_freq_axis != self.has_freq_axis:
            raise ValueError('the transformer needs has_freq_axis iff num_freq_tokens > 1')
        self.transformer = transformer
        self.dim = dim = transformer.dim

        self.mel_spec = MelSpec(**mel_spec_kwargs)
        self.num_channels = default(num_channels, self.mel_spec.n_mel_channels)
        self.proj_in = Linear(self.num_channels, dim * num_freq_tokens, dtype=dtype,
                              generator=generator)
        self.tokenizer, text_num_embeds = resolve_tokenizer(tokenizer, text_num_embeds)
        self.embed_text = CharacterEmbed(transformer.dim_text, num_embeds=text_num_embeds,
                                         dtype=dtype, generator=generator, **char_embed_kwargs)
        self.hl_gauss_layer = HLGaussLayer(dim, hl_gauss_loss=hl_gauss_loss,
                                           use_regression=use_regression, dtype=dtype,
                                           generator=generator)
        self.generator = generator
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.proj_in.weight.device

    def forward(self, x: torch.Tensor, *, text=None, lens=None, return_loss: bool = True,
                rand_frac: torch.Tensor | None = None,
                generator: torch.Generator | None = None, batch_offset: int = 0,
                global_batch: int | None = None) -> torch.Tensor:
        """``x``: mel ``(b, n, num_channels)`` or raw wave ``(b, nw)``.
        Returns the predicted frame counts ``(b,)`` (f32) or, with
        ``return_loss``, the loss against ``lens`` (default: the full
        length). ``rand_frac (b,)`` in [0, 1) sets the prefix; otherwise it
        is drawn from ``generator`` (default: the model's).

        ``x`` as rows ``[batch_offset, batch_offset + b)`` of a global batch
        of ``global_batch`` (a data-parallel rank's): the prefix draw is made
        at the global size and sliced, and the loss, a mean over the batch
        of per-sample terms (the pooling is per sample), is this rank's
        term of the global mean, ``b / global_batch`` of its own mean: the
        terms sum over the ranks to the global loss with no collective."""
        device = self.device
        x = as_mel(self.mel_spec, x.to(device), self.num_channels)
        batch, seq_len = x.shape[0], x.shape[1]
        x = self.proj_in(x)
        if self.has_freq_axis:                       # (b, f, n, dim)
            x = x.reshape(batch, seq_len, self.num_freq_tokens, self.dim).transpose(1, 2)

        text = tokenize_batch(self.tokenizer, text, batch, device)
        text_embed = self.embed_text(text, seq_len) if exists(text) else None

        if not exists(lens):
            lens = torch.full((batch,), seq_len, dtype=torch.long, device=device)
        lens = lens.to(device)
        mask = lens_to_mask(lens, length=seq_len)

        # train on a random prefix: predict the full duration from a truncated view
        total = default(global_batch, batch)
        if not 0 <= batch_offset <= total - batch:
            raise ValueError(f'rows [{batch_offset}, {batch_offset + batch}) are not in a '
                             f'global batch of {total}')
        if return_loss:
            if not exists(rand_frac):
                generator = default(generator, self.generator)
                rand_frac = torch.rand((total,), generator=generator, device=generator.device)
                rand_frac = rand_frac[batch_offset:batch_offset + batch]
            rand_frac = rand_frac.to(device=device, dtype=torch.float32)
            rand_index = (rand_frac * lens.float()).to(lens.dtype)
            seq = torch.arange(seq_len, device=device, dtype=lens.dtype)
            mask = mask & (seq[None, :] < rand_index[:, None])

        embed = self.transformer(x, mask=mask, text_embed=text_embed,
                                 generator=default(generator, self.generator),
                                 batch_offset=batch_offset)
        if self.has_freq_axis:
            embed = embed.mean(dim=1)
        pooled = maybe_masked_mean(embed, mask)
        if not return_loss:
            return self.hl_gauss_layer(pooled)
        loss = self.hl_gauss_layer(pooled, lens.float())
        return loss * (batch / total) if total > batch else loss
