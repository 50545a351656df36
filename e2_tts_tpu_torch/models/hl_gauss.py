"""HL-Gauss regression / classification head (counterpart of
e2_tts_tpu/models/hl_gauss.py; arXiv 2403.03950).

The duration predictor's output head is either a plain regression (Linear
-> softplus, MSE loss; the default) or a histogram-loss classification over
Gaussian-smeared targets (Linear -> logits, smeared cross-entropy; the
prediction is the expectation over the bin centres). One call predicts (no
target) or returns the loss (with a target).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from e2_tts_tpu_torch.models.blocks import Linear
from e2_tts_tpu_torch.utils.helpers import default, exists


class HLGaussLoss(nn.Module):
    """Histogram loss with Gaussian-smeared targets over [min_value,
    max_value]. The bin edges are a non-persistent buffer (f32)."""

    def __init__(self, min_value: float, max_value: float, num_bins: int,
                 sigma: float | None = None):
        super().__init__()
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.num_bins = num_bins
        # default smoothing ratio: sigma / bin width = 2, the paper's advice
        self.sigma = default(sigma, 2.0 * (self.max_value - self.min_value) / num_bins)
        support = np.linspace(self.min_value, self.max_value, num_bins + 1, dtype=np.float32)
        self.register_buffer('support', torch.from_numpy(support), persistent=False)

    @property
    def centers(self) -> torch.Tensor:
        return (self.support[:-1] + self.support[1:]) / 2

    def target_probs(self, target: torch.Tensor) -> torch.Tensor:
        """``(b,) -> (b, num_bins)`` Gaussian-smeared two-hot distribution."""
        z = (self.support[None, :] - target.float()[:, None]) / (2.0 ** 0.5 * self.sigma)
        cdf = 0.5 * (1.0 + torch.erf(z))
        probs = cdf[:, 1:] - cdf[:, :-1]
        total = torch.clamp(cdf[:, -1] - cdf[:, 0], min=1e-12)
        return probs / total[:, None]

    def loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logprobs = F.log_softmax(logits.float(), dim=-1)
        return -(self.target_probs(target) * logprobs).sum(-1).mean()

    def pred(self, logits: torch.Tensor) -> torch.Tensor:
        return (F.softmax(logits.float(), dim=-1) * self.centers[None, :]).sum(-1)


class HLGaussLayer(nn.Module):
    """Regression (``to_pred``: Linear(dim, 1, no bias) ->
    ``regress_activation``, softplus by default, MSE) unless
    ``hl_gauss_loss`` is given and ``use_regression`` is False, then
    classification (``to_logits``: Linear(dim, num_bins))."""

    def __init__(self, dim: int, hl_gauss_loss: dict | None = None,
                 use_regression: bool = True, regress_activation=F.softplus, *, dtype=None,
                 generator=None):
        super().__init__()
        self.use_regression = not (exists(hl_gauss_loss) and not use_regression)
        if self.use_regression:
            self.activation = regress_activation
            self.to_pred = Linear(dim, 1, bias=False, dtype=dtype, generator=generator)
        else:
            self.hl_gauss = HLGaussLoss(**hl_gauss_loss)
            self.to_logits = Linear(dim, self.hl_gauss.num_bins, dtype=dtype,
                                    generator=generator)

    def forward(self, embed: torch.Tensor, target: torch.Tensor | None = None):
        if self.use_regression:
            pred = self.activation(self.to_pred(embed)[..., 0].float())
            if not exists(target):
                return pred
            return torch.mean((pred - target.float()) ** 2)
        logits = self.to_logits(embed)
        if not exists(target):
            return self.hl_gauss.pred(logits)
        return self.hl_gauss.loss(logits, target)
