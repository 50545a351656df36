"""Exponential moving average of model weights + Switch-EMA (counterpart of
e2_tts_tpu/training/ema.py, itself the ema-pytorch semantics).

`EMA` holds a full copy of the model in ``eval()`` (the teacher never uses
dropout), which doubles as the velocity-consistency teacher. Per `update`
(one per optimizer step): copy for the first ``update_after_step`` steps,
blend every ``update_every`` calls with the decay ramp ``1 - (1 + epoch /
inv_gamma)^-power`` clamped to ``[min_value, beta]`` and evaluated at the
counter + 1 (ema-pytorch increments before computing it). Only
``nn.Parameter``s are blended; buffers (the fixed RandomFourierEmbed
frequencies) stay as copied. `update_model_with_ema` is Switch-EMA
(arXiv 2402.09240). `state_dict` holds the weights and the counters, as the
JAX EMA's state holds its ``step`` and ``step_initted`` buffers.

Under FSDP the trainer shards the copy as it shards the model, and the
blend acts on each rank's local shards, with no collective.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn

from e2_tts_tpu_torch.parallel.fsdp import load_full_state_dict, local


class EMA:

    def __init__(self, model: nn.Module, beta: float = 0.9999, update_after_step: int = 100,
                 update_every: int = 10, inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
                 min_value: float = 0.0, include_online_model: bool = False):
        self.beta = beta
        self.update_after_step = update_after_step
        self.update_every = update_every
        self.inv_gamma = inv_gamma
        self.power = power
        self.min_value = min_value
        self.ema_model = copy.deepcopy(model).eval()
        self.ema_model.requires_grad_(False)
        self.step = 0
        self.initted = False

    def _decay_at(self, step: int) -> float:
        epoch = max(step - self.update_after_step - 1, 0)
        if epoch <= 0:
            return 0.0
        value = 1.0 - (1.0 + epoch / self.inv_gamma) ** (-self.power)
        return min(max(value, self.min_value), self.beta)

    def current_decay(self) -> float:
        return self._decay_at(self.step)

    @torch.no_grad()
    def update(self, model: nn.Module):
        """One EMA tick (call once per optimizer step)."""
        step = self.step
        if step % self.update_every == 0:
            d = np.float32(0.0 if step <= self.update_after_step else self._decay_at(step + 1))
            # the blend's two weights rounded to f32 as the JAX package's are
            # (1 - d taken in f32, not in double): on a weight of ~10 the
            # other rounding of 1 - d moves the blend by an ulp or two
            d, keep = float(d), float(np.float32(1.0) - d)
            for e, o in zip(self.ema_model.parameters(), model.parameters()):
                e, o = local(e), local(o)
                e.copy_((e.float() * d + o.float() * keep).to(e.dtype))
            self.initted = True
        self.step = step + 1

    def state_dict(self) -> dict:
        """The EMA weights and both counters: the counters are plain
        attributes, so a checkpoint of the weights alone would restart the
        warmup (copies, not blends) and the velocity teacher's gate."""
        return dict(model=self.ema_model.state_dict(), step=self.step, initted=self.initted)

    def load_state_dict(self, state: dict):
        load_full_state_dict(self.ema_model, state['model'])
        self.step = int(state['step'])
        self.initted = bool(state['initted'])

    @torch.no_grad()
    def update_model_with_ema(self, model: nn.Module):
        """Switch-EMA: copy the EMA weights into the online model."""
        for e, o in zip(self.ema_model.parameters(), model.parameters()):
            local(o).copy_(local(e))
