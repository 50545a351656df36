"""ADOPT optimizer (counterpart of e2_tts_tpu/training/adopt.py).

ADOPT (arXiv 2411.02853): Adam with the second moment decoupled from the
current gradient, with the atan2 stabilisation (arXiv 2407.05872) in place
of the eps division by default. Per step k (1-based), decay b1 / b2:

    k = 1:  v <- g^2                      (primes the second moment; moves nothing)
    k > 1:  u <- atan2(g, sqrt(v))        (or g / max(sqrt(v), eps))
            m <- b1 m + (1 - b1) u
            v <- b2 v + (1 - b2) g^2      (after u: u sees the previous v)
            p <- p - lr_k m
    and, with weight decay w, p <- p - lr_k w p at every step (the first too),

the JAX package's optax chain ``scale_by_adopt -> add_decayed_weights(-w) ->
scale(lr)``. ``lr`` is a float or a schedule ``step -> lr`` evaluated at the
number of previous steps (optax's ``scale_by_schedule`` count).

Elementwise throughout, so on FSDP-sharded parameters (DTensors) each rank
updates its own shard and the moments' shards beside it, with no
collective; the moments are DTensors placed as their parameters.
"""

from __future__ import annotations

from typing import Callable

import torch

from e2_tts_tpu_torch.parallel.fsdp import local


class Adopt(torch.optim.Optimizer):

    def __init__(self, params, lr: float | Callable[[int], float] = 7.5e-5,
                 betas: tuple[float, float] = (0.9, 0.9999), eps: float = 1e-6,
                 use_atan2: bool = True, weight_decay: float = 0.0):
        defaults = dict(lr=lr, betas=betas, eps=eps, use_atan2=use_atan2,
                        weight_decay=weight_decay)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group['betas']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['step'] = 0
                    state['m'] = torch.zeros_like(p)
                    state['v'] = torch.zeros_like(p)
                state['step'] += 1
                k = state['step']
                lr = group['lr'](k - 1) if callable(group['lr']) else group['lr']
                p, g, m, v = (local(t) for t in (p, p.grad, state['m'], state['v']))
                # the update before the learning rate: -m, or 0 on the first step
                if k == 1:
                    v.copy_(g * g)
                    update = torch.zeros_like(p)
                else:
                    sq = torch.sqrt(torch.clamp(v, min=0.0))
                    u = (torch.atan2(g, sq) if group['use_atan2']
                         else g / torch.clamp(sq, min=group['eps']))
                    m.mul_(b1).add_((1.0 - b1) * u)
                    v.mul_(b2).add_((1.0 - b2) * g * g)
                    update = -m
                if group['weight_decay'] > 0.0:
                    update = update + (-group['weight_decay']) * p
                p.add_(lr * update)
        return loss
