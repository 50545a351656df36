"""E2Trainer — the single-device trainer (counterpart of
e2_tts_tpu/training/trainer.py).

One train step is the JAX package's jitted step, run eagerly: the
flow-matching loss (with the velocity-consistency teacher once the EMA has
ticked, when the model's ``velocity_consistency_weight > 0``), backward
through the port's kernels (K2, K4, K5b, K7 and PyTorch's autograd for the
rest), a global-norm clip with optax's formula, ADOPT with a linear warmup
-> linear decay schedule, then the EMA tick. The text-drop coin is a host
``random.Random(seed)`` draw per step, as in the JAX trainer; every other
draw of a step (span, x0, t, dropout seeds) comes from the trainer's
``torch.Generator``.

Not ported yet (each raises NotImplementedError): training the duration
predictor in the trainer, gradient accumulation, meshes / FSDP / sequence
parallelism, TensorBoard, the profiler hook, data prefetch workers,
checkpoint save and resume.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Callable

import numpy as np
import torch

from e2_tts_tpu_torch.training.adopt import Adopt
from e2_tts_tpu_torch.training.data import iter_batches
from e2_tts_tpu_torch.training.ema import EMA
from e2_tts_tpu_torch.utils.helpers import default, exists

logger = logging.getLogger('e2_tts_tpu_torch')


def _linear_schedule(init_value: float, end_value: float,
                     transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``transition_steps``, held
    at init when ``transition_steps <= 0``."""
    def schedule(step: int) -> float:
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def linear_warmup_decay_schedule(peak_lr: float, num_warmup_steps: int,
                                 total_steps: int) -> Callable[[int], float]:
    """Linear 1e-8 -> 1 warmup then linear 1 -> 1e-8 decay of ``peak_lr``
    (the JAX package's optax.join_schedules of two linear schedules)."""
    decay_steps = max(total_steps - num_warmup_steps, 1)
    warmup = _linear_schedule(peak_lr * 1e-8, peak_lr, num_warmup_steps)
    decay = _linear_schedule(peak_lr, peak_lr * 1e-8, decay_steps)
    return lambda step: warmup(step) if step < num_warmup_steps else decay(
        step - num_warmup_steps)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: each grad becomes ``g / norm *
    max_norm`` when the global norm reaches ``max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm; no host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def _not_ported(what: str):
    raise NotImplementedError(f'{what} is not ported to e2_tts_tpu_torch yet')


class E2Trainer:

    def __init__(
        self,
        model,
        optimizer: torch.optim.Optimizer | None = None,
        learning_rate: float = 7.5e-5,
        num_warmup_steps: int = 20_000,
        total_steps: int | None = None,
        grad_accumulation_steps: int = 1,
        duration_predictor=None,
        train_duration_predictor: bool = False,
        checkpoint_path: str | None = None,
        log_file: str | None = None,
        max_grad_norm: float = 1.0,
        sample_rate: int = 24_000,
        tensorboard_log_dir: str = 'runs/e2_tts_experiment',
        mesh=None,
        param_sharding: str = 'replicated',
        sequence_parallel: int = 1,
        ema_kwargs: dict = dict(),
        use_switch_ema: bool = False,
        use_tensorboard: bool = False,
        profile_dir: str | None = None,
        profile_steps: tuple[int, int] = (10, 15),
        dtype=None,
        log_step: int = 10,
        seed: int = 0,
    ):
        """``optimizer``: a ready optimizer over ``model``'s parameters
        (default: `Adopt` on the warmup/decay schedule). ``total_steps``
        fixes the schedule's horizon; None derives it from the dataset at
        `train`. ``dtype`` sets the compute dtype of every submodule
        (parameters stay f32). The trainer runs on the model's device."""
        for flag, what in ((exists(duration_predictor) or train_duration_predictor,
                            'training the duration predictor in E2Trainer'),
                           (grad_accumulation_steps > 1, 'gradient accumulation'),
                           (exists(mesh), 'a device mesh'),
                           (param_sharding != 'replicated', f'param_sharding={param_sharding!r}'),
                           (sequence_parallel > 1, 'sequence parallelism'),
                           (use_tensorboard, 'TensorBoard logging'),
                           (exists(profile_dir), 'the profiler hook (profile_dir)')):
            if flag:
                _not_ported(what)
        if exists(log_file):
            logger.addHandler(logging.FileHandler(log_file))

        if exists(dtype):
            for module in model.modules():
                if 'dtype' in vars(module):
                    module.dtype = dtype

        self.model = model
        self.device = model.device
        self.need_velocity_consistent_loss = model.velocity_consistency_weight > 0.0
        self.ema = EMA(model, **ema_kwargs)
        self.use_switch_ema = use_switch_ema
        self.num_warmup_steps = num_warmup_steps
        self.max_grad_norm = max_grad_norm
        self.target_sample_rate = sample_rate
        self.learning_rate = learning_rate
        self._user_optimizer = optimizer
        self.schedule = None
        self.optimizer = None
        if exists(total_steps):
            self._build_optimizer(total_steps)

        self.checkpoint_path = default(checkpoint_path, 'e2tts_ckpt')
        self.seed = seed
        self.log_step = max(int(log_step), 1)
        self.generator = torch.Generator().manual_seed(seed)

    def _build_optimizer(self, total_steps: int):
        self.schedule = linear_warmup_decay_schedule(
            self.learning_rate, self.num_warmup_steps, total_steps)
        self.optimizer = default(self._user_optimizer,
                                 Adopt(self.model.parameters(), lr=self.schedule))

    # -- one step --------------------------------------------------------------

    def prepare_batch(self, batch: dict):
        """A collated batch (`iter_batches`) -> ``(mel (b, n, d), mel_lens,
        text_ids)`` as `train_step` takes them: text tokenized and padded
        with -1 to a multiple of 32 characters, as the JAX trainer does."""
        model = self.model
        if batch['mel'].shape[1] != model.num_channels:
            raise ValueError(
                f"batch mel has {batch['mel'].shape[1]} channels, model expects "
                f'{model.num_channels}: dataset items must be (channels, frames) '
                'mel spectrograms')
        mel = np.ascontiguousarray(np.moveaxis(batch['mel'], 1, 2))   # b n d
        text_ids = model.tokenizer(batch['text'])
        pad_nt = -(-text_ids.shape[1] // 32) * 32
        text_ids = np.pad(text_ids, ((0, 0), (0, pad_nt - text_ids.shape[1])),
                          constant_values=-1)
        return mel, batch['mel_lengths'], text_ids

    def train_step(self, mel, mel_lens, text_ids, drop_text_cond: bool, *,
                   times=None, noise=None, rand_span_mask=None):
        """One optimizer step on a batch: ``mel (b, n, num_channels)``,
        ``mel_lens (b,)``, ``text_ids (b, nt)`` (-1 padded). Loss, backward,
        clip, ADOPT, EMA tick. ``times``, ``noise`` and ``rand_span_mask``
        replace the step's draws (see `E2TTS.forward`). Returns ``(loss,
        cond, pred_data)``, detached, with no host sync."""
        if not exists(self.optimizer):
            raise RuntimeError('the optimizer is built at train() or from total_steps=')
        model = self.model
        model.train()
        as_tensor = lambda t, dtype: torch.as_tensor(t, dtype=dtype).to(self.device)
        teacher = (self.ema.ema_model
                   if self.need_velocity_consistent_loss and self.ema.initted else None)
        self.optimizer.zero_grad(set_to_none=True)
        out = model(as_tensor(mel, torch.float32), text=as_tensor(text_ids, torch.long),
                    lens=as_tensor(mel_lens, torch.long), times=times, noise=noise,
                    rand_span_mask=rand_span_mask, drop_text_cond=drop_text_cond,
                    velocity_consistency_model=teacher, generator=self.generator)
        out.loss.backward()
        # a parameter the step did not reach (the text stream when the text is
        # dropped) has a zero grad, as in JAX: ADOPT still decays its moments
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in params], self.max_grad_norm)
        self.optimizer.step()
        self.ema.update(model)
        return out.loss.detach(), out.cond, out.pred_data.detach()

    # -- train loop --------------------------------------------------------------

    def load_checkpoint(self):
        """(start step, saved state): a run starts at step 0 when there is no
        checkpoint; resuming from one is not ported yet."""
        if os.path.exists(self.checkpoint_path):
            _not_ported(f'resuming from the checkpoint at {self.checkpoint_path!r}')
        return 0, None

    def train(self, train_dataset, epochs: int, batch_size: int, num_workers: int = 0,
              save_step: int = 1000, frame_bucket: int = 64) -> list[tuple[int, float]]:
        """Train over ``train_dataset`` (items ``dict(mel_spec=(d, n),
        text=str)``) for ``epochs``; logs the loss every ``log_step`` steps
        and returns ``[(step, loss), ...]``. A run that would reach
        ``save_step`` raises before it starts: checkpoints are not ported
        yet."""
        if num_workers > 0:
            _not_ported('prefetch workers (num_workers > 0)')
        model = self.model
        rng = random.Random(self.seed)
        steps_per_epoch = len(train_dataset) // batch_size
        if steps_per_epoch * epochs >= save_step:
            _not_ported(f'checkpoint saving (this run reaches save_step={save_step})')
        if not exists(self.optimizer):
            self._build_optimizer(max(max(steps_per_epoch, 1) * epochs,
                                      self.num_warmup_steps + 1))
        global_step, _ = self.load_checkpoint()

        history = []
        for epoch in range(epochs):
            model.train()
            pending = []

            def flush():
                for step, loss in pending:
                    loss = float(loss)
                    logger.info(f'step {step + 1}: loss = {loss:.4f}')
                    history.append((step, loss))
                pending.clear()

            for batch in iter_batches(train_dataset, batch_size, shuffle=True,
                                      seed=self.seed + epoch, frame_bucket=frame_bucket):
                drop_text_cond = rng.random() < model.cond_drop_prob
                loss, _, _ = self.train_step(*self.prepare_batch(batch), drop_text_cond)
                pending.append((global_step, loss))
                global_step += 1
                if len(pending) >= self.log_step:
                    flush()
            flush()
            epoch_losses = [loss for step, loss in history[-steps_per_epoch:]]
            if epoch_losses:
                logger.info(f'epoch {epoch + 1}/{epochs} - average loss = '
                            f'{sum(epoch_losses) / len(epoch_losses):.4f}')

        if self.use_switch_ema:
            self.ema.update_model_with_ema(model)
        return history
