"""Optimizer and learning-rate schedule of the train step.

PyTorch counterpart of `madeleine_tpu/train/optim.py:26-63` (ref:
setup_components.py:194-209 + trainer.py:128-131): AdamW (b1 0.9, b2 0.999,
eps 1e-8, the configured weight decay) with a per-step learning rate of the
reference's shape, which the train step sets before each update:

  warmup on:  linear ramp from 1e-5 * lr to lr over warmup_epochs epochs,
              lr flat for one more epoch, then cosine to end_learning_rate
              over (max_epochs - warmup_epochs) epochs;
  warmup off: cosine from lr to end_learning_rate over max_epochs epochs.

The schedule counts optimizer updates: a skipped step does not advance it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from madeleine_torch.config import MadeleineConfig

WARMUP_START_FACTOR = 1e-5  # ref: setup_components.py:205

Schedule = Callable[[int], float]


def _cosine(init: float, steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * cos_decay + alpha)."""
    def f(count: int) -> float:
        frac = min(count, steps) / steps
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)
    return f


def make_lr_schedule(cfg: MadeleineConfig, steps_per_epoch: int) -> Schedule:
    """step -> learning rate, the shape of optax.join_schedules([warmup,
    flat, cosine]) in the JAX package."""
    alpha = cfg.end_learning_rate / cfg.lr
    if not cfg.warmup:
        return _cosine(cfg.lr, max(1, cfg.max_epochs * steps_per_epoch), alpha)
    warmup_steps = max(1, cfg.warmup_epochs * steps_per_epoch)
    flat_end = (cfg.warmup_epochs + 1) * steps_per_epoch
    cosine = _cosine(cfg.lr, max(1, (cfg.max_epochs - cfg.warmup_epochs) * steps_per_epoch),
                     alpha)
    start = cfg.lr * WARMUP_START_FACTOR

    def f(count: int) -> float:
        if count < warmup_steps:
            return start + (cfg.lr - start) * min(count, warmup_steps) / warmup_steps
        if count < flat_end:
            return cfg.lr
        return cosine(count - flat_end)
    return f


def make_optimizer(cfg: MadeleineConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int) -> Tuple[torch.optim.AdamW, Schedule]:
    """AdamW over the f32 master parameters, and the schedule that sets its
    learning rate at each update (AdamW scales the decay by the lr, as
    optax.adamw does)."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    return opt, schedule
