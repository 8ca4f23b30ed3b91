"""Optimizer and learning-rate schedule of the train step.

PyTorch counterpart of `madeleine_tpu/train/optim.py:26-63` (ref:
setup_components.py:194-209 + trainer.py:128-131): AdamW (b1 0.9, b2 0.999,
eps 1e-8, the configured weight decay) with a per-step learning rate of the
reference's shape:

  warmup on:  linear ramp from 1e-5 * lr to lr over warmup_epochs epochs,
              lr flat for one more epoch, then cosine to end_learning_rate
              over (max_epochs - warmup_epochs) epochs;
  warmup off: cosine from lr to end_learning_rate over max_epochs epochs.

The schedule counts optimizer updates: a skipped step does not advance it.

`GatedAdamW` decides on the device whether an update applies, as the JAX
package's `lax.cond` does (madeleine_tpu/train/trainer.py:237-248): the train
step hands it a device bool and the host never reads it. Its state exists
from the start (zero moments, a count of 0, as `optax.adamw`'s init makes
them); the count is a device integer, and the schedule is evaluated from it
on the device in float64 (`LrSchedule.on_device`). Every parameter, both
moments and the count take `torch.where(ok, new, old)`: a select, never a
product with the flag, since a non-finite loss gives NaN gradients and
NaN * 0 is NaN. The arithmetic is torch.optim.AdamW's single-tensor path
(decoupled decay p *= 1 - lr wd, bias corrections, eps outside the square
root; the update p + (-lr / bc1) m / denom), with each scalar rounded from
float64 to float32 as that path rounds its Python scalars.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import torch

from madeleine_torch.config import MadeleineConfig

WARMUP_START_FACTOR = 1e-5  # ref: setup_components.py:205


class LrSchedule:
    """step -> learning rate, the shape of optax.join_schedules([warmup,
    flat, cosine]) in the JAX package (optax.cosine_decay_schedule: init *
    ((1 - alpha) * cos_decay + alpha)). Called with an int it gives a Python
    float; `on_device` gives the same value in float64 from a device count,
    with the same operations in the same order."""

    def __init__(self, cfg: MadeleineConfig, steps_per_epoch: int):
        self.lr = cfg.lr
        self.alpha = cfg.end_learning_rate / cfg.lr
        self.warmup = bool(cfg.warmup)
        if self.warmup:
            self.warmup_steps = max(1, cfg.warmup_epochs * steps_per_epoch)
            self.flat_end = (cfg.warmup_epochs + 1) * steps_per_epoch
            self.cos_steps = max(1, (cfg.max_epochs - cfg.warmup_epochs) * steps_per_epoch)
        else:
            self.warmup_steps = self.flat_end = 0
            self.cos_steps = max(1, cfg.max_epochs * steps_per_epoch)
        self.start = cfg.lr * WARMUP_START_FACTOR

    def _cosine(self, count: int) -> float:
        frac = min(count, self.cos_steps) / self.cos_steps
        return self.lr * ((1.0 - self.alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                          + self.alpha)

    def __call__(self, count: int) -> float:
        if not self.warmup:
            return self._cosine(count)
        if count < self.warmup_steps:
            return (self.start + (self.lr - self.start) * min(count, self.warmup_steps)
                    / self.warmup_steps)
        if count < self.flat_end:
            return self.lr
        return self._cosine(count - self.flat_end)

    def _cosine_t(self, c: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(c, max=self.cos_steps) / self.cos_steps
        return self.lr * ((1.0 - self.alpha) * 0.5 * (1.0 + torch.cos(math.pi * frac))
                          + self.alpha)

    def on_device(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate at `count` (an integer tensor), float64 on its device."""
        c = count.to(torch.float64)
        if not self.warmup:
            return self._cosine_t(c)
        ramp = (self.start + (self.lr - self.start) * torch.clamp(c, max=self.warmup_steps)
                / self.warmup_steps)
        flat = torch.full_like(c, self.lr)
        return torch.where(c < self.warmup_steps, ramp,
                           torch.where(c < self.flat_end, flat,
                                       self._cosine_t(c - self.flat_end)))


def make_lr_schedule(cfg: MadeleineConfig, steps_per_epoch: int) -> LrSchedule:
    return LrSchedule(cfg, steps_per_epoch)


class GatedAdamW(torch.optim.AdamW):
    """AdamW whose update applies only where a device flag holds (see the
    module docstring). `count` is the number of updates applied, an int64
    on the parameters' device. `step(ok=flag)` returns the learning rate it
    used (float64, on the device). The state dict has torch.optim.AdamW's
    layout, each parameter's ``step`` the count as a float32 CPU tensor, so
    a checkpoint of either optimizer loads into the other."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: LrSchedule, *,
                 betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, lr=schedule(0), betas=betas, eps=eps,
                         weight_decay=weight_decay, foreach=False)
        self.schedule = schedule
        first = self.param_groups[0]["params"][0]
        self.count = torch.zeros((), dtype=torch.int64, device=first.device)
        self._init_missing_state()

    def _init_missing_state(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st.pop("step", None)
                if "exp_avg" not in st:
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @torch.no_grad()
    def step(self, closure=None, ok: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update of every parameter with a gradient, kept where `ok`
        (a bool tensor on the device; None: always). Reads nothing back."""
        if closure is not None:
            raise ValueError("GatedAdamW takes no closure")
        count = self.count
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=count.device)
        lr = self.schedule.on_device(count)
        step = (count + 1).to(torch.float64)
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            beta1, beta2 = group["betas"]
            grads = [p.grad for p in ps]
            ms = [self.state[p]["exp_avg"] for p in ps]
            vs = [self.state[p]["exp_avg_sq"] for p in ps]
            decay = (1 - lr * group["weight_decay"]).float()
            step_size = (-(lr / (1 - torch.pow(beta1, step)))).float()
            bc2_sqrt = torch.pow(1 - torch.pow(beta2, step), 0.5).float()
            new_p = torch._foreach_mul(ps, decay)
            new_m = torch._foreach_lerp(ms, grads, 1 - beta1)
            new_v = torch._foreach_mul(vs, beta2)
            torch._foreach_addcmul_(new_v, grads, grads, value=1 - beta2)
            denom = torch._foreach_sqrt(new_v)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_mul(new_m, step_size)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(new_p, upd)
            for old, new in zip(ps + ms + vs, new_p + new_m + new_v):
                old.copy_(torch.where(ok, new, old))
        count.copy_(torch.where(ok, count + 1, count))
        return lr

    def state_dict(self):
        sd = super().state_dict()
        step = self.count.detach().to("cpu", torch.float32)   # a host read: checkpoints only
        sd["state"] = {i: dict(s, step=step.clone()) for i, s in sd["state"].items()}
        return sd

    def load_state_dict(self, state_dict) -> None:
        """Loads this class's state dicts and torch.optim.AdamW's (every
        parameter's ``step`` is the count of applied updates)."""
        super().load_state_dict(state_dict)
        steps = [s["step"] for s in self.state.values() if "step" in s]
        self.count.fill_(int(steps[0]) if steps else 0)
        self._init_missing_state()


def make_optimizer(cfg: MadeleineConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int) -> Tuple[GatedAdamW, LrSchedule]:
    """AdamW over the f32 master parameters, and the schedule it evaluates
    on the device at each update (AdamW scales the decay by the lr, as
    optax.adamw does)."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    opt = GatedAdamW(params, schedule, betas=(0.9, 0.999), eps=1e-8,
                     weight_decay=cfg.weight_decay)
    return opt, schedule
