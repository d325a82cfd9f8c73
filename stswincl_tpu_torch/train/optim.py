"""Optimizers and per-step LR schedules of the supervised stages.

Counterpart of `stswincl_tpu/train/optim.py` on `torch.optim`:

  * stage 1: constant-LR Adam 3e-4 (b1 0.9, b2 0.999, eps 1e-8), no
    weight decay (`make_adam`);
  * stage 3: SGD with momentum, weight decay folded into the gradient
    before the momentum buffer (torch's SGD and the JAX chain
    `add_decayed_weights` -> `sgd` agree), and the classifier as its own
    param group whose LR is scaled by `head_lr_mult` (`make_sgd`).

A schedule is a function step -> LR; `apply_schedule` writes
`schedule(step) * group["lr_mult"]` into every param group before the
optimizer's step, as optax evaluates its schedule at the update count.
LARS (stage 2) is not here yet.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn

Schedule = Callable[[int], float]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, warmup_multiplier: float = 100.0,
                           eta_min: float = 1e-6) -> Schedule:
    """Linear warmup from base / multiplier to base over `warmup_steps`,
    then cosine annealing to `eta_min` (GradualWarmupScheduler +
    CosineAnnealingLR)."""

    def schedule(step: int) -> float:
        if step <= warmup_steps:
            return base_lr / warmup_multiplier * (
                (warmup_multiplier - 1.0) * step / max(warmup_steps, 1) + 1.0)
        t = step - warmup_steps
        t_max = max(total_steps - warmup_steps, 1)
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t / t_max))

    return schedule


def poly_schedule(base_lr: float, total_steps: int, power: float = 0.9,
                  warmup_steps: int = 0) -> Schedule:
    """base * (1 - t / total)^power, with an optional linear warmup."""

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * step / warmup_steps
        t = max(step - warmup_steps, 0)
        frac = min(max(1.0 - t / max(total_steps - warmup_steps, 1), 0.0),
                   1.0)
        return base_lr * frac ** power

    return schedule


def step_schedule(base_lr: float, steps_per_epoch: int,
                  lr_step: int) -> Schedule:
    """base * 0.1^(epoch // lr_step)."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return base_lr * 0.1 ** (epoch // lr_step)

    return schedule


def apply_schedule(opt: torch.optim.Optimizer, schedule: Schedule,
                   step: int) -> None:
    lr = schedule(step)
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)


def make_adam(params, lr: float = 3e-4) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_sgd(model: nn.Module, lr: float, momentum: float = 0.9,
             weight_decay: float = 1e-4, head_lr_mult: float = 1.0,
             head_key: str = "classifier") -> torch.optim.SGD:
    """SGD over `model`'s parameters; those under the top-level module
    `head_key` form a second group whose LR is `head_lr_mult` times the
    schedule's."""
    head, rest = [], []
    for name, p in model.named_parameters():
        (head if name.split(".")[0] == head_key else rest).append(p)
    groups = [{"params": rest, "lr_mult": 1.0},
              {"params": head, "lr_mult": head_lr_mult}]
    return torch.optim.SGD([g for g in groups if g["params"]], lr=lr,
                           momentum=momentum, weight_decay=weight_decay)
