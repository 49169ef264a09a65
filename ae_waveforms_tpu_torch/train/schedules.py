"""Learning-rate schedules (the port of the JAX package's
``train/schedules.py``; reference: run_train.py:147-180, :233-248).

Each is a ``step -> lr`` function computed in float32 as the JAX package
computes it inside its train step (the step an integer, the result a 0-d
float32 tensor), except StepLR, whose step() in the reference fires only on
validation-plateau events (run_train.py:343-348): that event counter lives
in the train loop and is passed in here.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["step_lr", "cosine_annealing_warm_restarts", "cosine_annealing_warmup_hard_restarts"]


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine, rounded once from float64: torch's own float32 cos is
    off by one unit in the last place about four times as often as XLA's,
    and a unit near the schedule's floor is several 1e-7 of the rate."""
    return torch.cos(x.double()).float()


def step_lr(base_lr: float, gamma: float = 0.5) -> Callable:
    """lr after n plateau-triggered scheduler events.  With the reference
    default ``lr_scheduler_val_delay=0`` no event ever fires, so the LR stays
    constant — a quirk of the upstream defaults that we keep."""

    def lr(n_events):
        return base_lr * gamma**n_events

    return lr


def cosine_annealing_warm_restarts(base_lr: float, t_0: int, eta_min: float = 1e-4) -> Callable:
    """torch CosineAnnealingWarmRestarts with T_mult=1, stepped per batch."""

    def lr(step):
        t_cur = torch.as_tensor(step) % t_0
        return eta_min + (base_lr - eta_min) * (1 + _cos(torch.pi * t_cur / t_0)) / 2

    return lr


def cosine_annealing_warmup_hard_restarts(
    base_lr: float, t_0: int, num_warmup_steps: int, min_lr: float
) -> Callable:
    """Linear warmup then hard-restart cosine; lambda == 1 exactly at each
    restart boundary (run_train.py:175-176)."""
    min_lambda = min_lr / base_lr

    def lr(step):
        step = torch.as_tensor(step)
        warm = step / max(1, num_warmup_steps)
        t_cur = (step - num_warmup_steps) % t_0
        cos_val = min_lambda + 0.5 * (1.0 - min_lambda) * (1.0 + _cos(t_cur / t_0 * math.pi))
        lam = torch.where(step < num_warmup_steps, warm, torch.where(t_cur == 0, 1.0, cos_val))
        return base_lr * lam

    return lr
