"""Ranger (RAdam + Lookahead) as a ``torch.optim.Optimizer`` (the port of
the JAX package's ``train/ranger.py``).

Update math follows the published Ranger optimizer the reference vendors
(functions_ae/ranger_optimizer.py:27-169): RAdam variance rectification with
SMA threshold (default 5), decoupled weight decay ``p -= wd * lr * p``
applied before the step, and integrated Lookahead every k=6 steps with
slow-weight interpolation alpha=0.5.  The step-dependent scalars (the SMA
chain) are computed in float32 through ``expm1``, as the JAX package
computes them, each step.  The learning rate is read from the param group
at every step, so a schedule can set it per step.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Ranger", "sma_step_size"]


def sma_step_size(step: int, beta1: float, beta2: float, n_sma_threshold: float):
    """(rectified, step_size) at ``step`` (1-based), in float32: 1 - beta^t
    through expm1, which avoids float32 cancellation in the SMA chain."""
    f32 = np.float32
    step_f = f32(step)
    one_minus_beta2_t = -np.expm1(step_f * np.log(f32(beta2)))
    beta2_t = f32(1.0) - one_minus_beta2_t
    n_sma_max = f32(2.0 / (1 - beta2) - 1.0)
    n_sma = n_sma_max - f32(2.0) * step_f * beta2_t / one_minus_beta2_t
    rectified = bool(n_sma > n_sma_threshold)
    bias1 = -np.expm1(step_f * np.log(f32(beta1)))
    if not rectified:
        return False, f32(1.0) / bias1
    rect_term = np.sqrt(
        (f32(1.0) - beta2_t) * (n_sma - f32(4.0)) / (n_sma_max - f32(4.0))
        * (n_sma - f32(2.0)) / n_sma * n_sma_max / (n_sma_max - f32(2.0))
    )
    return True, rect_term / bias1


class Ranger(torch.optim.Optimizer):
    def __init__(self, params, lr: float, betas=(0.95, 0.999), eps: float = 1e-5, weight_decay: float = 0.0,
                 n_sma_threshold: int = 5, k: int = 6, alpha: float = 0.5):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        n_sma_threshold=n_sma_threshold, k=k, alpha=alpha)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            beta1, beta2 = group["betas"]
            lr = np.float32(group["lr"])
            wd_lr = float(np.float32(group["weight_decay"]) * lr)
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                    state["slow"] = p.detach().clone()
                state["step"] += 1
                step = state["step"]
                m, v, slow = state["exp_avg"], state["exp_avg_sq"], state["slow"]
                m.mul_(beta1).add_(g, alpha=1 - beta1)
                v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
                rectified, step_size = sma_step_size(step, beta1, beta2, group["n_sma_threshold"])
                if group["weight_decay"] != 0:
                    p.sub_(p * wd_lr)
                scaled = -float(step_size * lr)
                if rectified:
                    p.addcdiv_(m, v.sqrt().add_(group["eps"]), value=scaled)
                else:
                    p.add_(m, alpha=scaled)
                if step % group["k"] == 0:
                    slow.add_(p - slow, alpha=group["alpha"])
                    p.copy_(slow)
        return loss
