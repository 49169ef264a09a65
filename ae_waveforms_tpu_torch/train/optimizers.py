"""Optimizer factory (the port of the JAX package's ``train/optimizers.py``;
reference: run_train.py:215-230 selection with torch defaults).

Coupled (torch-style L2) weight decay is folded into the gradient before the
moment updates for adam/sgd/rmsprop/adagrad/adadelta; Ranger uses its own
decoupled rule.  The learning rate is read from the param group at each
step, so the train loop sets it per step (schedules and the StepLR plateau
multiplier).

sgd (trace momentum), rmsprop (eps outside the sqrt) and adadelta are
``torch.optim``'s own, whose math is the JAX package's optax chains'.  Two
are written here with optax's math:

- Adagrad: optax's ``scale_by_rss`` scales by ``rsqrt(s + eps)``, 0 where
  s = 0, where ``torch.optim.Adagrad`` scales by ``1 / (sqrt(s) + eps)``;
- Adam: ``torch.optim.Adam`` folds the bias corrections into the step size
  and the denominator and moves its moments by ``lerp``, which parts from
  optax by about 1e-6 over 20 steps at lr 1e-2; in optax's order (float32
  bias corrections, ``m_hat / (sqrt(v_hat) + eps) * -lr``) it is equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ae_waveforms_tpu_torch.train.ranger import Ranger

__all__ = ["Adam", "Adagrad", "make_optimizer"]


class Adam(torch.optim.Optimizer):
    """optax's ``add_decayed_weights`` -> ``scale_by_adam`` -> learning rate,
    in optax's order of operations, over all of a group's tensors at once."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            gs = [p.grad for p in ps]
            if group["weight_decay"]:
                gs = torch._foreach_add(gs, torch._foreach_mul(ps, group["weight_decay"]))
            for p in ps:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
            mu = [self.state[p]["mu"] for p in ps]
            nu = [self.state[p]["nu"] for p in ps]
            torch._foreach_copy_(mu, torch._foreach_add(torch._foreach_mul(gs, 1 - b1), torch._foreach_mul(mu, b1)))
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_copy_(nu, torch._foreach_add(torch._foreach_mul(g2, 1 - b2), torch._foreach_mul(nu, b2)))
            t = np.float32(self.state[ps[0]]["step"])
            bias1 = float(np.float32(1) - np.float32(b1) ** t)
            bias2 = float(np.float32(1) - np.float32(b2) ** t)
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bias2)), group["eps"])
            updates = torch._foreach_div(torch._foreach_div(mu, bias1), denom)
            torch._foreach_add_(ps, torch._foreach_mul(updates, -float(np.float32(group["lr"]))))
        return loss


class Adagrad(torch.optim.Optimizer):
    """optax's ``add_decayed_weights`` -> ``scale_by_rss`` -> learning rate."""

    def __init__(self, params, lr: float, eps: float = 1e-10, initial_accumulator_value: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps, initial_accumulator_value=initial_accumulator_value,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
                s = state["sum_of_squares"]
                s.add_(g * g)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), 0.0)
                p.add_(scale * g, alpha=-group["lr"])
        return loss


def make_optimizer(name: str, params, learning_rate: float, weight_decay: float = 0.0, **kw) -> torch.optim.Optimizer:
    name = name.lower()
    if name == "adam":
        return Adam(params, lr=learning_rate, weight_decay=weight_decay)
    if name == "adagrad":
        return Adagrad(params, lr=learning_rate, eps=1e-10, weight_decay=weight_decay)
    if name == "adadelta":
        return torch.optim.Adadelta(params, lr=learning_rate, rho=0.9, eps=1e-6, weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=kw.get("momentum", 0.9),
                               weight_decay=weight_decay)
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=learning_rate, alpha=0.99, eps=1e-8, weight_decay=weight_decay)
    if name == "ranger":
        return Ranger(params, lr=learning_rate, betas=(kw.get("ranger_momentum", 0.95), 0.999),
                      weight_decay=weight_decay, n_sma_threshold=kw.get("ranger_threshold", 5))
    raise ValueError(f"unsupported optimizer {name!r}")
