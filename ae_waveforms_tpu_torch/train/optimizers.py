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

from ae_waveforms_tpu_torch.train.profiling import span
from ae_waveforms_tpu_torch.train.ranger import Ranger

__all__ = ["Adam", "Adagrad", "make_optimizer"]


class Adam(torch.optim.Optimizer):
    """optax's ``add_decayed_weights`` -> ``scale_by_adam`` -> learning rate,
    in optax's order of operations, over every group's tensors at once (one
    chain of foreach ops, each group's betas, eps, bias corrections and
    learning rate as per-tensor scalars: the stacked trainers hold one
    group a config).  The moments' update and the parameters' are spans,
    ``adam.moments`` and ``adam.update``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        ps, gs, sc = [], [], {k: [] for k in ("c1", "b1", "c2", "b2", "bias1", "bias2", "eps", "neg_lr")}
        for group in self.param_groups:
            b1, b2 = group["betas"]
            gps = [p for p in group["params"] if p.grad is not None]
            if not gps:
                continue
            ggs = [p.grad for p in gps]
            if group["weight_decay"]:
                ggs = torch._foreach_add(ggs, torch._foreach_mul(gps, group["weight_decay"]))
            for p in gps:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
            t = np.float32(self.state[gps[0]]["step"])
            values = dict(c1=1 - b1, b1=b1, c2=1 - b2, b2=b2, bias1=float(np.float32(1) - np.float32(b1) ** t),
                          bias2=float(np.float32(1) - np.float32(b2) ** t), eps=group["eps"],
                          neg_lr=-float(np.float32(group["lr"])))
            for k, v in values.items():
                sc[k] += [v] * len(gps)
            ps += gps
            gs += ggs
        if not ps:
            return loss
        mu = [self.state[p]["mu"] for p in ps]
        nu = [self.state[p]["nu"] for p in ps]
        with span("adam.moments"):
            torch._foreach_copy_(mu, torch._foreach_add(torch._foreach_mul(gs, sc["c1"]),
                                                        torch._foreach_mul(mu, sc["b1"])))
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_copy_(nu, torch._foreach_add(torch._foreach_mul(g2, sc["c2"]),
                                                        torch._foreach_mul(nu, sc["b2"])))
        with span("adam.update"):
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, sc["bias2"])), sc["eps"])
            updates = torch._foreach_div(torch._foreach_div(mu, sc["bias1"]), denom)
            torch._foreach_add_(ps, torch._foreach_mul(updates, sc["neg_lr"]))
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
