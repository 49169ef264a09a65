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

from typing import Dict, List, Optional, Tuple

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
    ``adam.moments`` and ``adam.update``.

    ``step`` passes the per-step scalars (the bias corrections and -lr) to
    its ops as host numbers.  ``load_step`` and ``apply_loaded`` split the
    same step in two for a captured CUDA graph: the first counts the step
    on the host and writes each group's per-step scalars, computed as
    ``step`` computes them, into device tensors of its own; the second is
    the step's device work, reading them there, so that one capture of it
    serves every step.  Both give ``step``'s results bit for bit."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self._loaded: Dict[int, Dict[str, torch.Tensor]] = {}  # group index -> its per-step scalars on the device

    def _count(self, group) -> Optional[Dict[str, float]]:
        """Counts a step in the state of each of ``group``'s parameters that
        has a gradient (the state made at the first) and returns the group's
        per-step scalars, in float32 as optax computes them; None where no
        parameter has a gradient."""
        gps = [p for p in group["params"] if p.grad is not None]
        if not gps:
            return None
        for p in gps:
            state = self.state[p]
            if not state:
                state["step"] = 0
                state["mu"] = torch.zeros_like(p)
                state["nu"] = torch.zeros_like(p)
            state["step"] += 1
        b1, b2 = group["betas"]
        t = np.float32(self.state[gps[0]]["step"])
        return dict(bias1=float(np.float32(1) - np.float32(b1) ** t), bias2=float(np.float32(1) - np.float32(b2) ** t),
                    neg_lr=-float(np.float32(group["lr"])))

    @staticmethod
    def _grads(group) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """``group``'s parameters that have a gradient, and their gradients
        with the coupled weight decay folded in."""
        gps = [p for p in group["params"] if p.grad is not None]
        ggs = [p.grad for p in gps]
        if gps and group["weight_decay"]:
            ggs = torch._foreach_add(ggs, torch._foreach_mul(gps, group["weight_decay"]))
        return gps, ggs

    @staticmethod
    def _constants(group) -> Dict[str, float]:
        b1, b2 = group["betas"]
        return dict(c1=1 - b1, b1=b1, c2=1 - b2, b2=b2, eps=group["eps"])

    def _update(self, ps, gs, sc) -> None:
        """The moments and the parameters of ``ps`` from their gradients
        ``gs``; ``sc`` holds each scalar as one number a tensor, or the
        per-step ones as one device tensor for them all."""
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

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        ps, gs, sc = [], [], {k: [] for k in ("c1", "b1", "c2", "b2", "eps", "bias1", "bias2", "neg_lr")}
        for group in self.param_groups:
            gps, ggs = self._grads(group)
            values = self._count(group)
            if values is None:
                continue
            for k, v in {**self._constants(group), **values}.items():
                sc[k] += [v] * len(gps)
            ps += gps
            gs += ggs
        if ps:
            self._update(ps, gs, sc)
        return loss

    @torch.no_grad()
    def load_step(self) -> None:
        """The host half of a step: counts it, as ``step`` does, and writes
        each group's bias corrections and -lr into its device tensors (made
        at the first call) with ``fill_``, whose kernels carry the values,
        so no host buffer is read later."""
        for i, group in enumerate(self.param_groups):
            values = self._count(group)
            if values is None:
                continue
            loaded = self._loaded.get(i)
            if loaded is None:
                p = group["params"][0]
                loaded = self._loaded[i] = {k: torch.zeros((), dtype=p.dtype, device=p.device) for k in values}
            for k, v in values.items():
                loaded[k].fill_(v)

    @torch.no_grad()
    def apply_loaded(self) -> None:
        """The device half of a step: ``step``'s update of each group with
        the per-step scalars that ``load_step`` wrote, read on the device."""
        for i, group in enumerate(self.param_groups):
            gps, ggs = self._grads(group)
            if gps:
                constants = {k: [v] * len(gps) for k, v in self._constants(group).items()}
                self._update(gps, ggs, {**constants, **self._loaded[i]})


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
