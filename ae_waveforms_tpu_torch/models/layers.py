"""Primitive layers with the JAX package's semantics, on tensors.

LSTM: gate order (i, f, g, o), both b_ih and b_hh biases, h = o * tanh(c),
zero initial state, uniform(-1/sqrt(H), 1/sqrt(H)) init — the semantics of
``torch.nn.LSTM``.  Parameters are dicts with the JAX package's names
(``w_ih`` (4H, in), ``w_hh`` (4H, H), ``b_ih``, ``b_hh``; ``w``, ``b`` for
a linear layer), in torch's layouts.  These functions are the plain
versions the kernels and modules are held against.

Dropout is inverted dropout as in the JAX package: keep with probability
1 - rate, scale kept values by 1/(1 - rate).  Its mask is drawn from an
explicit ``torch.Generator`` on the tensor's device, never the global one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

__all__ = ["lstm_init", "lstm_cell", "lstm_apply", "linear_init", "linear_apply", "dropout"]

Params = Dict[str, torch.Tensor]


def _uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def lstm_init(generator: torch.Generator, input_size: int, hidden_size: int) -> Params:
    """torch's uniform(+-1/sqrt(H)) LSTM init, drawn from ``generator`` in
    the order w_ih, w_hh, b_ih, b_hh (CPU float32 tensors)."""
    k = 1.0 / math.sqrt(hidden_size)
    return {
        "w_ih": _uniform(generator, (4 * hidden_size, input_size), k),
        "w_hh": _uniform(generator, (4 * hidden_size, hidden_size), k),
        "b_ih": _uniform(generator, (4 * hidden_size,), k),
        "b_hh": _uniform(generator, (4 * hidden_size,), k),
    }


def lstm_cell(gates_x, h, c, w_hh_t):
    """One LSTM time step from a pre-projected input (``gates_x`` already
    holds x @ w_ih.T + biases).  torch gate order (i, f, g, o)."""
    gates = gates_x + h @ w_hh_t
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c = f * c + i * g
    return o * torch.tanh(c), c


def lstm_apply(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, in) -> (outputs (B, T, H), last hidden (B, H)), as a time
    loop of ``lstm_cell`` with the input projection hoisted out of it."""
    B, T, _ = x.shape
    H = params["w_hh"].shape[1]
    gates_x = x @ params["w_ih"].T + (params["b_ih"] + params["b_hh"])  # (B, T, 4H)
    w_hh_t = params["w_hh"].T
    h = c = x.new_zeros((B, H))
    hs = []
    for t in range(T):
        h, c = lstm_cell(gates_x[:, t], h, c, w_hh_t)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def linear_init(generator: torch.Generator, in_features: int, out_features: int) -> Params:
    """torch's uniform(+-1/sqrt(in)) Linear init, drawn from ``generator``."""
    k = 1.0 / math.sqrt(in_features)
    return {
        "w": _uniform(generator, (out_features, in_features), k),
        "b": _uniform(generator, (out_features,), k),
    }


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].T + params["b"]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], train: bool) -> torch.Tensor:
    """x unchanged in eval or at rate 0; else each value kept with
    probability 1 - rate (a uniform draw below it) and scaled by
    1/(1 - rate), the rest 0."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on the tensor's device")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
