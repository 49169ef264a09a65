"""Primitive layers with the JAX package's semantics, on tensors.

LSTM: gate order (i, f, g, o), both b_ih and b_hh biases, h = o * tanh(c),
zero initial state, uniform(-1/sqrt(H), 1/sqrt(H)) init — the semantics of
``torch.nn.LSTM``.  Parameters are dicts with the JAX package's names
(``w_ih`` (4H, in), ``w_hh`` (4H, H), ``b_ih``, ``b_hh``; ``w``, ``b`` for
a linear layer), in torch's layouts.  These functions are the plain
versions the kernels and modules are held against.

Conv1d weights are (out, in, K) and ConvTranspose1d weights (in, out, K),
torch's layouts and the JAX package's, so weights map by name.  Both draw
uniform(+-1/sqrt(in_ch * K)), the JAX package's bound: for a transposed
conv torch's own init would fan on out_ch * K instead.

Dropout is inverted dropout as in the JAX package: keep with probability
1 - rate, scale kept values by 1/(1 - rate).  Its mask is drawn from an
explicit ``torch.Generator`` on the tensor's device, never the global one,
and its forward is marked "dropout" for ``torch.profiler``, as the linear
upsample's is marked "upsample".
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ae_waveforms_tpu_torch.train.profiling import span

__all__ = [
    "lstm_init", "lstm_cell", "lstm_apply", "lstm_forward", "linear_init", "linear_apply", "conv1d_init",
    "conv1d_apply", "conv1d_transpose_apply", "avg_pool1d", "upsample_linear", "copy_tree_", "dropout",
]

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


def lstm_forward(lstm: torch.nn.LSTM, x: torch.Tensor):
    """``lstm(x)`` of a one-layer, batch-first ``nn.LSTM``: (outputs, (h,
    c)), its weights read from the module's attributes as they stand.
    Under ``torch.func.functional_call`` those are the tensors swapped in,
    which ``nn.LSTM.forward`` would first copy into a flat buffer of its own
    (``flatten_parameters``) on every call; here they go to the LSTM as they
    are (on the card, in place where they are one flat buffer in cuDNN's
    order, as the module's own parameters are after ``.to``)."""
    weights = [getattr(lstm, name) for name in lstm._flat_weights_names]
    h0 = x.new_zeros((1, x.shape[0], lstm.hidden_size))
    out, h, c = torch.lstm(x, (h0, h0), weights, lstm.bias, 1, 0.0, lstm.training, False, True)
    return out, (h, c)


def linear_init(generator: torch.Generator, in_features: int, out_features: int) -> Params:
    """torch's uniform(+-1/sqrt(in)) Linear init, drawn from ``generator``."""
    k = 1.0 / math.sqrt(in_features)
    return {
        "w": _uniform(generator, (out_features, in_features), k),
        "b": _uniform(generator, (out_features,), k),
    }


def linear_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].T + params["b"]


def conv1d_init(generator: torch.Generator, in_ch: int, out_ch: int, kernel: int, transpose: bool = False) -> Params:
    """uniform(+-1/sqrt(in_ch * kernel)) for ``w`` then ``b``, drawn from
    ``generator``; ``w`` is (out, in, K), or (in, out, K) for a transposed
    conv (CPU float32 tensors)."""
    k = 1.0 / math.sqrt(in_ch * kernel)
    shape = (in_ch, out_ch, kernel) if transpose else (out_ch, in_ch, kernel)
    return {"w": _uniform(generator, shape, k), "b": _uniform(generator, (out_ch,), k)}


def conv1d_apply(params: Params, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x (B, C, L) -> torch Conv1d."""
    return F.conv1d(x, params["w"], params["b"], stride=stride, padding=padding)


def conv1d_transpose_apply(params: Params, x: torch.Tensor, stride: int = 2, padding: int = 1,
                           output_padding: int = 1) -> torch.Tensor:
    """x (B, C, L) -> torch ConvTranspose1d: L_out = (L-1)*s - 2p + K + op."""
    return F.conv_transpose1d(x, params["w"], params["b"], stride=stride, padding=padding,
                              output_padding=output_padding)


def avg_pool1d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """torch AvgPool1d: no padding, the length floor-divided."""
    return F.avg_pool1d(x, window, stride)


@functools.lru_cache(maxsize=32)
def _linear_taps(length: int, size: int, device: torch.device):
    """The two input taps of each of ``size`` outputs resized from
    ``length`` inputs at half-pixel centres, and their weights, in float32
    as torch's ``F.interpolate(mode="linear")`` computes them (the source
    position clamped at 0)."""
    scale = torch.tensor(length / size, dtype=torch.float32)
    src = ((torch.arange(size, dtype=torch.float32) + 0.5) * scale - 0.5).clamp_min(0.0)
    lo = src.floor().to(torch.int64).clamp(max=length - 1)
    hi = (lo + 1).clamp(max=length - 1)
    w_hi = src - lo
    return lo.to(device), hi.to(device), (1.0 - w_hi).to(device), w_hi.to(device)


def upsample_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Half-pixel linear resize of the last axis of (B, C, L) up to
    ``size``: ``jax.image.resize(method="linear")``, which antialiases only
    when it shrinks, and every resize of the conv decoder grows.  Written
    as two gathers and a weighted sum: on the card, torch's own linear
    resize spreads only the output positions over threads, which at the
    decoder's 3 to 160 positions serialises the batch and channels."""
    if size < x.shape[-1]:
        raise ValueError(f"upsample_linear grows a length; {x.shape[-1]} -> {size} would shrink it")
    lo, hi, w_lo, w_hi = _linear_taps(x.shape[-1], size, x.device)
    with span("upsample"):
        return x.index_select(-1, lo) * w_lo + x.index_select(-1, hi) * w_hi


@torch.no_grad()
def copy_tree_(params: Dict[str, Params], tree) -> None:
    """Copy a JAX-named parameter tree (arrays or tensors) into ``params``,
    a model's tree of its own parameters under the same names."""
    for name, layer in params.items():
        for k, p in layer.items():
            v = tree[name][k]
            v = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{name}.{k}: expected shape {tuple(p.shape)}, got {tuple(v.shape)}")
            p.copy_(v)


@dataclass(frozen=True)
class RowShard:
    """A generator for a block of a batch's rows: ``dropout`` draws its
    uniforms for the whole batch of ``batch`` rows and keeps ``rows``, so a
    batch split over several devices drops what it would drop whole."""

    generator: torch.Generator
    batch: int
    rows: slice


def dropout(x: torch.Tensor, rate: float, generator, train: bool) -> torch.Tensor:
    """x unchanged in eval or at rate 0; else each value kept with
    probability 1 - rate (a uniform draw below it) and scaled by
    1/(1 - rate), the rest 0.  ``generator``: a ``torch.Generator`` on the
    tensor's device, or a ``RowShard`` of one when x holds a block of the
    batch's rows."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on the tensor's device")
    with span("dropout"):
        if isinstance(generator, RowShard):
            u = torch.rand((generator.batch, *x.shape[1:]), generator=generator.generator,
                           device=x.device)[generator.rows]
        else:
            u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)
