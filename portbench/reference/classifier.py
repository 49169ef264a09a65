"""The reference's end-to-end LSTM classifier (``LSTMClassifier``,
functions_dl/model_classes.py:8-32 of Computational-Biology-TUe/ae_waveforms),
its BCE and Adam as main_dl_classify.py trains it, written out in plain
torch operations, with a leading seed axis on every parameter so that the
seeds of a sweep run in one pass (seed s only ever meets its own weights).

The published block: three LSTMs 1 -> 128 -> 64 -> 64 (gates i, f, g, o,
zero initial state), dropout 0.2 after the first two, a softmax over the
time steps of a linear 64 -> 1 score, the pooled sum of the last LSTM's
outputs under those weights, BatchNorm1d(64) (eps 1e-5, momentum 0.1;
train mode normalises by the batch's biased variance and moves the running
variance towards the unbiased one), FC 64 -> 32, ReLU, FC 32 -> 1, sigmoid;
BCE; Adam at torch's defaults, lr 1e-4.

Departures from that description, each the port's (and the JAX
package's), so that the reference computes what the program should:

- a batch's short tail is padded to the full batch with row 0 of the
  training set; the padded rows enter the BatchNorm statistics (the mean,
  the variance and the running update's n) and weigh nothing in the loss,
  the kept rows' summed BCE over their count;
- the probabilities are clipped to [1e-7, 1 - 1e-7] before the logarithms
  (torch's ``BCELoss`` clamps each logarithm at -100 instead);
- Adam in the JAX harness's order: m = b1 m + (1 - b1) g, v = b2 v +
  ((1 - b2) g) g, p - lr (m / c1) / (sqrt(v / c2) + eps), with the bias
  corrections c1, c2 and lr rounded to float32, a step count a seed;
- dropout keeps a value where a float32 uniform draw from the seed's own
  generator lies below 0.8, drawn (B, T, 128) after lstm1, then
  (B, T, 64) after lstm2 (``ae.keep_masks``), and scales it by 1 / 0.8.

Parameters are flat: ``lstm1.w_ih`` ... ``lstm3.b_hh``, ``attn.w``,
``attn.b``, ``fc1.w`` ... ``fc2.b``, ``bn_gamma``, ``bn_beta`` in torch's
layouts, each (S, ...); the BatchNorm state ``bn_mean`` and ``bn_var``
(S, 64).  The dtype is the caller's: float64 for the reference, float32
for the control.  Every function runs with both TF32 flags set to its
``tf32`` argument, False unless the caller asks for the control's TF32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.ae import keep_masks

__all__ = ["LSTMS", "HEAD", "precision", "flatten", "lstm_layer", "lstms", "head", "forward", "bce", "head_grads",
           "Adam", "train_steps", "probabilities", "dropout_shapes", "keep_masks", "roc_auc"]

Flat = Dict[str, torch.Tensor]
LSTMS = ("lstm1", "lstm2", "lstm3")
HEAD = ("attn.w", "attn.b", "bn_gamma", "bn_beta", "fc1.w", "fc1.b", "fc2.w", "fc2.b")  # the parameters after the LSTMs
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
CLIP = 1e-7


@contextlib.contextmanager
def precision(tf32: bool = False):
    """``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` both set to ``tf32`` inside the
    block (False: full float32 products), restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def flatten(tree) -> Dict[str, object]:
    """A JAX-named tree (``{"lstm1": {"w_ih": ...}, ..., "bn_gamma": ...}``)
    as the flat names above."""
    return {f"{k}.{n}" if isinstance(v, dict) else k: leaf
            for k, v in tree.items() for n, leaf in (v.items() if isinstance(v, dict) else [(None, v)])}


def lstm_layer(p: Flat, name: str, x: torch.Tensor) -> torch.Tensor:
    """LSTM ``name`` of each seed on its rows: x (S, B, T, in) -> outputs
    (S, B, T, H)."""
    S, B, T, _ = x.shape
    w_hh = p[f"{name}.w_hh"].mT  # (S, H, 4H)
    gx = x @ p[f"{name}.w_ih"].mT[:, None] + (p[f"{name}.b_ih"] + p[f"{name}.b_hh"])[:, None, None]
    h = c = x.new_zeros((S, B, w_hh.shape[1]))
    outs = []
    for t in range(T):
        i, f, g, o = (gx[:, :, t] + h @ w_hh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=2)


def _dense(p: Flat, name: str, x: torch.Tensor) -> torch.Tensor:
    """x (S, ..., in) @ w.T + b, seed s with its own layer."""
    w, b = p[f"{name}.w"], p[f"{name}.b"]
    return torch.einsum("s...i,soi->s...o", x, w) + b.view(b.shape[0], *[1] * (x.dim() - 2), b.shape[1])


def lstms(params: Flat, x: torch.Tensor, keeps: Optional[Sequence[torch.Tensor]] = None,
          rate: float = 0.0) -> torch.Tensor:
    """x (S, B, T, 1) -> the last LSTM's outputs (S, B, T, 64); dropout
    where ``keeps`` (the two keep masks, (S, B, T, 128) and (S, B, T, 64))
    is given."""
    h = x
    for k, name in enumerate(LSTMS):
        if k and keeps is not None:
            h = torch.where(keeps[k - 1], h / (1.0 - rate), 0.0)
        h = lstm_layer(params, name, h)
    return h


def head(params: Flat, state: Flat, h: torch.Tensor, train: bool, alter=None) -> Tuple[torch.Tensor, Flat]:
    """The last LSTM's outputs h (S, B, T, 64) -> (probabilities (S, B), the
    BatchNorm state after the pass).  ``train``: the batch's statistics,
    the running statistics moved; else the running statistics normalise
    and the state is returned as it was.  ``alter``: a function the pooled
    features (S, B, 64) pass through before the BatchNorm (a planted
    fault), or None."""
    weights = torch.softmax(_dense(params, "attn", h), dim=2)  # (S, B, T, 1)
    pooled = (h * weights).sum(dim=2)  # (S, B, 64)
    if alter is not None:
        pooled = alter(pooled)
    if train:
        n = pooled.shape[1]
        mu = pooled.mean(dim=1)
        var = ((pooled - mu[:, None]) ** 2).mean(dim=1)
        state = {"bn_mean": (1 - BN_MOMENTUM) * state["bn_mean"] + BN_MOMENTUM * mu.detach(),
                 "bn_var": (1 - BN_MOMENTUM) * state["bn_var"] + BN_MOMENTUM * var.detach() * n / (n - 1)}
    else:
        mu, var = state["bn_mean"], state["bn_var"]
    normed = (pooled - mu[:, None]) / torch.sqrt(var[:, None] + BN_EPS) * params["bn_gamma"][:, None] \
        + params["bn_beta"][:, None]
    h = torch.relu(_dense(params, "fc1", normed))
    return torch.sigmoid(_dense(params, "fc2", h))[..., 0], state


def forward(params: Flat, state: Flat, x: torch.Tensor, train: bool, keeps: Optional[Sequence[torch.Tensor]] = None,
            rate: float = 0.0, alter=None, taps: Optional[Flat] = None) -> Tuple[torch.Tensor, Flat]:
    """x (S, B, T, 1) -> (probabilities (S, B), the BatchNorm state after
    the pass): ``lstms``, then ``head``.  ``taps``: a dict that receives the
    last LSTM's outputs (S, B, T, 64) under ``"lstm3"``, or None."""
    h = lstms(params, x, keeps, rate)
    if taps is not None:
        taps["lstm3"] = h.detach()
    return head(params, state, h, train, alter)


def bce(probs: torch.Tensor, y: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each seed's loss (S,): the BCE of the clipped probabilities, summed
    over the rows of weight 1, over their count."""
    p = probs.clamp(CLIP, 1 - CLIP)
    per_row = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    return (per_row * weights).sum(dim=1) / weights.sum(dim=1).clamp_min(1.0)


def head_grads(params: Flat, state: Flat, h: torch.Tensor, y: torch.Tensor, weights: torch.Tensor) -> Flat:
    """The gradients of the head's parameters (``HEAD``) in a train-mode
    step whose last LSTM outputs are ``h`` (S, B, T, 64), whatever computed
    them, on the labels ``y`` and row weights (S, B)."""
    probs, _ = head(params, state, h.detach(), True)
    return dict(zip(HEAD, torch.autograd.grad(bce(probs, y, weights).sum(), [params[k] for k in HEAD])))


class Adam:
    """torch's defaults (betas 0.9, 0.999, eps 1e-8) in the JAX harness's
    order (module docstring), a step count a seed: a step moves only the
    seeds of ``active`` (all where None)."""

    def __init__(self, params: Flat, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = np.zeros(next(iter(params.values())).shape[0], np.int64)

    @torch.no_grad()
    def step(self, params: Flat, grads: Flat, active: Optional[np.ndarray] = None) -> None:
        on = np.ones(len(self.t), bool) if active is None else np.asarray(active, bool)
        self.t += on
        f32 = np.float32
        c1 = np.where(on, f32(1) - f32(self.b1) ** self.t.astype(f32), 1.0)
        c2 = np.where(on, f32(1) - f32(self.b2) ** self.t.astype(f32), 1.0)
        lr = float(f32(self.lr))
        for k, p in params.items():
            shape = (-1,) + (1,) * (p.dim() - 1)
            mask = torch.as_tensor(on, device=p.device).reshape(shape)
            bc1, bc2 = (torch.as_tensor(c, dtype=p.dtype, device=p.device).reshape(shape) for c in (c1, c2))
            g = grads[k]
            m = torch.where(mask, self.b1 * self.m[k] + (1 - self.b1) * g, self.m[k])
            v = torch.where(mask, self.b2 * self.v[k] + ((1 - self.b2) * g) * g, self.v[k])
            self.m[k], self.v[k] = m, v
            p.copy_(torch.where(mask, p - lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps), p))


def train_steps(params: Flat, state: Flat, batches: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                keeps: List[Sequence[torch.Tensor]], rate: float, lr: float, dtype, tf32: bool = False,
                taps: Optional[Flat] = None, upstream: Optional[torch.Tensor] = None,
                lstm3: Optional[torch.Tensor] = None):
    """Steps of the reference trainer from ``params`` and ``state``, each
    on one batch (x (S, B, T, 1), y (S, B), weights (S, B)) with that
    step's keep masks.  Returns each step's losses (steps, S) as float64
    numpy, the first step's gradients, and the parameters and BatchNorm
    state after the last step, in ``dtype``.  ``taps`` receives, of the
    first step: the last LSTM's outputs (``"lstm3"``); with ``upstream``
    (S, B, T, 64), the LSTMs' parameter gradients that the backward of
    this step's LSTMs gives from that gradient at the last LSTM's outputs
    in place of the head's (``"lstm_grads"``); with ``lstm3`` (S, B, T,
    64), the head's parameter gradients from those outputs in place of the
    LSTMs' (``"head_grads"``, ``head_grads``)."""
    with precision(tf32):
        p = {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in params.items()}
        st = {k: v.detach().to(dtype).clone() for k, v in state.items()}
        opt = Adam(p, lr)
        losses, first = [], None
        for (x, y, w), keep in zip(batches, keeps):
            x, y, w = x.to(dtype), y.to(dtype), w.to(dtype)
            h = lstms(p, x, keep, rate)
            if first is None and taps is not None:
                taps["lstm3"] = h.detach()
                if lstm3 is not None:
                    taps["head_grads"] = head_grads(p, st, lstm3.to(dtype), y, w)
                if upstream is not None:
                    leaves = [k for k in p if k.split(".")[0] in LSTMS]
                    taps["lstm_grads"] = dict(zip(leaves, torch.autograd.grad(h, [p[k] for k in leaves],
                                                                              upstream.to(dtype), retain_graph=True)))
            probs, st = head(p, st, h, True)
            loss = bce(probs, y, w)
            grads = dict(zip(p, torch.autograd.grad(loss.sum(), list(p.values()))))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            losses.append(loss.detach().double().cpu().numpy())
            opt.step(p, grads)
    return np.stack(losses), first, {k: v.detach() for k, v in p.items()}, st


@torch.no_grad()
def probabilities(params: Flat, state: Flat, x: torch.Tensor, dtype, block: int = 5, tf32: bool = False,
                  alter=None) -> torch.Tensor:
    """Eval-mode probabilities (S, n) of every seed's model on the same rows
    x (n, T, 1), or each on its own rows x (S, n, T, 1), ``block`` seeds at
    a time; ``alter`` as for ``head``."""
    S = next(iter(params.values())).shape[0]
    out = []
    with precision(tf32):
        for s0 in range(0, S, block):
            sl = slice(s0, min(s0 + block, S))
            p = {k: v[sl].to(dtype) for k, v in params.items()}
            st = {k: v[sl].to(dtype) for k, v in state.items()}
            xs = x[sl].to(dtype) if x.dim() == 4 else x.to(dtype)[None].expand(sl.stop - sl.start, *x.shape)
            out.append(forward(p, st, xs, False, alter=alter)[0])
    return torch.cat(out)


def dropout_shapes(B: int, T: int, hidden=(128, 64)) -> List[Tuple[int, int, int]]:
    """The shapes of one seed's dropout draws in a training step, in order."""
    return [(B, T, hidden[0]), (B, T, hidden[1])]


def roc_auc(y: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC as the Mann-Whitney statistic, tied scores sharing their
    average rank."""
    y = np.asarray(y, np.float64)
    values, inverse, counts = np.unique(np.asarray(scores, np.float64), return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inverse]
    n_pos = y.sum()
    n_neg = len(y) - n_pos
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))
