"""MLP classifier head (the port of the JAX package's ``classify/mlp.py``):
a small dense net (d -> 64 -> 32 -> 1) trained full-batch with Adam on a
BCE with logits, an alternative to the GBT latent classifier.

``fit_mlp_multi`` fits S seeds at once on one shared feature pool with a
row-weight mask a seed: the parameters are (S, ...) tensors, every layer
one batched matmul over the seeds, the S losses summed for one backward
(each seed's gradient is its own loss's) and one Adam update over the
stacked tensors.  ``fit_mlp`` is the same code at S = 1.  Init is
He-normal (normal * sqrt(2 / fan_in), biases 0) from a ``torch.Generator``,
which cannot give ``jax.random``'s numbers; ``init`` injects another
package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ae_waveforms_tpu_torch import resolve_device

__all__ = ["fit_mlp", "fit_mlp_multi", "predict_mlp", "MLPClassifier", "mlp_init"]

Params = List[Dict[str, torch.Tensor]]


def mlp_init(generator: torch.Generator, d_in: int, hidden=(64, 32)) -> Params:
    """He-normal weights (d_in, 64), (64, 32), (32, 1) drawn in that order
    from ``generator``, zero biases (CPU float32)."""
    dims = (d_in, *hidden, 1)
    return [{"w": torch.randn((a, b), generator=generator) * np.float32(np.sqrt(2.0 / a)), "b": torch.zeros(b)}
            for a, b in zip(dims[:-1], dims[1:])]


def _forward(params: Params, X: torch.Tensor) -> torch.Tensor:
    """Logits (..., n) of X (n, d) through (..., a, b) layers."""
    h = X
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"].unsqueeze(-2))
    return (h @ params[-1]["w"] + params[-1]["b"].unsqueeze(-2))[..., 0]


def fit_mlp_multi(X, y, row_weights, generators: Sequence[torch.Generator] = (), steps: int = 300, lr: float = 1e-2,
                  hidden=(64, 32), init: Optional[Sequence[Params]] = None, device=None) -> Params:
    """S fits on the shared rows X (n, d), labels y (n,) and row weights
    (S, n), each from ``generators[s]`` (or ``init[s]``); returns the
    stacked params, (S, ...) tensors on ``device``."""
    device = resolve_device(device)
    X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    W = torch.as_tensor(np.asarray(row_weights, np.float32), device=device)
    trees = init if init is not None else [mlp_init(g, X.shape[1], hidden) for g in generators]
    params = [{k: torch.stack([torch.tensor(np.asarray(t[i][k])) for t in trees]).to(device).requires_grad_()
               for k in ("w", "b")} for i in range(len(trees[0]))]
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    w_sum = W.sum(1).clamp_min(1.0)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        logits = _forward(params, X)  # (S, n)
        bce = logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
        grads = torch.autograd.grad(((bce * W).sum(1) / w_sum).sum(), leaves)
        with torch.no_grad():
            torch._foreach_copy_(m, torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(grads, 1 - b1)))
            torch._foreach_copy_(v, torch._foreach_add(torch._foreach_mul(v, b2),
                                                       torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads)))
            t1 = np.float32(t)
            bc1 = float(np.float32(1) - np.float32(b1) ** t1)
            bc2 = float(np.float32(1) - np.float32(b2) ** t1)
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), eps)
            upd = torch._foreach_div(torch._foreach_div(m, bc1), den)
            torch._foreach_sub_(leaves, torch._foreach_mul(upd, float(np.float32(lr))))
    return [{k: p.detach() for k, p in layer.items()} for layer in params]


def fit_mlp(X, y, row_weight, generator: torch.Generator, steps: int = 300, lr: float = 1e-2, hidden=(64, 32),
            init: Optional[Params] = None, device=None) -> Params:
    """One fit (``fit_mlp_multi`` at S = 1); returns its params, tensors on
    ``device``."""
    out = fit_mlp_multi(X, y, np.asarray(row_weight)[None], [generator], steps=steps, lr=lr, hidden=hidden,
                        init=None if init is None else [init], device=device)
    return [{k: t[0] for k, t in layer.items()} for layer in out]


def predict_mlp(params: Params, X) -> torch.Tensor:
    """Probabilities of X (n, d): (n,) for one fit's params, (S, n) for
    stacked ones."""
    X = torch.as_tensor(np.asarray(X, np.float32), device=params[0]["w"].device)
    with torch.no_grad():
        return torch.sigmoid(_forward(params, X))


class MLPClassifier:
    """sklearn-style wrapper with per-feature standardisation, on
    ``device`` (the first CUDA device unless named)."""

    def __init__(self, steps: int = 300, lr: float = 1e-2, hidden=(64, 32), random_state: int = 0, device=None, **_):
        self.steps, self.lr, self.hidden = int(steps), float(lr), tuple(hidden)
        self.random_state = int(random_state)
        self.device = resolve_device(device)
        self._params = None
        self._mu = self._sd = None

    def fit(self, X: np.ndarray, y: np.ndarray, sample_weight: Optional[np.ndarray] = None):
        X = np.asarray(X, np.float32)
        self._mu = X.mean(axis=0)
        self._sd = X.std(axis=0) + 1e-8
        w = np.ones(len(y), np.float32) if sample_weight is None else np.asarray(sample_weight, np.float32)
        self._params = fit_mlp((X - self._mu) / self._sd, y, w, torch.Generator().manual_seed(self.random_state),
                               steps=self.steps, lr=self.lr, hidden=self.hidden, device=self.device)
        return self

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        p1 = predict_mlp(self._params, (np.asarray(X, np.float32) - self._mu) / self._sd).cpu().numpy()
        return np.stack([1 - p1, p1], axis=1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return (self.predict_proba(X)[:, 1] >= 0.5).astype(int)
