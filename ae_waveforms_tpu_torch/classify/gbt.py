"""Histogram gradient-boosted trees (the port of the JAX package's
``classify/gbt.py``): the fit and the predict half.

An ensemble is stored as the JAX package stores it: per tree, a heap of
split features, split bins and split flags, level d in the static range
[2^d - 1, 2^(d+1) - 1) plus one inert slot, and leaf weights indexed by the
final node id.  Logistic loss, second-order gains with L2 lambda, gamma
pruning, min_child_weight, per-tree row and column subsampling.

The fit grows S fits at once (the JAX package's vmapped fit axis, written
out), level by level.  Each tree starts with one ``tree_grad`` call (the
per-tree kernel K5: masks, g, h, shifts, node ids) and ends with one
``tree_leaves`` call (K6: leaf weights and margins).  Each level makes one
``left_histograms_fixed`` call (the histogram kernel) for all S fits, one
``split_level`` call (the split kernel: sibling subtraction, prefix sums,
gains, argmax and the level's heap slots) and one ``route_rows`` call (the
routing kernel).  ``predict_margin`` routes **all trees through all levels
in one launch** (``route_levels``): the tree axis is the routing kernel's
fit axis.  The tree loop never waits for the device: nothing in it copies
to the host.  Its phases are spans (``train.profiling``): ``gbt.grad`` and
``gbt.leaves`` once a tree, and once a level ``gbt.hist`` and
``gbt.route`` (the kernels' calls, spans of their own) around ``gbt.split``.

Numbers.  The histograms are exact integer sums of g and h in fixed point
(``ops/gbt_hist.py``), so the sibling subtraction, the prefix sums over
bins and the leaf sums are exact integer arithmetic, and a tie between two
bins (an empty bin between them) stays an exact tie.  The sigmoid, the
gains and the leaf weights work in float64 from those integers.  So a fit
on the card is bit-identical from run to run and grows the same trees as
the same fit on the CPU.  Row and column masks come from a counter-based
hash of (seed, tree, index) in integer ops, the same on every device;
``jax.random``'s streams cannot be reproduced, so the parity tests inject
the JAX package's masks through ``row_masks`` and ``col_masks``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.ops.gbt_hist import left_histograms_fixed, pack_bins
from ae_waveforms_tpu_torch.ops.gbt_route import route_levels, route_rows
from ae_waveforms_tpu_torch.ops.gbt_split import split_level
from ae_waveforms_tpu_torch.ops.gbt_tree import subsample_uniforms, tree_grad, tree_leaves
from ae_waveforms_tpu_torch.train.profiling import span

__all__ = [
    "GBTClassifier", "GBTEnsemble", "compute_bin_edges", "bin_data", "fit_gbt", "fit_gbt_multi",
    "fit_gbt_sweep", "fit_gbt_sweep_margins", "predict_margin", "predict_margin_multi",
    "subsample_uniforms",
]

N_BINS = 64
BASE_SCORE = 0.0  # margin of base_score 0.5


class GBTEnsemble(NamedTuple):
    feat: torch.Tensor  # (T, max_nodes) int32 split feature per internal node
    thresh: torch.Tensor  # (T, max_nodes) int32 split bin (go left if bin <= thresh)
    is_split: torch.Tensor  # (T, max_nodes) bool
    leaf: torch.Tensor  # (T, max_nodes) float32 leaf weights indexed by final node id
    lr: torch.Tensor  # scalar float32 learning rate


def compute_bin_edges(X: np.ndarray, n_bins: int = N_BINS) -> np.ndarray:
    """Per-feature quantile bin edges, (F, n_bins - 1)."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)


def bin_data(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, F) float32 -> (n, F) int32 bin ids, per feature the count of
    edges <= x (numpy's ``searchsorted(..., side="right")``)."""
    return torch.searchsorted(edges.contiguous(), X.T.contiguous(), right=True).T.to(torch.int32)


def _fit_batched(bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights,
                 subsamples, colsamples, n_actives, depth_limits, *, max_depth, n_estimators,
                 n_bins, row_masks=None, col_masks=None):
    """S fits on one binned pool, grown together; returns the (S, T, ...)
    ensembles and the (S, n) final margins of every pool row (held-out rows
    route through the trees with zero gradient weight).  Every argument is
    a tensor on one device; the per-fit ones have a leading S axis."""
    n, F = bins.shape
    S = row_weights.shape[0]
    dev = bins.device
    B, D = n_bins, max_depth
    binsT = bins.T.contiguous()
    # the histogram kernel's layout of the pool, made once; the CPU's plain version reads binsT
    packed = pack_bins(binsT, n_bins) if dev.type == "cuda" else None
    margin = torch.full((S, n), BASE_SCORE, dtype=torch.float32, device=dev)
    # static heaps, level d in [2^d-1, 2^(d+1)-1) plus one inert slot, written level by level
    feat = torch.zeros((S, n_estimators, 2**D), dtype=torch.int32, device=dev)
    thresh = torch.zeros_like(feat)
    is_split = torch.zeros_like(feat, dtype=torch.bool)
    leaf = torch.empty((S, n_estimators, 2**D), dtype=torch.float32, device=dev)
    for t in range(n_estimators):
        with span("gbt.grad"):
            g, h, node_of, col, shift = tree_grad(
                margin, y, row_weights, seeds, subsamples, colsamples, tree=t, n_features=F,
                row_mask=None if row_masks is None else row_masks[:, t],
                col_mask=None if col_masks is None else col_masks[:, t])
            heap = (feat[:, t], thresh[:, t], is_split[:, t])

        hist = None
        for depth in range(D):
            n_nodes = 2**depth
            half = max(n_nodes // 2, 1)
            q = left_histograms_fixed(binsT, g, h, node_of, shift, half=half, n_bins=B, packed=packed)
            with span("gbt.split"):
                level = split_level(q, hist, shift, gammas, min_child_weights, col, depth_limits, heap, depth=depth,
                                    n_bins=B, last=depth == D - 1)
                hist = level.hist
            # the level's heap slots are its splits; rows of a node that does not split descend its left spine
            node_of = route_rows(binsT, node_of, *(x[:, n_nodes - 1:2 * n_nodes - 1] for x in heap))

        with span("gbt.leaves"):
            tree_leaves(level.leaf_sums, shift, learning_rates, n_actives, node_of, margin, leaf, tree=t)
    return GBTEnsemble(feat, thresh, is_split, leaf, learning_rates), margin


def _sweep(bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights, subsamples,
           colsamples, n_actives, max_depth, n_estimators, n_bins, depth_limits, row_masks,
           col_masks):
    """Convert the arguments to tensors on ``bins``' device (the first CUDA
    device when ``bins`` is no tensor), per-fit ones broadcast to (S,), and
    run ``_fit_batched``."""
    dev = bins.device if isinstance(bins, torch.Tensor) else resolve_device()
    bins = torch.as_tensor(bins, device=dev).to(torch.int32).contiguous()
    row_weights = torch.as_tensor(row_weights, dtype=torch.float32, device=dev).contiguous()
    S = row_weights.shape[0]
    per_fit = lambda x, dtype: torch.as_tensor(x, dtype=dtype, device=dev).expand(S).contiguous()  # noqa: E731
    if depth_limits is None:
        depth_limits = max_depth
    masks = [None if m is None else torch.as_tensor(m, dtype=torch.bool, device=dev).contiguous()
             for m in (row_masks, col_masks)]
    return _fit_batched(
        bins, torch.as_tensor(y, dtype=torch.float32, device=dev).contiguous(), row_weights,
        per_fit(seeds, torch.int64),
        per_fit(learning_rates, torch.float32), per_fit(gammas, torch.float32),
        per_fit(min_child_weights, torch.float32), per_fit(subsamples, torch.float32),
        per_fit(colsamples, torch.float32), per_fit(n_actives, torch.int64), per_fit(depth_limits, torch.int64),
        max_depth=max_depth, n_estimators=n_estimators, n_bins=n_bins, row_masks=masks[0], col_masks=masks[1],
    )


def _fit_gbt_margins(
    bins, y, row_weight, seed: int,
    max_depth: int = 6,
    n_estimators: int = 100,
    learning_rate: float = 0.3,
    gamma: float = 0.0,
    min_child_weight: float = 1.0,
    subsample: float = 1.0,
    colsample_bytree: float = 1.0,
    n_bins: int = N_BINS,
    n_active=None,
    depth_limit=None,
    *,
    row_masks=None,
    col_masks=None,
):
    """One fit, returning ``(ensemble, final_margin)``: bins (n, F) int32,
    y (n,) in {0, 1}, row_weight (n,) training mask or weights, seed of the
    subsampling masks.  The final margin covers EVERY pool row and equals
    ``predict_margin(ens, bins)``.

    ``n_active`` (defaults to n_estimators) masks trees beyond it to no-ops;
    ``depth_limit`` (defaults to max_depth) masks splits at levels >= limit,
    whose rows descend the left spine, so the fit partitions rows as a
    native depth-limit fit does.  ``row_masks`` (n_estimators, n) and
    ``col_masks`` (n_estimators, F), when given, replace the drawn masks.
    The fit runs on ``bins``' device (the first CUDA device when ``bins`` is
    no tensor)."""
    ens, margins = _sweep(
        bins, y, torch.as_tensor(row_weight)[None], seed, learning_rate, gamma, min_child_weight,
        subsample, colsample_bytree, n_estimators if n_active is None else n_active, max_depth,
        n_estimators, n_bins, depth_limit, None if row_masks is None else torch.as_tensor(row_masks)[None],
        None if col_masks is None else torch.as_tensor(col_masks)[None],
    )
    return GBTEnsemble(*(x[0] for x in ens)), margins[0]


def fit_gbt(bins, y, row_weight, seed: int, max_depth: int = 6, n_estimators: int = 100,
            learning_rate: float = 0.3, gamma: float = 0.0, min_child_weight: float = 1.0,
            subsample: float = 1.0, colsample_bytree: float = 1.0, n_bins: int = N_BINS,
            n_active=None, depth_limit=None) -> GBTEnsemble:
    """See ``_fit_gbt_margins``: the ensemble alone."""
    return _fit_gbt_margins(
        bins, y, row_weight, seed, max_depth, n_estimators, learning_rate, gamma, min_child_weight,
        subsample, colsample_bytree, n_bins, n_active, depth_limit,
    )[0]


def fit_gbt_multi(bins, y, row_weights, seeds, max_depth: int = 6, n_estimators: int = 100,
                  learning_rate: float = 0.3, gamma: float = 0.0, min_child_weight: float = 1.0,
                  subsample: float = 1.0, colsample_bytree: float = 1.0, n_bins: int = N_BINS,
                  *, row_masks=None, col_masks=None) -> GBTEnsemble:
    """All seeds of an evaluation sweep fitted together: one hyperparameter
    set, (S, n) per-seed row masks over the shared binned pool and (S,)
    seeds.  Returns (S, T, ...) ensembles."""
    return _sweep(
        bins, y, row_weights, seeds, learning_rate, gamma, min_child_weight, subsample,
        colsample_bytree, n_estimators, max_depth, n_estimators, n_bins, None, row_masks, col_masks,
    )[0]


def fit_gbt_sweep_margins(bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights,
                          subsamples, colsamples, n_actives, max_depth: int, n_estimators: int,
                          n_bins: int = N_BINS, depth_limits=None, *, row_masks=None,
                          col_masks=None):
    """Hyperparameter-sweep fit: every continuous hyperparameter, the tree
    count (``n_actives``) and the effective depth (``depth_limits``) are
    per-fit (S,) values, so one call fits a whole chunk of candidates x CV
    folds.  Returns the (S, T, ...) ensembles and the (S, n) final pool
    margins (equal to ``predict_margin_multi`` on the same pool)."""
    return _sweep(
        bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights, subsamples,
        colsamples, n_actives, max_depth, n_estimators, n_bins, depth_limits, row_masks, col_masks,
    )


def fit_gbt_sweep(bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights,
                  subsamples, colsamples, n_actives, max_depth: int, n_estimators: int,
                  n_bins: int = N_BINS, depth_limits=None, *, row_masks=None,
                  col_masks=None) -> GBTEnsemble:
    """``fit_gbt_sweep_margins`` without the margins."""
    return fit_gbt_sweep_margins(
        bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights, subsamples,
        colsamples, n_actives, max_depth, n_estimators, n_bins, depth_limits,
        row_masks=row_masks, col_masks=col_masks,
    )[0]


def _route_leaves(ens: GBTEnsemble, bins: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(T, max_nodes) trees x (n, F) bins -> (T, n) leaf weights: every
    level of every tree routed in one call, from the root."""
    node_of = route_levels(bins.T, None, ens.feat, ens.thresh, ens.is_split, 0, max_depth)
    return torch.gather(ens.leaf, 1, node_of.long())


def predict_margin(ens: GBTEnsemble, bins: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(n, F) int32 bins -> (n,) float32 margins of the whole ensemble."""
    return (ens.lr * _route_leaves(ens, bins, max_depth)).sum(dim=0) + BASE_SCORE


def predict_margin_multi(ens: GBTEnsemble, bins: torch.Tensor, max_depth: int) -> torch.Tensor:
    """(S, T, ...) ensembles x shared (n, F) bins -> (S, n) margins; the
    S * T trees are routed together."""
    S, T, M = ens.feat.shape
    flat = GBTEnsemble(*(x.reshape(S * T, M) for x in ens[:4]), lr=None)
    leaf = _route_leaves(flat, bins, max_depth).view(S, T, -1)
    return (ens.lr.view(S, 1, 1) * leaf).sum(dim=1) + BASE_SCORE


class GBTClassifier:
    """sklearn/xgboost-style wrapper; its tensors live on ``device`` (the
    first CUDA device unless named)."""

    def __init__(
        self,
        max_depth: int = 6,
        learning_rate: float = 0.3,
        n_estimators: int = 100,
        gamma: float = 0.0,
        min_child_weight: float = 1.0,
        subsample: float = 1.0,
        colsample_bytree: float = 1.0,
        random_state: int = 0,
        n_bins: int = N_BINS,
        device=None,
        **_ignored,
    ):
        self.params = dict(
            max_depth=int(max_depth),
            learning_rate=float(learning_rate),
            n_estimators=int(n_estimators),
            gamma=float(gamma),
            min_child_weight=float(min_child_weight),
            subsample=float(subsample),
            colsample_bytree=float(colsample_bytree),
        )
        self.random_state = int(random_state)
        self.n_bins = n_bins
        self.device = resolve_device(device)
        self._ens: Optional[GBTEnsemble] = None
        self._edges: Optional[torch.Tensor] = None

    def fit(self, X, y, sample_weight=None) -> "GBTClassifier":
        """Fit on X (n, F) and labels y in {0, 1}; bin edges are the
        training rows' quantiles."""
        X = np.asarray(X, np.float32)
        dev = self.device
        self._edges = torch.as_tensor(compute_bin_edges(X, self.n_bins), device=dev).contiguous()
        bins = bin_data(torch.as_tensor(X, device=dev), self._edges)
        w = np.ones(len(X), np.float32) if sample_weight is None else np.asarray(sample_weight, np.float32)
        p = self.params
        self._ens = fit_gbt(
            bins, np.asarray(y, np.float32), w, self.random_state,
            max_depth=p["max_depth"], n_estimators=p["n_estimators"], learning_rate=p["learning_rate"],
            gamma=p["gamma"], min_child_weight=p["min_child_weight"], subsample=p["subsample"],
            colsample_bytree=p["colsample_bytree"], n_bins=self.n_bins,
        )
        return self

    def load_ensemble(self, ens: GBTEnsemble, edges) -> "GBTClassifier":
        """Install a fitted ensemble and its (F, n_bins - 1) bin edges."""
        T, max_nodes = ens.feat.shape
        if max_nodes != 2 ** self.params["max_depth"]:
            raise ValueError(f"ensemble has {max_nodes} nodes per tree, max_depth {self.params['max_depth']} needs {2 ** self.params['max_depth']}")
        for name in ("thresh", "is_split", "leaf"):
            if tuple(getattr(ens, name).shape) != (T, max_nodes):
                raise ValueError(f"{name}: expected shape {(T, max_nodes)}, got {tuple(getattr(ens, name).shape)}")
        dev = self.device
        self._ens = GBTEnsemble(
            feat=torch.as_tensor(ens.feat, dtype=torch.int32, device=dev),
            thresh=torch.as_tensor(ens.thresh, dtype=torch.int32, device=dev),
            is_split=torch.as_tensor(ens.is_split, dtype=torch.bool, device=dev),
            leaf=torch.as_tensor(ens.leaf, dtype=torch.float32, device=dev),
            lr=torch.as_tensor(ens.lr, dtype=torch.float32, device=dev),
        )
        self._edges = torch.as_tensor(edges, dtype=torch.float32, device=dev).contiguous()
        return self

    def to(self, device) -> "GBTClassifier":
        self.device = torch.device(device)
        if self._ens is not None:
            self.load_ensemble(self._ens, self._edges)
        return self

    def predict_proba(self, X) -> np.ndarray:
        """X (n, F) array or tensor -> (n, 2) float32 class probabilities."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        m = predict_margin(self._ens, bin_data(X, self._edges), self.params["max_depth"])
        p1 = torch.sigmoid(m)
        return torch.stack([1 - p1, p1], dim=1).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return (self.predict_proba(X)[:, 1] >= 0.5).astype(int)

    def get_params(self, deep=True):
        return {**self.params, "random_state": self.random_state}

    def set_params(self, **kw):
        for k, v in kw.items():
            if k == "random_state":
                self.random_state = int(v)
            elif k in self.params:
                self.params[k] = v
        return self
