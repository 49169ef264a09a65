"""Histogram gradient-boosted trees (the port of the JAX package's
``classify/gbt.py``): the fit and the predict half.

An ensemble is stored as the JAX package stores it: per tree, a heap of
split features, split bins and split flags, level d in the static range
[2^d - 1, 2^(d+1) - 1) plus one inert slot, and leaf weights indexed by the
final node id.  Logistic loss, second-order gains with L2 lambda, gamma
pruning, min_child_weight, per-tree row and column subsampling.

The fit grows S fits at once (the JAX package's vmapped fit axis, written
out), level by level.  Each level makes one ``left_histograms_fixed`` call
(the histogram kernel) for all S fits, the prefix-sum, gain and argmax
epilogue in plain torch, and one ``route_rows`` call (the routing kernel).
``predict_margin`` routes **all trees at once**: the tree axis is the
routing kernel's fit axis.  The tree loop never waits for the device:
nothing in it copies to the host.

Numbers.  The histograms are exact integer sums of g and h in fixed point
(``ops/gbt_hist.py``), so the sibling subtraction, the prefix sums over
bins and the leaf sums are exact integer arithmetic, and a tie between two
bins (an empty bin between them) stays an exact tie.  The sigmoid, the
gains and the leaf weights work in float64 from those integers.  So a fit
on the card is bit-identical from run to run and grows the same trees as
the same fit on the CPU.  Row and column masks come from a counter-based
hash of (seed, tree, index) in torch integer ops, the same on every device;
``jax.random``'s streams cannot be reproduced, so the parity tests inject
the JAX package's masks through ``row_masks`` and ``col_masks``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.ops.gbt_hist import fixed_point_shift, left_histograms_fixed, pack_bins, pow2
from ae_waveforms_tpu_torch.ops.gbt_route import route_rows

__all__ = [
    "GBTClassifier", "GBTEnsemble", "compute_bin_edges", "bin_data", "fit_gbt", "fit_gbt_multi",
    "fit_gbt_sweep", "fit_gbt_sweep_margins", "predict_margin", "predict_margin_multi",
    "subsample_uniforms",
]

N_BINS = 64
LAMBDA = 1.0  # xgboost reg_lambda default
BASE_SCORE = 0.0  # margin of base_score 0.5
_M32 = 0xFFFFFFFF
_ROW_STREAM, _COL_STREAM = 0x52F1, 0xC07A


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


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 (C. Wellons) on int64 tensors that hold uint32 values; its
    multipliers are below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def subsample_uniforms(seeds: torch.Tensor, tree: int, count: int, stream: int) -> torch.Tensor:
    """(S,) integer seeds -> (S, count) float32 uniforms in [0, 1), a hash of
    (seed, stream, tree, index) in integer ops: the same values on every
    device, different for every tree."""
    key = _hash32(_hash32((seeds.long() & _M32) ^ stream) ^ (tree & _M32))
    u = _hash32((key[:, None] + torch.arange(count, device=seeds.device)) & _M32)
    return (u >> 8).float() * 2.0**-24


def _masks(seeds, tree, n, F, subsamples, colsamples, row_masks, col_masks):
    """Tree ``tree``'s (S, n) row mask and (S, F) column mask."""
    if row_masks is not None:
        sub = row_masks[:, tree]
    else:
        sub = subsample_uniforms(seeds, tree, n, _ROW_STREAM) < subsamples[:, None]
    if col_masks is not None:
        col = col_masks[:, tree]
    else:
        col = subsample_uniforms(seeds, tree, F, _COL_STREAM) < colsamples[:, None]
    # at least one column: column 0 where the draw kept none
    first = torch.arange(F, device=col.device) == 0
    return sub, col | (~col.any(1, keepdim=True) & first)


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
    lam = LAMBDA
    bin_ok = torch.arange(B, device=dev) < B - 1  # bin B-1 puts every row left
    gam = gammas.double()[:, None, None, None]
    mcw = min_child_weights.double()[:, None, None, None]
    margin = torch.full((S, n), BASE_SCORE, dtype=torch.float32, device=dev)
    trees = []
    for t in range(n_estimators):
        active = (t < n_actives).float()[:, None]
        sub, col = _masks(seeds, t, n, F, subsamples, colsamples, row_masks, col_masks)
        w = (row_weights * sub).double()
        p = torch.sigmoid(margin.double())
        g = ((p - y) * w).float()
        h = ((p * (1.0 - p)).clamp_min(1e-16) * w).float()
        shift = fixed_point_shift(g, h)
        scale = pow2(-shift)[:, None, None, None]
        feasible_col = col[:, None, :, None] & bin_ok

        node_of = torch.zeros((S, n), dtype=torch.int32, device=dev)
        feats, thrs, splits = [], [], []
        for depth in range(D):
            n_nodes = 2**depth
            half = max(n_nodes // 2, 1)
            q = left_histograms_fixed(binsT, g, h, node_of, shift, half=half, n_bins=B, packed=packed)
            q = q.view(S, 2 * half, F, B)
            if depth == 0:
                # the root is node 0, a "left child": its rows are every row
                Gq, Hq = q[:, :1], q[:, 1:]
            else:
                # sibling subtraction, exact in integers: right = parent - left
                Gl, Hl = q[:, :half], q[:, half:]
                Gq = torch.stack([Gl, Gq - Gl], dim=2).view(S, n_nodes, F, B)
                Hq = torch.stack([Hl, Hq - Hl], dim=2).view(S, n_nodes, F, B)
            GLq, HLq = Gq.cumsum(-1), Hq.cumsum(-1)
            GL, HL = GLq.double() * scale, HLq.double() * scale
            GR, HR = (GLq[..., -1:] - GLq).double() * scale, (HLq[..., -1:] - HLq).double() * scale
            G, H = GL[..., -1:], HL[..., -1:]
            gain = 0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam) - G * G / (H + lam)) - gam
            feasible = (HL >= mcw) & (HR >= mcw) & feasible_col
            flat = torch.where(feasible, gain, -torch.inf).view(S, n_nodes, F * B)
            best = flat.argmax(-1)  # the first of equal gains, as in the JAX package
            best_gain = flat.gather(-1, best[..., None])[..., 0]
            do_split = (best_gain > 0.0) & (depth < depth_limits[:, None])
            bf, bb = (best // B).to(torch.int32), (best % B).to(torch.int32)
            # heap layout: level d fills the static range [2^d-1, 2^(d+1)-1)
            feats.append(torch.where(do_split, bf, 0))
            thrs.append(torch.where(do_split, bb, 0))
            splits.append(do_split)
            # rows of a node that does not split descend its left spine
            node_of = route_rows(binsT, node_of, bf, bb, do_split)

        # leaf sums from the last level's prefix sums: a split node's left
        # child holds GL at its split, an unsplit node's holds all its rows
        tot = (bf.long() * B + B - 1)[..., None]
        at = torch.where(do_split, best, tot[..., 0])[..., None]
        GLf, HLf = GLq.view(S, n_nodes, F * B), HLq.view(S, n_nodes, F * B)
        Gleft, Hleft = GLf.gather(-1, at)[..., 0], HLf.gather(-1, at)[..., 0]
        Gtot, Htot = GLf.gather(-1, tot)[..., 0], HLf.gather(-1, tot)[..., 0]
        leaf_scale = scale[:, :, 0, 0]
        Gleaf = torch.stack([Gleft, Gtot - Gleft], dim=2).view(S, 2 * n_nodes).double() * leaf_scale
        Hleaf = torch.stack([Hleft, Htot - Hleft], dim=2).view(S, 2 * n_nodes).double() * leaf_scale
        wleaf = (-Gleaf / (Hleaf + lam)).float() * active
        margin = margin + learning_rates[:, None] * torch.gather(wleaf, 1, node_of.long())

        # static heap bookkeeping, padded by one inert slot to (2^D,)
        zero = torch.zeros((S, 1), dtype=torch.int32, device=dev)
        trees.append((torch.cat(feats + [zero], 1), torch.cat(thrs + [zero], 1),
                      torch.cat(splits + [zero.bool()], 1), wleaf))
    feat, thresh, is_split, leaf = (torch.stack(x, 1) for x in zip(*trees))
    return GBTEnsemble(feat, thresh, is_split, leaf, learning_rates), margin


def _sweep(bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights, subsamples,
           colsamples, n_actives, max_depth, n_estimators, n_bins, depth_limits, row_masks,
           col_masks):
    """Convert the arguments to tensors on ``bins``' device (the first CUDA
    device when ``bins`` is no tensor), per-fit ones broadcast to (S,), and
    run ``_fit_batched``."""
    dev = bins.device if isinstance(bins, torch.Tensor) else resolve_device()
    bins = torch.as_tensor(bins, device=dev).to(torch.int32).contiguous()
    row_weights = torch.as_tensor(row_weights, dtype=torch.float32, device=dev)
    S = row_weights.shape[0]
    per_fit = lambda x, dtype: torch.as_tensor(x, dtype=dtype, device=dev).expand(S).contiguous()  # noqa: E731
    if depth_limits is None:
        depth_limits = max_depth
    masks = [None if m is None else torch.as_tensor(m, dtype=torch.bool, device=dev) for m in (row_masks, col_masks)]
    return _fit_batched(
        bins, torch.as_tensor(y, dtype=torch.float32, device=dev), row_weights, per_fit(seeds, torch.int64),
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
    """(T, max_nodes) trees x (n, F) bins -> (T, n) leaf weights."""
    binsT = bins.T.contiguous()
    node_of = torch.zeros((ens.feat.shape[0], bins.shape[0]), dtype=torch.int32, device=bins.device)
    for depth in range(max_depth):
        lo, hi = 2**depth - 1, 2 ** (depth + 1) - 1
        node_of = route_rows(binsT, node_of, ens.feat[:, lo:hi], ens.thresh[:, lo:hi], ens.is_split[:, lo:hi])
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
