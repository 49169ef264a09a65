"""The GBT grid search of the reference (main_ae_classify.py: GridSearchCV
of xgboost over the Latin-hypercube grid of
functions_ml/latin_hypercube_sampling.py, 3 folds, ROC-AUC), written out in
plain torch and NumPy at the program's stated arithmetic: per-fold quantile
bins from the training rows, logistic loss with second-order gains, L2
lambda 1, gamma, min_child_weight, row and column subsampling from a
counter hash of (seed, tree, index), g and h summed exactly in fixed point
(each fit's scale 2^shift with no sum of n terms reaching 2^62), the
gains, the sigmoid and the leaves in float64 (``dtype``), margins in
float32.  Each node's histogram is summed directly from its rows.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from scipy.stats import qmc

LAMBDA = 1.0
M32 = 0xFFFFFFFF
ROW_STREAM, COL_STREAM = 0x52F1, 0xC07A


def lhs_params(n: int, random_state: int) -> List[Dict[str, float]]:
    """The reference's Latin-hypercube candidates: a 7-dimensional unit LHS
    mapped onto max_depth 2-10, learning_rate 0.01-0.3, n_estimators 50-500
    step 50, gamma 0-5, min_child_weight 1-11, subsample and colsample 0.5-1."""
    out = []
    for s in qmc.LatinHypercube(d=7, seed=random_state).random(n):
        out.append({"max_depth": int(s[0] * 9) + 2, "learning_rate": 0.01 + s[1] * 0.29,
                    "n_estimators": (int(s[2] * 10) + 1) * 50, "gamma": s[3] * 5,
                    "min_child_weight": int(s[4] * 10) + 1, "subsample": 0.5 + s[5] * 0.5,
                    "colsample_bytree": 0.5 + s[6] * 0.5})
    return out


def folds(n: int, cv: int, random_state: int) -> List[np.ndarray]:
    return np.array_split(np.random.default_rng(random_state).permutation(n), cv)


def quantile_bins(X_train: np.ndarray, X: np.ndarray, n_bins: int) -> np.ndarray:
    """(n, F) int64 bins of X: per feature, the count of the training rows'
    (n_bins - 1) float32 quantile edges at or below the value."""
    edges = np.quantile(X_train, np.linspace(0, 1, n_bins + 1)[1:-1], axis=0).T.astype(np.float32)
    return np.stack([np.searchsorted(edges[f], X[:, f], side="right") for f in range(X.shape[1])], 1)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & M32
    return x ^ (x >> 15)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k, float64, from its bits (exact for integer k in [-1022, 1023])."""
    return ((k.long() + 1023) << 52).view(torch.float64)


def uniforms(seeds: torch.Tensor, tree: int, count: int, stream: int) -> torch.Tensor:
    key = _hash32(_hash32((seeds.long() & M32) ^ stream) ^ (tree & M32))
    u = _hash32((key[:, None] + torch.arange(count, device=seeds.device)) & M32)
    return (u >> 8).float() * 2.0**-24


def fit(bins: torch.Tensor, y: torch.Tensor, w0: torch.Tensor, seed: int, hp: Dict[str, torch.Tensor], depth: int,
        trees: int, n_bins: int, dtype=torch.float64):
    """S fits, each on its own (n, F) bins (``bins`` (S, n, F)), training
    weights ``w0`` (S, n) and float32 hyperparameters ``hp`` (S,) each
    (learning_rate, gamma, min_child_weight, subsample, colsample_bytree,
    n_estimators, max_depth); ``trees`` trees of heaps ``depth`` levels deep,
    trees past a fit's n_estimators weighing nothing and levels past its
    max_depth splitting nothing.  Returns the heaps (feat, thresh, is_split,
    leaf), each (S, trees, 2^depth), and the (S, n) float32 margins."""
    S, n, F = bins.shape
    dev = bins.device
    B = n_bins
    seeds = torch.full((S,), seed, dtype=torch.int64, device=dev)
    lam = LAMBDA
    gam = hp["gamma"].to(dtype)[:, None]
    mcw = hp["min_child_weight"].to(dtype)[:, None]
    fits = torch.arange(S, device=dev)[:, None]
    feat_of = torch.arange(F * B, device=dev) // B
    bin_ok = (torch.arange(F * B, device=dev) % B) < B - 1
    m = 2**depth
    heaps = {k: torch.zeros((S, trees, m), dtype=t, device=dev)
             for k, t in (("feat", torch.int32), ("thresh", torch.int32), ("is_split", torch.bool),
                          ("leaf", torch.float32))}
    margin = torch.zeros((S, n), dtype=torch.float32, device=dev)
    for t in range(trees):
        sub = uniforms(seeds, t, n, ROW_STREAM) < hp["subsample"][:, None]
        col = uniforms(seeds, t, F, COL_STREAM) < hp["colsample_bytree"][:, None]
        col[:, 0] |= ~col.any(1)
        w = (w0 * sub).to(dtype)
        p = torch.sigmoid(margin.to(dtype))
        g = ((p - y) * w).float()
        h = ((p * (1.0 - p)).clamp_min(1e-16) * w).float()
        top = torch.maximum(g.abs().amax(1), h.abs().amax(1))
        shift = (62 - (n - 1).bit_length() - torch.frexp(top).exponent).long()
        scale, sc = _pow2(shift)[:, None], _pow2(-shift)[:, None].to(dtype)
        qg = torch.round(g.double() * scale).long()
        qh = torch.round(h.double() * scale).long()
        node = torch.zeros((S, n), dtype=torch.int64, device=dev)
        for d in range(depth):
            nodes = 2**d
            cell = ((fits * nodes + node)[:, :, None] * F + torch.arange(F, device=dev)) * B + bins  # (S, n, F)
            hist = [torch.zeros(S * nodes * F * B, dtype=torch.int64, device=dev).index_add_(
                0, cell.reshape(-1), q[:, :, None].expand(S, n, F).reshape(-1)).view(S, nodes, F, B)
                for q in (qg, qh)]
            GLq, HLq = (x.cumsum(-1).view(S, nodes, F * B) for x in hist)
            GTq = [x.view(S, nodes, F, B)[..., -1:].expand(S, nodes, F, B).reshape(S, nodes, F * B) for x in (GLq, HLq)]
            s3 = sc[:, :, None]
            GL, HL = GLq.to(dtype) * s3, HLq.to(dtype) * s3
            GR, HR = (GTq[0] - GLq).to(dtype) * s3, (GTq[1] - HLq).to(dtype) * s3
            G, H = GTq[0].to(dtype) * s3, GTq[1].to(dtype) * s3
            gain = 0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam) - G * G / (H + lam)) - gam[:, :, None]
            ok = (HL >= mcw[:, :, None]) & (HR >= mcw[:, :, None]) & col[:, None, feat_of] & bin_ok
            gain = torch.where(ok, gain, -torch.inf)
            best = gain.argmax(-1)
            split = (gain.gather(-1, best[..., None])[..., 0] > 0) & (d < hp["max_depth"].long()[:, None])
            bf, bb = best // B, best % B
            lo = 2**d - 1
            heaps["feat"][:, t, lo:lo + nodes] = torch.where(split, bf, 0).to(torch.int32)
            heaps["thresh"][:, t, lo:lo + nodes] = torch.where(split, bb, 0).to(torch.int32)
            heaps["is_split"][:, t, lo:lo + nodes] = split
            f_row, b_row, s_row = bf.gather(1, node), bb.gather(1, node), split.gather(1, node)
            right = bins.gather(2, f_row[:, :, None])[..., 0] > b_row
            node = 2 * node + (s_row & right).long()
        Gn = torch.zeros((S, m), dtype=torch.int64, device=dev).scatter_add_(1, node, qg)
        Hn = torch.zeros((S, m), dtype=torch.int64, device=dev).scatter_add_(1, node, qh)
        leaf = (-(Gn.to(dtype) * sc) / (Hn.to(dtype) * sc + lam)).float() * (t < hp["n_estimators"]).float()[:, None]
        heaps["leaf"][:, t] = leaf
        margin = margin + hp["learning_rate"][:, None] * leaf.gather(1, node)
    return heaps, margin


def roc_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(S, m) scores of m rows -> (S,) ROC-AUC, ties at their average rank,
    in float64."""
    s = scores.double()
    srt = s.sort(dim=-1).values
    rank = (torch.searchsorted(srt, s, side="left") + torch.searchsorted(srt, s, side="right") + 1).double() / 2.0
    pos = labels.double().expand_as(s)
    n_pos = pos.sum(-1)
    n_neg = s.shape[-1] - n_pos
    return ((rank * pos).sum(-1) - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def chunks(params: List[Dict[str, float]], cv: int, shallow_fits: int = 96, deep_fits: int = 24):
    """The grid search's fit calls in their order: (depth of the heaps,
    fold, candidate indices), the candidates bucketed by max_depth <= 6 or
    <= 10, each bucket's folds in turn, chunks of at most 96 and 24 fits."""
    buckets: Dict[int, List[int]] = {}
    for i, p in enumerate(params):
        buckets.setdefault(6 if int(p["max_depth"]) <= 6 else 10, []).append(i)
    out = []
    for depth, idxs in sorted(buckets.items()):
        size = shallow_fits if depth <= 6 else min(shallow_fits, deep_fits)
        for f in range(cv):
            for c0 in range(0, len(idxs), size):
                out.append((depth, f, idxs[c0:c0 + size]))
    return out
