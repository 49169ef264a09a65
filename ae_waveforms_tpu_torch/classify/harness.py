"""Classifier evaluation harness (the port of the JAX package's
``classify/harness.py``; capability twin of main_ae_classify.py,
main_ml_classify.py and analysis_PPV_hypokalaemia.py).

Shared procedure, replicated exactly:

- cap each class at 6500 samples; the fixed test set is the last
  min(250, ...) rows of each class (main_ae_classify.py:43-49);
- hyperparameter selection: an LHS candidate list scored by K-fold
  cross-validated ROC-AUC on up to 6000 rows per class
  (main_ae_classify.py:57-77);
- evaluation: for each training size and 25 seeds, subsample
  ``rng(seed + 42).choice`` rows per class, fit with random_state
  ``seed + 42``, score AUC on the fixed test set; report median and IQR
  (main_ae_classify.py:82-115);
- PPV variant: size 6000 only, adding precision at threshold 0.5
  (analysis_PPV_hypokalaemia.py:78-110);
- handcrafted-feature variant: column 5 (T Duration) deleted from the
  10-feature matrix before fitting (main_ml_classify.py:110).

The model is the port's GBT (``classify/gbt.py``).  Every hyperparameter,
the tree count and the effective depth are per-fit values, so the
vectorized grid search fits chunks of candidates in one ``fit_gbt_sweep``
call per (depth bucket, fold, chunk).  ROC-AUC and precision are the port's
own functions (sklearn is not needed), and the CSVs are written with the
``csv`` module; matplotlib is imported only to draw the figures.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.classify.gbt import (
    GBTClassifier,
    bin_data,
    compute_bin_edges,
    fit_gbt_multi,
    fit_gbt_sweep_margins,
    predict_margin_multi,
)
from ae_waveforms_tpu_torch.classify.lhs import lhs_param_dicts

__all__ = [
    "prepare_class_data",
    "select_by_ids",
    "cv_folds",
    "grid_search_cv",
    "size_seed_sweep",
    "ppv_analysis",
    "roc_auc_score",
    "precision_score",
    "DEFAULT_SIZES",
]

DEFAULT_SIZES = [100, 250, 500, 750, 1000, 1500, 2000, 2500, 3000, 4000, 6000]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharding the seed axis over a device mesh belongs to the multi-device slice "
            "(ROADMAP.md, queue 1, item 11); the port fits every seed on one device"
        )


def _classifier_cls(backend: str):
    """GBDT implementation selector: 'torch' = the port's GBT (production),
    'sklearn' = HistGradientBoostingClassifier (independent C++ A/B oracle,
    classify/sklearn_gbt.py)."""
    if backend == "torch":
        return GBTClassifier
    if backend == "sklearn":
        from ae_waveforms_tpu_torch.classify.sklearn_gbt import SklearnGBTClassifier

        return SklearnGBTClassifier
    raise ValueError(f"unknown GBDT backend {backend!r}")


@dataclass
class ClassData:
    control_train: np.ndarray
    sick_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray


def prepare_class_data(
    control_features: np.ndarray,
    sick_features: np.ndarray,
    cap: int = 6500,
    test_size: int = 250,
) -> ClassData:
    control = np.asarray(control_features)[:cap]
    sick = np.asarray(sick_features)[:cap]
    ts = min(test_size, len(control) - 1, len(sick) - 1)
    X_test = np.concatenate([control[-ts:], sick[-ts:]], axis=0)
    y_test = np.concatenate([np.zeros(ts), np.ones(ts)])
    return ClassData(control[:-ts], sick[:-ts], X_test, y_test)


def select_by_ids(info_ids: np.ndarray, features: np.ndarray, wanted_ids: np.ndarray) -> np.ndarray:
    """Row-select features whose case id appears in the wanted list
    (main_ae_classify.py:40-44)."""
    idx = np.nonzero(np.isin(info_ids, wanted_ids))[0]
    return np.asarray(features)[idx]


def cv_folds(n: int, cv: int, random_state: int) -> List[np.ndarray]:
    """The grid search's K folds: a seeded permutation of the n rows cut
    into ``cv`` nearly equal parts."""
    return np.array_split(np.random.default_rng(random_state).permutation(n), cv)


def _roc_auc_device(scores: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank-statistic ROC-AUC of padded score vectors, (..., m) -> (...),
    on their device.

    Average ranks (tie-corrected, as sklearn's roc_auc_score) via two
    searchsorteds against the sorted scores; padded entries carry +inf
    scores and zero weight so they sit past every real rank.  Float64."""
    scores = torch.where(valid, scores.double(), torch.inf)
    w = valid.double()
    s_sorted = scores.sort(dim=-1).values
    lo = torch.searchsorted(s_sorted, scores, side="left")
    hi = torch.searchsorted(s_sorted, scores, side="right")
    rank = (lo + hi + 1).double() / 2.0  # 1-based average rank
    pos = labels.double() * w
    n_pos = pos.sum(-1)
    n_neg = w.sum(-1) - n_pos
    return ((rank * pos).sum(-1) - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def roc_auc_score(y_true, y_score) -> float:
    """Binary ROC-AUC with ties averaged, as ``sklearn.metrics.roc_auc_score``."""
    y = np.asarray(y_true, np.float64)
    if not 0 < y.sum() < len(y):
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined in that case.")
    s = torch.as_tensor(np.asarray(y_score, np.float64))
    return float(_roc_auc_device(s, torch.as_tensor(y), torch.ones_like(s, dtype=torch.bool)))


def precision_score(y_true, y_pred) -> float:
    """Precision of the positive class, tp / (tp + fp); 0.0 when nothing is
    predicted positive (sklearn's ``precision_score`` default)."""
    y_true, y_pred = np.asarray(y_true) == 1, np.asarray(y_pred) == 1
    n_pred = int(y_pred.sum())
    return float((y_true & y_pred).sum() / n_pred) if n_pred else 0.0


def grid_search_cv(
    X: np.ndarray,
    y: np.ndarray,
    n_candidates: int = 1000,
    cv: int = 3,
    random_state: int = 1,
    verbose: bool = False,
    vectorized: bool = False,
    fits_per_call: int = 96,
    backend: str = "torch",
    device=None,
) -> Dict:
    """LHS candidates scored by K-fold ROC-AUC; returns the best param dict
    and its mean score.

    ``vectorized=True`` buckets the candidates into two coarse depth groups
    (<= 6 and <= 10) and fits chunks of candidates together: one
    ``fit_gbt_sweep_margins`` per (bucket, fold, chunk), every
    hyperparameter including the depth a per-fit value.  Chunks hold
    ``fits_per_call`` fits in the shallow bucket and at most 24 in the deep
    one.  Quantile bin edges are computed per fold from the training rows
    only — the same no-leakage discipline as the reference's GridSearchCV +
    XGBoost.  Runs on ``device`` (the first CUDA device unless named)."""
    if n_candidates < 1:
        raise ValueError(f"n_candidates must be >= 1, got {n_candidates}")
    params = lhs_param_dicts(n_candidates, random_state=random_state)
    folds = cv_folds(len(y), cv, random_state)

    if vectorized:
        if backend != "torch":
            raise ValueError("vectorized grid search is the port's GBT path; use backend='torch'")
        return _grid_search_cv_vectorized(X, y, params, folds, random_state, verbose, fits_per_call, device)

    cls = _classifier_cls(backend)
    best_score, best_params = -np.inf, None
    for i, p in enumerate(params):
        scores = []
        for f in range(cv):
            te = folds[f]
            tr = np.concatenate([folds[g] for g in range(cv) if g != f])
            m = cls(**p, random_state=random_state, device=device)
            m.fit(X[tr], y[tr])
            scores.append(roc_auc_score(y[te], m.predict_proba(X[te])[:, 1]))
        s = float(np.mean(scores))
        if s > best_score:
            best_score, best_params = s, p
        if verbose and (i + 1) % 50 == 0:
            print(f"grid search {i + 1}/{len(params)}: best AUC {best_score:.4f}")
    if best_params is None:
        raise ValueError(
            "no candidate produced a finite CV score — dataset too small for "
            f"{cv}-fold CV (n={len(y)})"
        )
    return {"best_params": best_params, "best_score": best_score}


def _grid_search_cv_vectorized(X, y, params, folds, random_state, verbose, fits_per_call, device):
    dev = resolve_device(device)
    X = np.asarray(X, np.float32)
    y_f = np.asarray(y, np.float32)
    n = len(y_f)
    cv = len(folds)
    cap = max(p["n_estimators"] for p in params)

    fold_masks = np.zeros((cv, n), np.float32)
    for f, te in enumerate(folds):
        fold_masks[f] = 1.0
        fold_masks[f, te] = 0.0  # held-out rows excluded from training

    # per-fold quantile bin edges from the TRAINING rows only; held-out rows
    # are binned with their fold's training edges, like unseen data
    bins_folds = np.zeros((cv, n, X.shape[1]), np.int32)
    for f in range(cv):
        bins_folds[f] = bin_data(
            torch.as_tensor(X), torch.as_tensor(compute_bin_edges(X[fold_masks[f] > 0]))
        ).numpy()

    # fold data lives on the device; a chunk uploads its (7, S)
    # hyperparameters and brings back (S,) AUCs
    fold_masks_dev = torch.as_tensor(fold_masks, device=dev)
    bins_folds_dev = torch.as_tensor(bins_folds, device=dev)
    y_dev = torch.as_tensor(y_f, device=dev)
    m = max(len(te) for te in folds)
    te_idx = np.zeros((cv, m), np.int64)
    te_valid = np.zeros((cv, m), bool)
    for f, te in enumerate(folds):
        te_idx[f, : len(te)] = te
        te_valid[f, : len(te)] = True
    te_idx_dev = torch.as_tensor(te_idx, device=dev)
    te_valid_dev = torch.as_tensor(te_valid, device=dev)

    def dispatch(chunk, fold, depth):
        """Enqueue one chunk's fits and held-out AUCs; returns the (S,)
        AUCs on the device without waiting for them.  The margins of the
        held-out rows come from the boosting carry, so nothing is routed
        twice."""
        S = len(chunk)
        hp = torch.as_tensor(np.array(
            [[params[ci][k] for ci in chunk] for k in (
                "learning_rate", "gamma", "min_child_weight", "subsample", "colsample_bytree",
                "n_estimators", "max_depth")], np.float32), device=dev)
        _, margins = fit_gbt_sweep_margins(
            bins_folds_dev[fold], y_dev, fold_masks_dev[fold].expand(S, n), random_state,
            hp[0], hp[1], hp[2], hp[3], hp[4], hp[5], max_depth=depth, n_estimators=cap,
            depth_limits=hp[6],
        )
        idx = te_idx_dev[fold]
        return _roc_auc_device(margins[:, idx], y_dev[idx].expand(S, m), te_valid_dev[fold].expand(S, m))

    # group candidates into coarse depth buckets; the depth itself is a
    # per-fit limit, so a bucket serves every depth up to its own
    by_depth: Dict[int, List[int]] = {}
    for i, p in enumerate(params):
        by_depth.setdefault(6 if int(p["max_depth"]) <= 6 else 10, []).append(i)

    fold_scores = np.zeros((len(params), cv))
    fold_done = np.zeros((len(params), cv), bool)
    done = 0

    def score(chunk, fold, aucs_dev):
        nonlocal done
        aucs = aucs_dev.cpu().numpy()  # (S,) — waits for the chunk
        for j, ci in enumerate(chunk):
            fold_scores[ci, fold] = aucs[j]
            fold_done[ci, fold] = True
        done += len(chunk)
        if verbose:
            # mean over COMPLETED folds only
            complete = fold_done.all(axis=1)
            if complete.any():
                best = fold_scores[complete].mean(axis=1).max()
                print(f"grid search {done}/{len(params) * cv} fold-fits: best AUC {best:.4f}")
            else:
                print(f"grid search {done}/{len(params) * cv} fold-fits")

    # one-chunk lookahead: the host enqueues chunk k+1 before it waits for
    # chunk k's AUCs, so the device never runs dry between chunks
    pending = None
    for depth, idxs in sorted(by_depth.items()):
        bucket_fits = max(1, fits_per_call) if depth <= 6 else max(1, min(fits_per_call, 24))
        for fold in range(cv):
            for c0 in range(0, len(idxs), bucket_fits):
                chunk = idxs[c0 : c0 + bucket_fits]
                aucs_dev = dispatch(chunk, fold, depth)
                if pending is not None:
                    score(*pending)
                pending = (chunk, fold, aucs_dev)
    if pending is not None:
        score(*pending)

    mean_scores = fold_scores.mean(axis=1)
    best = int(np.argmax(mean_scores))
    return {"best_params": params[best], "best_score": float(mean_scores[best])}


def _fit_eval(data: ClassData, size: int, seed: int, best_params: Dict, drop_col: Optional[int],
              backend: str = "torch", device=None):
    rng = np.random.default_rng(seed + 42)
    idx_c = rng.choice(len(data.control_train), size, replace=False)
    idx_s = rng.choice(len(data.sick_train), size, replace=False)
    X_train = np.concatenate([data.control_train[idx_c], data.sick_train[idx_s]], axis=0)
    y_train = np.concatenate([np.zeros(size), np.ones(size)])
    X_test = data.X_test
    if drop_col is not None:
        X_train = np.delete(X_train, drop_col, axis=1)
        X_test = np.delete(X_test, drop_col, axis=1)
    m = _classifier_cls(backend)(**best_params, random_state=seed + 42, device=device)
    m.fit(X_train, y_train)
    return m.predict_proba(X_test)[:, 1]


def _fit_eval_vectorized(
    data: ClassData, size: int, n_seeds: int, best_params: Dict, drop_col: Optional[int],
    mesh=None, device=None,
) -> np.ndarray:
    """All seeds of one size fitted together, one ``fit_gbt_multi`` call.

    Seed subsets become row-weight masks over the pooled train matrix;
    binning uses the pool's quantile edges (vs per-subset edges in the
    sequential path — an approximation-detail difference only).  Returns
    the (n_seeds, n_test) probabilities."""
    _no_mesh(mesh)
    dev = resolve_device(device)
    X_pool = np.concatenate([data.control_train, data.sick_train], axis=0).astype(np.float32)
    y_pool = np.concatenate(
        [np.zeros(len(data.control_train)), np.ones(len(data.sick_train))]
    ).astype(np.float32)
    X_test = data.X_test
    if drop_col is not None:
        X_pool = np.delete(X_pool, drop_col, axis=1)
        X_test = np.delete(X_test, drop_col, axis=1)

    n_c = len(data.control_train)
    weights = np.zeros((n_seeds, len(y_pool)), np.float32)
    for seed in range(n_seeds):
        rng = np.random.default_rng(seed + 42)
        weights[seed, rng.choice(n_c, size, replace=False)] = 1.0
        weights[seed, n_c + rng.choice(len(data.sick_train), size, replace=False)] = 1.0

    edges = torch.as_tensor(compute_bin_edges(X_pool), device=dev)
    bins_pool = bin_data(torch.as_tensor(X_pool, device=dev), edges)
    bins_test = bin_data(torch.as_tensor(np.asarray(X_test, np.float32), device=dev), edges)
    p = best_params
    ens = fit_gbt_multi(
        bins_pool, y_pool, weights, np.arange(n_seeds) + 42,
        max_depth=int(p["max_depth"]), n_estimators=int(p["n_estimators"]),
        learning_rate=float(p["learning_rate"]), gamma=float(p["gamma"]),
        min_child_weight=float(p["min_child_weight"]), subsample=float(p["subsample"]),
        colsample_bytree=float(p["colsample_bytree"]),
    )
    margins = predict_margin_multi(ens, bins_test, int(p["max_depth"])).cpu().numpy()
    return 1.0 / (1.0 + np.exp(-margins))  # (S, n_test)


def _write_csv(path: str, records: List[Dict]) -> None:
    """Records as a CSV with a header row, columns in the records' key
    order (what the JAX package's ``pandas.DataFrame.to_csv`` writes)."""
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(records[0]) if records else [])
        writer.writeheader()
        writer.writerows(records)


def size_seed_sweep(
    data: ClassData,
    best_params: Dict,
    sizes: Sequence[int] = tuple(DEFAULT_SIZES),
    n_seeds: int = 25,
    drop_col: Optional[int] = None,
    out_dir: Optional[str] = None,
    file_stem: str = "",
    vectorized: bool = False,
    mesh=None,
    backend: str = "torch",
    device=None,
) -> Tuple[List[Dict], List[Dict]]:
    """AUC-vs-training-size evaluation; writes individual_aucs.csv and
    summary_auc_by_size.csv plus the AUC-vs-size plot when out_dir given.
    ``vectorized=True`` fits all seeds of a size together."""
    _no_mesh(mesh)
    auc_records, summary_records = [], []
    for size in sizes:
        size = min(size, len(data.control_train), len(data.sick_train))
        if vectorized:
            probas = _fit_eval_vectorized(data, size, n_seeds, best_params, drop_col, device=device)
        else:
            probas = [_fit_eval(data, size, seed, best_params, drop_col, backend=backend, device=device)
                      for seed in range(n_seeds)]
        aucs = []
        for seed in range(n_seeds):
            auc = roc_auc_score(data.y_test, probas[seed])
            aucs.append(auc)
            auc_records.append({"size": size, "seed": seed, "auc": auc})
        summary_records.append(
            {
                "size": size,
                "median_auc": float(np.median(aucs)),
                "q1_auc": float(np.percentile(aucs, 25)),
                "q3_auc": float(np.percentile(aucs, 75)),
            }
        )
        print(
            f"Size: {size}, Median AUC: {summary_records[-1]['median_auc']:.4f}, "
            f"IQR: ({summary_records[-1]['q1_auc']:.4f}, {summary_records[-1]['q3_auc']:.4f})"
        )

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prefix = f"{file_stem}_" if file_stem else ""
        _write_csv(os.path.join(out_dir, f"{prefix}individual_aucs.csv"), auc_records)
        _write_csv(os.path.join(out_dir, f"{prefix}summary_auc_by_size.csv"), summary_records)
        _plot_auc_vs_size(summary_records, os.path.join(out_dir, f"{prefix}auc_vs_data_size.png"))
    return auc_records, summary_records


def ppv_analysis(
    data: ClassData,
    best_params: Dict,
    size: int = 6000,
    n_seeds: int = 25,
    threshold: float = 0.5,
    vectorized: bool = False,
    mesh=None,
    backend: str = "torch",
    device=None,
) -> Dict:
    """Median/IQR AUC and PPV at the given threshold for one training size —
    the north-star hypokalaemia PPV metric (analysis_PPV_hypokalaemia.py).
    ``vectorized=True`` fits all seeds together."""
    _no_mesh(mesh)
    size = min(size, len(data.control_train), len(data.sick_train))
    if vectorized:
        seed_probas = list(_fit_eval_vectorized(data, size, n_seeds, best_params, None, device=device))
    else:
        seed_probas = [
            _fit_eval(data, size, seed, best_params, None, backend=backend, device=device)
            for seed in range(n_seeds)
        ]
    aucs, ppvs = [], []
    for proba in seed_probas:
        aucs.append(roc_auc_score(data.y_test, proba))
        ppvs.append(precision_score(data.y_test, (proba >= threshold).astype(int)))
    result = {
        "size": size,
        "median_auc": float(np.median(aucs)),
        "q1_auc": float(np.percentile(aucs, 25)),
        "q3_auc": float(np.percentile(aucs, 75)),
        "median_ppv": float(np.median(ppvs)),
        "q1_ppv": float(np.percentile(ppvs, 25)),
        "q3_ppv": float(np.percentile(ppvs, 75)),
        "aucs": aucs,
        "ppvs": ppvs,
    }
    print(f"Size: {size}")
    print(f"Median AUC: {result['median_auc']:.4f}, IQR: ({result['q1_auc']:.4f}, {result['q3_auc']:.4f})")
    print(
        f"Median PPV @ threshold {threshold}: {result['median_ppv']:.4f}, "
        f"IQR: ({result['q1_ppv']:.4f}, {result['q3_ppv']:.4f})"
    )
    return result


def evaluate_combined_model_auc(X: np.ndarray, y: np.ndarray, best_params: Dict, seed: int,
                                device=None) -> float:
    """AUC of a combined-feature model on a stratified 80/20 split
    (main_ml_classify.py:66-75 capability); needs sklearn for the split."""
    from sklearn.model_selection import train_test_split

    Xtr, Xva, ytr, yva = train_test_split(X, y, test_size=0.2, random_state=seed, stratify=y)
    m = GBTClassifier(**best_params, random_state=seed, device=device)
    m.fit(Xtr, ytr)
    return roc_auc_score(yva, m.predict_proba(Xva)[:, 1])


def plot_individual_feature_rocs(
    X_train: np.ndarray,
    X_val: np.ndarray,
    y_train: np.ndarray,
    y_val: np.ndarray,
    best_params: Dict,
    feature_names: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """Per-feature single-variable ROC curves plus the combined model
    (main_ml_classify.py:16-64 capability); needs sklearn and matplotlib.
    Returns {label: AUC}."""
    from sklearn.metrics import roc_curve

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if feature_names is None:
        feature_names = [
            "P Duration", "PR Interval", "QRS Complex", "ST Interval", "ST Segment",
            "P Prominence", "Q Prominence", "R Prominence", "S Prominence", "T Prominence",
        ]
    aucs: Dict[str, float] = {}
    plt.figure(figsize=(8, 6))
    for i in range(X_train.shape[1]):
        m = GBTClassifier(**best_params, random_state=1, device=device)
        m.fit(X_train[:, i : i + 1], y_train)
        proba = m.predict_proba(X_val[:, i : i + 1])[:, 1]
        fpr, tpr, _ = roc_curve(y_val, proba)
        label = feature_names[i] if i < len(feature_names) else f"Feature {i + 1}"
        aucs[label] = roc_auc_score(y_val, proba)
        plt.plot(fpr, tpr, lw=1, label=f"{label} (AUC = {aucs[label]:.2f})")

    full = GBTClassifier(**best_params, random_state=1, device=device)
    full.fit(X_train, y_train)
    proba = full.predict_proba(X_val)[:, 1]
    fpr, tpr, _ = roc_curve(y_val, proba)
    aucs["Combined"] = roc_auc_score(y_val, proba)
    plt.plot(fpr, tpr, color="black", lw=2, label=f"Combined Model (AUC = {aucs['Combined']:.2f})")
    plt.plot([0, 1], [0, 1], color="gray", linestyle="--")
    plt.xlabel("False Positive Rate")
    plt.ylabel("True Positive Rate")
    plt.legend(loc="lower right", fontsize=8)
    plt.grid(True)
    plt.tight_layout()
    if out_path:
        plt.savefig(out_path, dpi=200)
    plt.close()
    return aucs


def _plot_auc_vs_size(summary: List[Dict], out_path: str) -> None:
    try:
        import matplotlib
    except ModuleNotFoundError:
        print(f"matplotlib is not installed: {out_path} was not drawn")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sizes = np.array([r["size"] for r in summary])
    med = np.array([r["median_auc"] for r in summary])
    q1 = np.array([r["q1_auc"] for r in summary])
    q3 = np.array([r["q3_auc"] for r in summary])
    plt.figure(figsize=(8, 6))
    plt.plot(sizes, med, "-o", label="Median AUC")
    plt.fill_between(sizes, q1, q3, alpha=0.2, label="IQR (25th-75th percentile)")
    ref = med[-1]
    for frac, color in [(1.0, "black"), (0.975, "gray"), (0.95, "lightgray")]:
        plt.axhline(frac * ref, color=color, linestyle="--", linewidth=1.5, label=f"{frac:.1%} of Max AUC")
    plt.xlabel("Number of Patients per Class")
    plt.ylabel("ROC AUC on Fixed Test Set")
    plt.grid(True)
    plt.xticks(sizes, rotation=45)
    plt.legend(loc="lower right")
    plt.tight_layout()
    plt.savefig(out_path, dpi=300)
    plt.close()
