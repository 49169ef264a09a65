"""Traditional-vs-AE reconstruction comparison (the port of the JAX
package's ``analysis/trad_vs_ae.py``; capability twin of
analysis_performance_traditional_vs_ae.py).

Pipeline: load the test split, reorder the 20 fiducial columns into
occurrence order and insert R at (0, -1e-10), compute per-sample baselines,
optionally search the sigma map (device sweep and/or GP), reconstruct with
the final sigma map, and compute MSE / per-sample RMSE / PRD / QS for the
traditional method and any number of trained AEs.  QS = CR / PRD with
CR = 320/20 for the traditional method (20 stored numbers: 10 fiducial
(x, y) pairs) and 320/latent_size for an AE (analysis_...:195-232).

The sigma search's objective, the final reconstruction and each AE's test
pass (``train.eval.main_test``) run on one device, the first CUDA device
unless the caller names one; the metrics are numpy on the host.

Quirks preserved: the sigma search objective compares against
max-subtracted beats while the final metrics compare raw beats with the
max added back (analysis_...:33, :186-187).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet, load_arrays
from ae_waveforms_tpu_torch.traditional.reconstruction import reconstruct_gaussian_batch
from ae_waveforms_tpu_torch.traditional.sigma_search import (
    DEFAULT_SIGMA_MAP,
    SIGMA_MAP_X0,
    make_objective,
    prepare_reconstruction_inputs,
    sweep_search,
)

__all__ = ["MethodResult", "compare", "reconstruction_metrics"]


@dataclass
class MethodResult:
    label: str
    mse: float
    rmse_mean: float
    rmse_median: float
    rmse_per_sample: np.ndarray
    prd_mean: float
    prd_median: float
    prd_per_sample: np.ndarray
    qs_per_sample: np.ndarray
    qs_median: float = field(init=False)

    def __post_init__(self):
        self.qs_median = float(np.median(self.qs_per_sample))


def reconstruction_metrics(label: str, pred: np.ndarray, true: np.ndarray, cr: float) -> MethodResult:
    err = pred - true
    mse = float(np.mean(err**2))
    rmse_per = np.sqrt(np.mean(err**2, axis=1))
    prd_per = 100.0 * np.sqrt(np.sum(err**2, axis=1) / np.sum(true**2, axis=1))
    return MethodResult(
        label=label,
        mse=mse,
        rmse_mean=float(rmse_per.mean()),
        rmse_median=float(np.median(rmse_per)),
        rmse_per_sample=rmse_per,
        prd_mean=float(prd_per.mean()),
        prd_median=float(np.median(prd_per)),
        prd_per_sample=prd_per,
        qs_per_sample=cr / prd_per,
    )


def compare(
    cfg: TrainConfig,
    arrays: Optional[ArraySet] = None,
    model_runs: Optional[List[Dict]] = None,
    sigma_map: Optional[np.ndarray] = None,
    run_sigma_search: bool = False,
    search_candidates: int = 2000,
    plot_dir: Optional[str] = None,
    device=None,
) -> Dict[str, MethodResult]:
    """Run the comparison on ``device`` (the first CUDA device unless
    named).  ``model_runs``: list of dicts with keys trained_model /
    latent_size / model_class / seed, mirroring the AUT-231 and AUT-296
    test invocations (analysis_...:226-230)."""
    device = resolve_device(device)
    if arrays is None:
        arrays = load_arrays(cfg.dataset_dir)
    test_files = sorted(glob.glob(os.path.join(cfg.dataset_dir, "indices_test_*.npy")))
    if test_files:
        te_mask = np.load(test_files[0])
    else:
        te_mask = np.ones(len(arrays), bool)

    beats = np.asarray(arrays.waves, np.float32)[te_mask]
    feats = np.asarray(arrays.features)[te_mask]
    fx, fy, baselines, x_time = prepare_reconstruction_inputs(feats)

    sigma_map = np.asarray(sigma_map if sigma_map is not None else DEFAULT_SIGMA_MAP, float)
    if run_sigma_search:
        search_true = beats - beats.max(axis=1, keepdims=True)
        objective = make_objective(fx, fy, baselines, x_time, search_true, device=device)
        sigma_map, best = sweep_search(objective, n_candidates=search_candidates, seed=42, x0=SIGMA_MAP_X0)
        print(f"sigma search best map {list(sigma_map)} loss {best:.6f}")

    recon = reconstruct_gaussian_batch(fx, fy, x_time, baselines, sigma_map, device=device).cpu().numpy()
    # final metrics on raw beats with the per-sample max added back
    pred = recon + beats.max(axis=1, keepdims=True)
    results = {"traditional": reconstruction_metrics("Traditional, d=20", pred, beats, cr=320.0 / 20.0)}

    for run in model_runs or []:
        from ae_waveforms_tpu_torch.train.eval import main_test

        run_cfg = cfg.replace(
            mode="test",
            trained_model=run["trained_model"],
            latent_size=run["latent_size"],
            model_class=run.get("model_class", cfg.model_class),
            seed=run.get("seed", cfg.seed),
            plotting=False,
        )
        _, (loss, rmse, rmse_per, prd, prd_per), (p, t, _), _ = main_test(run_cfg, arrays=arrays, device=device)
        cr = 320.0 / run["latent_size"]
        results[run["trained_model"]] = MethodResult(
            label=f"AE, d={run['latent_size']}",
            mse=loss,
            rmse_mean=rmse,
            rmse_median=float(np.median(rmse_per)),
            rmse_per_sample=rmse_per,
            prd_mean=prd,
            prd_median=float(np.median(prd_per)),
            prd_per_sample=prd_per,
            qs_per_sample=cr / prd_per,
        )

    for r in results.values():
        print(
            f"{r.label}: MSE {r.mse:.6f}  median RMSE {r.rmse_median:.6f} "
            f"[{np.percentile(r.rmse_per_sample, 25):.6f}-{np.percentile(r.rmse_per_sample, 75):.6f}]  "
            f"median QS {r.qs_median:.6f}"
        )

    if plot_dir is not None:
        _plot_boxes(results, plot_dir)
        _plot_local_error(results, beats, pred, plot_dir)
    return results


def _plot_boxes(results: Dict[str, MethodResult], plot_dir: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plot_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(10, 7))
    data = [r.rmse_per_sample for r in results.values()]
    ax.boxplot(data, vert=False, showfliers=False)
    ax.set_yticklabels([r.label for r in results.values()])
    for i, r in enumerate(results.values(), start=1):
        ax.plot([r.rmse_mean, r.rmse_mean], [i - 0.3, i + 0.3], "r--", linewidth=1.5)
    ax.set_xlabel("RMSE")
    ax.grid(True, linestyle="--", alpha=0.6)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "rmse_boxplots.png"), dpi=200)
    plt.close(fig)


def _plot_local_error(results, beats, trad_pred, plot_dir: str) -> None:
    """Median local error figure (analysis_...:263-389 capability)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ecg_median = np.median(beats, axis=0)
    err = trad_pred - beats
    med = np.median(err, axis=0)
    q1, q3 = np.percentile(err, 25, axis=0), np.percentile(err, 75, axis=0)
    x = np.arange(beats.shape[1]) * 2

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True, height_ratios=[0.4, 1])
    ax1.plot(x, med, color="red", linewidth=2, label="Median Error")
    ax1.fill_between(x, q1, q3, color="red", alpha=0.3, label="IQR")
    ax1.set_ylabel("Discrepancy")
    ax1.grid(True)
    ax1.legend()
    ax2.plot(x, ecg_median, color="black", linewidth=2)
    ax2.fill_between(x, ecg_median + np.minimum(0, med), ecg_median + np.maximum(0, med), color="red", alpha=0.3)
    ax2.set_xlabel("Time (ms)")
    ax2.set_ylabel("Amplitude")
    ax2.grid(True)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "analysis_local_error_ae_classic.svg"), format="svg")
    plt.close(fig)
