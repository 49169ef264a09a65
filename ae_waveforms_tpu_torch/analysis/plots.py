"""Host-side plotting helpers (the port's copy of the JAX package's
``analysis/plots.py``; reference: custom_plots.py:6-37 and the figure hooks
in median_sample.py:85-122 / features_ecg.py:5-53).

Matplotlib is imported lazily, with the Agg backend, inside each function:
headless runs never touch a display, and importing this module needs no
matplotlib.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["plot_rmse_distribution", "plot_median_beat", "plot_qc_grid", "plot_fiducials"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_rmse_distribution(avg_rmse: float, rmse_values: np.ndarray, results_dir: str) -> str:
    """Violin plot of per-sample RMSE with the mean marked; saved at dpi 400
    as RMSE_distribution.png (custom_plots.py:34-35 contract)."""
    plt = _plt()
    try:
        import seaborn as sns

        plt.figure(figsize=(8, 3))
        sns.violinplot(data=rmse_values, orient="h", color="skyblue", inner="quart", linewidth=1.5)
    except ImportError:
        plt.figure(figsize=(8, 3))
        plt.violinplot(rmse_values, vert=False)
    plt.axvline(avg_rmse, color="red", linestyle="--", label=f"Avg RMSE = {avg_rmse:.4f}")
    plt.xlabel("RMSE")
    plt.ylabel("Sample Density")
    plt.title("Distribution of RMSE Values")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.tight_layout()
    out = os.path.join(results_dir, "RMSE_distribution.png")
    plt.savefig(out, dpi=400, transparent=True)
    plt.close()
    return out


def plot_qc_grid(
    samples: np.ndarray,
    peak_lists,
    metric_values: np.ndarray,
    metric_name: str,
    out_path: str,
    n_panels: int = 28,
    sort_by: str = "largest",
) -> str:
    """Diagnostic grid of windows with their R peaks and a QC metric
    (capability twin of remove_samples.py plot_error :167-202)."""
    plt = _plt()
    order = np.argsort(-metric_values) if sort_by == "largest" else np.argsort(metric_values)
    if sort_by == "evenly":
        order = np.argsort(metric_values)[np.linspace(0, len(metric_values) - 1, n_panels, dtype=int)]
    idxs = order[:n_panels]
    rows = int(np.ceil(len(idxs) / 4))
    fig, axes = plt.subplots(rows, 4, figsize=(25, 13 * rows / 7))
    for ax, i in zip(np.ravel(axes), idxs):
        ax.plot(samples[i], color="black")
        pk = np.asarray(peak_lists[i], int)
        ax.scatter(pk, samples[i][pk], color="green", marker="o")
        ax.set_title(f"{metric_name}: {metric_values[i]:.4f}")
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_fiducials(
    ecg_sample: np.ndarray, fiducials: dict, out_path: str, fs: int = 500
) -> str:
    """Waveform with fiducial markers (capability twin of
    features_ecg.py plot_ecg_features :5-53)."""
    plt = _plt()
    t = np.arange(len(ecg_sample)) / fs
    plt.figure(figsize=(20, 6))
    plt.plot(t, ecg_sample, color="black", linewidth=1)
    for name, idxs in fiducials.items():
        arr = np.asarray(idxs, float)
        valid = arr[~np.isnan(arr)].astype(int)
        if len(valid):
            plt.scatter(t[valid], ecg_sample[valid], s=40, edgecolors="black",
                        label=name.replace("ECG_", "").replace("_", " "))
    plt.xlabel("Time (s)")
    plt.ylabel("ECG Amplitude")
    plt.legend(loc="upper right", fontsize=8)
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(out_path, dpi=150)
    plt.close()
    return out_path


def plot_median_beat(beat: np.ndarray, out_path: str, fs: int = 500) -> str:
    plt = _plt()
    t = (np.arange(len(beat)) - len(beat) // 3) / fs * 1000
    plt.figure(figsize=(10, 4))
    plt.plot(t, beat, color="black")
    plt.xlabel("Time (ms)")
    plt.ylabel("Amplitude")
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(out_path, dpi=200)
    plt.close()
    return out_path
