"""Auxiliary QC/diagnostic helpers (capability twins of the unused-but-
present helpers in remove_samples.py: sd_filter :124, calculate_entropy
:135, autocorrelation :145; the plot_error diagnostic grid lives in
analysis.plots.plot_qc_grid).  The port's own copy of the JAX package's
``signals/qc_extras.py``."""

from __future__ import annotations

import numpy as np
from scipy.stats import entropy as _entropy

__all__ = ["sd_filter", "calculate_entropy", "autocorrelation"]


def sd_filter(samples: np.ndarray, threshold: float = 39.0) -> set:
    """Indices of windows whose per-window standard deviation exceeds the
    threshold."""
    return set(np.where(np.std(samples, axis=1) > threshold)[0])


def calculate_entropy(signal: np.ndarray, num_bins: int = 100) -> float:
    """Shannon entropy (bits) of the binned amplitude distribution."""
    hist, _ = np.histogram(signal, bins=num_bins, density=True)
    hist = hist[hist > 0]
    return float(_entropy(hist, base=2))


def autocorrelation(signal_data: np.ndarray) -> np.ndarray:
    """Normalised autocorrelation, positive lags only."""
    n = len(signal_data)
    ac = np.correlate(signal_data, signal_data, mode="full")
    ac = ac / ac.max()
    return ac[n - 1 :]
