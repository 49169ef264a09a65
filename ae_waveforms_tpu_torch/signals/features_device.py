"""Batched device computation of the 35-column feature rows: the counterpart
of the JAX package's ``signals/features_jax.py``, fed by
``signals.delineate_device``.

Per window: relative (x, y) of the ten fiducials against each beat's R
peak, the 15 morphology intervals and prominences, and nanmedians over
beats (a sort with NaN at +inf and the mean of the two middle values, as
numpy's), in the np_features column order.
"""

from __future__ import annotations

from typing import Dict

import torch

from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES
from ae_waveforms_tpu_torch.signals.qc import div, masked_median

__all__ = ["feature_rows_batch"]


def _nanmedian(v: torch.Tensor) -> torch.Tensor:
    """np.nanmedian over the last axis (NaN where all are NaN)."""
    return masked_median(v, ~torch.isnan(v), dim=-1)


def _nanmax2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """np.nanmax of two arrays elementwise (NaN only where both are)."""
    m = torch.maximum(torch.nan_to_num(a, nan=float("-inf")), torch.nan_to_num(b, nan=float("-inf")))
    return torch.where(torch.isnan(a) & torch.isnan(b), float("nan"), m)


def feature_rows_batch(samples: torch.Tensor, peaks: torch.Tensor, n_peaks: torch.Tensor,
                       fiducials: Dict[str, torch.Tensor], fs: int = 500) -> torch.Tensor:
    """(B, T) windows, (B, K) R peaks and the ten (B, K) fiducial arrays ->
    (B, 35) float32 feature rows."""
    x = samples.to(torch.float32)
    B, T = x.shape
    K = peaks.shape[1]
    peaks = peaks.to(torch.int64)
    beat_valid = (torch.arange(K, device=x.device)[None, :] < n_peaks[:, None]) & (peaks >= 0)
    r_idx = peaks.clamp(0, T - 1)
    r_amp = torch.gather(x, 1, r_idx)

    fid = torch.stack([fiducials[name] for name in FIDUCIAL_NAMES], dim=1)  # (B, 10, K)
    ii = torch.nan_to_num(fid).to(torch.int64).clamp(0, T - 1)
    xs = div(fid - r_idx.to(torch.float32)[:, None, :], float(fs)) * 1000.0
    ys = torch.gather(x, 1, ii.reshape(B, -1)).reshape(B, 10, K) - r_amp[:, None, :]
    bad = torch.isnan(fid) | ~beat_valid[:, None, :]
    xs = torch.where(bad, float("nan"), xs)
    ys = torch.where(bad, float("nan"), ys)

    f = {name[len("ECG_"):]: i for i, name in enumerate(FIDUCIAL_NAMES)}
    rx = torch.where(beat_valid, 0.0, float("nan"))  # the R peak injected at (0, 0)
    ry = rx

    def X(name):
        return rx if name == "R" else xs[:, f[name]]

    def Y(name):
        return ry if name == "R" else ys[:, f[name]]

    morph = [
        X("P_Offsets") - X("P_Onsets"),  # P duration
        rx - X("R_Onsets"),  # Q duration
        X("S_Peaks") - X("Q_Peaks"),  # R duration
        X("R_Offsets") - rx,  # S duration
        X("T_Offsets") - X("T_Onsets"),  # T duration
        rx - X("P_Onsets"),  # PR interval
        X("R_Offsets") - X("R_Onsets"),  # QRS complex
        X("T_Offsets") - X("R_Offsets"),  # ST interval
        X("T_Onsets") - X("R_Offsets"),  # ST segment
        X("T_Offsets") - X("R_Onsets"),  # QT interval
        Y("P_Peaks") - _nanmax2(Y("P_Onsets"), Y("P_Offsets")),  # P prominence
        Y("Q_Peaks") - Y("R_Onsets"),  # Q prominence
        ry - _nanmax2(Y("Q_Peaks"), Y("S_Peaks")),  # R prominence
        Y("S_Peaks") - Y("R_Offsets"),  # S prominence
        Y("T_Peaks") - _nanmax2(Y("T_Onsets"), Y("T_Offsets")),  # T prominence
    ]
    pairs = torch.stack([xs, ys], dim=2).reshape(B, 20, K)  # x, y of each fiducial in turn
    return _nanmedian(torch.cat([pairs, torch.stack(morph, dim=1)], dim=1))
