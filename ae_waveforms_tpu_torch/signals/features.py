"""Fiducial and morphology feature computation (the port's own copy of the
JAX package's ``signals/features.py``; numpy).

Pure array math mirroring the reference semantics:

- relative-R features (features_ecg.py:56-86): per beat, x = (idx - r_idx) /
  fs * 1000 ms and y = ecg[idx] - ecg[r_idx]; NaN where the fiducial was not
  detected.
- morphology features (features_ecg.py:89-136): 10 time intervals and 5
  prominences, with the max-of-two-baselines rule for P/R/T prominence and
  the R peak injected at (0, 0).
- medians over beats (median_sample.py:57-82): nanmedian of x and y per
  fiducial plus nanmedian of each morphology feature.

The output is the 35-column feature row of the ``np_features`` contract
(see core.schema for the column order).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence

import numpy as np

from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES, MORPHOLOGY_NAMES

__all__ = ["relative_to_r", "morphology_features", "median_feature_row"]


def relative_to_r(
    ecg: np.ndarray,
    fiducials: Dict[str, Sequence[float]],
    rpeaks: Sequence[int],
    sampling_frequency: float,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-beat (x_ms, y) of each fiducial relative to its R peak."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for feat in fiducials:
        xs: List[float] = []
        ys: List[float] = []
        for beat, r_idx in enumerate(rpeaks):
            idx = fiducials[feat][beat]
            if isinstance(idx, float) and np.isnan(idx):
                xs.append(np.nan)
                ys.append(np.nan)
            else:
                xs.append((idx - r_idx) / sampling_frequency * 1000.0)
                ys.append(float(ecg[int(idx)] - ecg[int(r_idx)]))
        out[feat] = {"x": np.asarray(xs, float), "y": np.asarray(ys, float)}
    return out


def morphology_features(
    relative: Dict[str, Dict[str, np.ndarray]], nr_of_beats: int
) -> Dict[str, np.ndarray]:
    """Clinical interval/prominence features per beat.

    Mutates ``relative`` by injecting the R peak at (0, 0), exactly like the
    reference (features_ecg.py:111).
    """
    relative["ECG_R_Peaks"] = {
        "x": np.zeros(nr_of_beats),
        "y": np.zeros(nr_of_beats),
    }

    def dt(a: str, b: str) -> np.ndarray:
        return np.asarray(relative[b]["x"]) - np.asarray(relative[a]["x"])

    def dy(peak: str, baseline) -> np.ndarray:
        if isinstance(baseline, list):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", category=RuntimeWarning)
                base = np.nanmax(
                    np.stack([relative[baseline[0]]["y"], relative[baseline[1]]["y"]]), axis=0
                )
        else:
            base = relative[baseline]["y"]
        return np.asarray(relative[peak]["y"]) - np.asarray(base)

    feats = {
        "ECG_P_Duration": dt("ECG_P_Onsets", "ECG_P_Offsets"),
        "ECG_Q_Duration": dt("ECG_R_Onsets", "ECG_R_Peaks"),
        "ECG_R_Duration": dt("ECG_Q_Peaks", "ECG_S_Peaks"),
        "ECG_S_Duration": dt("ECG_R_Peaks", "ECG_R_Offsets"),
        "ECG_T_Duration": dt("ECG_T_Onsets", "ECG_T_Offsets"),
        "ECG_PR_Interval": dt("ECG_P_Onsets", "ECG_R_Peaks"),
        "ECG_QRS_Complex": dt("ECG_R_Onsets", "ECG_R_Offsets"),
        "ECG_ST_Interval": dt("ECG_R_Offsets", "ECG_T_Offsets"),
        "ECG_ST_Segment": dt("ECG_R_Offsets", "ECG_T_Onsets"),
        "ECG_QT_Interval": dt("ECG_R_Onsets", "ECG_T_Offsets"),
        "ECG_P_Prominence": dy("ECG_P_Peaks", ["ECG_P_Onsets", "ECG_P_Offsets"]),
        "ECG_Q_Prominence": dy("ECG_Q_Peaks", "ECG_R_Onsets"),
        "ECG_R_Prominence": dy("ECG_R_Peaks", ["ECG_Q_Peaks", "ECG_S_Peaks"]),
        "ECG_S_Prominence": dy("ECG_S_Peaks", "ECG_R_Offsets"),
        "ECG_T_Prominence": dy("ECG_T_Peaks", ["ECG_T_Onsets", "ECG_T_Offsets"]),
    }
    return feats


def median_feature_row(
    relative: Dict[str, Dict[str, np.ndarray]],
    morphology: Dict[str, np.ndarray],
) -> np.ndarray:
    """The (35,) feature row: 10 x (median x, median y) then 15 morphology
    medians, in the np_features column order."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        row = []
        for name in FIDUCIAL_NAMES:
            row.append(np.nanmedian(relative[name]["x"]))
            row.append(np.nanmedian(relative[name]["y"]))
        for name in MORPHOLOGY_NAMES:
            row.append(np.nanmedian(morphology[name]))
    return np.asarray(row, float)
