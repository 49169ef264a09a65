"""Build the handcrafted-feature matrices consumed by the feature
classifier (main_ml_classify.py's ``*_features*.npy`` inputs); the port's
own copy of the JAX package's ``classify/feature_export.py``.

The stored 11-column layout (main_ml_classify.py:18-30 name list, with
T Duration at column 5 — deleted again at fit time, :110):
P Duration, PR Interval, QRS Complex, ST Interval, ST Segment, T Duration,
P/Q/R/S/T Prominence — mapped from the np_features 35-column schema.
"""

from __future__ import annotations

import numpy as np

from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES, MORPHOLOGY_NAMES

__all__ = ["HANDCRAFTED_COLUMNS", "export_handcrafted_features"]

_MORPH_BASE = 2 * len(FIDUCIAL_NAMES)  # 20


def _col(name: str) -> int:
    return _MORPH_BASE + MORPHOLOGY_NAMES.index(name)


HANDCRAFTED_COLUMNS = [
    _col("ECG_P_Duration"),
    _col("ECG_PR_Interval"),
    _col("ECG_QRS_Complex"),
    _col("ECG_ST_Interval"),
    _col("ECG_ST_Segment"),
    _col("ECG_T_Duration"),
    _col("ECG_P_Prominence"),
    _col("ECG_Q_Prominence"),
    _col("ECG_R_Prominence"),
    _col("ECG_S_Prominence"),
    _col("ECG_T_Prominence"),
]


def export_handcrafted_features(
    np_features: np.ndarray,
    np_info: np.ndarray,
    wanted_ids: np.ndarray,
    cap: int | None = None,
) -> np.ndarray:
    """Rows of the 11-column handcrafted matrix for the requested case ids,
    in np_features row order, optionally capped."""
    ids = np.asarray(np_info)[:, 0]
    sel = np.isin(ids, np.asarray(wanted_ids))
    out = np.asarray(np_features)[sel][:, HANDCRAFTED_COLUMNS]
    return out[:cap] if cap else out
