"""Array contracts (the port's own copy of the JAX package's
``core/schema.py``).

The parity surface of the whole pipeline is three arrays
(reference: data_create_arrays.py:17-21, :56-58):

- ``np_waves``    (N, 320) float32   median beat per 20-s sample
- ``np_features`` (N, 35)  float64   10 fiducial (x, y) pairs + 15 morphology
- ``np_info``     (N, 2)   float64   [case_id, sample_end_index]

Feature column order (reference: data_extract_vitaldb.py:109-116 and
data_create_arrays.py:34-45): the 10 fiducial dict columns each contribute
(x, y) giving columns 0..19 in the order
P_Peaks, P_Onsets, P_Offsets, Q_Peaks, R_Onsets, R_Offsets, S_Peaks,
T_Peaks, T_Onsets, T_Offsets; columns 20..34 are the morphology medians
P/Q/R/S/T_Duration, PR_Interval, QRS_Complex, ST_Interval, ST_Segment,
QT_Interval, P/Q/R/S/T_Prominence.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

FIDUCIAL_NAMES = (
    "ECG_P_Peaks",
    "ECG_P_Onsets",
    "ECG_P_Offsets",
    "ECG_Q_Peaks",
    "ECG_R_Onsets",
    "ECG_R_Offsets",
    "ECG_S_Peaks",
    "ECG_T_Peaks",
    "ECG_T_Onsets",
    "ECG_T_Offsets",
)

MORPHOLOGY_NAMES = (
    "ECG_P_Duration",
    "ECG_Q_Duration",
    "ECG_R_Duration",
    "ECG_S_Duration",
    "ECG_T_Duration",
    "ECG_PR_Interval",
    "ECG_QRS_Complex",
    "ECG_ST_Interval",
    "ECG_ST_Segment",
    "ECG_QT_Interval",
    "ECG_P_Prominence",
    "ECG_Q_Prominence",
    "ECG_R_Prominence",
    "ECG_S_Prominence",
    "ECG_T_Prominence",
)

N_FEATURES = 2 * len(FIDUCIAL_NAMES) + len(MORPHOLOGY_NAMES)  # 35
BEAT_LENGTH = 320


@dataclass
class ArraySet:
    waves: np.ndarray  # (N, 320) float32
    features: np.ndarray  # (N, 35)
    info: np.ndarray  # (N, 2)

    def __post_init__(self):
        n = len(self.waves)
        assert self.waves.shape == (n, BEAT_LENGTH), self.waves.shape
        assert self.features.shape == (n, N_FEATURES), self.features.shape
        assert self.info.shape == (n, 2), self.info.shape

    def __len__(self) -> int:
        return len(self.waves)


def save_arrays(arrays: ArraySet, directory: str, allow_pickle: bool = True) -> None:
    os.makedirs(directory, exist_ok=True)
    np.save(os.path.join(directory, "np_waves.npy"), arrays.waves.astype(np.float32), allow_pickle=allow_pickle)
    np.save(os.path.join(directory, "np_features.npy"), arrays.features, allow_pickle=allow_pickle)
    np.save(os.path.join(directory, "np_info.npy"), arrays.info, allow_pickle=allow_pickle)


def load_arrays(directory: str, mmap: bool = True) -> ArraySet:
    """Load the three .npy files (reference: functions_ae/load_data.py:73-94)."""
    mode = "r" if mmap else None
    return ArraySet(
        waves=np.load(os.path.join(directory, "np_waves.npy"), mmap_mode=mode),
        features=np.load(os.path.join(directory, "np_features.npy"), mmap_mode=mode),
        info=np.load(os.path.join(directory, "np_info.npy"), mmap_mode=mode),
    )
