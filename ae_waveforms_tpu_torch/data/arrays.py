"""Array builder (reference: data_create_arrays.py:9-58; the port's own copy
of the JAX package's ``data/arrays.py``).

Stacks per-case extraction results into the three judged arrays:
np_waves (N, 320) float32, np_features (N, 35), np_info (N, 2) where
info = [case_id, window_end_index].
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ae_waveforms_tpu_torch.core.schema import ArraySet
from ae_waveforms_tpu_torch.data.extract import CaseResult

__all__ = ["build_arrays"]


def build_arrays(cases: Sequence[CaseResult]) -> ArraySet:
    total = sum(len(c.waves) for c in cases)
    waves = np.zeros((total, 320), np.float32)
    features = np.zeros((total, 35))
    info = np.zeros((total, 2))
    i = 0
    for c in cases:
        n = len(c.waves)
        waves[i : i + n] = c.waves
        features[i : i + n] = c.features
        info[i : i + n, 0] = c.case_id
        info[i : i + n, 1] = c.indices
        i += n
    return ArraySet(waves=waves, features=features, info=info)
