"""Non-overlapping window segmentation (reference: sample_from_record.py:4-40).

Pure reshape: a record of T samples yields floor(T / W) windows of
W = fs * sample_length samples, plus the end index of each window.  The
port's own copy of the JAX package's ``signals/segment.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def segment_record(
    record: np.ndarray,
    sampling_frequency: int = 500,
    sample_length: int = 20,
) -> Tuple[np.ndarray, np.ndarray]:
    """Slice a (T,) or (T, n_tracks) record into non-overlapping windows.

    Returns
    -------
    samples : (n, W) or (n, W, n_tracks)
    indices : (n, 1) int — sample-end indices (exclusive), matching the
        reference's ``indices_samples`` contract.
    """
    W = int(sampling_frequency * sample_length)
    squeeze = record.ndim == 1
    if squeeze:
        record = record[:, None]
    n = record.shape[0] // W
    samples = record[: n * W].reshape(n, W, record.shape[1])
    indices = (np.arange(1, n + 1) * W).reshape(n, 1)
    if squeeze:
        samples = samples[:, :, 0]
    return samples, indices
