"""The trainer's data order, worked out from the seed: the patient-level
split (a categorical draw per unique case id from the legacy global
``np.random`` stream seeded with the run's seed, functions_ae/load_data.py)
and then the first epoch's permutation of the training rows."""

from __future__ import annotations

import numpy as np


def split_rows(case_ids: np.ndarray, seed: int, val_fraction: float, test_fraction: float):
    """(indices of the training rows in the data set, indices of the
    validation rows, the first epoch's permutation of the training rows)."""
    rs = np.random.RandomState(seed)
    train_fraction = round(1.0 - val_fraction - test_fraction, 2)
    unique = np.unique(case_ids)
    assignment = rs.choice(["train", "val", "test"], size=len(unique), p=[train_fraction, val_fraction, test_fraction])
    train = np.nonzero(np.isin(case_ids, unique[assignment == "train"]))[0]
    val = np.nonzero(np.isin(case_ids, unique[assignment == "val"]))[0]
    return train, val, rs.permutation(len(train))


def train_rows_and_order(case_ids: np.ndarray, seed: int, val_fraction: float, test_fraction: float):
    """(indices of the training rows in the data set, the first epoch's
    permutation of them)."""
    train, _, order = split_rows(case_ids, seed, val_fraction, test_fraction)
    return train, order
