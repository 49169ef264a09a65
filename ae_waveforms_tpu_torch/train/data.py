"""Dataset splits and the wave layout (the port of the JAX package's
``train/data.py``; reference: functions_ae/load_data.py).

Patient-level splits: every unique case id is assigned to train/val/test by
a seeded categorical draw (load_data.py:137-143); split masks are cached as
``indices_{split}_{yymmdd}.npy`` in the dataset dir, re-used on later runs,
copied into the run's results dir, and per-split subject-id CSVs are written
(:161-196).  ``nr_train_ids`` optionally subsamples the training case ids.
Every draw comes from the legacy global ``np.random`` stream, as in the JAX
package, so a seeded run gives the same masks and files there and here.

Batches are gathered on the device from device-resident arrays (see
``train/loop.py``); ``WaveDataset`` is the per-item view beside that path,
a ``torch.utils.data.Dataset`` over the same numpy rows.
"""

from __future__ import annotations

import glob
import os
import re
import time
from typing import Optional, Tuple

import numpy as np
from torch.utils.data import Dataset

__all__ = ["draw_split_masks", "split_datasets", "save_subject_ids", "layout_waves", "WaveDataset"]


def draw_split_masks(
    case_ids: np.ndarray,
    val_fraction: float,
    test_fraction: float,
    nr_train_ids: int = 0,
) -> dict:
    """One patient-level split draw from the CURRENT global ``np.random``
    state: a categorical choice per unique case id (load_data.py:137-143),
    then the optional ``nr_train_ids`` subsample (:121-126)."""
    train_fraction = round(1.0 - val_fraction - test_fraction, 2)
    unique_ids = np.unique(case_ids)
    assignment = np.random.choice(
        ["train", "val", "test"], size=len(unique_ids),
        p=[train_fraction, val_fraction, test_fraction],
    )
    masks = {s: np.isin(case_ids, unique_ids[assignment == s])
             for s in ("train", "val", "test")}
    if nr_train_ids and nr_train_ids > 0 and len(unique_ids) > nr_train_ids:
        selected = np.random.choice(unique_ids, size=nr_train_ids, replace=False)
        masks["train"] = masks["train"] & np.isin(case_ids, selected)
    return masks


def split_datasets(
    info: np.ndarray,
    dataset_dir: str,
    results_dir: Optional[str] = None,
    val_fraction: float = 0.2,
    test_fraction: float = 0.1,
    nr_train_ids: int = 0,
    regex_rule: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Boolean masks (train, val, test) over rows of ``info`` (N, 2).

    ``regex_rule`` optionally restricts every split to rows whose case id
    matches the pattern (load_data.py:146-153)."""
    case_ids = info[:, 0]
    patterns = {s: os.path.join(dataset_dir, f"indices_{s}_*.npy") for s in ("train", "val", "test")}
    cached = {s: sorted(glob.glob(p)) for s, p in patterns.items()}

    if all(cached.values()):
        masks = {s: np.load(cached[s][0]) for s in cached}
    else:
        # nr_train_ids stays below: it applies to cached masks too, and its
        # draw follows the assignment draw in the global stream
        masks = draw_split_masks(case_ids, val_fraction, test_fraction)
        stamp = time.strftime("%y%m%d")
        os.makedirs(dataset_dir, exist_ok=True)
        for s in masks:
            np.save(os.path.join(dataset_dir, f"indices_{s}_{stamp}"), masks[s])

    if regex_rule is not None:
        pattern = re.compile(regex_rule)
        matched = np.array([bool(pattern.match(str(c))) for c in case_ids])
        for s in masks:
            masks[s] = masks[s] & matched

    if nr_train_ids and nr_train_ids > 0:
        unique_ids = np.unique(case_ids)
        if len(unique_ids) > nr_train_ids:
            selected = np.random.choice(unique_ids, size=nr_train_ids, replace=False)
            masks["train"] = masks["train"] & np.isin(case_ids, selected)

    if results_dir is not None:
        os.makedirs(results_dir, exist_ok=True)
        stamp = time.strftime("%y%m%d")
        for s in masks:
            np.save(os.path.join(results_dir, f"indices_{s}_{stamp}"), masks[s])
        for s, label in (("train", "training"), ("val", "validation"), ("test", "testing")):
            save_subject_ids(case_ids[masks[s]], label, results_dir)

    return masks["train"], masks["val"], masks["test"]


def save_subject_ids(subject_ids: np.ndarray, dataset: str, results_dir: str) -> None:
    """Per-split subject-id CSV (load_data.py:185-196 contract)."""
    ids, counts = np.unique(subject_ids, return_counts=True)
    with open(os.path.join(results_dir, f"subject_ids_used_in_{dataset}.csv"), "wt") as f:
        f.write("chart_names, counts\n")
        for a, b in zip(ids, counts):
            f.write(f"{a}, {b}\n")


def layout_waves(waves: np.ndarray, channel_first: bool) -> np.ndarray:
    """(N, 320) -> (N, 1, 320) for conv models, (N, 320, 1) for recurrent
    (load_data.py:35-46 swap_dim)."""
    return waves[:, None, :] if channel_first else waves[:, :, None]


class WaveDataset(Dataset):
    """Array-backed dataset view (capability twin of the reference's torch
    ``Datasets`` class, load_data.py:14-70): flag-mask selection, layout
    control, y == x autoencoder targets, (x, y, f, c) item tuples, and the
    patient-demographics accessor.  Items are the numpy rows, as the JAX
    package's view returns them; a ``DataLoader`` collates them into
    tensors."""

    def __init__(self, waves, features, info, flag=None, channel_first: bool = True):
        if flag is not None:
            waves, features, info = waves[flag], features[flag], info[flag]
        self.wave = layout_waves(np.asarray(waves, np.float32), channel_first)
        self.features = np.asarray(features, np.float32)
        self.info = np.asarray(info)
        self.y = self.wave  # autoencoder target

    def __len__(self) -> int:
        return len(self.info)

    def __getitem__(self, index):
        return self.wave[index], self.y[index], self.features[index], self.info[index]

    def get_yvals(self):
        return self.y

    def get_patient_demographics(self):
        """Per-patient mean of the feature columns keyed by case id
        (load_data.py:66-70 capability; the reference assumes demographic
        columns, here it is the generic per-id aggregation).  Needs
        pandas."""
        import pandas as pd

        ids = self.info[:, 0]
        df = pd.DataFrame(self.features)
        df.insert(0, "id", ids)
        return df.groupby("id").mean().reset_index()
