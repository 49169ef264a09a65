"""A stratified train/test split equal to scikit-learn's.

``train_test_split(X, y, test_size=..., stratify=y, random_state=seed)``
picks its rows with ``StratifiedShuffleSplit``; the DL classifier's seeds
(main_dl_classify.py) and the combined-feature AUC draw their splits that
way.  The machine with the card has no scikit-learn, so the port keeps its
own copy of that draw: the same ``RandomState(seed)`` calls in the same
order (the class counts of each side by ``_approximate_mode``, its ties
broken by the stream; one permutation of each class; a permutation of the
train rows, then of the test rows), so the rows picked are sklearn 1.x's
exactly.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

__all__ = ["stratified_split_indices", "train_test_split"]


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """Rows drawn from each class: the floored proportional share, then one
    more for the classes with the largest remainders, ties drawn from
    ``rng`` (sklearn.utils.extmath._approximate_mode)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split_indices(y, test_size: float, random_state: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train rows, test rows) of one stratified shuffle split of the
    labels ``y`` with a float ``test_size`` in (0, 1)."""
    y = np.asarray(y)
    n = len(y)
    if not 0 < test_size < 1:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the train set would be empty")
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError(f"The least populated classes in y have only 1 member: {classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) need at least one row of each of {len(classes)} "
                         "classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[int] = []
    test: List[int] = []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(*arrays, test_size: float = 0.25, stratify=None, random_state: int = 0):
    """``sklearn.model_selection.train_test_split`` with ``stratify`` given:
    each array's train rows, then its test rows."""
    if stratify is None:
        raise ValueError("only the stratified split is ported; pass stratify=y")
    train, test = stratified_split_indices(stratify, test_size, random_state)
    out = []
    for a in arrays:
        a = np.asarray(a)
        out += [a[train], a[test]]
    return out
