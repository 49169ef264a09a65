"""sklearn HistGradientBoostingClassifier adapter for the classify harness
(the port's own copy of the JAX package's ``classify/sklearn_gbt.py``).

Purpose: an INDEPENDENT C++-core GBDT that can be plugged into the exact
same evaluation procedure (grid search, size x seed sweep, PPV analysis) as
the port's GBT (``backend="sklearn"``), so the north-star hypokalaemia PPV
metric (analysis_PPV_hypokalaemia.py:95-110) can be A/B'd across
implementations.  sklearn is imported only when the adapter is built:
nothing on the harness's default path needs it.

Parameter mapping from the harness's xgboost-style dicts
(functions_ml/latin_hypercube_sampling.py grid):

- ``max_depth``, ``learning_rate`` map directly;
- ``n_estimators`` -> ``max_iter``;
- ``min_child_weight`` (a hessian mass bound) -> ``min_samples_leaf``:
  for binary log-loss each sample's hessian is at most 1/4, so a leaf
  needs >= 4*w samples before its hessian can reach w — the closest
  count-based analog sklearn exposes;
- ``gamma``, ``subsample``, ``colsample_bytree`` have no
  HistGradientBoosting equivalent and are accepted but ignored (documented
  A/B caveat: sklearn candidates differ only along the mappable axes).
"""

from __future__ import annotations

__all__ = ["SklearnGBTClassifier"]


class SklearnGBTClassifier:
    """fit/predict_proba-compatible stand-in for ``classify.gbt.GBTClassifier``."""

    def __init__(
        self,
        max_depth: int = 6,
        learning_rate: float = 0.3,
        n_estimators: int = 100,
        gamma: float = 0.0,
        min_child_weight: float = 1.0,
        subsample: float = 1.0,
        colsample_bytree: float = 1.0,
        random_state: int = 0,
        device=None,  # the port GBT's device; sklearn runs on the host
    ):
        from sklearn.ensemble import HistGradientBoostingClassifier

        self._m = HistGradientBoostingClassifier(
            max_depth=int(max_depth),
            learning_rate=float(learning_rate),
            max_iter=int(n_estimators),
            min_samples_leaf=max(1, int(round(4 * float(min_child_weight)))),
            l2_regularization=0.0,
            max_bins=255,
            early_stopping=False,
            random_state=int(random_state),
        )

    def fit(self, X, y):
        self._m.fit(X, y)
        return self

    def predict_proba(self, X):
        return self._m.predict_proba(X)
