"""Latin-hypercube hyperparameter sampling (capability twin of
functions_ml/latin_hypercube_sampling.py:4-26); the port's own copy of the
JAX package's ``classify/lhs.py``.

Same 7-dim unit LHS (scipy qmc, a consumed dependency of the reference too)
and the same mapping onto the gradient-boosting grid: max_depth 2-10,
learning_rate 0.01-0.3, n_estimators {50..550 step 50}, gamma 0-5,
min_child_weight 1-11, subsample and colsample_bytree 0.5-1.

Note the nominal 550-tree cell is unreachable in the reference too:
``(int(s*10)+1)*50`` with s < 1 tops out at 500 — preserved exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from scipy.stats import qmc

__all__ = ["generate_lhs_params", "lhs_param_dicts"]


def generate_lhs_params(n_samples: int, random_state: Optional[int] = None) -> List[Dict[str, list]]:
    """List of single-point param grids (GridSearchCV-style), mirroring the
    reference's return contract."""
    return [{k: [v] for k, v in p.items()} for p in lhs_param_dicts(n_samples, random_state)]


def lhs_param_dicts(n_samples: int, random_state: Optional[int] = None) -> List[Dict[str, float]]:
    sampler = qmc.LatinHypercube(d=7, seed=random_state)
    sample = sampler.random(n_samples)
    out = []
    for s in sample:
        out.append(
            {
                "max_depth": int(s[0] * (10 - 2 + 1)) + 2,
                "learning_rate": 0.01 + s[1] * (0.3 - 0.01),
                "n_estimators": (int(s[2] * 10) + 1) * 50,
                "gamma": s[3] * 5,
                "min_child_weight": int(s[4] * 10) + 1,
                "subsample": 0.5 + s[5] * (1 - 0.5),
                "colsample_bytree": 0.5 + s[6] * (1 - 0.5),
            }
        )
    return out
