"""Operations the GBT grid search needs for its inputs, for ``gbt_mfu``.

For each candidate and fold, each of the candidate's trees, and each of
its levels d below its depth:

- histogram adds: a g and an h add per (row at a left child, feature),
  the rows at left children taken as every kept training row at the root
  and half of them below it (the sibling's histogram is a subtraction);
- split scoring: per (node, feature, bin) two prefix-sum adds and the
  gain's ten operations (three products, three divisions, two additions,
  two subtractions);
- routing: a compare, a shift and an add per pool row.

Trees past a candidate's ``n_estimators`` and levels past its depth count
nothing: they are work the fit does that the candidate does not need.
"""

SCORE_OPS = 12
ROUTE_OPS = 3


def candidate_fold_ops(n_train: int, n_pool: int, F: int, n_bins: int, depth: int, trees: int,
                       subsample: float) -> float:
    kept = n_train * subsample
    per_tree = 0.0
    for d in range(depth):
        at_left = kept if d == 0 else kept / 2
        per_tree += 2 * F * at_left + SCORE_OPS * 2**d * F * n_bins + ROUTE_OPS * n_pool
    return per_tree * trees


def grid_search_ops(params, fold_train_rows, n_pool: int, F: int, n_bins: int) -> float:
    """Σ over candidates (LHS parameter dicts) and folds (their training row
    counts) of ``candidate_fold_ops``."""
    return sum(candidate_fold_ops(n_train, n_pool, F, n_bins, int(p["max_depth"]), int(p["n_estimators"]),
                                  float(p["subsample"]))
               for p in params for n_train in fold_train_rows)


def grid_search_trees(params, folds: int) -> int:
    """Trees a grid search grows for its candidates: Σ n_estimators x folds."""
    return folds * sum(int(p["n_estimators"]) for p in params)
