"""The port's classify harness (on the CPU) against the JAX package's, and
its ROC-AUC and precision against ``sklearn.metrics``.

The per-seed fits run at subsample = colsample = 1, where no random mask
enters, so the two packages grow the same trees and the per-seed AUCs agree
to 1e-4.  The grid search's candidates subsample, so its best score is held
to 0.05, JAX's own bar between its sequential and vectorized searches
(tests/test_gbt_multi.py:56-68).
"""

import csv

import numpy as np
import pytest
import sklearn.metrics
import torch

from ae_waveforms_tpu.classify import harness as jh
from ae_waveforms_tpu.classify.lhs import generate_lhs_params as jax_generate_lhs_params
from ae_waveforms_tpu.classify.lhs import lhs_param_dicts as jax_lhs_param_dicts
from ae_waveforms_tpu_torch.classify import harness as th
from ae_waveforms_tpu_torch.classify.lhs import generate_lhs_params, lhs_param_dicts

PARAMS = dict(max_depth=3, learning_rate=0.3, n_estimators=10, gamma=0.0, min_child_weight=1.0,
              subsample=1.0, colsample_bytree=1.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these fits issue thousands of tiny CPU ops, and
    with one thread per core in every test worker the parallel regions
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _latents(n_per=260, F=10, seed=0):
    rng = np.random.default_rng(seed)
    control = rng.standard_normal((n_per, F)).astype(np.float32)
    sick = (rng.standard_normal((n_per, F)) + 0.5 * (np.arange(F) < 3)).astype(np.float32)
    return control, sick


def test_lhs_and_data_helpers_match_jax():
    assert lhs_param_dicts(12, random_state=1) == jax_lhs_param_dicts(12, random_state=1)
    assert generate_lhs_params(5, random_state=3) == jax_generate_lhs_params(5, random_state=3)
    control, sick = _latents()
    for kw in ({}, dict(cap=200, test_size=40)):
        got, want = th.prepare_class_data(control, sick, **kw), jh.prepare_class_data(control, sick, **kw)
        for name in ("control_train", "sick_train", "X_test", "y_test"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    ids = np.arange(520) * 3
    wanted = np.random.default_rng(1).choice(ids, 100, replace=False)
    feats = np.concatenate([control, sick])
    np.testing.assert_array_equal(th.select_by_ids(ids, feats, wanted), jh.select_by_ids(ids, feats, wanted))
    # the JAX grid search's folds (classify/harness.py:124-127)
    want_folds = np.array_split(np.random.default_rng(7).permutation(301), 3)
    for got, want in zip(th.cv_folds(301, 3, 7), want_folds, strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_roc_auc_and_precision_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 301)
    scores = np.round(rng.random(301) * 20) / 20 + 0.2 * y  # many ties
    assert abs(th.roc_auc_score(y, scores) - sklearn.metrics.roc_auc_score(y, scores)) <= 1e-6
    # batched on padded rows, as the vectorized grid search scores folds
    S, m = 4, 120
    s = rng.integers(0, 15, size=(S, m)).astype(np.float32)
    lab = rng.integers(0, 2, size=(S, m))
    valid = np.arange(m)[None, :] < np.array([[120], [77], [100], [31]])
    got = th._roc_auc_device(torch.from_numpy(s), torch.from_numpy(lab), torch.from_numpy(valid)).numpy()
    want = [sklearn.metrics.roc_auc_score(lab[i, valid[i]], s[i, valid[i]]) for i in range(S)]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    pred = (scores > 0.5).astype(int)
    assert abs(th.precision_score(y, pred) - sklearn.metrics.precision_score(y, pred)) <= 1e-6
    assert th.precision_score(y, np.zeros_like(y)) == sklearn.metrics.precision_score(y, np.zeros_like(y), zero_division=0)
    with pytest.raises(ValueError, match="one class"):
        th.roc_auc_score(np.ones(5), np.arange(5))


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], dtype=np.float64)


def test_size_seed_sweep_and_ppv_match_jax(tmp_path):
    data = th.prepare_class_data(*_latents(), test_size=60)
    jdata = jh.prepare_class_data(*_latents(), test_size=60)
    kw = dict(sizes=[50, 150], n_seeds=3, vectorized=True)
    recs, summary = th.size_seed_sweep(data, PARAMS, out_dir=str(tmp_path / "port"), device="cpu", **kw)
    jrecs, jsummary = jh.size_seed_sweep(jdata, PARAMS, out_dir=str(tmp_path / "jax"), **kw)
    assert [(r["size"], r["seed"]) for r in recs] == [(r["size"], r["seed"]) for r in jrecs]
    np.testing.assert_allclose([r["auc"] for r in recs], [r["auc"] for r in jrecs], atol=1e-4, rtol=0)
    for name in ("individual_aucs.csv", "summary_auc_by_size.csv"):
        cols, got = _read_csv(tmp_path / "port" / name)
        jcols, want = _read_csv(tmp_path / "jax" / name)
        assert cols == jcols and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())

    got = th.ppv_analysis(data, PARAMS, size=150, n_seeds=3, vectorized=True, device="cpu")
    want = jh.ppv_analysis(jdata, PARAMS, size=150, n_seeds=3, vectorized=True)
    np.testing.assert_allclose(got["aucs"], want["aucs"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["ppvs"], want["ppvs"], atol=1e-4, rtol=0)
    assert got.keys() == want.keys() and got["size"] == want["size"] == 150
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        th.ppv_analysis(data, PARAMS, size=150, n_seeds=3, vectorized=True, mesh=object(), device="cpu")


def test_sequential_paths_run_on_the_port_classifier():
    data = th.prepare_class_data(*_latents(120), test_size=30)
    got = th.ppv_analysis(data, PARAMS, size=60, n_seeds=2, device="cpu")
    want = jh.ppv_analysis(jh.prepare_class_data(*_latents(120), test_size=30), PARAMS, size=60, n_seeds=2)
    np.testing.assert_allclose(got["aucs"], want["aucs"], atol=1e-4, rtol=0)
    X = np.concatenate([data.control_train, data.sick_train])
    y = np.concatenate([np.zeros(len(data.control_train)), np.ones(len(data.sick_train))])
    gs = th.grid_search_cv(X, y, n_candidates=1, random_state=4, device="cpu")
    assert gs["best_params"] == lhs_param_dicts(1, random_state=4)[0] and 0.5 < gs["best_score"] <= 1.0


def test_vectorized_grid_search_matches_jax():
    control, sick = _latents(150)
    X = np.concatenate([control, sick])
    y = np.concatenate([np.zeros(150), np.ones(150)])
    # two depth <= 6 candidates, (6, 300 trees) and (2, 50 trees): one bucket
    got = th.grid_search_cv(X, y, n_candidates=2, random_state=10, vectorized=True, device="cpu")
    want = jh.grid_search_cv(X, y, n_candidates=2, random_state=10, vectorized=True)
    assert got["best_params"] in jax_lhs_param_dicts(2, random_state=10)
    assert abs(got["best_score"] - want["best_score"]) <= 0.05
