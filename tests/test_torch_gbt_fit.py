"""The port's GBT fit (plain versions, on the CPU) against the JAX package.

``jax.random``'s masks cannot be drawn in torch, so each test draws the
row and column masks from ``jax.random`` exactly as the JAX fit does
(classify/gbt.py:246-253) and hands them to the port.  The trees are then
held equal (feat, thresh, is_split), leaves and margins to 5e-3, the bar
the JAX histogram kernel meets against its XLA path
(tests/test_gbt_pallas.py:66-78).

One difference is by design.  Where two candidate splits of a node have
equal gains, the port's prefix sums are exact integers, so it keeps the tie
and takes the first split, as the JAX package means to; the JAX package's
float32 prefix sums may round the tie either way.  Where the tied splits
send every weighted row the same way (no weighted row in the bins between
them), the trees still partition the training rows identically: such nodes
are allowed, and margins are compared on the rows that reach the same
leaves.  A tie between splits that send different rows with equal g and h
each way would make the two fits part from there on; the inputs here hold
none that the two packages break differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.classify import gbt as jgbt
from ae_waveforms_tpu_torch.classify import gbt
from ae_waveforms_tpu_torch.ops import _build

KW = dict(max_depth=4, n_estimators=12, learning_rate=0.2, subsample=0.9, colsample_bytree=0.9, n_bins=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these fits issue thousands of tiny CPU ops, and
    with one thread per core in every test worker the parallel regions
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task(n=900, F=10, n_bins=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.standard_normal(n) > 0).astype(np.float32)
    return jgbt.bin_data(X, jgbt.compute_bin_edges(X, n_bins)), y, rng


def _jax_masks(key, n_trees, n, F, subsample, colsample):
    """(T, n) and (T, F) masks as the JAX fit draws them from ``key``."""
    rows, cols = [], []
    for k in jax.random.split(key, n_trees):
        k_row, k_col = jax.random.split(k)
        rows.append(np.asarray(jax.random.uniform(k_row, (n,)) < subsample))
        col = np.array(jax.random.uniform(k_col, (F,)) < colsample)
        col[0] |= not col.any()
        cols.append(col)
    return np.stack(rows), np.stack(cols)


def _paths(feat, thresh, is_split, bins, depth):
    """Node id of every row at every level of one tree, (depth + 1, n)."""
    node = np.zeros(len(bins), np.int64)
    out = [node]
    for d in range(depth):
        k = 2**d - 1 + node
        right = bins[np.arange(len(bins)), feat[k]] > thresh[k]
        node = np.where(is_split[k], 2 * node + right, 2 * node)
        out.append(node)
    return np.stack(out)


def _assert_same_trees(ens, jens, bins, weights, depth, margins=None, jmargins=None):
    """Trees equal, or splitting every weighted row the same way where an
    exact tie was broken differently; leaves and margins within 5e-3.
    ``weights`` (S, T, n) are the rows' weights in each tree."""
    got = [getattr(ens, k).numpy().reshape((-1,) + ens.feat.shape[-2:]) for k in ("feat", "thresh", "is_split", "leaf")]
    want = [np.asarray(getattr(jens, k)).reshape(got[0].shape) for k in ("feat", "thresh", "is_split", "leaf")]
    weights = weights.reshape(-1, *weights.shape[-2:])
    same_leaf = np.ones((len(got[0]), bins.shape[0]), bool)
    ties = 0
    for s in range(len(got[0])):
        for t in range(got[0].shape[1]):
            a = _paths(*(x[s, t] for x in got[:3]), bins, depth)
            b = _paths(*(x[s, t] for x in want[:3]), bins, depth)
            trained = weights[s, t] > 0
            np.testing.assert_array_equal(a[:, trained], b[:, trained], err_msg=f"fit {s} tree {t}")
            same_leaf[s] &= a[-1] == b[-1]
            ties += any(not np.array_equal(x[s, t], y[s, t]) for x, y in zip(got[:3], want[:3]))
            np.testing.assert_allclose(got[3][s, t, a[-1, trained]], want[3][s, t, b[-1, trained]], atol=5e-3)
    assert ties <= max(1, got[0].size // 100), f"{ties} trees differ"
    assert same_leaf.mean() > 0.9
    if margins is not None:
        m, jm = margins.numpy().reshape(same_leaf.shape), np.asarray(jmargins).reshape(same_leaf.shape)
        np.testing.assert_allclose(m[same_leaf], jm[same_leaf], atol=5e-3)


def test_fit_margins_match_jax():
    bins, y, rng = _task()
    w = (rng.uniform(size=y.shape) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jens, jm = jgbt._fit_gbt_margins(jnp.asarray(bins), jnp.asarray(y), jnp.asarray(w), key, hist_impl="xla", **KW)
    rows, cols = _jax_masks(key, 12, len(y), 10, 0.9, 0.9)
    ens, m = gbt._fit_gbt_margins(torch.from_numpy(bins), y, w, 3, row_masks=rows, col_masks=cols, **KW)
    assert ens.feat.shape == (12, 16) and ens.feat.dtype == torch.int32 and m.dtype == torch.float32
    _assert_same_trees(ens, jens, bins, w * rows, 4, m, jm)
    # the boosting carry is the ensemble's margin of every pool row
    np.testing.assert_allclose(gbt.predict_margin(ens, torch.from_numpy(bins), 4).numpy(), m.numpy(), atol=1e-5)
    assert _build.launches["gbt_hist"] == _build.launches["gbt_route"] == 0


def _sweep_inputs(S=3):
    bins, y, rng = _task()
    ws = (rng.uniform(size=(S,) + y.shape) > 0.3).astype(np.float32)
    keys = [jax.random.PRNGKey(s) for s in range(S)]
    masks = [_jax_masks(k, 12, len(y), 10, 0.9, 0.9) for k in keys]
    return bins, y, ws, jnp.stack(keys), np.stack([m[0] for m in masks]), np.stack([m[1] for m in masks])


def test_sweep_margins_match_jax():
    bins, y, ws, keys, rows, cols = _sweep_inputs()
    hp = dict(learning_rates=np.float32([0.2, 0.3, 0.1]), gammas=np.float32([0.0, 0.5, 0.1]),
              min_child_weights=np.float32([1.0, 2.0, 1.0]), subsamples=np.full(3, 0.9, np.float32),
              colsamples=np.full(3, 0.9, np.float32), n_actives=np.int32([12, 8, 5]))
    depth_limits = np.int32([4, 2, 3])
    jens, jm = jgbt.fit_gbt_sweep_margins(
        jnp.asarray(bins), jnp.asarray(y), jnp.asarray(ws), keys, *map(jnp.asarray, hp.values()),
        max_depth=4, n_estimators=12, depth_limits=jnp.asarray(depth_limits), hist_impl="xla")
    ens, m = gbt.fit_gbt_sweep_margins(
        torch.from_numpy(bins), y, ws, [0, 1, 2], *hp.values(), max_depth=4, n_estimators=12,
        depth_limits=depth_limits, row_masks=rows, col_masks=cols)
    assert ens.feat.shape == (3, 12, 16) and m.shape == (3, len(y))
    _assert_same_trees(ens, jens, bins, ws[:, None] * rows, 4, m, jm)
    # a depth limit leaves the deeper levels unsplit; inactive trees are no-ops
    assert not ens.is_split[1, :, 3:].any() and not ens.is_split[2, :, 7:].any()
    assert not ens.leaf[1, 8:].any() and not ens.leaf[2, 5:].any()
    ens_only = gbt.fit_gbt_sweep(torch.from_numpy(bins), y, ws, [0, 1, 2], *hp.values(), max_depth=4,
                                 n_estimators=12, depth_limits=depth_limits, row_masks=rows, col_masks=cols)
    assert all(torch.equal(a, b) for a, b in zip(ens_only, ens))


def test_multi_fit_and_predict_match_jax():
    bins, y, ws, keys, rows, cols = _sweep_inputs()
    jens = jgbt.fit_gbt_multi(jnp.asarray(bins), jnp.asarray(y), jnp.asarray(ws), keys, hist_impl="xla", **KW)
    ens = gbt.fit_gbt_multi(torch.from_numpy(bins), y, ws, [0, 1, 2], row_masks=rows, col_masks=cols, **KW)
    _assert_same_trees(ens, jens, bins, ws[:, None] * rows, 4)
    got = gbt.predict_margin_multi(ens, torch.from_numpy(bins), 4)
    want = jgbt.predict_margin_multi(jens, jnp.asarray(bins), 4)
    assert got.shape == (3, len(y))
    _assert_same_trees(ens, jens, bins, ws[:, None] * rows, 4, got, want)


def test_classifier_fit_predict_matches_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((600, 10)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.standard_normal(600) > 0).astype(np.float32)
    params = dict(max_depth=3, n_estimators=10, learning_rate=0.3, min_child_weight=2.0)
    jclf = jgbt.GBTClassifier(**params, random_state=0).fit(X, y)
    clf = gbt.GBTClassifier(**params, random_state=0, device="cpu").fit(X, y)
    np.testing.assert_array_equal(clf._edges.numpy(), jclf._edges)
    Xq = rng.standard_normal((80, 10)).astype(np.float32)
    np.testing.assert_allclose(clf.predict_proba(Xq), jclf.predict_proba(Xq), atol=1e-4)
    assert clf.get_params() == jclf.get_params()


def test_counter_masks_are_reproducible_and_vary_by_tree():
    seeds = torch.tensor([0, 1, 2**40 + 7])
    a = gbt.subsample_uniforms(seeds, 3, 5000, 1)
    assert a.dtype == torch.float32 and a.shape == (3, 5000)
    assert torch.equal(a, gbt.subsample_uniforms(seeds.clone(), 3, 5000, 1))
    assert (a >= 0).all() and (a < 1).all()
    assert not torch.equal(a, gbt.subsample_uniforms(seeds, 4, 5000, 1))  # another tree
    assert not torch.equal(a, gbt.subsample_uniforms(seeds, 3, 5000, 2))  # another stream
    assert not torch.equal(a[0], a[1])  # another seed
    assert abs(float(a.mean()) - 0.5) < 0.01 and abs(float((a < 0.3).float().mean()) - 0.3) < 0.01


def test_fit_is_bit_identical_across_runs_and_drawn_masks_apply():
    bins, y, rng = _task(n=400)
    w = np.ones(len(y), np.float32)
    kw = dict(KW, subsample=0.6, colsample_bytree=0.5)
    a = gbt._fit_gbt_margins(torch.from_numpy(bins), y, w, 11, **kw)
    b = gbt._fit_gbt_margins(torch.from_numpy(bins), y, w, 11, **kw)
    assert all(torch.equal(x, z) for x, z in zip(a[0], b[0])) and torch.equal(a[1], b[1])
    full = gbt._fit_gbt_margins(torch.from_numpy(bins), y, w, 11, **dict(KW, subsample=1.0, colsample_bytree=1.0))
    assert not torch.equal(a[0].thresh, full[0].thresh)
    # a column mask keeps at least one column, so every tree may still split
    assert a[0].is_split.any(1).all()


@pytest.mark.parametrize("n_active", [0, 5])
def test_inactive_trees_are_no_ops(n_active):
    bins, y, _ = _task(n=300)
    ens, m = gbt._fit_gbt_margins(torch.from_numpy(bins), y, np.ones(len(y), np.float32), 0,
                                  n_active=n_active, **KW)
    assert not ens.leaf[n_active:].any()
    np.testing.assert_allclose(gbt.predict_margin(ens, torch.from_numpy(bins), 4).numpy(), m.numpy(), atol=1e-5)


def test_fit_calls_the_histogram_and_routing_hooks_once_a_level(monkeypatch):
    # a benchmark swaps these two module globals for recorders of exactly
    # these signatures, counts their calls to find its trees and keeps each
    # histogram call's g, h and node ids to count their rows afterwards
    hist, route = gbt.left_histograms_fixed, gbt.route_rows
    hist_calls, route_calls = [], []

    def hist_recorded(binsT, g, h, node_of, shift, *, half, n_bins, packed=None):
        hist_calls.append((half, g, h, node_of, g.clone(), h.clone(), node_of.clone()))
        return hist(binsT, g, h, node_of, shift, half=half, n_bins=n_bins, packed=packed)

    def route_recorded(binsT, node_of, bf, bb, do_split):
        route_calls.append(bf.shape)
        return route(binsT, node_of, bf, bb, do_split)

    monkeypatch.setattr(gbt, "left_histograms_fixed", hist_recorded)
    monkeypatch.setattr(gbt, "route_rows", route_recorded)
    bins, y, rng = _task(n=300)
    S, depth, trees = 3, 3, 4
    gbt.fit_gbt_sweep_margins(torch.from_numpy(bins), y, (rng.uniform(size=(S, len(y))) > 0.3).astype(np.float32),
                              [1, 2, 3], 0.3, 0.0, 1.0, 0.8, 0.8, trees, max_depth=depth, n_estimators=trees)
    assert [c[0] for c in hist_calls] == [1, 1, 2] * trees
    assert route_calls == [(S, 2**d) for d in range(depth)] * trees
    # a tree's levels share its g and h; every call has node ids of its own
    # and no tensor a call was given is written to later
    storage = lambda t: t.untyped_storage().data_ptr()  # noqa: E731
    for k, (_, g, h, node_of, g0, h0, node0) in enumerate(hist_calls):
        assert torch.equal(g, g0) and torch.equal(h, h0) and torch.equal(node_of, node0)
        first = hist_calls[k - k % depth]
        assert g is first[1] and h is first[2]
    assert len({storage(c[3]) for c in hist_calls}) == len(hist_calls)
    assert len({storage(c[1]) for c in hist_calls}) == len({storage(c[2]) for c in hist_calls}) == trees
