"""The port's GBT routing (plain version on the CPU) and GBT predict half
against the JAX package.

Routing is an integer decision, so routing is compared with EXACT equality;
margins and probabilities at 1e-5, since the trees are summed in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.classify.gbt import GBTClassifier as JaxGBTClassifier
from ae_waveforms_tpu.ops.gbt_route_pallas import _route_xla_batched
from ae_waveforms_tpu.ops.gbt_route_pallas import route_rows as jax_route_rows
from ae_waveforms_tpu_torch.bridge import gbt_from_numpy
from ae_waveforms_tpu_torch.classify.gbt import GBTClassifier, bin_data, predict_margin
from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.ops.gbt_route import (
    BLOCKS_PER_SM, SMEM_BYTES, THREADS, VEC, route_layout, route_levels, route_levels_reference, route_plan,
    route_rows, route_rows_reference, route_spans,
)


def _case(rng, n, F, S, n_nodes, n_bins=64):
    bins = rng.integers(0, n_bins, size=(n, F)).astype(np.int32)
    node = rng.integers(0, n_nodes, size=(S, n)).astype(np.int32)
    bf = rng.integers(0, F, size=(S, n_nodes)).astype(np.int32)
    bb = rng.integers(0, n_bins, size=(S, n_nodes)).astype(np.int32)
    do = rng.random((S, n_nodes)) < 0.7
    return bins, node, bf, bb, do


def _port_route(bins, node, bf, bb, do):
    t = torch.from_numpy
    return route_rows(t(np.ascontiguousarray(bins.T)), t(node), t(bf), t(bb), t(do)).numpy()


@pytest.mark.parametrize("n_nodes", [1, 2, 8, 32])
def test_route_rows_matches_jax_exactly(n_nodes):
    bins, node, bf, bb, do = _case(np.random.default_rng(n_nodes), n=300, F=10, S=5, n_nodes=n_nodes)
    binsT = jnp.asarray(bins.T.astype(np.float32))
    xla = np.asarray(_route_xla_batched(binsT, jnp.asarray(node), jnp.asarray(bf), jnp.asarray(bb),
                                        jnp.asarray(do), n_nodes))
    kernel = np.asarray(jax.vmap(
        lambda nd, f, b, d: jax_route_rows(binsT, nd, f, b, d, n_nodes=n_nodes, interpret=True)
    )(jnp.asarray(node), jnp.asarray(bf), jnp.asarray(bb), jnp.asarray(do)))
    got = _port_route(bins, node, bf, bb, do)
    assert got.dtype == np.int32 and got.shape == node.shape
    assert np.array_equal(got, xla)
    assert np.array_equal(got, kernel)
    assert _build.launches["gbt_route"] == 0  # CPU tensors run the plain version


def test_route_rows_no_split_descends_left_spine():
    bins, node, bf, bb, _ = _case(np.random.default_rng(3), n=400, F=10, S=3, n_nodes=4)
    got = _port_route(bins, node, bf, bb, np.zeros((3, 4), bool))
    assert np.array_equal(got, 2 * node)


def test_route_rows_reference_is_exact_for_any_int32():
    """Bins and thresholds anywhere in int32, past 2^23 and 2^24 where a
    float32 or a 24-bit field would merge neighbours, decide as the integer
    compare bin > threshold."""
    rng = np.random.default_rng(12)
    S, n, F, n_nodes = 4, 500, 5, 8
    edge = np.array([-2**31, -2**31 + 1, -2**24 - 1, -2**24, -2**23, -1, 0, 1, 2**23 - 1, 2**23, 2**24,
                     2**24 + 1, 2**31 - 2, 2**31 - 1], np.int64)
    bins = rng.choice(edge, size=(F, n)).astype(np.int32)
    node = rng.integers(0, n_nodes, size=(S, n)).astype(np.int32)
    bf = rng.integers(0, F, size=(S, n_nodes)).astype(np.int32)
    bb = rng.choice(edge, size=(S, n_nodes)).astype(np.int32)
    do = rng.random((S, n_nodes)) < 0.8
    t = torch.from_numpy
    got = route_rows_reference(t(bins), t(node), t(bf), t(bb), t(do)).numpy()
    right = bins[bf[np.arange(S)[:, None], node], np.arange(n)].astype(np.int64) > bb[np.arange(S)[:, None], node]
    assert np.array_equal(got, np.where(do[np.arange(S)[:, None], node], 2 * node + right, 2 * node))


def test_route_rows_level_slices_of_a_tree_heap():
    # predict_margin hands the kernel column slices of (T, max_nodes) heaps
    bins, node, bf, bb, do = _case(np.random.default_rng(4), n=200, F=6, S=7, n_nodes=16)
    heap = lambda a: np.concatenate([np.zeros_like(a[:, :15]), a, np.zeros_like(a[:, :1])], 1)  # noqa: E731
    t = torch.from_numpy
    got = route_rows(t(np.ascontiguousarray(bins.T)), t(node), t(heap(bf))[:, 15:31],
                     t(heap(bb))[:, 15:31], t(heap(do))[:, 15:31]).numpy()
    assert np.array_equal(got, _port_route(bins, node, bf, bb, do))


@pytest.mark.parametrize("D,d0,d1,from_root", [(6, 0, 6, True), (8, 0, 8, True), (6, 2, 5, False),
                                               (8, 3, 8, False), (8, 0, 4, False)])
def test_route_levels_reference_matches_jax_level_by_level(D, d0, d1, from_root):
    """Levels [d0, d1) of random depth-D heaps, from the root or from level
    d0's ids (some outside the level), equal the JAX package's routing
    applied level by level to the heap slices, exactly."""
    rng = np.random.default_rng(10 * D + d0)
    S, n, F = 7, 150, 6
    bins = rng.integers(0, 64, size=(n, F)).astype(np.int32)
    feat = rng.integers(0, F, size=(S, 2**D)).astype(np.int32)
    thresh = rng.integers(0, 64, size=(S, 2**D)).astype(np.int32)
    split = rng.random((S, 2**D)) < 0.75
    node = np.zeros((S, n), np.int32) if from_root else rng.integers(-1, 2**d0 + 1, size=(S, n)).astype(np.int32)
    want = jnp.asarray(node)
    for d in range(d0, d1):
        lo, hi = 2**d - 1, 2 ** (d + 1) - 1
        want = _route_xla_batched(jnp.asarray(bins.T.astype(np.float32)), want, jnp.asarray(feat[:, lo:hi]),
                                  jnp.asarray(thresh[:, lo:hi]), jnp.asarray(split[:, lo:hi]), hi - lo)
    t = torch.from_numpy
    args = (t(bins).T, None if from_root else t(node), t(feat), t(thresh), t(split), d0, d1)
    got = route_levels_reference(*args).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(want))
    assert np.array_equal(route_levels(*args).numpy(), got)  # CPU tensors run the plain version
    assert _build.launches["gbt_route"] == 0


def _covered(plan, S, n):
    """How often the kernel's blocks and tasks, as route_plan gives them,
    reach each flat (fit, row) index: a block's task t takes ``plan.vec``
    ids of fit t // (tile / vec) from row (t % (tile / vec)) * vec."""
    tiles = -(-n // plan.tile)
    per_fit = plan.tile // plan.vec
    hits = np.zeros(S * n, np.int64)
    for b in range(plan.blocks):
        s0, i0 = (b // tiles) * plan.chunk, (b % tiles) * plan.tile
        fits, rows = min(plan.chunk, S - s0), min(plan.tile, n - i0)
        task = np.arange(fits * per_fit)
        s, r = task // per_fit, (task % per_fit) * plan.vec
        live = r < rows
        idx = ((s0 + s) * n + i0 + r)[live][:, None] + np.arange(plan.vec)
        np.add.at(hits, idx.ravel(), 1)
    return hits


@pytest.mark.parametrize("S,n,F,levels,width", [
    (96, 12500, 10, 1, 32), (24, 12000, 10, 1, 512), (25, 12500, 10, 1, 128), (100, 64, 10, 6, 1),
    (100, 256, 10, 4, 4), (12500, 500, 10, 8, 1), (3, 1001, 10, 1, 1024), (1, 37, 3, 2, 2), (5, 3, 256, 3, 1),
    (40, 3000, 10, 13, 1),
])
def test_route_plan_covers_every_pair_once(S, n, F, levels, width):
    plan = route_plan(S, n, F, levels, width)
    resident = THREADS * BLOCKS_PER_SM * 132  # threads an H100 SXM holds at once
    small = S * n < resident
    assert plan.tile >= VEC and plan.tile & (plan.tile - 1) == 0
    # VEC ids a task: staged where the launch is not small, in place where such tasks fill the card
    assert plan.vec == (VEC if n % VEC == 0 and (not small if plan.staged else S * n >= VEC * resident) else 1)
    assert plan.threads % 32 == 0 and plan.threads <= THREADS
    assert plan.blocks == -(-S // plan.chunk) * -(-n // plan.tile)
    staged = 8 * plan.chunk * width * (2**levels - 1) + 4 * F * plan.tile
    assert plan.smem_bytes == (staged if plan.staged else 0) <= SMEM_BYTES
    # shared memory holds as many blocks on an SM as the registers allow, where one fit's tables let it
    assert plan.smem_bytes <= SMEM_BYTES // BLOCKS_PER_SM or (plan.chunk == 1 and plan.tile <= 2 * VEC)
    # one level in place where the launch is small or its table has more splits than a staged tile has rows
    staged_tile = route_layout(S, n, F, width, True, 1).tile
    assert plan.staged == (levels > 1 or (not small and width <= staged_tile))
    assert np.all(_covered(plan, S, n) == 1)


def test_route_plan_raises_where_a_table_cannot_fit():
    with pytest.raises(ValueError):  # 32,767 splits a tree: 262,136 bytes
        route_plan(10, 100, 10, 15)
    route_plan(10, 100, 10, 14)  # 16,383 splits, 131,064 bytes, fit
    assert not route_plan(10, 10**5, 10, 1, 2**16).staged  # one level of any width: in place
    with pytest.raises(ValueError):
        route_plan(10, 100, 0, 1)


@pytest.mark.parametrize("F,d0,d1", [(10, 0, 6), (10, 0, 8), (10, 0, 16), (10, 3, 20), (7000, 0, 12), (10, 5, 5)])
def test_route_spans_cover_the_levels_in_launches_that_fit(F, d0, d1):
    spans = route_spans(F, d0, d1)
    bounds = [d0] + [e for _, e in spans]  # consecutive, from d0 to d1
    assert [d for d, _ in spans] == bounds[:-1] and bounds[-1] == d1
    for d, e in spans:
        assert e > d
        if e - d > 1:  # several levels in one launch: their tables are staged, and one more would not fit
            route_plan(3, 100, F, e - d, 2**d)
        if e < d1:
            with pytest.raises(ValueError):
                route_plan(3, 100, F, e + 1 - d, 2**d)
    if F == 10 and d0 == 0:  # up to 14 levels of a tree from the root in one launch
        assert (len(spans) == 1) == (d1 <= 14)


def test_predict_matches_jax_gbt():
    _predict_against_jax(3)


def test_predict_matches_jax_gbt_at_depth_6():
    # the serving head's depth: six levels routed in one call
    _predict_against_jax(6)


def _predict_against_jax(depth):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 10)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.standard_normal(300) > 0).astype(np.float32)
    jclf = JaxGBTClassifier(max_depth=depth, n_estimators=10, random_state=0).fit(X, y)
    ens = jclf._ens
    clf = gbt_from_numpy(ens.feat, ens.thresh, ens.is_split, ens.leaf, ens.lr, jclf._edges,
                         jclf.get_params(), device="cpu")
    assert clf.get_params() == jclf.get_params()
    Xq = rng.standard_normal((50, 10)).astype(np.float32)
    bins = bin_data(torch.from_numpy(Xq), clf._edges)
    from ae_waveforms_tpu.classify.gbt import bin_data as jax_bin_data
    from ae_waveforms_tpu.classify.gbt import predict_margin as jax_predict_margin

    jbins = jax_bin_data(Xq, jclf._edges)
    assert np.array_equal(bins.numpy(), jbins)
    m = predict_margin(clf._ens, bins, depth).numpy()
    np.testing.assert_allclose(m, np.asarray(jax_predict_margin(ens, jnp.asarray(jbins), depth)), atol=1e-5, rtol=0)
    p = clf.predict_proba(Xq)
    assert p.shape == (50, 2) and p.dtype == np.float32
    np.testing.assert_allclose(p, jclf.predict_proba(Xq), atol=1e-5, rtol=0)
    assert np.array_equal(clf.predict(Xq), jclf.predict(Xq))


def test_fit_is_not_ported_yet():
    """GBTClassifier.fit runs on the CPU and its trees route the training
    rows to probabilities that separate the classes."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((200, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    clf = GBTClassifier(max_depth=2, n_estimators=5, device="cpu").fit(X, y)
    p = clf.predict_proba(X)
    assert p.shape == (200, 2) and clf._ens.feat.shape == (5, 4)
    assert _build.launches["gbt_route"] == 0 and (clf.predict(X) == y).mean() > 0.9
