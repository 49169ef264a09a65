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
from ae_waveforms_tpu_torch.ops.gbt_route import route_rows


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
    assert route_rows.launches == 0  # CPU tensors run the plain version


def test_route_rows_no_split_descends_left_spine():
    bins, node, bf, bb, _ = _case(np.random.default_rng(3), n=400, F=10, S=3, n_nodes=4)
    got = _port_route(bins, node, bf, bb, np.zeros((3, 4), bool))
    assert np.array_equal(got, 2 * node)


def test_route_rows_level_slices_of_a_tree_heap():
    # predict_margin hands the kernel column slices of (T, max_nodes) heaps
    bins, node, bf, bb, do = _case(np.random.default_rng(4), n=200, F=6, S=7, n_nodes=16)
    heap = lambda a: np.concatenate([np.zeros_like(a[:, :15]), a, np.zeros_like(a[:, :1])], 1)  # noqa: E731
    t = torch.from_numpy
    got = route_rows(t(np.ascontiguousarray(bins.T)), t(node), t(heap(bf))[:, 15:31],
                     t(heap(bb))[:, 15:31], t(heap(do))[:, 15:31]).numpy()
    assert np.array_equal(got, _port_route(bins, node, bf, bb, do))


def test_predict_matches_jax_gbt():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 10)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.standard_normal(300) > 0).astype(np.float32)
    jclf = JaxGBTClassifier(max_depth=3, n_estimators=10, random_state=0).fit(X, y)
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
    m = predict_margin(clf._ens, bins, 3).numpy()
    np.testing.assert_allclose(m, np.asarray(jax_predict_margin(ens, jnp.asarray(jbins), 3)), atol=1e-5, rtol=0)
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
    assert route_rows.launches == 0 and (clf.predict(X) == y).mean() > 0.9
