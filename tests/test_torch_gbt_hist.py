"""The port's GBT histograms (plain versions, on the CPU) against the JAX
package's histogram kernel and its XLA oracle.

The port's float32 histograms are exact sums rounded once, so they are
held to the JAX float32 paths at the JAX kernel's own bar (atol 1e-4,
rtol 1e-5, tests/test_gbt_pallas.py).  The fixed-point histograms are
integers: the kernel's plain version and the float64 plain version are
compared exactly after scaling back, and integer identities exactly.

The kernel's layout is held here too: ``pack_bins`` round-trips,
``hist_plan``'s tiles and cluster slices cover every output cell and every
row exactly once within a block's shared memory, and a fit on packed bins
equals the fit on the unpacked ones.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.ops.gbt_hist_pallas import left_histograms as jax_left_histograms
from ae_waveforms_tpu.ops.gbt_hist_pallas import left_histograms_xla, onehot_int8
from ae_waveforms_tpu_torch.classify import gbt
from ae_waveforms_tpu_torch.ops import gbt_hist
from ae_waveforms_tpu_torch.ops.gbt_hist import (
    fixed_point_shift,
    hist_plan,
    left_histograms,
    left_histograms_fixed,
    left_histograms_reference,
    pack_bins,
    pow2,
)


def _case(half, n_bins, S=5, n=700, F=10):
    rng = np.random.default_rng(half * 1000 + n_bins)
    bins = rng.integers(0, n_bins, size=(n, F)).astype(np.int32)
    g = rng.standard_normal((S, n)).astype(np.float32)
    h = rng.uniform(0, 1, (S, n)).astype(np.float32)
    node = rng.integers(0, 2 * half, size=(S, n)).astype(np.int32)
    return bins, g, h, node


def _port(fn, bins, g, h, node, **kw):
    t = torch.from_numpy
    return fn(t(np.ascontiguousarray(bins.T)), t(g), t(h), t(node), **kw).numpy()


@pytest.mark.parametrize("half,n_bins", [(1, 64), (8, 64), (16, 32), (4, 256)])
def test_left_histograms_match_jax(half, n_bins):
    bins, g, h, node = _case(half, n_bins)
    kw = dict(half=half, n_bins=n_bins)
    xla = np.asarray(left_histograms_xla(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(node), **kw))
    oh8 = onehot_int8(jnp.asarray(bins), n_bins)
    kernel = np.asarray(jax.vmap(
        lambda gg, hh, nn: jax_left_histograms(oh8, gg, hh, nn, interpret=True, precision="float32", **kw)
    )(jnp.asarray(g), jnp.asarray(h), jnp.asarray(node)))
    ref = _port(left_histograms_reference, bins, g, h, node, **kw)
    fixed = _port(left_histograms, bins, g, h, node, **kw)
    assert ref.shape == fixed.shape == xla.shape and ref.dtype == fixed.dtype == np.float32
    for got in (ref, fixed):
        np.testing.assert_allclose(got, xla, atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(got, kernel.reshape(xla.shape), atol=1e-4, rtol=1e-5)
    # both are exact sums rounded once to float32
    assert np.array_equal(ref, fixed)
    assert left_histograms_fixed.launches == 0  # CPU tensors run the plain version


def test_fixed_point_sums_are_exact_integers():
    bins, g, h, node = _case(4, 64)
    t = torch.from_numpy
    binsT = t(np.ascontiguousarray(bins.T))
    shift = fixed_point_shift(t(g), t(h))
    q = left_histograms_fixed(binsT, t(g), t(h), t(node), shift, half=4, n_bins=64)
    assert q.dtype == torch.int64 and q.shape == (5, 8, 640)
    # every feature sees each row once: per (fit, child) the F totals agree
    totals = q.view(5, 8, 10, 64).sum(-1)
    assert torch.equal(totals, totals[:, :, :1].expand_as(totals))
    # and equal the child's rows' rounded values summed directly
    scale = pow2(shift)[:, None]
    qg = torch.round(t(g).double() * scale).long()
    for c in range(4):
        rows = t(node) == 2 * c
        assert torch.equal(totals[:, c, 0], (qg * rows).sum(1))


def test_fixed_point_shift_keeps_sums_in_range():
    n = 1000
    g = torch.full((2, n), 0.999, dtype=torch.float32)
    g[1] = -3.5e4  # a large sample weight
    h = g.abs() / 4
    shift = fixed_point_shift(g, h)
    binsT = torch.zeros((3, n), dtype=torch.int32)
    node = torch.zeros((2, n), dtype=torch.int32)
    q = left_histograms_fixed(binsT, g, h, node, shift, half=1, n_bins=8)
    assert (q[:, 0, 0].abs() < 2**62).all() and (q[:, 0, 0].abs() >= 2**52).all()
    got = (q[:, 0, 0].double() * pow2(-shift)).numpy()
    np.testing.assert_allclose(got, [float(np.float32(0.999)) * n, -3.5e4 * n], rtol=1e-12)


def test_rows_outside_the_level_add_nothing():
    bins, g, h, node = _case(2, 16)
    node[:, :100] = -1  # no node
    node[:, 100:200] = 7  # a right child
    node[:, 200:300] = 8  # a left child beyond half
    bins[300:400, 3] = 16  # a bin beyond n_bins
    got = _port(left_histograms, bins, g, h, node, half=2, n_bins=16)
    ref = _port(left_histograms_reference, bins[300:], g[:, 300:], h[:, 300:], node[:, 300:], half=2, n_bins=16)
    np.testing.assert_array_equal(got, ref)
    # feature 3 lost the rows whose bin is out of range; feature 0 kept them
    H = got[:, 2:].reshape(5, 2, 10, 16).sum(-1)
    lost = h[:, 300:400] * (node[:, 300:400] < 4) * (node[:, 300:400] % 2 == 0)
    np.testing.assert_allclose(H[:, :, 0].sum(1) - H[:, :, 3].sum(1), lost.sum(1), rtol=1e-4)


def test_wrappers_raise_on_unsupported_input():
    bins, g, h, node = _case(1, 64, S=2, n=50)
    t = torch.from_numpy
    binsT = t(np.ascontiguousarray(bins.T))
    shift = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        left_histograms_fixed(binsT, t(g).double(), t(h), t(node), shift, half=1, n_bins=64)
    with pytest.raises(ValueError):
        left_histograms_fixed(binsT, t(g), t(h), t(node)[:1], shift, half=1, n_bins=64)
    with pytest.raises(ValueError):
        left_histograms_fixed(binsT, t(g), t(h), t(node), shift.long(), half=1, n_bins=64)
    with pytest.raises(ValueError):
        left_histograms(binsT, t(g), t(h), t(node), half=0, n_bins=64)
    with pytest.raises(ValueError):
        left_histograms(binsT.to("meta"), t(g), t(h), t(node), half=1, n_bins=64)


def _unpack_bins(packed, F, n_bins):
    """``pack_bins``' (n, W) rows back to (F, n) int32 bins, the sentinel
    kept as 255 (65535): the bins as the kernel reads them."""
    es = 1 if n_bins <= 255 else 2
    return sum(packed[:, k : F * es : es].int() << (8 * k) for k in range(es)).T.contiguous()


@pytest.mark.parametrize("F,n_bins", [(10, 64), (10, 255), (10, 256), (17, 64), (9, 4000)])
def test_pack_bins_round_trips(F, n_bins):
    rng = np.random.default_rng(F * n_bins)
    binsT = torch.from_numpy(rng.integers(-3, n_bins + 3, size=(F, 101)).astype(np.int32))
    packed = pack_bins(binsT, n_bins)
    es = 1 if n_bins <= 255 else 2
    assert packed.dtype == torch.uint8 and packed.shape == (101, math.ceil(F * es / 16) * 16)
    sentinel = 255 if es == 1 else 65535
    want = torch.where((binsT >= 0) & (binsT < n_bins), binsT, sentinel)
    assert torch.equal(_unpack_bins(packed, F, n_bins), want)
    assert not packed[:, F * es:].any()  # the padding is zero
    with pytest.raises(ValueError):
        pack_bins(binsT, 65536)


# clusters of C blocks of the kernel's layout that an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters, printed by chip_smoke.py)
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15}

# (S, n, F, n_bins, half): the fit's shapes, two-byte bins, features beyond
# one 16-byte word, one pair of bins per tile, and rows fewer than blocks
PLAN_SHAPES = [(96, 12000, 10, 64, 16), (24, 12000, 10, 64, 256), (6, 12000, 10, 64, 1), (25, 12500, 10, 64, 64),
               (1, 37, 10, 300, 2), (5, 3000, 10, 300, 4), (3, 1000, 30, 64, 8), (2, 500, 10, 13247, 1),
               (4, 100, 3, 5000, 16), (2, 5, 10, 64, 4)]


@pytest.mark.parametrize("S,n,F,n_bins,half", PLAN_SHAPES)
def test_hist_plan_covers_every_cell_and_row_once(S, n, F, n_bins, half):
    plan = hist_plan(S, n, F, n_bins, half, H100_ACTIVE)
    C, NT, FT = plan.cluster, plan.node_tile, plan.feature_tile
    assert C in (1, 2, 4, 8) and plan.threads == 1024
    assert plan.smem_bytes <= 227 * 1024 and NT * FT * n_bins <= gbt_hist.MAX_CELLS
    assert 1 <= NT <= half and 1 <= FT <= F
    n_ftiles = math.ceil(F / FT)
    assert plan.walks == math.ceil(half / NT) * n_ftiles and plan.clusters == S * plan.walks
    # the kernel's split: tile -> (c0, f0); block r of a cluster -> pairs
    # [P*r/C, P*(r+1)/C) of the tile's P = NT*FT, all bins of each
    covered = np.zeros((half, F, n_bins), np.int64)
    pairs = NT * FT
    for tile in range(plan.walks):
        c0, f0 = tile // n_ftiles * NT, tile % n_ftiles * FT
        for r in range(C):
            p = np.arange(pairs * r // C, pairs * (r + 1) // C)
            jl, fl = p // FT, p % FT
            ok = (c0 + jl < half) & (f0 + fl < F)
            np.add.at(covered, (c0 + jl[ok], f0 + fl[ok]), 1)
    assert (covered == 1).all()
    rows = np.concatenate([np.arange(n * r // C, n * (r + 1) // C) for r in range(C)])
    assert np.array_equal(rows, np.arange(n))


# (S, half, cards' clusters at once, C): the largest cluster size at which
# every cluster runs in one wave; C = 1 beyond one wave even so
@pytest.mark.parametrize("S,half,active,C", [
    (96, 16, H100_ACTIVE, 1), (25, 16, H100_ACTIVE, 4), (25, 64, H100_ACTIVE, 1),
    (6, 1, H100_ACTIVE, 8), (6, 16, H100_ACTIVE, 8), (6, 256, H100_ACTIVE, 1),
    (36, 16, H100_ACTIVE, 2), (200, 1, H100_ACTIVE, 1),
    (15, 1, {1: 114, 2: 57, 4: 28, 8: 14}, 4),
])
def test_hist_plan_takes_the_largest_cluster_of_one_wave(S, half, active, C):
    plan = hist_plan(S, 12000, 10, 64, half, active)
    assert plan.cluster == C
    assert plan.clusters <= active[C] or C == 1


def test_hist_plan_refuses_bins_beyond_shared_memory():
    hist_plan(1, 100, 10, gbt_hist.MAX_CELLS, 1, H100_ACTIVE)
    with pytest.raises(ValueError):
        hist_plan(1, 100, 10, gbt_hist.MAX_CELLS + 1, 1, H100_ACTIVE)


def test_packed_bins_give_the_same_histograms():
    bins, g, h, node = _case(4, 300)
    bins[:50, 2] = 300  # outside [0, n_bins): the sentinel
    t = torch.from_numpy
    binsT = t(np.ascontiguousarray(bins.T))
    shift = fixed_point_shift(t(g), t(h))
    kw = dict(half=4, n_bins=300)
    want = left_histograms_fixed(binsT, t(g), t(h), t(node), shift, **kw)
    packed = pack_bins(binsT, 300)
    got = left_histograms_fixed(_unpack_bins(packed, 10, 300), t(g), t(h), t(node), shift, **kw)
    assert torch.equal(got, want)  # the sentinel adds nothing, as a bin out of range does
    assert torch.equal(left_histograms_fixed(binsT, t(g), t(h), t(node), shift, packed=packed, **kw), want)
    with pytest.raises(ValueError):  # packed for one-byte bins
        left_histograms_fixed(binsT, t(g), t(h), t(node), shift, packed=pack_bins(binsT, 64), **kw)
    with pytest.raises(ValueError):  # not uint8
        left_histograms_fixed(binsT, t(g), t(h), t(node), shift, packed=pack_bins(binsT, 300).int(), **kw)


@pytest.mark.parametrize("n_bins", [64, 300])
def test_fit_with_packed_bins_equals_fit_without(n_bins, monkeypatch):
    rng = np.random.default_rng(n_bins)
    X = rng.standard_normal((400, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.standard_normal(400) > 0).astype(np.float32)
    bins = gbt.bin_data(torch.from_numpy(X), torch.from_numpy(gbt.compute_bin_edges(X, n_bins)))
    weights = (rng.random((3, 400)) < 0.7).astype(np.float32)
    hp = ([0.3] * 3, [0.0] * 3, [1.0] * 3, [0.8] * 3, [0.8] * 3, [6] * 3)

    def fit():
        return gbt.fit_gbt_sweep_margins(bins, y, weights, np.arange(3), *hp, max_depth=4, n_estimators=6,
                                         n_bins=n_bins)

    without = fit()

    def on_packed(binsT, *args, n_bins, packed, **kw):  # every level on the bins as the kernel reads them
        assert packed is None  # the CPU's plain version reads binsT
        bins = _unpack_bins(pack_bins(binsT, n_bins), binsT.shape[0], n_bins)
        return left_histograms_fixed(bins, *args, n_bins=n_bins, **kw)

    monkeypatch.setattr(gbt, "left_histograms_fixed", on_packed)
    with_packed = fit()
    for a, b in zip((*with_packed[0], with_packed[1]), (*without[0], without[1])):
        assert torch.equal(a, b)
