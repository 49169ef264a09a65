"""The port's GBT histograms (plain versions, on the CPU) against the JAX
package's histogram kernel and its XLA oracle.

The port's float32 histograms are exact sums rounded once, so they are
held to the JAX float32 paths at the JAX kernel's own bar (atol 1e-4,
rtol 1e-5, tests/test_gbt_pallas.py).  The fixed-point histograms are
integers: the kernel's plain version and the float64 plain version are
compared exactly after scaling back, and integer identities exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.ops.gbt_hist_pallas import left_histograms as jax_left_histograms
from ae_waveforms_tpu.ops.gbt_hist_pallas import left_histograms_xla, onehot_int8
from ae_waveforms_tpu_torch.ops.gbt_hist import (
    fixed_point_shift,
    left_histograms,
    left_histograms_fixed,
    left_histograms_reference,
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
