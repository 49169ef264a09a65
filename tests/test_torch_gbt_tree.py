"""The GBT fit's per-tree work (``ops/gbt_tree.py``): ``tree_grad`` (K5:
masks, g, h, shifts, fresh node ids) and ``tree_leaves`` (K6: leaf weights
and the margins' step).

On the CPU the plain versions are held bit for bit to the fit's tree loop
as it was written before the kernels, kept here as the oracle
(``loop_before``: the masks' hash, the float64 sigmoid, g, h and the leaves
in torch ops inline), over subsampling, injected masks, trees past
``n_actives`` and depth limits, and to heaps held in the test.  The card
tests (marker ``cuda``; they skip without a card) hold each kernel bit for
bit to its plain version on the card, and a whole card fit to the CPU fit:
heaps, leaves and margins.
"""

import numpy as np
import pytest
import torch

from ae_waveforms_tpu_torch.classify import gbt
from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.ops.gbt_hist import fixed_point_shift, left_histograms_fixed, pow2
from ae_waveforms_tpu_torch.ops.gbt_route import route_rows
from ae_waveforms_tpu_torch.ops.gbt_split import LAMBDA, split_level
from ae_waveforms_tpu_torch.ops.gbt_tree import (
    COL_STREAM, ROW_STREAM, subsample_uniforms, tree_grad, tree_grad_reference, tree_leaves, tree_leaves_reference,
)

N_BINS = 16


def fit_inputs(case, S=3, n=150, F=5, trees=4, depth=3, seed=19):
    """A sweep fit's arguments on the CPU for ``case``: "plain" (no
    subsampling), "subsampled", "masks" (injected row and column masks,
    one tree with no column kept), "inactive" (fits whose ``n_actives``
    stop before the last tree) or "limits" (depth limits below the depth)."""
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, N_BINS, size=(n, F)).astype(np.int32))
    y = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
    w = torch.from_numpy((rng.random((S, n)) < 0.8).astype(np.float32))
    rates = 1.0 if case == "plain" else 0.7
    kw = dict(seeds=torch.tensor([3, 2**40 + 7, -5][:S], dtype=torch.int64),
              learning_rates=torch.tensor([0.3, 0.1, 0.25][:S]), gammas=torch.tensor([0.0, 0.2, 0.0][:S]),
              min_child_weights=torch.tensor([1.0, 2.0, 0.5][:S]), subsamples=torch.full((S,), rates),
              colsamples=torch.full((S,), rates), n_actives=torch.full((S,), trees, dtype=torch.int64),
              depth_limits=torch.full((S,), depth, dtype=torch.int64), row_masks=None, col_masks=None)
    if case == "masks":
        kw["row_masks"] = torch.from_numpy(rng.random((S, trees, n)) < 0.75)
        col = rng.random((S, trees, F)) < 0.6
        col[0, 1] = False
        kw["col_masks"] = torch.from_numpy(col)
    elif case == "inactive":
        kw["n_actives"] = torch.tensor([trees, 2, 1][:S], dtype=torch.int64)
    elif case == "limits":
        kw["depth_limits"] = torch.tensor([1, depth, 2][:S], dtype=torch.int64)
    return bins, y, w, kw, dict(max_depth=depth, n_estimators=trees, n_bins=N_BINS)


def loop_before(bins, y, row_weights, seeds, learning_rates, gammas, min_child_weights, subsamples, colsamples,
                n_actives, depth_limits, *, max_depth, n_estimators, n_bins, row_masks=None, col_masks=None):
    """The fit as ``classify.gbt._fit_batched`` grew it before the per-tree
    kernels: each tree's masks, g, h, shift and leaves in torch ops inline."""
    n, F = bins.shape
    S = row_weights.shape[0]
    binsT = bins.T.contiguous()
    margin = torch.full((S, n), 0.0)
    feat = torch.zeros((S, n_estimators, 2**max_depth), dtype=torch.int32)
    thresh = torch.zeros_like(feat)
    is_split = torch.zeros_like(feat, dtype=torch.bool)
    m32 = 0xFFFFFFFF

    def hash32(x):
        x = x ^ (x >> 16)
        x = (x * 0x21F0AAAD) & m32
        x = x ^ (x >> 15)
        x = (x * 0x735A2D97) & m32
        return x ^ (x >> 15)

    def uniforms(tree, count, stream):
        key = hash32(hash32((seeds.long() & m32) ^ stream) ^ (tree & m32))
        return (hash32((key[:, None] + torch.arange(count)) & m32) >> 8).float() * 2.0**-24

    leaves = []
    for t in range(n_estimators):
        sub = row_masks[:, t] if row_masks is not None else uniforms(t, n, 0x52F1) < subsamples[:, None]
        col = col_masks[:, t] if col_masks is not None else uniforms(t, F, 0xC07A) < colsamples[:, None]
        col = col | (~col.any(1, keepdim=True) & (torch.arange(F) == 0))
        active = (t < n_actives).float()[:, None]
        w = (row_weights * sub).double()
        p = torch.sigmoid(margin.double())
        g = ((p - y) * w).float()
        h = ((p * (1.0 - p)).clamp_min(1e-16) * w).float()
        shift = fixed_point_shift(g, h)
        node_of = torch.zeros((S, n), dtype=torch.int32)
        heap = (feat[:, t], thresh[:, t], is_split[:, t])
        hist = None
        for depth in range(max_depth):
            n_nodes = 2**depth
            q = left_histograms_fixed(binsT, g, h, node_of, shift, half=max(n_nodes // 2, 1), n_bins=n_bins)
            level = split_level(q, hist, shift, gammas, min_child_weights, col, depth_limits, heap, depth=depth,
                                n_bins=n_bins, last=depth == max_depth - 1)
            hist = level.hist
            node_of = route_rows(binsT, node_of, *(x[:, n_nodes - 1:2 * n_nodes - 1] for x in heap))
        left, total = level.leaf_sums.view(S, -1, 2, 2).unbind(2)
        GH = torch.stack([left, total - left], dim=2).view(S, -1, 2).double() * pow2(-shift)[:, None, None]
        wleaf = (-GH[..., 0] / (GH[..., 1] + LAMBDA)).float() * active
        margin = margin + learning_rates[:, None] * torch.gather(wleaf, 1, node_of.long())
        leaves.append(wleaf)
    return gbt.GBTEnsemble(feat, thresh, is_split, torch.stack(leaves, 1), learning_rates), margin


def assert_fits_equal(got, want):
    (ens, margin), (ens_want, margin_want) = got, want
    for name in gbt.GBTEnsemble._fields:
        a, b = getattr(ens, name), getattr(ens_want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert margin.dtype == margin_want.dtype and torch.equal(margin, margin_want)


@pytest.mark.parametrize("case", ["plain", "subsampled", "masks", "inactive", "limits"])
def test_fit_equals_the_loop_before_the_kernels(case):
    bins, y, w, kw, static = fit_inputs(case)
    got = gbt._fit_batched(bins, y, w, **kw, **static)
    assert_fits_equal(got, loop_before(bins, y, w, **kw, **static))
    assert got[0].is_split.any() and not got[0].is_split.all()
    if case == "inactive":
        assert not got[0].leaf[1, 2:].any() and not got[0].leaf[2, 1:].any() and got[0].leaf[0, 3].any()


# the heaps of ``fit_inputs("subsampled", S=2, n=120, F=4, trees=3, depth=2, seed=5)`` from the loop before the
# kernels: (S, T, 2^depth) split feature, split bin and split flag
HEAPS = dict(
    feat=[[[1, 1, 0, 0], [0, 0, 2, 0], [2, 0, 3, 0]], [[0, 2, 0, 0], [2, 0, 3, 0], [0, 2, 1, 0]]],
    thresh=[[[12, 7, 0, 0], [6, 4, 11, 0], [2, 6, 7, 0]], [[5, 7, 10, 0], [3, 6, 5, 0], [9, 11, 3, 0]]],
    is_split=[[[1, 1, 0, 0], [1, 1, 1, 0], [1, 1, 1, 0]], [[1, 1, 1, 0], [1, 1, 1, 0], [1, 1, 1, 0]]],
)


def test_fit_holds_the_heaps_of_the_loop_before_the_kernels():
    bins, y, w, kw, static = fit_inputs("subsampled", S=2, n=120, F=4, trees=3, depth=2, seed=5)
    ens, _ = gbt._fit_batched(bins, y, w, **kw, **static)
    for name, want in HEAPS.items():
        assert getattr(ens, name).int().tolist() == want, name


def grad_inputs(S, n, case, *, F=10, tree=7, seed=0, dev="cpu"):
    """``tree_grad``'s arguments for S fits of n rows: margins with some
    beyond +-37, where p (1 - p) falls below the 1e-16 floor, 0/1 row
    weights scaled at random, seeds beyond 32 bits and negative ones.
    ``case``: "plain" (no subsampling), "subsampled", "nocol" (a column
    rate so low that most fits keep no column), "masks" (injected row and
    column masks, fit 0 keeping no column) or "zero" (fit 0 weighs no row:
    its g and h are all zero)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    margin = (rng.standard_normal((S, n)) * 3).astype(np.float32)
    margin[:, :4] = [40.0, -41.5, 60.0, 0.0]
    w = ((rng.random((S, n)) < 0.67) * rng.uniform(0.5, 2, (S, n))).astype(np.float32)
    if case == "zero":
        w[0] = 0.0
    rates = np.ones(S) if case == "plain" else rng.uniform(0.5, 1, S)
    kw = dict(seeds=t(rng.integers(-2**40, 2**40, S)), subsamples=t(rates.astype(np.float32)),
              colsamples=t(np.full(S, 1e-4 if case == "nocol" else rates, np.float32)), tree=tree, n_features=F)
    if case == "masks":  # a tree's slices of (S, T, ...) masks, as the fit hands them
        kw["row_mask"] = t(rng.random((S, tree + 1, n)) < 0.7)[:, tree]
        col = rng.random((S, tree + 1, F)) < 0.5
        col[0, tree] = False
        kw["col_mask"] = t(col)[:, tree]
    return (t(margin), t((rng.random(n) < 0.5).astype(np.float32)), t(w)), kw


def leaves_inputs(S, n, depth, case, *, trees=5, seed=0, dev="cpu"):
    """``tree_leaves``' arguments at the last tree of ``trees``: leaf sums
    with 0 <= HL <= H and any sign of GL and G, shifts of 30 to 44, rows at
    random leaves.  ``case`` "inactive": about half the fits stop before
    the tree."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    L = 2**depth
    H = rng.integers(0, 2**42, (S, L // 2))
    HL = (H * rng.random((S, L // 2))).astype(np.int64)
    G, GL = rng.integers(-2**41, 2**41, (2, S, L // 2))
    n_actives = rng.integers(trees // 2, trees + 1, S) if case == "inactive" else np.full(S, trees)
    args = (t(np.stack([GL, HL, G, H], -1)), t(rng.integers(30, 45, S).astype(np.int32)),
            t(rng.uniform(0.01, 0.3, S).astype(np.float32)), t(n_actives), t(rng.integers(0, L, (S, n)).astype(np.int32)))
    margin = t(rng.standard_normal((S, n)).astype(np.float32))
    leaf = t(rng.standard_normal((S, trees, L)).astype(np.float32))
    return args, margin, leaf, trees - 1


def test_tree_grad_keeps_column_0_where_the_draw_keeps_none():
    (margin, y, w), kw = grad_inputs(6, 50, "nocol")
    col = tree_grad(margin, y, w, **kw).col
    drawn = subsample_uniforms(kw["seeds"], kw["tree"], 10, COL_STREAM) < kw["colsamples"][:, None]
    assert not drawn.any(1).all()
    assert torch.equal(col, drawn | (~drawn.any(1, keepdim=True) & (torch.arange(10) == 0)))
    (margin, y, w), kw = grad_inputs(3, 50, "masks")
    col = tree_grad(margin, y, w, **kw).col
    assert col[0].tolist() == [True] + [False] * 9 and torch.equal(col[1:], kw["col_mask"][1:] | (
        ~kw["col_mask"][1:].any(1, keepdim=True) & (torch.arange(10) == 0)))


def test_tree_grad_draws_the_rows_and_floors_h():
    (margin, y, w), kw = grad_inputs(4, 300, "zero")
    out = tree_grad(margin, y, w, **kw)
    keep = subsample_uniforms(kw["seeds"], kw["tree"], 300, ROW_STREAM) < kw["subsamples"][:, None]
    weighed = (w != 0) & keep
    assert torch.equal(out.h != 0, weighed) and not out.g[~weighed].any()
    assert out.shift[0] == 62 - (300 - 1).bit_length()  # a fit of zeros: the maximum 0 has exponent 0
    assert torch.equal(out.shift, fixed_point_shift(out.g, out.h)) and not out.node_of.any()
    at40 = weighed[:, 0]  # margin 40: p (1 - p) is below the floor
    assert at40.any() and torch.equal(out.h[at40, 0], (1e-16 * w[at40, 0].double()).float())


def test_tree_leaves_zero_an_inactive_fit_and_leave_its_margins():
    args, margin, leaf, tree = leaves_inputs(8, 40, 3, "inactive", seed=4)
    before = margin.clone()
    tree_leaves(*args, margin, leaf, tree=tree)
    inactive = args[3] <= tree
    assert inactive.any() and not inactive.all()
    assert not leaf[inactive, tree].any() and leaf[~inactive, tree].all()
    assert torch.equal(margin[inactive], before[inactive]) and not torch.equal(margin[~inactive], before[~inactive])


@pytest.mark.parametrize("change", ["margin_dtype", "y_shape", "seeds_dtype", "row_mask_dtype", "col_mask_shape",
                                    "n_features", "tree"])
def test_tree_grad_raises_on_bad_arguments(change):
    (margin, y, w), kw = grad_inputs(2, 30, "masks")
    args = dict(margin=margin, y=y, row_weights=w, **kw)
    args.update(dict(margin_dtype=dict(margin=margin.double()), y_shape=dict(y=y[:-1]),
                     seeds_dtype=dict(seeds=kw["seeds"].int()), row_mask_dtype=dict(row_mask=kw["row_mask"].float()),
                     col_mask_shape=dict(col_mask=kw["col_mask"][:, :5]), n_features=dict(n_features=0),
                     tree=dict(tree=-1))[change])
    with pytest.raises(ValueError):
        tree_grad(**args)


@pytest.mark.parametrize("change", ["sums_shape", "shift_dtype", "node_of_shape", "leaf_width", "tree",
                                    "margin_layout"])
def test_tree_leaves_raises_on_bad_arguments(change):
    (sums, shift, lr, n_actives, node_of), margin, leaf, tree = leaves_inputs(3, 20, 2, "plain")
    args = dict(leaf_sums=sums, shift=shift, learning_rates=lr, n_actives=n_actives, node_of=node_of,
                margin=margin, leaf=leaf, tree=tree)
    args.update(dict(sums_shape=dict(leaf_sums=sums[:, :1]), shift_dtype=dict(shift=shift.long()),
                     node_of_shape=dict(node_of=node_of[:, 1:]), leaf_width=dict(leaf=leaf[..., :3]),
                     tree=dict(tree=leaf.shape[1]), margin_layout=dict(margin=margin.T.contiguous().T))[change])
    with pytest.raises(ValueError):
        tree_leaves(**args)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


GRAD_CASES = [(1, 149, "plain"), (1, 149, "nocol"), (21, 12000, "subsampled"), (21, 12000, "masks"),
              (27, 12000, "plain"), (27, 12000, "zero"), (27, 12500, "nocol"), (96, 12000, "subsampled"),
              (96, 12500, "masks"), (96, 149, "zero")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,case", GRAD_CASES)
def test_grad_kernel_matches_plain_bit_for_bit(S, n, case):
    dev = _card()
    (margin, y, w), kw = grad_inputs(S, n, case, seed=S + n, dev=dev)
    before = _build.launches["gbt_grad"]
    got = tree_grad(margin, y, w, **kw)
    assert _build.launches["gbt_grad"] == before + 1
    want = tree_grad_reference(margin, y, w, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    if case == "zero":
        assert int(got.shift[0]) == 62 - (n - 1).bit_length()


LEAF_CASES = [(1, 149, 8, "plain"), (21, 12000, 10, "inactive"), (27, 12000, 6, "plain"), (27, 12500, 6, "inactive"),
              (96, 12000, 6, "plain"), (96, 149, 2, "inactive"), (25, 12500, 1, "plain")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,depth,case", LEAF_CASES)
def test_leaves_kernel_matches_plain_bit_for_bit(S, n, depth, case):
    dev = _card()
    args, margin, leaf, tree = leaves_inputs(S, n, depth, case, seed=S * depth, dev=dev)
    outs = [(margin.clone(), leaf.clone()) for _ in range(2)]
    before = _build.launches["gbt_leaves"]
    tree_leaves(*args, *outs[0], tree=tree)
    assert _build.launches["gbt_leaves"] == before + 1
    tree_leaves_reference(*args, *outs[1], tree=tree)
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    if case == "inactive":
        assert (args[3] <= tree).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["subsampled", "masks"])
def test_card_fit_equals_the_cpu_fit_with_leaves(case):
    dev = _card()
    rng = np.random.default_rng(19)
    S, n, F, depth, trees = 6, 3000, 10, 6, 12
    X = rng.standard_normal((n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 3] + rng.standard_normal(n) > 0).astype(np.float32)
    bins = gbt.bin_data(torch.from_numpy(X), torch.from_numpy(gbt.compute_bin_edges(X)))
    w = (rng.random((S, n)) < 0.7).astype(np.float32)
    hp = (rng.uniform(0.05, 0.3, S), rng.uniform(0, 2, S), rng.integers(1, 8, S).astype(np.float64),
          rng.uniform(0.5, 1, S), rng.uniform(0.5, 1, S), rng.integers(trees // 2, trees + 1, S))
    kw = dict(max_depth=depth, n_estimators=trees, depth_limits=rng.integers(2, depth + 1, S))
    if case == "masks":
        kw.update(row_masks=rng.random((S, trees, n)) < 0.8, col_masks=rng.random((S, trees, F)) < 0.3)
    before = dict(_build.launches)
    card = gbt.fit_gbt_sweep_margins(bins.to(dev), y, w, np.arange(S) + 2**35, *hp, **kw)
    launched = {k: _build.launches[k] - before[k] for k in ("gbt_grad", "gbt_leaves")}
    assert launched == {"gbt_grad": trees, "gbt_leaves": trees}
    cpu = gbt.fit_gbt_sweep_margins(bins, y, w, np.arange(S) + 2**35, *hp, **kw)
    assert_fits_equal((gbt.GBTEnsemble(*(x.cpu() for x in card[0])), card[1].cpu()), cpu)
    assert cpu[0].is_split.any() and not cpu[0].leaf[:, -1].all()
