"""The GBT fit's split epilogue (``ops/gbt_split.py``) on the CPU.

``split_level_reference``, the kernel's oracle, is held exactly to a plain
loop over every (fit, node, feature, bin) written here with Python integers
and floats: the sibling subtraction and prefix sums in integers, each gain
in float64 operations in the fit's order, the first of equal gains, the
heap slots and the leaf sums.  The cases cover nodes where nothing is
feasible, exact ties (empty bins between bins), gamma pruning, depth limits
below the level, dropped columns and two-byte bins.  ``split_level``'s
argument checks raise ``ValueError`` before anything runs.

``level_inputs`` builds a level's inputs from rows routed at random, with
the histogram kernel's plain version; the card tests use it too.
"""

import math

import numpy as np
import pytest
import torch

from ae_waveforms_tpu_torch.ops.gbt_hist import fixed_point_shift, left_histograms_fixed_reference
from ae_waveforms_tpu_torch.ops.gbt_split import LAMBDA as LAM, split_level, split_level_reference


def level_inputs(S, n, F, n_bins, depth, *, seed=0, mcw=(1.0, 4.0), gamma=(0.0, 0.5), ties=False, limits=None,
                 zero=0.3, dev="cpu"):
    """One level's arguments for ``split_level``, made on ``dev``: the
    histogram kernel's sums ``q`` of rows spread at random over the
    level's nodes and the last level's node histograms ``parent``, with
    per-fit gammas and min_child_weights drawn from the given ranges.
    ``ties`` keeps every row in even bins, so odd bins are empty and their
    prefix sums tie with the bin before; ``zero`` is the share of rows with
    no weight; ``limits`` the fits' depth limits: depth + 1 by default,
    0, 1, 2, ... depth + 1 over and over where "cycle"."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    bins = rng.integers(0, n_bins, size=(F, n))
    if ties:
        bins -= bins % 2
    binsT = t(bins.astype(np.int32))
    keep = (rng.random((S, n)) >= zero).astype(np.float32)
    g = t((rng.standard_normal((S, n)) * keep).astype(np.float32))
    h = t((rng.uniform(0, 1, (S, n)) * keep).astype(np.float32))
    shift = fixed_point_shift(g, h)
    n_nodes = 2**depth
    half = max(n_nodes // 2, 1)
    up = t(rng.integers(0, half, size=(S, n)).astype(np.int32))  # each row's node at the last level
    node_of = (2 * up + t(rng.integers(0, 2, size=(S, n)).astype(np.int32))) if depth else torch.zeros_like(up)
    q = left_histograms_fixed_reference(binsT, g, h, node_of, shift, half=half, n_bins=n_bins)
    parent = left_histograms_fixed_reference(binsT, g, h, 2 * up, shift, half=half, n_bins=n_bins) if depth else None
    col = rng.random((S, F)) < 0.8
    col[:, 0] |= ~col.any(1)
    return dict(
        q=q, parent=parent, shift=shift, gammas=t(rng.uniform(*gamma, S).astype(np.float32)),
        min_child_weights=t(rng.uniform(*mcw, S).astype(np.float32)), col=t(col),
        depth_limits=t(np.full(S, depth + 1) if limits is None else np.arange(S) % (depth + 2)),
        heap=tuple(torch.zeros((S, 2 * n_nodes), dtype=d, device=dev) for d in (torch.int32, torch.int32, torch.bool)),
    )


def plain_split(a, depth, n_bins, last):
    """The level fit by fit and node by node in Python integers and floats:
    (best, bf, bb, do_split, heap slots, node histograms or leaf sums)."""
    B = n_bins
    S, _, FB = a["q"].shape
    F = FB // B
    n_nodes = 2**depth
    half = max(n_nodes // 2, 1)
    q = a["q"].tolist()
    parent = a["parent"].tolist() if depth else None
    col = a["col"].tolist()
    out = {k: [[None] * n_nodes for _ in range(S)] for k in ("best", "bf", "bb", "do_split", "hist_g", "hist_h", "sums")}
    for s in range(S):
        scale = 2.0 ** -int(a["shift"][s])
        gam, mcw = float(a["gammas"][s]), float(a["min_child_weights"][s])
        for k in range(n_nodes):
            j = k // 2
            Gn, Hn = q[s][j], q[s][half + j]
            if k % 2:
                Gn = [p - v for p, v in zip(parent[s][j], Gn)]
                Hn = [p - v for p, v in zip(parent[s][half + j], Hn)]
            best_v, best_i, prefix = -math.inf, 0, []
            for f in range(F):
                tg, th = sum(Gn[f * B:(f + 1) * B]), sum(Hn[f * B:(f + 1) * B])
                col_ok = col[s][f]
                G, H = float(tg) * scale, float(th) * scale
                lg = lh = 0
                for b in range(B):
                    lg, lh = lg + Gn[f * B + b], lh + Hn[f * B + b]
                    prefix.append((lg, lh, tg, th))
                    GL, HL = float(lg) * scale, float(lh) * scale
                    GR, HR = float(tg - lg) * scale, float(th - lh) * scale
                    gain = 0.5 * (GL * GL / (HL + LAM) + GR * GR / (HR + LAM) - G * G / (H + LAM)) - gam
                    ok = HL >= mcw and HR >= mcw and col_ok and b < B - 1
                    v = gain if ok else -math.inf
                    if v > best_v:
                        best_v, best_i = v, f * B + b
            split = best_v > 0.0 and depth < int(a["depth_limits"][s])
            bf, bb = divmod(best_i, B)
            at = best_i if split else bf * B + B - 1
            for key, v in (("best", best_i), ("bf", bf), ("bb", bb), ("do_split", split), ("hist_g", Gn),
                           ("hist_h", Hn), ("sums", [*prefix[at][:2], *prefix[bf * B + B - 1][:2]])):
                out[key][s][k] = v
    got = dict(best=torch.tensor(out["best"]), bf=torch.tensor(out["bf"], dtype=torch.int32),
               bb=torch.tensor(out["bb"], dtype=torch.int32), do_split=torch.tensor(out["do_split"]))
    split = got["do_split"]
    got["heap"] = (torch.where(split, got["bf"], 0), torch.where(split, got["bb"], 0), split)
    if last:
        got["leaf_sums"] = torch.tensor(out["sums"])
    else:
        got["hist"] = torch.cat([torch.tensor(out["hist_g"]), torch.tensor(out["hist_h"])], 1).view(S, 2 * n_nodes, FB)
    return got


def assert_level_equal(level, heap, want, depth):
    """Every output of a level bit for bit: the level's heap slots, the
    slots outside the level left as they were (zero), and the node
    histograms or the leaf sums."""
    n_nodes = 2**depth
    for got, slots in zip(heap, want["heap"]):
        got = got.cpu()
        assert torch.equal(got[:, n_nodes - 1:2 * n_nodes - 1], slots)
        assert not got[:, :n_nodes - 1].any() and not got[:, 2 * n_nodes - 1:].any()
    if "leaf_sums" in want:
        assert level.hist is None and torch.equal(level.leaf_sums.cpu(), want["leaf_sums"])
    else:
        assert level.leaf_sums is None and torch.equal(level.hist.cpu(), want["hist"])


# (S, n, F, n_bins, depth, case): the root, deeper levels, many features,
# two-byte bins, one fit on few rows, and the edge cases
CASES = [
    (3, 300, 4, 16, 0, "plain"), (3, 300, 4, 16, 2, "plain"), (2, 400, 3, 8, 3, "plain"),
    (2, 200, 35, 8, 1, "plain"), (1, 500, 2, 300, 1, "plain"), (1, 20, 3, 16, 3, "plain"),
    (3, 300, 4, 16, 2, "infeasible"), (3, 300, 4, 16, 2, "ties"), (3, 300, 4, 16, 2, "gamma"),
    (4, 300, 4, 16, 2, "limits"),
]
VARIANTS = {"plain": {}, "infeasible": dict(mcw=(1e9, 2e9)), "ties": dict(ties=True, mcw=(0.0, 0.0)),
            "gamma": dict(gamma=(1.0, 4.0)), "limits": dict(limits="cycle")}


@pytest.mark.parametrize("last", [False, True], ids=["inner", "last"])
@pytest.mark.parametrize("S,n,F,n_bins,depth,case", CASES)
def test_reference_matches_a_plain_loop(S, n, F, n_bins, depth, case, last):
    a = level_inputs(S, n, F, n_bins, depth, seed=depth * 7 + F, **VARIANTS[case])
    level = split_level_reference(**a, depth=depth, n_bins=n_bins, last=last)
    want = plain_split(a, depth, n_bins, last)
    assert_level_equal(level, a["heap"], want, depth)
    split = want["do_split"]
    if case == "infeasible":  # nothing feasible: best 0, no split
        assert not split.any() and not want["best"].any()
    elif case == "ties":  # empty odd bins: a tie with the even bin before, which wins
        assert (want["bb"][split] % 2 == 0).all() and split.any()
    elif case == "gamma":  # some nodes pruned by gamma alone
        assert split.any() and not split.all()
    elif case == "limits":  # fits at their depth limit split nothing
        below = a["depth_limits"] <= depth
        assert not split[below].any() and split[~below].any()


def test_split_level_runs_the_reference_on_the_cpu():
    a = level_inputs(3, 300, 4, 16, 2, seed=5)
    b = {k: v.clone() if isinstance(v, torch.Tensor) else tuple(x.clone() for x in v) for k, v in a.items()}
    got = split_level(**a, depth=2, n_bins=16, last=False)
    want = split_level_reference(**b, depth=2, n_bins=16, last=False)
    assert got.leaf_sums is None and want.leaf_sums is None
    for x, y in zip((got.hist, *a["heap"]), (want.hist, *b["heap"])):
        assert torch.equal(x, y)


def test_split_level_writes_a_row_view_of_the_ensemble_heaps():
    a = level_inputs(3, 300, 4, 16, 2, seed=6)
    ens = tuple(torch.zeros((3, 4, 8), dtype=x.dtype) for x in a["heap"])
    split_level(**{**a, "heap": tuple(x[:, 2] for x in ens)}, depth=2, n_bins=16, last=True)
    want = plain_split(a, 2, 16, True)["heap"]
    assert want[2].any()
    for x, slots in zip(ens, want):
        assert torch.equal(x[:, 2, 3:7], slots) and not x[:, [0, 1, 3]].any() and not x[:, 2, [0, 1, 2, 7]].any()


def test_split_level_raises_on_unsupported_input():
    a = level_inputs(2, 100, 3, 16, 1, seed=1)
    kw = dict(depth=1, n_bins=16, last=False)
    bad = [
        dict(q=a["q"].double()),  # dtype
        dict(q=a["q"][:, :1]),  # shape
        dict(q=a["q"][..., :-1]),  # not a whole number of features
        dict(parent=None),  # the last level's histograms are needed below the root
        dict(parent=a["parent"][:, :, :16]),
        dict(shift=a["shift"].long()),
        dict(gammas=a["gammas"].double()),
        dict(min_child_weights=a["min_child_weights"][:1]),
        dict(col=a["col"].int()),
        dict(col=a["col"][:, :2]),
        dict(depth_limits=a["depth_limits"].int()),
        dict(shift=a["shift"].to("meta")),  # device
        dict(q=a["q"].to("meta"), parent=a["parent"].to("meta")),  # neither CUDA nor CPU
        dict(heap=a["heap"][:2]),
        dict(heap=(a["heap"][0][:, :2], *a["heap"][1:])),  # too short for the level
        dict(heap=(a["heap"][0].t().contiguous().t(), *a["heap"][1:])),  # column stride
        dict(heap=(a["heap"][0].long(), *a["heap"][1:])),
    ]
    for change in bad:
        with pytest.raises(ValueError):
            split_level(**{**a, **change}, **kw)
    with pytest.raises(ValueError):
        split_level(**a, depth=1, n_bins=0, last=False)
    with pytest.raises(ValueError):
        split_level(**a, depth=-1, n_bins=16, last=False)
