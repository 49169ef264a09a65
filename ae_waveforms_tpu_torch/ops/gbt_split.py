"""GBT split epilogue of one tree level: a CUDA kernel for Hopper and its
plain version.

For S fits at once, at a level of ``n_nodes = 2^depth`` nodes, from the
histogram kernel's exact int64 sums ``q`` (``left_histograms_fixed``, (S,
2 * half, F * B), half = max(n_nodes / 2, 1)) and the last level's node
histograms ``parent`` (the same layout, None at depth 0):

- each node's G and H histograms, exact in integers: a left child's are K1's
  sums, a right child's its parent's minus its left sibling's (right =
  parent - left); the root's are ``q`` itself;
- per feature, the prefix sums GL, HL over the bins, and GR, HR from the
  feature's totals G, H;
- the gain ``0.5 * (GL^2 / (HL + lam) + GR^2 / (HR + lam) - G^2 / (H + lam))
  - gamma`` in float64, lam being ``LAMBDA``, each int64 sum taken to
  float64 and scaled by 2^-shift, feasible where HL and HR reach
  ``min_child_weight``, the column is kept and the bin is not the last;
- the first flat index ``f * B + b`` of the largest feasible gain
  (``best``; 0 where nothing is feasible), its feature ``bf`` and bin ``bb``,
  and ``do_split``: the gain above 0 and the depth below the fit's limit.

It writes the level's slots ``[2^depth - 1, 2^(depth+1) - 1)`` of the tree's
heaps (``bf``, ``bb`` and ``do_split``, zero where the node does not
split), which ``route_rows`` takes as the level's splits, and returns the
level's node histograms for the next level or, at the last level
(``last``), the four int64 sums the leaves need instead: GL and HL at
``best`` where the node splits, else at the feature's last bin, and G and H
of that feature.

``split_level`` launches the kernel (``csrc/gbt_split.cu``, K4) for CUDA
tensors and runs ``split_level_reference`` for CPU tensors; nothing falls
back from one to the other.  The kernel rounds each float64 operation as
torch's separate ops round it, so the two agree bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.ops.gbt_hist import pow2

__all__ = ["LAMBDA", "SplitLevel", "split_level", "split_level_reference"]

LAMBDA = 1.0  # xgboost reg_lambda default


class SplitLevel(NamedTuple):
    hist: Optional[torch.Tensor]  # (S, 2 * n_nodes, F * B) int64 node histograms, G rows then H rows; None if last
    leaf_sums: Optional[torch.Tensor]  # (S, n_nodes, 4) int64 GL, HL at the split, G, H; only if last


def split_level_reference(q, parent, shift, gammas, min_child_weights, col, depth_limits, heap, *, depth: int,
                          n_bins: int, last: bool) -> SplitLevel:
    """Plain PyTorch version: the fit's epilogue in whole-tensor ops (int64
    cumsums, float64 gains, ``argmax``).  See the module's docstring and
    ``split_level`` for the arguments."""
    S, B = q.shape[0], n_bins
    F = q.shape[2] // B
    n_nodes = 2**depth
    half = max(n_nodes // 2, 1)
    lam = LAMBDA
    scale = pow2(-shift)[:, None, None, None]
    gam = gammas.double()[:, None, None, None]
    mcw = min_child_weights.double()[:, None, None, None]
    feasible_col = col[:, None, :, None] & (torch.arange(B, device=q.device) < B - 1)  # bin B-1 puts every row left
    left = q.view(S, 2, half, F * B)
    if depth == 0:
        hist = left  # the root is node 0, a "left child": its rows are every row
    else:  # sibling subtraction, exact in integers: right = parent - left
        hist = torch.stack([left, parent.view(S, 2, half, F * B) - left], dim=3)
    sums = hist.reshape(S, 2, n_nodes, F, B).cumsum(-1)
    GLq, HLq = sums[:, 0], sums[:, 1]
    GL, HL = GLq.double() * scale, HLq.double() * scale
    GR, HR = (GLq[..., -1:] - GLq).double() * scale, (HLq[..., -1:] - HLq).double() * scale
    G, H = GL[..., -1:], HL[..., -1:]
    gain = 0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam) - G * G / (H + lam)) - gam
    feasible = (HL >= mcw) & (HR >= mcw) & feasible_col
    flat = torch.where(feasible, gain, -torch.inf).view(S, n_nodes, F * B)
    best = flat.argmax(-1)  # the first of equal gains, as in the JAX package
    best_gain = flat.gather(-1, best[..., None])[..., 0]
    do_split = (best_gain > 0.0) & (depth < depth_limits[:, None])
    bf, bb = (best // B).to(torch.int32), (best % B).to(torch.int32)
    # heap layout: level d fills the static range [2^d-1, 2^(d+1)-1)
    lo, hi = n_nodes - 1, 2 * n_nodes - 1
    for slots, value in zip(heap, (torch.where(do_split, bf, 0), torch.where(do_split, bb, 0), do_split)):
        slots[:, lo:hi] = value
    if not last:
        return SplitLevel(hist.reshape(S, 2 * n_nodes, F * B), None)
    # leaf sums from the prefix sums: a split node's left child holds GL at
    # its split, an unsplit node's holds all its rows
    tot = (bf.long() * B + B - 1)[..., None]
    at = torch.where(do_split, best, tot[..., 0])[..., None]
    GLf, HLf = GLq.reshape(S, n_nodes, F * B), HLq.reshape(S, n_nodes, F * B)
    leaf_sums = torch.stack([GLf.gather(-1, at)[..., 0], HLf.gather(-1, at)[..., 0], GLf.gather(-1, tot)[..., 0],
                             HLf.gather(-1, tot)[..., 0]], -1)
    return SplitLevel(None, leaf_sums)


@functools.cache
def _max_warps() -> int:
    """The most warps a block of the kernel has (``gbt_split_max_warps``)."""
    return _build.load("gbt_split").gbt_split_max_warps()


def _warps(F: int, max_warps: int) -> int:
    """Warps a block: as few as take the features in the same number of
    rounds as ``max_warps`` warps do, so that no warp idles in the last
    round."""
    rounds = -(-F // max_warps)
    return -(-F // rounds)


def _check(q, parent, shift, gammas, min_child_weights, col, depth_limits, heap, depth: int,
           n_bins: int) -> Tuple[torch.device, int, int, list]:
    """The tensors' device, S, F and the heap's row strides, after the checks."""
    dev = _build.device(q, "split_level")
    if depth < 0 or n_bins < 1:
        raise ValueError(f"need depth >= 0 and n_bins >= 1, got depth={depth}, n_bins={n_bins}")
    shape = q.shape
    if len(shape) != 3 or shape[2] % n_bins:
        raise ValueError(f"q: expected (S, 2 * half, F * {n_bins}), got {tuple(shape)}")
    S, FB = shape[0], shape[2]
    n_nodes = 2**depth
    q_shape = (S, 2 * max(n_nodes // 2, 1), FB)
    if depth > 0 and parent is None:
        raise ValueError(f"parent: the last level's node histograms are needed at depth {depth}")
    _build.checks(dev, ("q", q, torch.int64, q_shape), ("shift", shift, torch.int32, (S,)),
                  ("gammas", gammas, torch.float32, (S,)), ("min_child_weights", min_child_weights, torch.float32, (S,)),
                  ("col", col, torch.bool, (S, FB // n_bins)), ("depth_limits", depth_limits, torch.int64, (S,)),
                  *((("parent", parent, torch.int64, q_shape),) if depth > 0 else ()))
    if len(heap) != 3:
        raise ValueError(f"heap: expected (feat, thresh, is_split), got {len(heap)} tensors")
    # a heap row holds at least the slots up to this level's
    row_strides = [_build.check_table(f"heap {name}", t, dev, dtype, S, 2 * n_nodes - 1)[0] for name, t, dtype in
                   zip(("feat", "thresh", "is_split"), heap, (torch.int32, torch.int32, torch.bool))]
    return dev, S, FB // n_bins, row_strides


def split_level(q, parent, shift, gammas, min_child_weights, col, depth_limits,
                heap: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], *, depth: int, n_bins: int,
                last: bool) -> SplitLevel:
    """One level's split epilogue for S fits (see the module's docstring).

    q (S, 2 * half, F * n_bins) int64 from ``left_histograms_fixed``;
    parent, the last level's ``SplitLevel.hist`` (None at depth 0); shift
    (S,) int32 of ``fixed_point_shift``; gammas and min_child_weights (S,)
    float32; col (S, F) bool, the tree's kept columns; depth_limits (S,)
    int64; heap, the tree's (S, M) feat and thresh int32 and is_split bool,
    M >= 2^(depth+1) - 1, unit column stride (a row view of larger arrays
    does), written in place; ``last`` returns the leaf sums in place of
    the node histograms.

    On a CUDA tensor this launches the kernel (counted in
    ``_build.launches``); on a CPU tensor it runs the plain version.
    A wrong dtype, shape or device raises ``ValueError``, a launch error
    ``RuntimeError``."""
    dev, S, F, row_strides = _check(q, parent, shift, gammas, min_child_weights, col, depth_limits, heap, depth,
                                    n_bins)
    if q.is_cpu:
        return split_level_reference(q, parent, shift, gammas, min_child_weights, col, depth_limits, heap, depth=depth,
                                     n_bins=n_bins, last=last)
    n_nodes = 2**depth
    if S > 65535:
        raise ValueError(f"at most 65535 fits per call, got {S}")
    fn = _build.load("gbt_split").gbt_split_launch
    args = _build.plan(("gbt_split", S, F, n_bins, depth, last, dev.index),
                       lambda: _build.scalars(fn, 15, S, n_nodes, F, n_bins, depth, LAMBDA, _warps(F, _max_warps())))
    if last:
        hist, leaf_sums = None, torch.empty(S, n_nodes, 4, dtype=torch.int64, device=dev)
    else:
        hist, leaf_sums = torch.empty(S, 2 * n_nodes, F * n_bins, dtype=torch.int64, device=dev), None
    slot = n_nodes - 1  # the level's first heap slot
    feat, thresh, is_split = heap
    _build.launch(fn, dev, q.data_ptr(), 0 if parent is None else parent.data_ptr(), shift.data_ptr(),
                  gammas.data_ptr(), min_child_weights.data_ptr(), col.data_ptr(), depth_limits.data_ptr(),
                  feat.data_ptr() + 4 * slot, thresh.data_ptr() + 4 * slot, is_split.data_ptr() + slot, *row_strides,
                  0 if leaf_sums is None else leaf_sums.data_ptr(), 0 if hist is None else hist.data_ptr(), *args)
    return SplitLevel(hist, leaf_sums)
