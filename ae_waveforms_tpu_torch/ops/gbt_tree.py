"""GBT fit's per-tree work: two CUDA kernels for Hopper and their plain
versions.

For S fits at once, at tree ``tree`` of a fit:

- ``tree_grad`` (K5), before the tree's first level: the row and column
  subsample masks (a counter hash of (seed, stream, tree, index), or the
  injected ``row_mask`` and ``col_mask``; column 0 where no column is kept),
  the float64 sigmoid of the margins, the float32 gradients ``g = (p - y) *
  w`` and hessians ``h = max(p (1 - p), 1e-16) * w`` with w the row weight
  times the row mask, each fit's ``fixed_point_shift`` of g and h, and
  fresh node ids, all 0;
- ``tree_leaves`` (K6), after the last level: the leaf weights ``-G / (H +
  LAMBDA)`` from the split kernel's leaf sums (a left child's G and H at its
  split, a right child's the node's less its sibling's; int64 scaled by
  2^-shift to float64), zero for a fit whose ``n_actives`` is at most
  ``tree``, written into the ensemble's leaf tensor at ``tree``, and the
  margins moved by ``learning_rate * leaf[node]`` in place.

Each launches its kernel (``csrc/gbt_tree.cu``) for CUDA tensors and runs
its plain version (``tree_grad_reference``, ``tree_leaves_reference``) for
CPU tensors; nothing falls back from one to the other.  The kernels round
each float64 and float32 operation as torch's separate ops round it, so the
two agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.ops.gbt_hist import fixed_point_shift, pow2
from ae_waveforms_tpu_torch.ops.gbt_split import LAMBDA

__all__ = ["COL_STREAM", "ROW_STREAM", "TreeGrad", "subsample_uniforms", "tree_grad", "tree_grad_reference",
           "tree_leaves", "tree_leaves_reference"]

ROW_STREAM, COL_STREAM = 0x52F1, 0xC07A
_M32 = 0xFFFFFFFF


class TreeGrad(NamedTuple):
    g: torch.Tensor  # (S, n) float32 gradients, zero where the row weighs nothing
    h: torch.Tensor  # (S, n) float32 hessians
    node_of: torch.Tensor  # (S, n) int32 zeros: every row at the root
    col: torch.Tensor  # (S, F) bool, the tree's kept columns
    shift: torch.Tensor  # (S,) int32 fixed-point scale exponents of g and h


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 (C. Wellons) on int64 tensors that hold uint32 values; its
    multipliers are below 2^31, so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def subsample_uniforms(seeds: torch.Tensor, tree: int, count: int, stream: int) -> torch.Tensor:
    """(S,) integer seeds -> (S, count) float32 uniforms in [0, 1), a hash of
    (seed, stream, tree, index) in integer ops: the same values on every
    device, different for every tree."""
    key = _hash32(_hash32((seeds.long() & _M32) ^ stream) ^ (tree & _M32))
    u = _hash32((key[:, None] + torch.arange(count, device=seeds.device)) & _M32)
    return (u >> 8).float() * 2.0**-24


def tree_grad_reference(margin, y, row_weights, seeds, subsamples, colsamples, *, tree: int, n_features: int,
                        row_mask=None, col_mask=None) -> TreeGrad:
    """Plain PyTorch version of K5, in whole-tensor ops.  See ``tree_grad``
    for the arguments."""
    S, n = margin.shape
    F = n_features
    if row_mask is None:
        row_mask = subsample_uniforms(seeds, tree, n, ROW_STREAM) < subsamples[:, None]
    col = col_mask if col_mask is not None else subsample_uniforms(seeds, tree, F, COL_STREAM) < colsamples[:, None]
    # at least one column: column 0 where the draw kept none
    first = torch.arange(F, device=col.device) == 0
    col = col | (~col.any(1, keepdim=True) & first)
    w = (row_weights * row_mask).double()
    p = torch.sigmoid(margin.double())
    g = ((p - y) * w).float()
    h = ((p * (1.0 - p)).clamp_min(1e-16) * w).float()
    return TreeGrad(g, h, torch.zeros((S, n), dtype=torch.int32, device=margin.device), col, fixed_point_shift(g, h))


def tree_leaves_reference(leaf_sums, shift, learning_rates, n_actives, node_of, margin, leaf, *, tree: int) -> None:
    """Plain PyTorch version of K6, in whole-tensor ops.  See
    ``tree_leaves`` for the arguments."""
    S = margin.shape[0]
    # a split node's left child holds GL at its split, an unsplit node's
    # holds all its rows; the right child the rest of the node
    left, total = leaf_sums.view(S, -1, 2, 2).unbind(2)  # (S, nodes, [G, H]) each
    GH = torch.stack([left, total - left], dim=2).view(S, -1, 2).double() * pow2(-shift)[:, None, None]
    active = (tree < n_actives).float()[:, None]
    wleaf = (-GH[..., 0] / (GH[..., 1] + LAMBDA)).float() * active
    leaf[:, tree] = wleaf
    margin.add_(learning_rates[:, None] * torch.gather(wleaf, 1, node_of.long()))


def tree_grad(margin, y, row_weights, seeds, subsamples, colsamples, *, tree: int, n_features: int,
              row_mask: Optional[torch.Tensor] = None, col_mask: Optional[torch.Tensor] = None) -> TreeGrad:
    """Tree ``tree``'s masks, g, h, shifts and fresh node ids for S fits
    (see the module's docstring).

    margin (S, n) float32, the fits' margins before the tree; y (n,)
    float32 labels; row_weights (S, n) float32; seeds (S,) int64;
    subsamples and colsamples (S,) float32; ``n_features`` F; row_mask (S,
    n) and col_mask (S, F) bool, unit last stride (a tree's slice of
    (S, T, ...) masks does), replace the drawn masks where given.  Returns
    new tensors.

    On CUDA tensors this launches K5 (counted in ``_build.launches``); on
    CPU tensors it runs the plain version.  A wrong dtype, shape or device
    raises ``ValueError``, a launch error ``RuntimeError``."""
    dev = _build.device(margin, "tree_grad")
    if margin.dim() != 2 or tree < 0 or n_features < 1:
        raise ValueError(f"need (S, n) margins, tree >= 0 and n_features >= 1, got {tuple(margin.shape)}, "
                         f"tree={tree}, n_features={n_features}")
    S, n = margin.shape
    F = n_features
    _build.checks(dev, ("margin", margin, torch.float32, (S, n)), ("y", y, torch.float32, (n,)),
                  ("row_weights", row_weights, torch.float32, (S, n)), ("seeds", seeds, torch.int64, (S,)),
                  ("subsamples", subsamples, torch.float32, (S,)), ("colsamples", colsamples, torch.float32, (S,)))
    for name, t, shape in (("row_mask", row_mask, (S, n)), ("col_mask", col_mask, (S, F))):
        if t is not None:
            _build.check(name, t, dev, torch.bool, shape, "rows")
    if margin.is_cpu:
        return tree_grad_reference(margin, y, row_weights, seeds, subsamples, colsamples, tree=tree, n_features=F,
                                   row_mask=row_mask, col_mask=col_mask)
    g = torch.empty(S, n, dtype=torch.float32, device=dev)
    h = torch.empty(S, n, dtype=torch.float32, device=dev)
    node_of = torch.empty(S, n, dtype=torch.int32, device=dev)
    col = torch.empty(S, F, dtype=torch.bool, device=dev)
    shift = torch.empty(S, dtype=torch.int32, device=dev)
    masks = [(0, 0) if m is None else (m.data_ptr(), m.stride(0)) for m in (row_mask, col_mask)]
    fn = _build.load("gbt_tree").gbt_grad_launch
    # the shift's base: 62 less the bits of n - 1, as in fixed_point_shift
    sizes, shift_base = _build.plan(("gbt_grad", S, n, F, dev.index), lambda: (
        _build.scalars(fn, 15, S, n, F), _build.scalars(fn, 19, 62 - max(n - 1, 0).bit_length())[0]))
    _build.launch(fn, dev, margin.data_ptr(), y.data_ptr(), row_weights.data_ptr(), seeds.data_ptr(),
                  subsamples.data_ptr(), colsamples.data_ptr(), *masks[0], *masks[1], g.data_ptr(), h.data_ptr(),
                  node_of.data_ptr(), col.data_ptr(), shift.data_ptr(), *sizes, tree, shift_base)
    return TreeGrad(g, h, node_of, col, shift)


def tree_leaves(leaf_sums, shift, learning_rates, n_actives, node_of, margin, leaf, *, tree: int) -> None:
    """Tree ``tree``'s leaf weights into ``leaf[:, tree]`` and the margins'
    step, in place, for S fits (see the module's docstring).

    leaf_sums (S, L / 2, 4) int64 from the last level's ``split_level``;
    shift (S,) int32 of the tree's ``tree_grad``; learning_rates (S,)
    float32; n_actives (S,) int64; node_of (S, n) int32, each row's leaf in
    [0, L); margin (S, n) float32, updated; leaf (S, T, L) float32, the
    ensemble's leaves, unit last stride, L a power of two, at least 2.

    On CUDA tensors this launches K6 (counted in ``_build.launches``);
    on CPU tensors it runs the plain version.  A wrong dtype, shape or
    device raises ``ValueError``, a launch error ``RuntimeError``."""
    dev = _build.device(margin, "tree_leaves")
    if margin.dim() != 2 or leaf.dim() != 3 or not 0 <= tree < leaf.shape[1]:
        raise ValueError(f"need (S, n) margins, (S, T, L) leaves and 0 <= tree < T, got {tuple(margin.shape)}, "
                         f"{tuple(leaf.shape)}, tree={tree}")
    S, n = margin.shape
    L = leaf.shape[2]
    if L < 2 or L & (L - 1):
        raise ValueError(f"leaves a tree: expected a power of two, at least 2, got {L}")
    _build.checks(dev, ("leaf_sums", leaf_sums, torch.int64, (S, L // 2, 4)), ("shift", shift, torch.int32, (S,)),
                  ("learning_rates", learning_rates, torch.float32, (S,)), ("n_actives", n_actives, torch.int64, (S,)),
                  ("node_of", node_of, torch.int32, (S, n)), ("margin", margin, torch.float32, (S, n)))
    leaf_stride = leaf.stride()
    if leaf.dtype is not torch.float32 or leaf.shape[0] != S or leaf.device != dev or leaf_stride[2] != 1:
        _build.check("leaf", leaf, dev, torch.float32, (S, leaf.shape[1], L), "rows")
    if margin.is_cpu:
        return tree_leaves_reference(leaf_sums, shift, learning_rates, n_actives, node_of, margin, leaf, tree=tree)
    if S > 65535:
        raise ValueError(f"at most 65535 fits per call, got {S}")
    fn = _build.load("gbt_tree").gbt_leaves_launch
    sizes, lam = _build.plan(("gbt_leaves", S, n, L, dev.index),
                             lambda: (_build.scalars(fn, 8, S, n, L), _build.scalars(fn, 12, LAMBDA)[0]))
    _build.launch(fn, dev, leaf_sums.data_ptr(), shift.data_ptr(), learning_rates.data_ptr(), n_actives.data_ptr(),
                  node_of.data_ptr(), margin.data_ptr(), leaf.data_ptr() + 4 * tree * leaf_stride[1], leaf_stride[0],
                  *sizes, tree, lam)
