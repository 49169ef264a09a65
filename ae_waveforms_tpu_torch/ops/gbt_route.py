"""GBT row routing over tree levels: a CUDA kernel for Hopper and its plain
versions.

The port of ``ae_waveforms_tpu/ops/gbt_route_pallas.py::route_rows``.  For S
fits (or S trees of one ensemble) at once, every row moves one level down:
``node <- 2*node + [bins[i, bf[node]] > bb[node]]`` where ``do_split[node]``,
else ``2*node``.  An exact integer decision; levels of any width work.  The
kernel is ``csrc/gbt_route.cu``; one launch routes one level
(``route_rows``, the fit) or a range of levels of tree heaps
(``route_levels``, prediction: every level in one launch).

``route_plan`` chooses a launch: whether the block stages the tables and
the bins in shared memory, the node ids a thread's task holds, and the
chunk of fits and the tile of rows a block takes.  ``route_spans`` splits a
level range into the launches whose tables fit.  ``route_rows`` and
``route_levels`` launch the kernel for CUDA tensors and run
``route_rows_reference`` and ``route_levels_reference`` for CPU tensors;
nothing falls back from one to the other.  Both count their launches in
``_build.launches["gbt_route"]``.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.train.profiling import span

__all__ = ["RoutePlan", "route_layout", "route_levels", "route_levels_reference", "route_plan", "route_rows",
           "route_rows_reference", "route_spans"]


def route_rows_reference(binsT, node_of, bf, bb, do_split) -> torch.Tensor:
    """Plain PyTorch version: a gather and a compare.

    binsT (F, n) int32 binned pool shared by the S fits; node_of (S, n)
    int32; bf, bb (S, n_nodes) int32 and do_split (S, n_nodes) bool, the
    level's split feature, split bin and validity -> (S, n) int32.  Node ids
    outside [0, n_nodes) take the left spine; split features outside
    [0, F) route left."""
    F, n = binsT.shape
    n_nodes = bf.shape[1]
    valid = (node_of >= 0) & (node_of < n_nodes)
    k = node_of.clamp(0, n_nodes - 1).long()
    split = torch.gather(do_split, 1, k) & valid
    f = torch.gather(bf, 1, k)
    cols = torch.arange(n, device=binsT.device).expand_as(f)
    vals = binsT[f.clamp(0, F - 1).long(), cols]
    go = ((f >= 0) & (f < F) & (vals > torch.gather(bb, 1, k))).to(torch.int32)
    return torch.where(split, 2 * node_of + go, 2 * node_of).to(torch.int32)


def route_levels_reference(bins_t, node_of, feat, thresh, is_split, d0: int, d1: int) -> torch.Tensor:
    """Plain PyTorch version of ``route_levels``: ``route_rows_reference``
    on each level's heap slice in turn."""
    if node_of is None:
        node_of = torch.zeros((feat.shape[0], bins_t.shape[1]), dtype=torch.int32, device=feat.device)
    for d in range(d0, d1):
        lo, hi = 2**d - 1, 2 ** (d + 1) - 1
        node_of = route_rows_reference(bins_t, node_of, feat[:, lo:hi], thresh[:, lo:hi], is_split[:, lo:hi])
    return node_of


# The launch plan.  A block of at most THREADS threads owns a chunk of fits
# and a tile of rows (a power of two, at least VEC) and, where staged,
# keeps in shared memory the chunk's splits (SPLIT_BYTES a node) and the
# tile's bins (4 bytes a bin).  A block takes PAIRS (fit, row) pairs, a
# power of two from MIN_PAIRS to MAX_PAIRS, so that about two blocks an SM
# run at once, and stages at most SMEM_BYTES / BLOCKS_PER_SM bytes, so that
# shared memory does not hold fewer blocks on an SM than the kernel's
# registers allow.  The card holds THREADS * BLOCKS_PER_SM threads an SM at
# once; a launch of fewer (fit, row) pairs than that is small.
#
# Several levels are always staged.  One level is read in place where the
# launch is small (staging is one more round of loads) or its table holds
# more splits than the staged tile has rows (staging it costs more than
# the rows read of it).  A task is VEC node ids of one fit (a 16-byte load
# and store) where n is a multiple of VEC and, staged, the launch is not
# small, or, in place, the tasks of VEC ids still fill every thread the
# card holds; else one id, since a short chain of loads in every thread
# slot beats wide tasks in few.  tools/route_profile.py times both paths
# and both task widths at shapes on either side of each rule.
VEC = 4
THREADS = 256
BLOCKS_PER_SM = 4  # the kernel's __launch_bounds__: 4 blocks of THREADS threads fill an SM's registers
MIN_PAIRS, MAX_PAIRS = 256, 16384
DIRECT_TILE = 512
SPLIT_BYTES = 8  # a staged split: its threshold and its feature, two int32
SMEM_BYTES = 232_448


class RoutePlan(NamedTuple):
    chunk: int  # fits per block
    tile: int  # rows per block, a power of two >= VEC
    vec: int  # node ids a task: VEC or 1
    staged: bool  # the tables and the tile's bins staged in shared memory, else read in place
    blocks: int  # ceil(S / chunk) * ceil(n / tile)
    threads: int  # per block
    smem_bytes: int  # per block


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _tables_fit(F: int, nodes: int) -> bool:
    """One fit's splits and 2 * VEC rows of bins fit a block's shared memory."""
    return SPLIT_BYTES * nodes + 4 * F * 2 * VEC <= SMEM_BYTES


def route_plan(S: int, n: int, F: int, levels: int, width: int = 1, sms: int = 132) -> RoutePlan:
    """The kernel's launch for S fits of n rows and F features, routed down
    ``levels`` levels whose first is ``width`` nodes wide, on a card of
    ``sms`` SMs: staged or in place, and the task width, by the rules in
    the comment above ``VEC``; ``route_layout`` gives the chunk and the
    tile, and raises ValueError where several levels' tables for one fit do
    not fit a block's shared memory (``route_spans`` keeps ``route_levels``
    clear of that).  One level of any width can be read in place."""
    if min(S, n, F, levels, width) < 1:
        raise ValueError(f"need S, n, F, levels and width >= 1, got {S}, {n}, {F}, {levels}, {width}")
    nodes = width * (2**levels - 1)
    resident = THREADS * BLOCKS_PER_SM * sms  # threads the card holds at once
    small = S * n < resident
    if levels > 1 or (not small and _tables_fit(F, nodes)):
        plan = route_layout(S, n, F, nodes, True, VEC if n % VEC == 0 and not small else 1, sms)
        if levels > 1 or nodes <= plan.tile:
            return plan
    return route_layout(S, n, F, nodes, False, VEC if n % VEC == 0 and S * n >= VEC * resident else 1, sms)


def route_layout(S: int, n: int, F: int, nodes: int, staged: bool, vec: int, sms: int = 132) -> RoutePlan:
    """The chunk and the tile of a launch over ``nodes`` split nodes a fit,
    staged or in place, in tasks of ``vec`` ids.

    A block takes PAIRS = S * n / (2 * sms) pairs, as a power of two within
    [MIN_PAIRS, MAX_PAIRS]: about two blocks an SM.  Staged, a pair costs
    2 * nodes / tile + F / chunk staged words, the table's and the pool's;
    the chunk is taken at sqrt(2 * PAIRS * F / nodes), rounded to a power
    of two, twice the chunk at which that cost is least, so that the pool,
    the array read from device memory, is re-read less, and the tile holds
    the rest (at most n rows, rounded up to a power of two; longer where
    one chunk holds all S fits), then both are halved while the block's
    staging exceeds SMEM_BYTES / BLOCKS_PER_SM (fewer fits first where the
    tables take more of it than the bins).  In place, the tile is
    DIRECT_TILE rows.  Raises ValueError where staged tables of one fit
    cannot fit."""
    if staged and not _tables_fit(F, nodes):
        raise ValueError(f"{nodes} splits a fit take {SPLIT_BYTES * nodes} bytes, with F={F} more than the "
                         f"{SMEM_BYTES} bytes of a block's shared memory")
    pairs = min(MAX_PAIRS, max(MIN_PAIRS, _pow2_floor(S * n // (2 * sms))))
    longest = max(VEC, _pow2_ceil(n))
    if staged:
        tile = pairs >> max(round(math.log2(math.sqrt(2 * pairs * F / nodes))), 0)
    else:
        tile = DIRECT_TILE
    tile = min(max(tile, 2 * VEC), longest)
    chunk = max(min(pairs // tile, S), -(-S // 65535))  # the grid's y counts chunks: at most 65,535
    if chunk * tile < pairs:  # all S fits in a chunk: longer tiles instead
        tile = min(max(tile, _pow2_floor(pairs // chunk)), longest)
    plan = _plan(S, n, F, nodes, chunk, tile, staged, vec)
    while plan.smem_bytes > SMEM_BYTES // BLOCKS_PER_SM and (chunk > 1 or tile > 2 * VEC):
        if chunk > 1 and SPLIT_BYTES * chunk * nodes >= 4 * F * tile:
            chunk //= 2
        else:
            tile //= 2
        plan = _plan(S, n, F, nodes, chunk, tile, staged, vec)
    return plan


def _plan(S: int, n: int, F: int, nodes: int, chunk: int, tile: int, staged: bool, vec: int) -> RoutePlan:
    """The launch of chunks of ``chunk`` fits by tiles of ``tile`` rows."""
    threads = min(THREADS, -(-chunk * tile // vec // 32) * 32)
    smem = SPLIT_BYTES * chunk * nodes + 4 * F * tile if staged else 0
    return RoutePlan(chunk, tile, vec, staged, -(-S // chunk) * -(-n // tile), threads, smem)


def route_spans(F: int, d0: int, d1: int) -> list:
    """Levels [d0, d1) of tree heaps as the launches ``route_levels`` makes,
    [(d, e), ...] in order: from each level on, as many levels as one fit's
    tables of them fit a block's shared memory, or that one level alone
    (which is read in place when its table does not fit)."""
    spans, d = [], d0
    while d < d1:
        e = d1
        while e - d > 1 and not _tables_fit(F, 2**d * (2 ** (e - d) - 1)):
            e -= 1
        spans.append((d, e))
        d = e
    return spans


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(bins_t, node_of, feat, thresh, split, S: int, width: int, levels: int) -> torch.Tensor:
    """Check the CUDA tensors and launch the kernel with ``route_plan``'s
    plan: rows down ``levels`` levels, the first ``width`` nodes wide, whose
    splits start at column 0 of feat, thresh and split; ``node_of`` None
    starts every row at node 0."""
    dev = feat.device
    F, n = bins_t.shape
    nodes = width * (2**levels - 1)
    _build.check("bins", bins_t, dev, torch.int32, (F, n), "any")
    if node_of is not None:
        _build.checks(dev, ("node_of", node_of, torch.int32, (S, n)))
        if node_of.data_ptr() % 16:  # a view into another array: the kernel loads 16-byte groups
            node_of = node_of.clone()
    # a table may be wider than the launch's levels, never narrower
    layout = "rows" if nodes > 1 else "any"
    strides = [_build.check_table(name, t, dev, dtype, S, nodes, layout)[0] for name, t, dtype in
               (("feat", feat, torch.int32), ("thresh", thresh, torch.int32), ("split", split, torch.bool))]
    out = torch.empty(S, n, dtype=torch.int32, device=dev)
    if S * n == 0:
        return out
    fn = _build.load("gbt_route").gbt_route_launch
    args = _build.plan(("gbt_route", S, n, F, width, levels, dev.index),
                       lambda: _launch_args(fn, S, n, F, width, levels, _sms(dev.index)))
    bins_stride = bins_t.stride()
    _build.launch(fn, dev, bins_t.data_ptr(), *bins_stride, 0 if node_of is None else node_of.data_ptr(),
                  feat.data_ptr(), thresh.data_ptr(), split.data_ptr(), *strides, out.data_ptr(), *args)
    return out


def _launch_args(fn, S: int, n: int, F: int, width: int, levels: int, sms: int) -> tuple:
    """The scalar arguments of the launcher ``fn`` for ``route_plan``'s plan."""
    p = route_plan(S, n, F, levels, width, sms)
    return _build.scalars(fn, 11, S, n, F, width, levels, p.chunk, p.tile, p.vec, int(p.staged), p.blocks, p.threads,
                          p.smem_bytes)


def route_rows(binsT, node_of, bf, bb, do_split) -> torch.Tensor:
    """Route every row one level down, (S, n) int32 -> (S, n) int32; see
    ``route_rows_reference`` for the arguments.

    ``binsT`` may be any (F, n) view.  ``bf``, ``bb`` and ``do_split`` may
    be column slices of larger per-tree arrays (unit column stride, any row
    stride), so a level of a tree heap is routed without a copy.  On a CUDA
    tensor this launches the kernel (counted in ``_build.launches``); on
    a CPU tensor it runs the plain version.  A wrong dtype, shape or device
    raises ``ValueError``, a launch error ``RuntimeError``.  The call is a
    span, ``gbt.route``."""
    with span("gbt.route"):
        _build.device(node_of, "route_rows")
        if node_of.is_cpu:
            return route_rows_reference(binsT, node_of, bf, bb, do_split)
        S, n_nodes = bf.shape
        for name, t in (("bb", bb), ("do_split", do_split)):
            if tuple(t.shape) != (S, n_nodes):
                raise ValueError(f"{name}: expected shape {(S, n_nodes)}, got {tuple(t.shape)}")
        return _launch(binsT, node_of, bf, bb, do_split, S, n_nodes, 1)


def route_levels(bins_t, node_of: Optional[torch.Tensor], feat, thresh, is_split, d0: int, d1: int) -> torch.Tensor:
    """Route every row from level d0 down to level d1 of S tree heaps, (S, n)
    int32 node ids within level d0 -> ids within level d1, in one launch
    where one tree's tables of the levels fit a block's shared memory (up
    to 14 levels from the root at F = 10), else in the launches of
    ``route_spans``.

    bins_t (F, n) int32, any view (``bins.T`` needs no copy); node_of (S, n)
    int32, or None for every row at node 0 of level d0 (the root when d0 is
    0); feat, thresh (S, M) int32 and is_split (S, M) bool heaps, level d at
    columns [2^d - 1, 2^(d+1) - 1), M >= 2^d1 - 1, unit column stride.  The
    same as ``route_rows`` level by level, ids outside a level taking the
    left spine.  CUDA tensors launch the kernel (counted in
    ``_build.launches``), CPU tensors run ``route_levels_reference``."""
    if not 0 <= d0 <= d1:
        raise ValueError(f"need 0 <= d0 <= d1, got d0={d0}, d1={d1}")
    _build.device(feat, "route_levels")
    if feat.is_cpu or d0 == d1:
        return route_levels_reference(bins_t, node_of, feat, thresh, is_split, d0, d1)
    for d, e in route_spans(bins_t.shape[0], d0, d1):
        c = 2**d - 1
        node_of = _launch(bins_t, node_of, feat[:, c:], thresh[:, c:], is_split[:, c:], feat.shape[0], 2**d, e - d)
    return node_of

