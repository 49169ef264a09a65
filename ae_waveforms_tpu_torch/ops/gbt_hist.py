"""GBT per-level left-child histograms: a CUDA kernel for Hopper and its
plain versions.

The port of ``ae_waveforms_tpu/ops/gbt_hist_pallas.py::left_histograms``.
For S fits at once, at one tree level with ``half`` left children:

    GH[s, c, f*B + b] = sum_i [node_of[s, i] == 2 * (c mod half)]
                              * (g if c < half else h)[s, i] * [bins[i, f] == b]

The binned pool ``binsT`` (F, n) is shared by the S fits, as in
``route_rows``.  Right children come by subtraction in the fit.

The kernel (``csrc/gbt_hist.cu``) sums in integer fixed point: g and h of
fit s are scaled by 2^shift[s] and rounded to 64-bit integers, and the
histograms are the exact integer sums.  ``left_histograms_fixed`` returns
them as they are; the fit takes them so, since its prefix sums and sibling
subtractions are then exact and the trees bit-identical from run to run and
from the card to the CPU.  ``left_histograms`` scales them back to float32.

The kernel reads the bins packed (``pack_bins``: a row's bins as bytes in
16-byte words), which the fit builds once per pool.  ``hist_plan`` chooses
its launch: the cluster size C (a fit's rows split over C blocks), the tile
of (left child, feature) pairs one block's shared memory holds, and so the
walks of each fit's rows.

``left_histograms_fixed`` launches the kernel for CUDA tensors and runs
``left_histograms_fixed_reference`` (the same integers from an
``index_add_``) for CPU tensors; nothing falls back from one to the other.
``left_histograms_reference`` is an independent plain version in float64,
the oracle of both within 1e-4 absolute and 1e-5 relative.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Optional

import torch

from ae_waveforms_tpu_torch.train.profiling import span

from ae_waveforms_tpu_torch.ops import _build

__all__ = [
    "HistPlan", "active_clusters", "fixed_point_shift", "hist_plan", "left_histograms", "left_histograms_fixed",
    "left_histograms_fixed_reference", "left_histograms_reference", "max_active_clusters", "pack_bins", "pow2",
]


def pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k as float64, built from its bits, so exact on every device
    (integer k in [-1022, 1023])."""
    return ((k.long() + 1023) << 52).view(torch.float64)


def fixed_point_shift(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(S,) int32 scale exponents for (S, n) g and h: shift = 62 - L - e with
    max(|g|, |h|) of the fit below 2^e and n <= 2^L, so that no sum of n
    scaled terms reaches 2^62.  Computed on the tensors' device."""
    S, n = g.shape
    if n == 0:
        return torch.zeros(S, dtype=torch.int32, device=g.device)
    m = torch.maximum(g.abs().amax(1), h.abs().amax(1))
    return (62 - (n - 1).bit_length() - torch.frexp(m).exponent).to(torch.int32)


def _bin_bytes(n_bins: int) -> int:
    if not 1 <= n_bins <= 65535:
        raise ValueError(f"packed bins hold 1 to 65535 bins, got n_bins={n_bins}")
    return 1 if n_bins <= 255 else 2


def pack_bins(binsT: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(F, n) int32 bins -> (n, W) uint8 rows, the kernel's layout: row i
    holds bin f of row i at byte f (uint8, n_bins <= 255) or at bytes 2f and
    2f + 1 (little-endian uint16, n_bins > 255), zero-padded to W, a
    multiple of 16.  A bin outside [0, n_bins) becomes the sentinel 255
    (65535), which adds nothing."""
    F, n = binsT.shape
    es = _bin_bytes(n_bins)
    b = torch.where((binsT >= 0) & (binsT < n_bins), binsT, 256**es - 1).T
    out = torch.zeros((n, -(-F * es // 16) * 16), dtype=torch.uint8, device=binsT.device)
    for k in range(es):
        out[:, k : F * es : es] = ((b >> (8 * k)) & 255).to(torch.uint8)
    return out


def _cells(binsT, node_of, half: int, n_bins: int):
    """Flat index of each (fit, row, feature)'s cell in the g half of the
    output, (S * n * F,), and whether it counts, (S, n, F)."""
    F, n = binsT.shape
    S = node_of.shape[0]
    dev = node_of.device
    j = torch.div(node_of, 2, rounding_mode="floor").long()
    row_ok = (node_of >= 0) & (node_of % 2 == 0) & (j < half)  # (S, n)
    bins = binsT.T.long()  # (n, F)
    ok = row_ok[:, :, None] & (bins >= 0) & (bins < n_bins)  # (S, n, F)
    base = (torch.arange(S, device=dev)[:, None] * 2 * half + j) * F  # (S, n)
    idx = (base[:, :, None] + torch.arange(F, device=dev)) * n_bins + bins  # (S, n, F)
    return torch.where(ok, idx, 0).reshape(-1), ok


def left_histograms_reference(binsT, g, h, node_of, *, half: int, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version in float64: one ``index_add_`` over the
    flattened (fit, child, feature, bin) index.

    binsT (F, n) int32; g, h (S, n) float32; node_of (S, n) int32 ->
    (S, 2 * half, F * n_bins) float32.  Rows whose node is not a left child
    in [0, 2 * half), and bins outside [0, n_bins), add nothing."""
    F = binsT.shape[0]
    S = g.shape[0]
    idx, ok = _cells(binsT, node_of, half, n_bins)
    out = torch.zeros(S * 2 * half * F * n_bins, dtype=torch.float64, device=g.device)
    for values, offset in ((g, 0), (h, half * F * n_bins)):
        out.index_add_(0, idx + offset, torch.where(ok, values.double()[:, :, None], 0.0).reshape(-1))
    return out.view(S, 2 * half, F * n_bins).float()


def left_histograms_fixed_reference(binsT, g, h, node_of, shift, *, half: int, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same rounding of g and h to
    fixed point (ties to even) and one integer ``index_add_``, so the same
    int64 histograms (S, 2 * half, F * n_bins) as ``left_histograms_fixed``."""
    F = binsT.shape[0]
    S = g.shape[0]
    idx, ok = _cells(binsT, node_of, half, n_bins)
    scale = pow2(shift)[:, None]
    out = torch.zeros(S * 2 * half * F * n_bins, dtype=torch.int64, device=g.device)
    for values, offset in ((g, 0), (h, half * F * n_bins)):
        q = torch.round(values.double() * scale).long()
        out.index_add_(0, idx + offset, torch.where(ok, q[:, :, None], 0).reshape(-1))
    return out.view(S, 2 * half, F * n_bins)


# The launch plan.  A cluster of C blocks (C in CLUSTER_SIZES) takes one
# (fit, tile); each block keeps a copy of the tile's sums in shared memory,
# 16 bytes a cell, in a layout of fixed size: THREADS threads and SMEM_BYTES
# bytes a block, so one block an SM, and at most MAX_CELLS cells a tile (the
# kernel's kStride - 1, checked by the launcher and by chip_smoke.py).
CLUSTER_SIZES = (1, 2, 4, 8)
THREADS = 1024
SMEM_BYTES = 232_448
MAX_CELLS = 13_247


class HistPlan(NamedTuple):
    cluster: int  # C: blocks that split each fit's rows between them
    node_tile: int  # left children per tile
    feature_tile: int  # features per tile
    walks: int  # tiles per fit, each a walk of the fit's rows
    clusters: int  # S * walks
    threads: int  # per block
    smem_bytes: int  # per block


def _tiles(count: int, cap: int):
    """``count`` items in the fewest tiles of at most ``cap``, balanced:
    (items per tile, tiles)."""
    tiles = -(-count // cap)
    return -(-count // tiles), tiles


def hist_plan(S: int, n: int, F: int, n_bins: int, half: int, active: Mapping[int, int]) -> HistPlan:
    """The kernel's launch for S fits of n rows, F features, ``n_bins`` bins
    and ``half`` left children, on a card that holds ``active[C]`` clusters
    of C blocks at once.

    The tile is the most (left child, feature) pairs one block holds, so
    each fit's rows are walked the fewest times: once where a whole level
    fits.  C is the largest cluster size at which all S * walks clusters
    run at once, in one wave; 1 where they do not fit one wave even so.  A
    block costs some microseconds however few rows it walks, so splitting a
    fit's rows over more blocks pays only while the card has SMs to spare,
    and a second wave costs a whole block's time.  Raises ValueError when
    one (node, feature) pair of bins does not fit a block."""
    pairs = MAX_CELLS // n_bins
    if pairs < 1:
        raise ValueError(f"{n_bins} bins need {16 * n_bins} bytes of shared memory per (node, feature); "
                         f"a block holds {16 * MAX_CELLS}")
    FT, f_tiles = _tiles(F, pairs)
    NT, n_tiles = _tiles(half, pairs // FT)
    walks = n_tiles * f_tiles
    C = max((c for c in CLUSTER_SIZES if S * walks <= active[c]), default=1)
    return HistPlan(C, NT, FT, walks, S * walks, THREADS, SMEM_BYTES)


def max_active_clusters(cluster: int) -> int:
    """How many clusters of ``cluster`` blocks of the kernel's layout the
    current card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    active = ctypes.c_int(0)
    rc = _build.load("gbt_hist").gbt_hist_max_active_clusters(cluster, THREADS, SMEM_BYTES, ctypes.byref(active))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError_t {rc}")
    return active.value


@functools.cache
def active_clusters(device_index: int) -> dict:
    """``max_active_clusters`` of CUDA device ``device_index`` for each
    cluster size, asked once: the ``active`` argument of ``hist_plan``."""
    with torch.cuda.device(device_index):
        return {C: max_active_clusters(C) for C in CLUSTER_SIZES}


def left_histograms_fixed(binsT, g, h, node_of, shift, *, half: int, n_bins: int,
                          packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-level left-child G/H histograms as exact int64 sums of g and h
    scaled by 2^shift[s], (S, 2 * half, F * n_bins); the arguments are
    those of ``left_histograms_reference`` plus ``shift`` (S,) int32 from
    ``fixed_point_shift`` and, optionally, ``packed``, ``pack_bins(binsT,
    n_bins)`` made once for many calls on the same pool (packed here when
    not given).  g and h must be finite.

    On a CUDA tensor this launches the kernel with the plan of
    ``hist_plan`` for the card (counted in ``_build.launches``); on a CPU
    tensor it runs the plain version on ``binsT`` (``packed``, where given,
    is checked and not read).  A wrong dtype, shape or device raises
    ``ValueError``, as do more bins than a block's shared memory holds; a
    launch error raises ``RuntimeError``.  The call is a span, ``gbt.hist``."""
    with span("gbt.hist"):
        dev = _build.device(node_of, "left_histograms")
        if half < 1 or n_bins < 1:
            raise ValueError(f"need half >= 1 and n_bins >= 1, got half={half}, n_bins={n_bins}")
        F, n = binsT.shape
        S = g.shape[0]
        _build.checks(dev, ("binsT", binsT, torch.int32, (F, n)), ("g", g, torch.float32, (S, n)),
                      ("h", h, torch.float32, (S, n)), ("node_of", node_of, torch.int32, (S, n)),
                      ("shift", shift, torch.int32, (S,)),
                      *((("packed", packed, torch.uint8, (n, -(-F * _bin_bytes(n_bins) // 16) * 16)),)
                        if packed is not None else ()))
        if packed is not None and packed.data_ptr() % 16:
            raise ValueError(f"packed: expected pack_bins' 16-byte aligned rows on {dev}, "
                             f"got address {packed.data_ptr():#x}")
        if node_of.is_cpu:
            return left_histograms_fixed_reference(binsT, g, h, node_of, shift, half=half, n_bins=n_bins)
        if S > 65535:
            raise ValueError(f"at most 65535 fits per call, got {S}")
        if n == 0 or F == 0 or S == 0:
            return torch.zeros((S, 2 * half, F * n_bins), dtype=torch.int64, device=dev)
        fn = _build.load("gbt_hist").gbt_hist_launch
        args = _build.plan(("gbt_hist", S, n, F, n_bins, half, dev.index),
                           lambda: _launch_args(fn, S, n, F, n_bins, half, active_clusters(dev.index)))
        out = torch.empty(S, 2 * half, F * n_bins, dtype=torch.int64, device=dev)
        if packed is None:
            packed = pack_bins(binsT, n_bins)
        _build.launch(fn, dev, packed.data_ptr(), g.data_ptr(), h.data_ptr(), node_of.data_ptr(), shift.data_ptr(),
                      out.data_ptr(), *args)
        return out


def _launch_args(fn, S: int, n: int, F: int, n_bins: int, half: int, active: Mapping[int, int]) -> tuple:
    """The scalar arguments of the launcher ``fn`` for ``hist_plan``'s plan."""
    p = hist_plan(S, n, F, n_bins, half, active)
    es = _bin_bytes(n_bins)
    return _build.scalars(fn, 6, S, n, -(-F * es // 16) * 16, es, F, n_bins, half, p.cluster, p.node_tile,
                          p.feature_tile, p.threads, p.smem_bytes)


def left_histograms(binsT, g, h, node_of, *, half: int, n_bins: int,
                    shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-level left-child G/H histograms, (S, 2 * half, F * n_bins)
    float32: ``left_histograms_fixed`` scaled back, so exact sums rounded
    once to float32; on the card the bins are packed for each call.
    ``shift`` defaults to ``fixed_point_shift(g, h)``."""
    if shift is None:
        shift = fixed_point_shift(g, h)
    q = left_histograms_fixed(binsT, g, h, node_of, shift, half=half, n_bins=n_bins)
    return (q.double() * pow2(-shift)[:, None, None]).float()
