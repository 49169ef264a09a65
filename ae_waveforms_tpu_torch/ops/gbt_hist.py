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

``left_histograms_fixed`` launches the kernel for CUDA tensors and runs
``left_histograms_fixed_reference`` (the same integers from an
``index_add_``) for CPU tensors; nothing falls back from one to the other.
``left_histograms_reference`` is an independent plain version in float64,
the oracle of both within 1e-4 absolute and 1e-5 relative.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ae_waveforms_tpu_torch.ops import _build

__all__ = [
    "fixed_point_shift", "left_histograms", "left_histograms_fixed",
    "left_histograms_fixed_reference", "left_histograms_reference", "pow2",
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


@functools.cache
def _launcher():
    fn = _build.load("gbt_hist").gbt_hist_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(binsT, g, h, node_of, shift) -> None:
    F, n = binsT.shape
    S = g.shape[0]
    dev = node_of.device
    for name, t, dtype, shape in (
        ("binsT", binsT, torch.int32, (F, n)),
        ("g", g, torch.float32, (S, n)),
        ("h", h, torch.float32, (S, n)),
        ("node_of", node_of, torch.int32, (S, n)),
        ("shift", shift, torch.int32, (S,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def left_histograms_fixed(binsT, g, h, node_of, shift, *, half: int, n_bins: int) -> torch.Tensor:
    """Per-level left-child G/H histograms as exact int64 sums of g and h
    scaled by 2^shift[s], (S, 2 * half, F * n_bins); the arguments are
    those of ``left_histograms_reference`` plus ``shift`` (S,) int32 from
    ``fixed_point_shift``.  g and h must be finite.

    On a CUDA tensor this launches the kernel (counted in
    ``left_histograms_fixed.launches``); on a CPU tensor it runs the plain
    version.  A wrong dtype, shape or device raises ``ValueError``; the
    kernel refuses more bins than its shared memory holds, and that launch
    error raises ``RuntimeError``."""
    if node_of.device.type not in ("cpu", "cuda"):
        raise ValueError(f"left_histograms runs on CUDA or CPU tensors, got {node_of.device}")
    if half < 1 or n_bins < 1:
        raise ValueError(f"need half >= 1 and n_bins >= 1, got half={half}, n_bins={n_bins}")
    _check(binsT, g, h, node_of, shift)
    if node_of.device.type == "cpu":
        return left_histograms_fixed_reference(binsT, g, h, node_of, shift, half=half, n_bins=n_bins)
    F, n = binsT.shape
    S = g.shape[0]
    if S > 65535:
        raise ValueError(f"at most 65535 fits per call, got {S}")
    out = torch.empty((S, 2 * half, F * n_bins), dtype=torch.int64, device=node_of.device)
    if n == 0 or F == 0 or S == 0:
        return out.zero_()
    rc = _launcher()(
        binsT.data_ptr(), g.data_ptr(), h.data_ptr(), node_of.data_ptr(), shift.data_ptr(),
        out.data_ptr(), S, n, F, n_bins, half, torch.cuda.current_stream(node_of.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"gbt_hist kernel launch failed: cudaError_t {rc}")
    left_histograms_fixed.launches += 1
    return out


left_histograms_fixed.launches = 0


def left_histograms(binsT, g, h, node_of, *, half: int, n_bins: int,
                    shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-level left-child G/H histograms, (S, 2 * half, F * n_bins)
    float32: ``left_histograms_fixed`` scaled back, so exact sums rounded
    once to float32.  ``shift`` defaults to ``fixed_point_shift(g, h)``."""
    if shift is None:
        shift = fixed_point_shift(g, h)
    q = left_histograms_fixed(binsT, g, h, node_of, shift, half=half, n_bins=n_bins)
    return (q.double() * pow2(-shift)[:, None, None]).float()
