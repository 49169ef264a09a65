"""R-peak detection over a (B, T) batch of windows (counterpart of the JAX
package's ``signals/rpeaks.py``, written batched where the JAX function is
vmapped).

The detector is the gradient-threshold QRS detector that the reference
reaches through ``nk.ecg_findpeaks(x, sampling_rate)`` (remove_samples.py:
50-51; Brammer 2020):

1. absolute gradient of the signal, boxcar-smoothed twice (0.1 s smoothing
   window, 0.75 s averaging window);
2. QRS candidate regions where the smoothed gradient exceeds 1.5x its local
   average;
3. within each region, the local maximum with the largest topographic
   prominence (scipy ``find_peaks(prominence=(None, None))`` semantics,
   bases confined to the region);
4. regions shorter than 0.4x the mean region length are dropped, and peaks
   closer than 0.3 s to the previously accepted one (starting from a
   virtual peak at index 0) are dropped.

Fixed shapes throughout: nearest-higher-neighbour searches walk sparse
tables (doubling range maxima) from the candidate local maxima only, and
the one sequential part, the min-delay acceptance, is a loop over the
``MAX_SEGMENTS`` regions of small ops on (B,) tensors.

float32 as in the JAX package.  The boxcar's running sums reproduce XLA's
float32 cumulative sum term by term (``xla_cumsum``), so the threshold
``smoothgrad > 1.5 * avggrad`` sees the same values as the JAX function on
any device; everything else is exact (compares, maxima, integer counts).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ae_waveforms_tpu_torch.signals.qc import div

__all__ = ["find_rpeaks", "find_rpeaks_batch", "xla_cumsum", "MAX_SEGMENTS", "LIGHT_CANDIDATES"]

MAX_SEGMENTS = 128  # QRS candidate regions per 20-s window (>= physiological max)

#: light candidate buffer: band-limited ECG has at most ~600 strict local
#: maxima per 20-s window (30 Hz LP bound), so 1024 slots cover every real
#: workload; inputs with more local maxima take the provable bound.
LIGHT_CANDIDATES = 1024

_XLA_SCAN_BASE = 16


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumulative sum over the last axis in XLA's order of
    additions: the axis cut into rows of 16, each summed left to right, the
    rows' totals scanned the same way (recursively) and each row's exclusive
    prefix added last.  ``torch.cumsum`` sums in another order (in float64
    on the CPU), which can move the detector's threshold by an ulp."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    base = _XLA_SCAN_BASE
    if n <= base:
        out = x.clone()
        for i in range(1, n):
            out[..., i] += out[..., i - 1]
        return out
    m = -(-n // base)
    rows = torch.nn.functional.pad(x, (0, m * base - n)).reshape(*lead, m, base).clone()
    for i in range(1, base):
        rows[..., i] += rows[..., i - 1]
    totals = xla_cumsum(rows[..., base - 1].contiguous())
    excl = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (rows + excl[..., None]).reshape(*lead, m * base)[..., :n]


def _gradient(x: torch.Tensor) -> torch.Tensor:
    """np.gradient over the last axis: central differences, one-sided at the
    edges."""
    interior = (x[:, 2:] - x[:, :-2]) * 0.5
    return torch.cat([x[:, 1:2] - x[:, :1], interior, x[:, -1:] - x[:, -2:-1]], dim=1)


def _boxcar_smooth(x: torch.Tensor, size: int) -> torch.Tensor:
    """Edge-replicating boxcar smoothing as the reference detector's helper
    does it: pad ``size`` copies of each edge value, convolve 'same' with a
    normalised boxcar, trim the padding; the moving mean over
    [n - size + 1 + (size-1)//2, n + (size-1)//2] as a difference of running
    sums."""
    B = x.shape[0]
    padded = torch.cat([x[:, :1].expand(B, size), x, x[:, -1:].expand(B, size)], dim=1)
    csum = torch.cat([torch.zeros_like(x[:, :1]), xla_cumsum(padded)], dim=1)
    P = padded.shape[1]
    lo_off = (size - 1) // 2 - size + 1  # <= 0
    hi_off = (size - 1) // 2
    lo_vals = torch.cat([csum[:, :1].expand(B, -lo_off), csum[:, : P + lo_off]], dim=1)
    hi_vals = torch.cat([csum[:, hi_off + 1 :], csum[:, P : P + 1].expand(B, hi_off)], dim=1)
    same = div(hi_vals - lo_vals, float(size))
    return same[:, size:-size]


def _sparse_tables(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, levels, T) doubling tables: maxt[:, k, i] = max x[i : i+2^k],
    mint likewise (the last block clamps at the end)."""
    maxt, mint = [x], [x]
    for k in range(1, levels):
        half = 1 << (k - 1)
        pm, pn = maxt[-1], mint[-1]
        maxt.append(torch.maximum(pm, torch.cat([pm[:, half:], pm[:, -half:]], dim=1)))
        mint.append(torch.minimum(pn, torch.cat([pn[:, half:], pn[:, -half:]], dim=1)))
    return torch.stack(maxt, dim=1), torch.stack(mint, dim=1)


def _row(table: torch.Tensor, k: int, idx: torch.Tensor) -> torch.Tensor:
    """table[b, k, idx[b, j]] (idx clamped into the row)."""
    return torch.gather(table[:, k], 1, idx.clamp(0, table.shape[2] - 1))


def _range_min(mint: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """min over x[lo..hi] inclusive (lo <= hi) from two overlapping blocks of
    2^k, k = floor(log2(hi - lo + 1)) taken from the float's exponent."""
    B, levels, T = mint.shape
    length = (hi - lo + 1).clamp(min=1)
    k = torch.frexp(length.to(torch.float32))[1].to(torch.int64) - 1
    flat = mint.reshape(B, levels * T)
    a = torch.gather(flat, 1, k * T + lo)
    b = torch.gather(flat, 1, k * T + hi - torch.bitwise_left_shift(torch.ones_like(k), k) + 1)
    return torch.minimum(a, b)


def _nearest_higher(maxt, pos, v, lo_bound, hi_bound, levels: int, left: bool):
    """For each candidate at ``pos`` with value ``v``, the boundary of the
    region walked before the first strictly higher point in [lo_bound,
    pos-1] (left) or [pos+1, hi_bound] (right), or the region's border.
    Each descent step reads one entry of sparse-table row k."""
    idx = pos
    for k in range(levels - 1, -1, -1):
        step = 1 << k
        if left:
            cand = idx - step
            jumpable = (cand >= lo_bound) & (_row(maxt, k, cand) <= v)
        else:
            cand = idx + step
            jumpable = (cand <= hi_bound) & (_row(maxt, k, idx + 1) <= v)
        idx = torch.where(jumpable, cand, idx)
    if left:
        return torch.maximum(idx - 1, lo_bound - 1)
    return torch.minimum(idx + 1, hi_bound + 1)


def _compact(mask: torch.Tensor, width: int, fill: int, values: Optional[torch.Tensor] = None):
    """The first ``width`` masked positions (or ``values`` there) of each
    row, ascending, into (B, width) filled with ``fill``: a scatter into one
    spare slot more, sliced off."""
    B, n = mask.shape
    rank = torch.cumsum(mask, dim=1) - 1
    slot = torch.where(mask, rank, width).clamp(max=width)
    if values is None:
        values = torch.arange(n, device=mask.device).expand(B, n)
    out = torch.full((B, width + 1), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(1, slot, values.to(torch.int64))
    return out[:, :width]


def find_rpeaks_batch(
    signals: torch.Tensor,
    sampling_rate: int = 500,
    max_peaks: Optional[int] = None,
    candidate_slots: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R peaks of each row of a (B, T) batch.

    Returns (peaks, n_peaks): ``peaks`` (B, max_peaks) int64 padded with -1,
    ``n_peaks`` (B,) int64.  ``max_peaks`` defaults to the provable bound
    ``min(MAX_SEGMENTS, T // mindelay + 2)``.

    ``candidate_slots`` narrows the prominence-walk buffer; the caller must
    guarantee every row has at most that many strict interior local maxima.
    Left as None, the batch's largest count is read from the device (one
    host sync) and the light buffer (``LIGHT_CANDIDATES``) taken where it
    fits, else the provable bound (T-1)//2+1: the JAX function's two-tier
    dispatch.  Results are the same either way; only the walk width
    differs."""
    x = signals.to(torch.float32)
    B, T = x.shape
    dev = x.device
    levels = int(math.ceil(math.log2(T))) + 1

    smoothwindow, avgwindow = 0.1, 0.75
    gradthreshweight, minlenweight, mindelay_s = 1.5, 0.4, 0.3
    smooth_kernel = int(round(smoothwindow * sampling_rate))
    avg_kernel = int(round(avgwindow * sampling_rate))
    mindelay = int(round(mindelay_s * sampling_rate))
    if max_peaks is None:
        max_peaks = min(MAX_SEGMENTS, T // mindelay + 2)
    max_candidates = (T - 1) // 2 + 1
    if candidate_slots is None and max_candidates > LIGHT_CANDIDATES and B:
        interior = (x[:, 1:-1] > x[:, :-2]) & (x[:, 1:-1] > x[:, 2:])
        if int(interior.sum(dim=1).max()) <= LIGHT_CANDIDATES:
            candidate_slots = LIGHT_CANDIDATES
    if candidate_slots is not None:
        max_candidates = min(max_candidates, candidate_slots)

    absgrad = _gradient(x).abs()
    smoothgrad = _boxcar_smooth(absgrad, smooth_kernel)
    avggrad = _boxcar_smooth(smoothgrad, avg_kernel)
    qrs = smoothgrad > gradthreshweight * avggrad

    # transitions: beg at i where ~qrs[i] & qrs[i+1]; end at i where qrs[i] & ~qrs[i+1]
    rise = (~qrs[:, :-1]) & qrs[:, 1:]
    fall = qrs[:, :-1] & (~qrs[:, 1:])
    beg_qrs = _compact(rise, MAX_SEGMENTS, T)
    n_beg = rise.sum(dim=1)
    end_qrs_all = _compact(fall, MAX_SEGMENTS, T)
    first_beg = beg_qrs[:, :1]
    # keep only ends strictly after the first beginning
    end_valid = (end_qrs_all > first_beg) & (end_qrs_all < T)
    end_qrs = _compact(end_valid, MAX_SEGMENTS, T, end_qrs_all)
    n_end = end_valid.sum(dim=1)

    num_qrs = torch.minimum(n_beg, n_end)
    seg_ids = torch.arange(MAX_SEGMENTS, device=dev)
    seg_valid = seg_ids[None, :] < num_qrs[:, None]
    seg_len = torch.where(seg_valid, end_qrs - beg_qrs, 0)
    # float32 true divide of the two integer counts, as the JAX function's
    min_len = seg_len.sum(dim=1).to(torch.float32) / num_qrs.clamp(min=1).to(torch.float32) * minlenweight

    # strict local maxima (plateaus resolve to their left edge)
    is_locmax = torch.zeros_like(qrs)
    is_locmax[:, 1:-1] = (x[:, 1:-1] > x[:, :-2]) & (x[:, 1:-1] > x[:, 2:])

    # segment membership in position space: rises and valid falls alternate,
    # so the containing segment's beg is a forward cummax fill of valid rise
    # positions and its end a reverse cummin fill of valid fall positions
    pos = torch.arange(T, device=dev).expand(B, T)
    no = torch.zeros_like(qrs[:, :1])
    rise_f = torch.cat([rise, no], dim=1)
    fall_f = torch.cat([fall, no], dim=1)
    n_seg_cap = num_qrs.clamp(max=MAX_SEGMENTS)[:, None]
    rise_ord = torch.cumsum(rise_f, dim=1) - 1
    valid_rise = rise_f & (rise_ord < n_seg_cap)
    fall_after = fall_f & (pos > first_beg)
    fall_ord = torch.cumsum(fall_after, dim=1) - 1
    valid_fall = fall_after & (fall_ord < n_seg_cap)

    last_beg = torch.cummax(torch.where(valid_rise, pos, -1), dim=1).values
    next_end = torch.cummin(torch.where(valid_fall, pos, T).flip(1), dim=1).values.flip(1)
    in_seg = last_beg > torch.cummax(torch.where(valid_fall, pos, -1), dim=1).values
    # find_peaks runs on the slice [beg, end): interior maxima only
    cand = is_locmax & in_seg & (pos > last_beg) & (pos < next_end - 1)

    # prominence walks at the candidate local maxima only
    ci = _compact(cand, max_candidates, T)
    cvalid = ci < T
    cis = ci.clamp(0, T - 1)
    cv = torch.gather(x, 1, cis)
    seg_c = torch.gather(rise_ord, 1, cis).clamp(0, MAX_SEGMENTS - 1)
    clo = torch.where(cvalid, torch.gather(last_beg, 1, cis), 0)
    chi = torch.where(cvalid, torch.gather(next_end, 1, cis) - 1, 0)

    maxt, mint = _sparse_tables(x, levels)
    lstop = _nearest_higher(maxt, cis, cv, clo, chi, levels, left=True)
    rstop = _nearest_higher(maxt, cis, cv, clo, chi, levels, left=False)
    # the base minima: including the higher stop point never changes a min,
    # so clamping to the segment border is safe
    lmin = _range_min(mint, torch.maximum(lstop, clo).clamp(0, T - 1), cis)
    rmin = _range_min(mint, cis, torch.minimum(rstop, chi).clamp(0, T - 1))
    cprom = torch.where(cvalid, cv - torch.maximum(lmin, rmin), float("-inf"))

    # best candidate per segment; argmax ties go to the first position
    spare = torch.where(cvalid, seg_c, MAX_SEGMENTS)
    seg_best = torch.full((B, MAX_SEGMENTS + 1), float("-inf"), device=dev)
    seg_best.scatter_reduce_(1, spare, cprom, reduce="amax")
    is_best = cvalid & (cprom == torch.gather(seg_best, 1, seg_c))
    seg_peak = torch.full((B, MAX_SEGMENTS + 1), T, dtype=torch.int64, device=dev)
    seg_peak.scatter_reduce_(1, torch.where(is_best, seg_c, MAX_SEGMENTS), ci, reduce="amin")
    seg_peak = seg_peak[:, :MAX_SEGMENTS]
    seg_has_peak = seg_valid & (seg_len >= min_len[:, None]) & (seg_peak < T)

    # sequential min-delay acceptance (from the virtual peak at 0)
    last = torch.zeros(B, dtype=torch.int64, device=dev)
    takes = []
    for s in range(MAX_SEGMENTS):
        peak = seg_peak[:, s]
        take = seg_has_peak[:, s] & (peak - last > mindelay)
        last = torch.where(take, peak, last)
        takes.append(take)
    acc_mask = torch.stack(takes, dim=1)

    peaks = _compact(acc_mask, max_peaks, -1, seg_peak)
    n_peaks = acc_mask.sum(dim=1)
    return peaks, n_peaks


def find_rpeaks(signal: torch.Tensor, sampling_rate: int = 500, max_peaks: Optional[int] = None,
                candidate_slots: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One window (T,): ``find_rpeaks_batch`` of a batch of one."""
    peaks, n = find_rpeaks_batch(signal[None], sampling_rate, max_peaks, candidate_slots)
    return peaks[0], n[0]
