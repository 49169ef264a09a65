"""Batched DWT delineation on the device: the counterpart of the JAX
package's ``signals/delineate_jax.py`` (``delineate_batch``), the same
algorithm as ``signals.delineate`` in float32 with fixed shapes and masked
searches.

Everything the host version does per beat with Python loops becomes a
masked reduction over a fixed search window of every (window, beat) pair:

- "last/first slope peak"            -> masked max/min of local-max indices
- "first zero crossing after p"      -> reverse-cummin next-crossing index
- "next retained modulus maximum"    -> reverse-cummin next-peak index
- "last/first threshold candidate"   -> masked max/min index

A search over windows of capacity ``w`` works on (B, K, w) tensors, each
window a row gathered from an unfolded view of the zero-padded signal (no
index tensor of that size).  At B = 512 windows, K = 48 beats and w = 1,280
one such float32 tensor is 126 MB.

Arithmetic follows the JAX function as XLA runs it on the CPU, where LLVM
fuses a multiply into the add that consumes it: the 4x linear resample and
the a-trous smoothing taps keep that one rounding (``_fma``: the product and
sum in float64, rounded once to float32), the taps' left-to-right order is
np.convolve's, and the window RMS is a float32 sum accumulated in float64.
The fiducials are integer indices picked by float32 thresholds, so these
roundings decide ties; the card and the CPU give the same indices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES
from ae_waveforms_tpu_torch.signals.qc import div, sum_f32

__all__ = ["delineate_batch", "ANALYSIS_RATE", "W"]

ANALYSIS_RATE = 2000
W = 1280  # largest search window (the 0.6 s T-onset lookback at the analysis rate)
BIG = 10**9
_PAD = 2048  # covers the 9-scale a-trous growth (sum of 3 * 2^deg)

assert W >= int(0.6 * ANALYSIS_RATE), "W must cover the T-onset search window"


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add): the
    product and sum are exact in float64 for these operands."""
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


def _resample4(x: torch.Tensor) -> torch.Tensor:
    """Linear resample by exactly 4x (500 Hz -> 2000 Hz) of each row, as
    np.interp over endpoint=False grids: out[4i+j] = (1-j/4) x[i] + (j/4)
    x[i+1], the first product fused into the add."""
    B, n = x.shape
    x_next = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    cols = []
    for j in range(4):
        w = j * 0.25
        cols.append(_fma(x, 1.0 - w, x_next * w))
    return torch.stack(cols, dim=2).reshape(B, 4 * n)


def _dwt_scales(x: torch.Tensor, needed) -> Dict[int, torch.Tensor]:
    """Detail signals ``{scale: (B, T)}`` of the a-trous quadratic-spline
    bank (smoothing taps [1/8, 3/8, 3/8, 1/8], detail taps [2, -2], dilated
    by 2^deg, with the time-shift compensation), for the ``needed`` scales.

    Every scale runs on a buffer zero-padded by ``_PAD``, which reproduces
    the entries of the host's growing full convolutions that survive the
    final trim to T.  A tap is a shifted copy (the dense convolution's zero
    taps add exactly 0), summed in np.convolve's left-to-right order."""
    needed = set(int(s) for s in needed)
    max_degree = max(needed) + 1
    B, T = x.shape
    approx = torch.cat([x, x.new_zeros(B, _PAD)], dim=1)
    n = T + _PAD
    details = {}
    for deg in range(max_degree):
        s = 2**deg
        # a_j[i] = approx[i + s - j*s] over the output range i in [0, n):
        # the full convolution's term j, shifted back by the delay s
        ext = torch.cat([x.new_zeros(B, 2 * s), approx, x.new_zeros(B, s)], dim=1)

        def tap(j):
            return ext[:, 3 * s - j * s : 3 * s - j * s + n]

        if deg in needed:
            details[deg] = (2.0 * tap(0) + (-2.0) * tap(1))[:, :T]
        if deg + 1 < max_degree:
            t1 = 0.125 * tap(0) + 0.375 * tap(1)
            approx = _fma(tap(2), 0.375, t1) + 0.125 * tap(3)
    return details


class _Padded:
    """A (B, T) signal zero-padded by W on both sides, from which fixed-width
    windows are gathered as rows of its unfolded view."""

    def __init__(self, sig: torch.Tensor):
        self.T = sig.shape[1]
        self.buf = torch.nn.functional.pad(sig, (W, W))
        self.rows = torch.arange(sig.shape[0], device=sig.device)[:, None]

    def window(self, start: torch.Tensor, length: torch.Tensor, w: int):
        """sig[start : start+length] in (B, K, w) windows with their validity
        masks (zeros where invalid)."""
        k = torch.arange(w, device=start.device)
        idx = start[..., None] + k
        valid = (k < length[..., None]) & (idx >= 0) & (idx < self.T)
        view = self.buf.unfold(1, w, 1)  # (B, T + 2W - w + 1, w), no copy
        vals = view[self.rows, start.clamp(-w, self.T) + W]
        return torch.where(valid, vals, 0.0), valid


def _local_max_mask(d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """scipy find_peaks: strictly greater than both neighbours, inside the
    valid region only."""
    up = torch.zeros_like(valid)
    up[..., 1:-1] = (d[..., 1:-1] > d[..., :-2]) & (d[..., 1:-1] > d[..., 2:])
    interior = valid & torch.roll(valid, 1, -1) & torch.roll(valid, -1, -1)
    interior[..., 0] = False
    interior[..., -1] = False
    return up & interior


def _iota(d: torch.Tensor) -> torch.Tensor:
    return torch.arange(d.shape[-1], device=d.device, dtype=torch.int32)


def _next_index(mask: torch.Tensor) -> torch.Tensor:
    """nxt[k] = smallest index >= k with mask, else BIG (reverse cummin)."""
    idx = torch.where(mask, _iota(mask), BIG)
    return torch.cummin(idx.flip(-1), dim=-1).values.flip(-1)


def _masked_last(mask: torch.Tensor) -> torch.Tensor:
    """largest index with mask, else -BIG."""
    return torch.where(mask, _iota(mask), -BIG).amax(dim=-1)


def _masked_first(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, _iota(mask), BIG).amin(dim=-1)


def _shift_left(a: torch.Tensor, fill: int) -> torch.Tensor:
    """a[k + 1], ``fill`` at the end."""
    return torch.cat([a[..., 1:], torch.full_like(a[..., :1], fill)], dim=-1)


def _as_index(v: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(v).to(torch.int64)


def _nan_where(found: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(found, v.to(torch.float32), float("nan"))


def _tp_peak(ecg: _Padded, dwt: _Padded, start, length, eps_weight, expected_latency, symmetric, fs, w):
    """Each beat's T- or P-peak search in [start, start+length): among
    positive -> negative modulus-maxima pairs of the detail signal, the zero
    crossing with the best amplitude-minus-latency score.  Returns the float
    index into the analysis signal, or NaN."""
    d, valid = dwt.window(start, length, w)
    e, _ = ecg.window(start, length, w)
    n = valid.sum(dim=-1)
    rms = torch.sqrt(sum_f32(torch.where(valid, d * d, 0.0), -1) / n.clamp(min=1).to(torch.float32))
    height = eps_weight * rms
    absd = d.abs()
    peaks = _local_max_mask(absd, valid) & (absd > height[..., None])
    dmax = torch.where(valid, d, float("-inf")).amax(dim=-1)
    peaks &= absd > (0.025 * dmax)[..., None]
    # the virtual peak at 0 when the window opens positive
    peaks[..., 0] |= valid[..., 0] & (d[..., 0] > 0)

    k = _iota(d)
    partner = _shift_left(_next_index(peaks), BIG)
    # the next peak is negative iff the next negative peak is the next peak
    partner_neg = _shift_left(_next_index(peaks & (d < 0)), BIG)
    s = torch.sign(d)
    cross = torch.zeros_like(valid)
    cross[..., :-1] = s[..., 1:] != s[..., :-1]
    cross &= valid & torch.roll(valid, -1, -1)
    idx_zero = _next_index(cross)  # first crossing at/after the positive peak
    cand = peaks & (partner < BIG) & (d > 0) & (partner_neg == partner) & (idx_zero <= partner) & (idx_zero < w)

    # the score depends only on the crossing a candidate leads to, so take
    # the argmax over crossings hit by a candidate (first max wins, as the
    # candidates' order)
    last_cand_le = torch.cummax(torch.where(cand, k, -1), dim=-1).values
    last_cross_le = torch.cummax(torch.where(cross, k, -1), dim=-1).values
    prev_cross_lt = torch.cat([torch.full_like(last_cross_le[..., :1], -1), last_cross_le[..., :-1]], dim=-1)
    hit = cross & (last_cand_le > prev_cross_lt)
    latency = div(k.to(torch.float32), float(fs)) - expected_latency
    penalty = latency.abs() if symmetric else latency
    g = torch.where(hit, e - penalty, float("-inf"))
    best = torch.argmax(g, dim=-1)
    found = (n > 0) & hit.any(dim=-1)
    return _nan_where(found, best + start)


def _onset_search(row: _Padded, start, length, weight, negate, w):
    """Last sub-threshold point before the last slope peak in
    [start, start+length): eps = weight * value at that slope peak."""
    d, valid = row.window(start, length, w)
    d = -d if negate else d
    last_sp = _masked_last(_local_max_mask(d, valid))
    eps = weight * torch.gather(d, -1, last_sp.clamp(0, w - 1).to(torch.int64)[..., None])
    k = _iota(d)
    last_c = _masked_last(valid & (k < last_sp[..., None]) & (d < eps))
    return _nan_where((last_sp >= 0) & (last_c >= 0), last_c + start)


def _offset_search(row: _Padded, start, length, weight, negate, w):
    """First sub-threshold point at/after the first slope peak in
    [start, start+length)."""
    d, valid = row.window(start, length, w)
    d = -d if negate else d
    first_sp = _masked_first(_local_max_mask(d, valid))
    eps = weight * torch.gather(d, -1, first_sp.clamp(0, w - 1).to(torch.int64)[..., None])
    k = _iota(d)
    first_c = _masked_first(valid & (k >= first_sp[..., None]) & (d < eps))
    return _nan_where((first_sp < BIG) & (first_c < BIG), first_c + start)


def _argmin_window(sig: _Padded, lo, hi, w):
    """argmin of sig over [lo, hi) as an absolute float index, NaN if the
    window is empty."""
    vals, valid = sig.window(lo, hi - lo, w)
    k = torch.argmin(torch.where(valid, vals, float("inf")), dim=-1)
    return _nan_where(valid.any(dim=-1), k + lo)


def _lane(n: int) -> int:
    """Search capacity: the longest possible window rounded up to 128, as
    the JAX function sizes its static windows."""
    return ((n + 127) // 128) * 128


def delineate_batch(samples: torch.Tensor, peaks: torch.Tensor, n_peaks: torch.Tensor,
                    fs_in: int = 500) -> Dict[str, torch.Tensor]:
    """(B, T) windows + (B, K) padded R peaks -> the ten (B, K) float32
    fiducial arrays at the original rate (NaN for undetected or padded
    beats), keyed by ``FIDUCIAL_NAMES``."""
    fs = ANALYSIS_RATE
    up = fs // fs_in
    x = samples.to(torch.float32)
    peaks = peaks.to(device=x.device, dtype=torch.int64)
    n_peaks = n_peaks.to(device=x.device, dtype=torch.int64)
    ecg_sig = _resample4(x)
    deg = int(np.log2(fs / 250))  # 3
    dwt = _dwt_scales(ecg_sig, needed=(2 + deg, 3 + deg))
    ecg, row2, row3 = _Padded(ecg_sig), _Padded(dwt[2 + deg]), _Padded(dwt[3 + deg])

    K = peaks.shape[1]
    beat_valid = (torch.arange(K, device=x.device)[None, :] < n_peaks[:, None]) & (peaks >= 0)
    r = torch.where(beat_valid, peaks * up, 0)

    srch_bndry = int(0.5 * 0.13 * fs)  # 130
    t_dur = 2 * int(0.25 * fs)  # 1000
    p_back = 2 * int(0.2 * fs)  # 800
    on_off = int(0.3 * fs)  # 600
    t_on = int(0.6 * fs)  # 1200

    tpeaks = _tp_peak(ecg, row3, r + srch_bndry, torch.full_like(r, t_dur - srch_bndry), 0.25,
                      0.25 - 0.5 * 0.13, False, fs, _lane(t_dur - srch_bndry))
    p_start = r - p_back
    ppeaks = _tp_peak(ecg, row2, p_start, (r - srch_bndry) - p_start, 0.02, 0.2, True, fs,
                      _lane(p_back - srch_bndry))
    ppeaks = torch.where(p_start < 0, float("nan"), ppeaks)

    # QRS bounds from the P and T peaks
    pp, tp = _as_index(ppeaks), _as_index(tpeaks)
    r_on = torch.where(torch.isnan(ppeaks), float("nan"), _onset_search(row2, pp, r - pp, 0.5, True, _lane(p_back)))
    r_off = torch.where(torch.isnan(tpeaks), float("nan"), _offset_search(row2, r, tp - r, 0.5, True, _lane(t_dur)))

    def bounds(pk, pki, dur_on, w_on, weight_on):
        start = (pki - dur_on).clamp(min=0)
        on = _onset_search(row2, start, pki - start, weight_on, False, _lane(w_on))
        off = _offset_search(row2, pki, torch.full_like(pki, on_off), 0.4, True, _lane(on_off))
        nan = torch.isnan(pk)
        return torch.where(nan, float("nan"), on), torch.where(nan, float("nan"), off)

    p_on, p_off = bounds(ppeaks, pp, on_off, on_off, 0.4)
    t_onset, t_off = bounds(tpeaks, tp, t_on, t_on, 0.6)

    # Q and S: signal minima between the QRS bounds and the R peak
    on_i, off_i = _as_index(r_on), _as_index(r_off)
    q_pk = torch.where(torch.isnan(r_on) | (on_i >= r), float("nan"), _argmin_window(ecg, on_i, r, _lane(p_back)))
    s_pk = torch.where(torch.isnan(r_off) | (r + 1 >= off_i), float("nan"),
                       _argmin_window(ecg, r + 1, off_i, _lane(t_dur)))

    def down(v):
        out = torch.floor(torch.nan_to_num(v) * (1.0 / up))
        return torch.where(torch.isnan(v) | ~beat_valid, float("nan"), out)

    fid = [ppeaks, p_on, p_off, q_pk, r_on, r_off, s_pk, tpeaks, t_onset, t_off]
    return {name: down(v) for name, v in zip(FIDUCIAL_NAMES, fid)}
