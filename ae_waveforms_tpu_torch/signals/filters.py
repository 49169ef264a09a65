"""Z-score and zero-phase Butterworth filtering (counterpart of the JAX
package's ``signals/filters.py``).

Two paths, as in the JAX package:

- the host path, ``butterworth(..., precision="float64")``: the reference's
  scipy ``filtfilt`` chain in float64 (reference: filters.py:15-55), the
  parity oracle and the CLI's default;
- the device path, ``filtfilt_fixed`` and ``butterworth_batched``: the IIR
  runs as a cascade of biquads in float32 on torch tensors, each biquad a
  linear recurrence ``s_t = M s_{t-1} + v_t`` over a 2-vector state,
  evaluated by a Hillis-Steele doubling scan: ``ceil(log2 N)`` steps of
  ``s[t] += M^(2^k) s[t - 2^k]``.  For the complex pole pair of every
  Butterworth low- or high-pass biquad the state runs in modal coordinates,
  where ``M = r R(theta)`` and ``M^(2^k)`` has the closed form
  ``r^(2^k) R(2^k theta)``, taken from ``exp(2^k log r)``,
  ``cos(2^k theta)`` and ``sin(2^k theta)`` in float64 on the host, never
  from repeated products.  That is what keeps the stiff 1 Hz high-pass
  (poles ~4e-3 from the unit circle) accurate in float32, as the JAX
  package's closed-form associative scan does.  The initial state enters as
  part of the first step's input.

Both paths keep the reference's NaN rule: each non-NaN segment is filtered
on its own, and segments of length <= ``3 * max(len(a), len(b))`` pass
through unfiltered.  Filter design (``scipy.signal.butter``) runs on the
host.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import scipy.signal
import torch

__all__ = [
    "zscore",
    "butter_coefficients",
    "butter_sos",
    "filtfilt",
    "filtfilt_fixed",
    "butterworth",
    "butterworth_batched",
    "nan_segments",
]


def zscore(data: np.ndarray) -> np.ndarray:
    """NaN-aware z-score over all elements (reference: filters.py:5-12)."""
    return (data - np.nanmean(data)) / np.nanstd(data)


@functools.lru_cache(maxsize=32)
def butter_coefficients(order: int, cutoff_hz: float, btype: str,
                        fs: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Butterworth (b, a) plus steady-state initial conditions ``zi`` (host
    constants for a given (order, cutoff, type, fs))."""
    nyquist = 0.5 * fs
    b, a = scipy.signal.butter(N=order, Wn=cutoff_hz / nyquist, btype=btype, analog=False)
    zi = scipy.signal.lfilter_zi(b, a)
    return b, a, zi


@functools.lru_cache(maxsize=32)
def butter_sos(order: int, cutoff_hz: float, btype: str, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """Second-order-section form plus per-section steady-state ``zi``.

    The device path runs the IIR as a cascade of biquads: each biquad's
    transients stay bounded by ~1/sin(pole angle), where the powers of a
    stiff 4th-order companion matrix overflow float32.  With steady-state
    initialisation the cascade equals the ba-form ``lfilter`` in real
    arithmetic."""
    nyquist = 0.5 * fs
    sos = scipy.signal.butter(N=order, Wn=cutoff_hz / nyquist, btype=btype, analog=False, output="sos")
    zi = scipy.signal.sosfilt_zi(sos)  # (n_sections, 2), unit-constant-input steady state
    return sos, zi


def _affine_ops(b: np.ndarray, a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(A, c) of the DF2T state recurrence s' = A s + c x (a0 = 1):
    y = b0 x + z0, z_k' = b_{k+1} x + z_{k+1} - a_{k+1} y (z_n := 0)."""
    n = max(len(a), len(b)) - 1
    b = np.concatenate([b, np.zeros(n + 1 - len(b))])
    a = np.concatenate([a, np.zeros(n + 1 - len(a))])
    A = np.zeros((n, n))
    c = np.zeros(n)
    for k in range(n):
        if k + 1 < n:
            A[k, k + 1] = 1.0
        A[k, 0] += -a[k + 1]
        c[k] = b[k + 1] - a[k + 1] * b[0]
    return A, c


@functools.lru_cache(maxsize=64)
def _biquad_scan_form(b: tuple, a: tuple, n_steps: int):
    """Host constants of one biquad's scan: the basis V of the scan
    coordinates (DF2T state = V @ scan state), the input map ``c`` and the
    initial-state map in scan coordinates, and for each doubling step k the
    2x2 matrix ``M^(2^k)``, all float64.

    Complex poles: modal coordinates, ``M^(2^k) = r^(2^k) R(2^k theta)`` in
    closed form.  Real poles (a first-order section of an odd-order design):
    DF2T coordinates, ``A^(2^k)`` by float64 matrix powers."""
    A, c = _affine_ops(np.asarray(b), np.asarray(a))
    assert A.shape == (2, 2), "the scan is specialised to biquads"
    w, U = np.linalg.eig(A)
    if abs(w[0].imag) < 1e-12:
        V = np.eye(2)
        steps = [np.linalg.matrix_power(A, 1 << k) for k in range(n_steps)]
        return V, c, A, np.stack(steps) if steps else np.zeros((0, 2, 2))
    i = 0 if w[0].imag > 0 else 1
    lam, u = w[i], U[:, i]
    V = np.stack([u.real, u.imag], axis=1)  # A V = V [[re, im], [-im, re]]
    Vinv = np.linalg.inv(V)
    log_r, theta = float(np.log(np.abs(lam))), float(np.arctan2(lam.imag, lam.real))

    def power(length: float) -> np.ndarray:
        scale, ang = math.exp(length * log_r), length * theta
        return scale * np.array([[math.cos(ang), math.sin(ang)], [-math.sin(ang), math.cos(ang)]])

    steps = [power(float(1 << k)) for k in range(n_steps)]
    return V, Vinv @ c, power(1.0) @ Vinv, np.stack(steps) if steps else np.zeros((0, 2, 2))


def _lfilter(x: torch.Tensor, b, a, zi_row: np.ndarray, x0: torch.Tensor) -> torch.Tensor:
    """One biquad over the last axis of x (..., N) from the DF2T state
    ``zi_row * x0`` (x0: (...,)), by the doubling scan.  float32 in, float32
    out.

    The initial state enters the first step as ``(M V^-1 zi_row) x0``, the
    2-vector taken in float64 on the host: the modal basis of the stiff
    high-pass is ill-conditioned (|V^-1| ~ 300), and mapping a float32
    state through it would cancel ~2e-5 of its value away."""
    N = x.shape[-1]
    n_steps = max(1, math.ceil(math.log2(N))) if N > 1 else 0
    V, c, init, steps = _biquad_scan_form(tuple(float(v) for v in b), tuple(float(v) for v in a), n_steps)
    f32 = dict(dtype=x.dtype, device=x.device)
    c = torch.as_tensor(c, **f32)
    s = x[..., None] * c  # (..., N, 2) per-step inputs in scan coordinates
    # s_{-1} = V^-1 zi_row x0: fold M s_{-1} into the first step's input
    s[..., 0, :] += torch.as_tensor(init @ np.asarray(zi_row, np.float64), **f32) * x0[..., None]
    s0 = torch.as_tensor(zi_row, **f32) * x0[..., None]
    for k in range(n_steps):
        d = 1 << k
        if d >= N:
            break
        m = [float(v) for v in steps[k].reshape(-1)]
        prev = s[..., :-d, :]
        s0c, s1c = prev[..., 0], prev[..., 1]
        add = torch.stack([s0c * m[0] + s1c * m[1], s0c * m[2] + s1c * m[3]], dim=-1)
        s[..., d:, :] += add
    # back to DF2T coordinate 0; y[t] = b0 x[t] + z0[t-1]
    row0 = s[..., 0] * float(V[0, 0]) + s[..., 1] * float(V[0, 1])
    prev0 = torch.cat([s0[..., :1], row0[..., :-1]], dim=-1)
    return float(b[0]) * x + prev0


def _sosfilt(x: torch.Tensor, sos: np.ndarray, zi_rows: np.ndarray, x0: torch.Tensor) -> torch.Tensor:
    """Biquad cascade; ``zi_rows * x0`` seeds each section with its steady
    state for a constant input equal to the first sample (``sosfilt_zi``
    folds the sections' DC gains into the rows, scipy semantics)."""
    y = x
    for s in range(sos.shape[0]):
        y = _lfilter(y, sos[s, :3], sos[s, 3:], zi_rows[s], x0)
    return y


def filtfilt(x: torch.Tensor, sos: np.ndarray, zi_rows: np.ndarray, padlen: int) -> torch.Tensor:
    """Zero-phase forward-backward IIR over the last axis, scipy
    ``filtfilt(b, a, x)`` semantics (odd extension, ba-form padlen,
    steady-state zi), as a biquad cascade of doubling scans.  x must be
    NaN-free and longer than padlen."""
    left = 2 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    ext = torch.cat([left, x, right], dim=-1)
    y = _sosfilt(ext, sos, zi_rows, ext[..., 0]).flip(-1)
    y = _sosfilt(y, sos, zi_rows, y[..., 0]).flip(-1)
    return y[..., padlen:-padlen]


def filtfilt_fixed(x: torch.Tensor, n_valid: torch.Tensor, order: int, cutoff_hz: float, btype: str,
                   fs: float) -> torch.Tensor:
    """Batched filtfilt over rows of different lengths: x (R, N) is a
    zero-padded buffer whose row r holds ``n_valid[r]`` real samples.  The
    odd extension and both reversals are gathers at each row's own length.
    Returns (R, N) whose first ``n_valid[r]`` entries of row r are the
    filtered segment (the rest is unspecified).  Counterpart of the JAX
    ``filtfilt_fixed``, vmapped."""
    sos, zi_rows = butter_sos(order, cutoff_hz, btype, fs)
    padlen = 3 * (order + 1)
    R, N = x.shape
    L = n_valid.to(device=x.device, dtype=torch.int64)[:, None]
    M = L + 2 * padlen  # extended length
    p = torch.arange(N + 2 * padlen, device=x.device)[None, :]

    def take(v, idx):
        return torch.gather(v, 1, idx.clamp(0, N - 1).expand(R, -1))

    left = 2 * x[:, :1] - take(x, padlen - p)
    mid = take(x, p - padlen)
    right = 2 * take(x, L - 1) - take(x, 2 * L + padlen - 2 - p)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ext = torch.where(p < padlen, left, torch.where(p < padlen + L, mid, torch.where(p < M, right, zero)))

    def reverse(y):  # rev[p] = y[M - 1 - p] within each row's extended length
        idx = (M - 1 - p).clamp(0, N + 2 * padlen - 1).expand(R, -1)
        return torch.where(p < M, torch.gather(y, 1, idx), zero)

    y = _sosfilt(ext, sos, zi_rows, ext[:, 0])
    y = reverse(y)
    y = _sosfilt(y, sos, zi_rows, y[:, 0])
    y = reverse(y)
    return y[:, padlen : padlen + N]


def nan_segments(data: np.ndarray) -> List[Tuple[int, int]]:
    """[start, end) of each non-NaN run, as the reference finds them
    (filters.py:37-45)."""
    isnan = np.isnan(data)
    if len(data) == 0:
        return []
    seg_start = np.where(isnan[:-1] & ~isnan[1:])[0] + 1
    seg_end = np.where(~isnan[:-1] & isnan[1:])[0] + 1
    if not isnan[0]:
        seg_start = np.insert(seg_start, 0, 0)
    if not isnan[-1]:
        seg_end = np.append(seg_end, len(data))
    return [(int(s), int(e)) for s, e in zip(seg_start, seg_end)]


def _filter_rows(segments: List[np.ndarray], hp_hz: Optional[float], lp_hz: Optional[float], fs: float,
                 order: int, device) -> List[np.ndarray]:
    """HP then LP (each optional) over segments pooled into one (R, N)
    float32 batch on ``device``; returns each segment filtered."""
    from ae_waveforms_tpu_torch import resolve_device

    device = resolve_device(device)
    N = max(len(s) for s in segments)
    buf = np.zeros((len(segments), N), np.float32)
    for k, s in enumerate(segments):
        buf[k, : len(s)] = s
    y = torch.from_numpy(buf).to(device)
    ns = torch.tensor([len(s) for s in segments], device=device)
    if hp_hz is not None:
        y = filtfilt_fixed(y, ns, order, float(hp_hz), "high", float(fs))
    if lp_hz is not None:
        y = filtfilt_fixed(y, ns, order, float(lp_hz), "low", float(fs))
    out = y.cpu().numpy()
    return [out[k, : len(s)] for k, s in enumerate(segments)]


def butterworth_batched(
    records: List[np.ndarray],
    hp_hz: Optional[float],
    lp_hz: Optional[float],
    sampling_frequency: float = 500,
    filter_order: int = 4,
    device=None,
) -> List[np.ndarray]:
    """NaN-segmented zero-phase HP+LP over many records at once (float32
    device path).  Segment boundaries, the short-segment pass-through and
    NaN preservation match ``butterworth`` (reference: filters.py:15-55,
    applied twice).  Segments of all records are pooled and grouped by
    power-of-two length bucket, one batch on ``device`` per bucket; a
    segment's result does not depend on its batch or bucket."""
    if hp_hz is None and lp_hz is None:
        return [np.asarray(r, np.float32) for r in records]
    ref_cut = hp_hz if hp_hz is not None else lp_hz
    b, a, _ = butter_coefficients(filter_order, float(ref_cut), "high" if hp_hz is not None else "low",
                                  float(sampling_frequency))
    thresh = 3 * max(len(a), len(b))

    outs = [np.full(len(r), np.nan, np.float32) for r in records]
    groups: dict = {}  # bucket -> [(record index, start, end)]
    for ri, data in enumerate(records):
        data = np.asarray(data)
        for start, end in nan_segments(data):
            if end - start <= thresh:
                outs[ri][start:end] = data[start:end]
            else:
                bucket = 1 << max(10, int(np.ceil(np.log2(end - start))))
                groups.setdefault(bucket, []).append((ri, start, end))
    for _, items in sorted(groups.items()):
        ys = _filter_rows([np.asarray(records[ri][s:e], np.float32) for ri, s, e in items],
                          hp_hz, lp_hz, sampling_frequency, filter_order, device)
        for (ri, s, e), y in zip(items, ys):
            outs[ri][s:e] = y
    return outs


def butterworth(
    data: np.ndarray,
    btype: str,
    cutoff_frequency: float,
    sampling_frequency: float = 500,
    filter_order: int = 4,
    precision: str = "float32",
    device=None,
) -> np.ndarray:
    """NaN-segmented zero-phase Butterworth (reference: filters.py:15-55).

    ``precision="float64"`` runs scipy's ``filtfilt`` on the host (the
    parity oracle); ``"float32"`` runs ``filtfilt_fixed`` on ``device``,
    every long segment of the record in one batch."""
    data = np.asarray(data)
    b, a, _ = butter_coefficients(filter_order, float(cutoff_frequency), btype, float(sampling_frequency))
    thresh = 3 * max(len(a), len(b))
    out = np.full_like(data, np.nan, dtype=np.float64 if precision == "float64" else np.float32)
    long_segments = []
    for start, end in nan_segments(data):
        seg = data[start:end]
        if end - start <= thresh:
            out[start:end] = seg
        elif precision == "float64":
            out[start:end] = scipy.signal.filtfilt(b, a, seg.astype(np.float64))
        else:
            long_segments.append((start, end))
    if long_segments:
        hp, lp = (cutoff_frequency, None) if btype == "high" else (None, cutoff_frequency)
        ys = _filter_rows([np.asarray(data[s:e], np.float32) for s, e in long_segments], hp, lp,
                          sampling_frequency, filter_order, device)
        for (s, e), y in zip(long_segments, ys):
            out[s:e] = y
    return out
