"""ECG delineation — P/Q/R/S/T peaks, onsets, offsets.

The reference delegates delineation to ``nk.ecg_delineate(sample, rpeaks,
sampling_rate)`` with the library default method
(data_extract_vitaldb.py:131; neurokit2 is *unpinned* in the reference's
requirements.txt, and 2024+ releases default to the DWT delineator).  This
module is a from-scratch implementation of that discrete-wavelet-transform
delineation algorithm (Martinez et al., IEEE TBME 2004, as adapted by the
neurokit2 project):

1. resample the window to a 2000 Hz analysis rate (linear interpolation);
2. compute 9 levels of an a-trous DWT (quadratic-spline filter bank:
   smoothing taps [1/8, 3/8, 3/8, 1/8], detail taps [2, -2], dilated by
   2^level, with per-level time-shift compensation);
3. T and P peaks: modulus-maxima pairs of the scale-4/3 detail signal inside
   HR-anchored search windows after/before each R peak; the positive->negative
   zero crossing with the best amplitude-vs-expected-latency score wins;
4. QRS onsets/offsets and T/P onsets/offsets: threshold crossings of the
   detail signal relative to the nearest slope peak;
5. Q and S peaks: signal minima between the QRS bounds and the R peak.

Output contract matches the reference's consumption
(data_extract_vitaldb.py:109-144, features_ecg.py:56-86): a dict of ten
per-beat lists (``ECG_P_Peaks`` ... ``ECG_T_Offsets``), each entry an int
sample index at the original rate or ``np.nan`` for undetected beats, list
lengths equal to len(rpeaks).

This is the behavioural twin of the third-party delineator, not a copy; where
the upstream library's exact tie-breaking could not be pinned (it is an
unpinned dependency in the reference too), the choice here is documented
inline.  It is the port's own copy of the JAX package's
``signals/delineate.py``: the ``python`` engine and the oracle of the C++
(``csrc/delineate.cpp``) and batched (``signals/delineate_device.py``) ones.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import scipy.signal

__all__ = [
    "delineate",
    "dwt_multiscales",
    "resample_to_analysis_rate",
    "FIDUCIAL_KEYS",
    "RESAMPLE_METHODS",
]

FIDUCIAL_KEYS = (
    "ECG_P_Peaks",
    "ECG_P_Onsets",
    "ECG_P_Offsets",
    "ECG_Q_Peaks",
    "ECG_R_Onsets",
    "ECG_R_Offsets",
    "ECG_S_Peaks",
    "ECG_T_Peaks",
    "ECG_T_Onsets",
    "ECG_T_Offsets",
)

_ANALYSIS_RATE = 2000

#: Known analysis-rate resampling assumption: the
#: upstream library resamples 500 -> 2000 Hz through its own
#: ``signal_resample`` helper whose interpolation method is a library
#: choice we cannot pin here (the dependency is unpinned in the reference
#: and it is not a dependency of this package).  "linear" is this framework's
#: default and the contract the C++ (csrc/delineate.cpp) and device
#: (delineate_device.py) engines implement; "fft" (scipy.signal.resample) and
#: "poly" (scipy.signal.resample_poly) are selectable on the python engine
#: to quantify the sensitivity once an oracle is available
#: (tests/test_nk_oracle.py activates itself when neurokit2 is importable).
RESAMPLE_METHODS = ("linear", "fft", "poly")


def resample_to_analysis_rate(
    signal: np.ndarray, fs: float, fs_out: float, method: str = "linear"
) -> np.ndarray:
    """Resample a window to the delineation analysis rate (see
    RESAMPLE_METHODS for the method contract)."""
    n_out = int(np.round(len(signal) * fs_out / fs))
    if method == "linear":
        x_out = np.linspace(0.0, 1.0, n_out, endpoint=False)
        x_in = np.linspace(0.0, 1.0, len(signal), endpoint=False)
        return np.interp(x_out, x_in, signal)
    if method == "fft":
        return scipy.signal.resample(np.asarray(signal, float), n_out)
    if method == "poly":
        up = int(round(fs_out))
        down = int(round(fs))
        g = np.gcd(up, down)
        return scipy.signal.resample_poly(np.asarray(signal, float), up // g, down // g)
    raise ValueError(f"unknown resample method {method!r}; choose from {RESAMPLE_METHODS}")


def dwt_multiscales(ecg: np.ndarray, max_degree: int = 9) -> np.ndarray:
    """A-trous DWT detail signals, shape (max_degree, len(ecg))."""
    details = []
    approx = np.asarray(ecg, dtype=float)
    for deg in range(max_degree):
        gap = np.zeros(2**deg - 1)
        delay = 2**deg
        g_taps = np.r_[2.0, gap, -2.0]
        h_taps = np.r_[1.0 / 8, gap, 3.0 / 8, gap, 3.0 / 8, gap, 1.0 / 8]
        detail = scipy.signal.convolve(approx, g_taps, mode="full")
        detail[:-delay] = detail[delay:]
        smooth = scipy.signal.convolve(approx, h_taps, mode="full")
        smooth[:-delay] = smooth[delay:]
        details.append(detail)
        approx = smooth
    return np.array([d[: len(ecg)] for d in details])


def _zero_crossings(x: np.ndarray) -> np.ndarray:
    return np.nonzero(np.abs(np.diff(np.sign(x))))[0]


def _modulus_maxima_pair_peak(
    dwt_local: np.ndarray,
    ecg_local: np.ndarray,
    height: float,
    fs: float,
    expected_latency: float,
    symmetric_score: bool,
) -> float:
    """Pick the fiducial peak inside a search window: among positive->negative
    modulus-maxima pairs of the detail signal, the zero crossing with the best
    (amplitude - latency penalty) score.  Returns a local index or NaN."""
    if len(dwt_local) == 0:
        return np.nan
    peaks, _ = scipy.signal.find_peaks(np.abs(dwt_local), height=height)
    peaks = [p for p in peaks if np.abs(dwt_local[p]) > 0.025 * np.max(dwt_local)]
    if dwt_local[0] > 0:
        peaks = [0] + peaks

    best_idx, best_score = np.nan, -np.inf
    for idx_peak, idx_nxt in zip(peaks[:-1], peaks[1:]):
        if not (dwt_local[idx_peak] > 0 and dwt_local[idx_nxt] < 0):
            continue
        zeros = _zero_crossings(dwt_local[idx_peak : idx_nxt + 1])
        if len(zeros) == 0:
            continue
        idx_zero = int(zeros[0]) + idx_peak
        latency = float(idx_zero) / fs - expected_latency
        score = ecg_local[idx_zero] - (abs(latency) if symmetric_score else latency)
        if score > best_score:
            best_score, best_idx = score, idx_zero
    return best_idx


def _delineate_tp_peaks(ecg, rpeaks, dwtmatr, fs, qrs_width=0.13, p2r_duration=0.2, rt_duration=0.25):
    srch_bndry = int(0.5 * qrs_width * fs)
    degree_add = int(np.log2(fs / 250))

    tpeaks: List[float] = []
    for rp in rpeaks:
        if np.isnan(rp):
            tpeaks.append(np.nan)
            continue
        start = int(rp) + srch_bndry
        end = int(rp) + 2 * int(rt_duration * fs)
        dwt_local = dwtmatr[3 + degree_add, start:end]
        if len(dwt_local) == 0:
            tpeaks.append(np.nan)
            continue
        height = 0.25 * np.sqrt(np.mean(np.square(dwt_local)))
        idx = _modulus_maxima_pair_peak(
            dwt_local, ecg[start:end], height, fs, rt_duration - 0.5 * qrs_width, symmetric_score=False
        )
        tpeaks.append(np.nan if np.isnan(idx) else int(idx) + start)

    ppeaks: List[float] = []
    for rp in rpeaks:
        if np.isnan(rp):
            ppeaks.append(np.nan)
            continue
        start = int(rp) - 2 * int(p2r_duration * fs)
        end = int(rp) - srch_bndry
        if start < 0 or end <= start:
            ppeaks.append(np.nan)
            continue
        dwt_local = dwtmatr[2 + degree_add, start:end]
        if len(dwt_local) == 0:
            ppeaks.append(np.nan)
            continue
        height = 0.02 * np.sqrt(np.mean(np.square(dwt_local)))
        idx = _modulus_maxima_pair_peak(
            dwt_local, ecg[start:end], height, fs, p2r_duration, symmetric_score=True
        )
        ppeaks.append(np.nan if np.isnan(idx) else int(idx) + start)

    return tpeaks, ppeaks


def _delineate_onsets_offsets(
    peaks, dwtmatr, fs, duration_onset, duration_offset, onset_weight, offset_weight, degree=2
):
    """Onset = last point below onset_weight * (last slope peak) before it;
    offset mirrored."""
    degree_add = int(np.log2(fs / 250))
    onsets: List[float] = []
    offsets: List[float] = []
    for pk in peaks:
        if np.isnan(pk):
            onsets.append(np.nan)
            offsets.append(np.nan)
            continue
        pk = int(pk)
        # onset
        start = max(pk - int(duration_onset * fs), 0)
        dwt_local = dwtmatr[degree + degree_add, start:pk]
        onset = np.nan
        slope_peaks, _ = scipy.signal.find_peaks(dwt_local)
        if len(slope_peaks) > 0:
            eps = onset_weight * dwt_local[slope_peaks[-1]]
            cands = np.where(dwt_local[: slope_peaks[-1]] < eps)[0]
            if len(cands) > 0:
                onset = int(cands[-1]) + start
        onsets.append(onset)
        # offset
        end = pk + int(duration_offset * fs)
        dwt_local = dwtmatr[degree + degree_add, pk:end]
        offset = np.nan
        slope_peaks, _ = scipy.signal.find_peaks(-dwt_local)
        if len(slope_peaks) > 0:
            eps = -offset_weight * dwt_local[slope_peaks[0]]
            cands = np.where(-dwt_local[slope_peaks[0] :] < eps)[0]
            if len(cands) > 0:
                offset = int(cands[0]) + slope_peaks[0] + pk
        offsets.append(offset)
    return onsets, offsets


def _delineate_qrs_bounds(rpeaks, dwtmatr, ppeaks, tpeaks, fs):
    degree_add = int(np.log2(fs / 250))
    onsets: List[float] = []
    for rp, pp in zip(rpeaks, ppeaks):
        if np.isnan(rp) or np.isnan(pp):
            onsets.append(np.nan)
            continue
        start, end = int(pp), int(rp)
        dwt_local = dwtmatr[2 + degree_add, start:end]
        onset = np.nan
        slope_peaks, _ = scipy.signal.find_peaks(-dwt_local)
        if len(slope_peaks) > 0:
            eps = 0.5 * -dwt_local[slope_peaks[-1]]
            cands = np.where(-dwt_local[: slope_peaks[-1]] < eps)[0]
            if len(cands) > 0:
                onset = int(cands[-1]) + start
        onsets.append(onset)

    offsets: List[float] = []
    for rp, tp in zip(rpeaks, tpeaks):
        if np.isnan(rp) or np.isnan(tp):
            offsets.append(np.nan)
            continue
        start, end = int(rp), int(tp)
        dwt_local = dwtmatr[2 + degree_add, start:end]
        offset = np.nan
        slope_peaks, _ = scipy.signal.find_peaks(-dwt_local)
        if len(slope_peaks) > 0:
            eps = 0.5 * -dwt_local[slope_peaks[0]]
            cands = np.where(-dwt_local[slope_peaks[0] :] < eps)[0]
            if len(cands) > 0:
                offset = int(cands[0]) + slope_peaks[0] + start
        offsets.append(offset)
    return onsets, offsets


def _qs_peaks(ecg, rpeaks, qrs_onsets, qrs_offsets):
    """Q/S peaks as signal minima between the QRS bounds and the R peak."""
    qpeaks: List[float] = []
    speaks: List[float] = []
    for rp, on, off in zip(rpeaks, qrs_onsets, qrs_offsets):
        if np.isnan(rp) or np.isnan(on) or int(on) >= int(rp):
            qpeaks.append(np.nan)
        else:
            seg = ecg[int(on) : int(rp)]
            qpeaks.append(int(np.argmin(seg)) + int(on))
        if np.isnan(rp) or np.isnan(off) or int(rp) + 1 >= int(off):
            speaks.append(np.nan)
        else:
            seg = ecg[int(rp) + 1 : int(off)]
            speaks.append(int(np.argmin(seg)) + int(rp) + 1)
    return qpeaks, speaks


def _downsample_points(points: Sequence[float], factor: float) -> List[float]:
    return [np.nan if np.isnan(p) else int(p * factor) for p in points]


def delineate(
    ecg: np.ndarray,
    rpeaks: Sequence[int],
    sampling_rate: int = 500,
    resample_method: str = "linear",
) -> Dict[str, List[float]]:
    """Delineate one window.  Returns the ten fiducial lists (see module docs).

    ``resample_method``: analysis-rate resampler, see RESAMPLE_METHODS."""
    rpeaks = list(rpeaks)
    if len(rpeaks) == 0:
        return {k: [] for k in FIDUCIAL_KEYS}
    fs = _ANALYSIS_RATE
    up = fs / sampling_rate
    ecg_hi = resample_to_analysis_rate(np.asarray(ecg, float), sampling_rate, fs, resample_method)
    dwtmatr = dwt_multiscales(ecg_hi, 9)
    rp_hi = [int(r * up) for r in rpeaks]

    tpeaks, ppeaks = _delineate_tp_peaks(ecg_hi, rp_hi, dwtmatr, fs)
    r_onsets, r_offsets = _delineate_qrs_bounds(rp_hi, dwtmatr, ppeaks, tpeaks, fs)
    p_onsets, p_offsets = _delineate_onsets_offsets(
        ppeaks, dwtmatr, fs, duration_onset=0.3, duration_offset=0.3, onset_weight=0.4, offset_weight=0.4
    )
    t_onsets, t_offsets = _delineate_onsets_offsets(
        tpeaks, dwtmatr, fs, duration_onset=0.6, duration_offset=0.3, onset_weight=0.6, offset_weight=0.4
    )
    qpeaks, speaks = _qs_peaks(ecg_hi, rp_hi, r_onsets, r_offsets)

    down = 1.0 / up
    return {
        "ECG_P_Peaks": _downsample_points(ppeaks, down),
        "ECG_P_Onsets": _downsample_points(p_onsets, down),
        "ECG_P_Offsets": _downsample_points(p_offsets, down),
        "ECG_Q_Peaks": _downsample_points(qpeaks, down),
        "ECG_R_Onsets": _downsample_points(r_onsets, down),
        "ECG_R_Offsets": _downsample_points(r_offsets, down),
        "ECG_S_Peaks": _downsample_points(speaks, down),
        "ECG_T_Peaks": _downsample_points(tpeaks, down),
        "ECG_T_Onsets": _downsample_points(t_onsets, down),
        "ECG_T_Offsets": _downsample_points(t_offsets, down),
    }
