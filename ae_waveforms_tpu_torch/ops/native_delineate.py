"""The float64 host delineator (``csrc/delineate.cpp``, the ``host``
engine): built with ``g++`` by ``ops/_build.py`` on first use and bound
with ctypes, with the contract of the JAX package's
``native.delineate_batch_native``.

The C++ implements ``signals.delineate`` index-exactly.  A failed build
raises: the ``host`` engine never falls back to the Python delineator,
which runs only as the explicit ``python`` engine.  Windows are
independent, so a large batch is split over threads (ctypes releases the
interpreter lock during the call).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES
from ae_waveforms_tpu_torch.ops import _build

__all__ = ["delineate_batch_native"]

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_INT32_P = ctypes.POINTER(ctypes.c_int32)
_MIN_WINDOWS_PER_THREAD = 32


def _lib() -> ctypes.CDLL:
    lib = _build.load("delineate")
    fn = lib.delineate_batch_f64
    fn.argtypes = [
        _DOUBLE_P,  # samples (n_windows, window_len)
        ctypes.c_int,  # n_windows
        ctypes.c_int,  # window_len
        _INT32_P,  # peaks (n_windows, max_peaks)
        _INT32_P,  # n_peaks (n_windows,)
        ctypes.c_int,  # max_peaks
        ctypes.c_int,  # fs_in
        _DOUBLE_P,  # out (10, n_windows, max_peaks)
    ]
    fn.restype = None
    return lib


def delineate_batch_native(samples: np.ndarray, peaks: np.ndarray, n_peaks: np.ndarray,
                           fs_in: int = 500) -> Dict[str, np.ndarray]:
    """(B, T) float64 windows, (B, K) R peaks padded with -1 and (B,) peak
    counts -> the ten (B, K) float64 fiducial arrays at the original rate
    (NaN for undetected or padded beats), keyed by ``FIDUCIAL_NAMES``."""
    samples = np.ascontiguousarray(samples, np.float64)
    peaks = np.ascontiguousarray(peaks, np.int32)
    n_peaks = np.ascontiguousarray(n_peaks, np.int32)
    if samples.ndim != 2 or peaks.ndim != 2 or n_peaks.shape != (samples.shape[0],) or len(peaks) != len(samples):
        raise ValueError(f"shapes {samples.shape}, {peaks.shape}, {n_peaks.shape}: want (B, T), (B, K), (B,)")
    if np.any(n_peaks > peaks.shape[1]):
        raise ValueError("n_peaks exceeds the width of peaks")
    B, T = samples.shape
    K = peaks.shape[1]
    out = np.empty((10, B, K), np.float64)
    if B == 0:
        return {name: out[i] for i, name in enumerate(FIDUCIAL_NAMES)}
    fn = _lib().delineate_batch_f64

    def run(lo: int, hi: int) -> np.ndarray:
        part = np.empty((10, hi - lo, K), np.float64)
        fn(samples[lo:hi].ctypes.data_as(_DOUBLE_P), hi - lo, T, peaks[lo:hi].ctypes.data_as(_INT32_P),
           n_peaks[lo:hi].ctypes.data_as(_INT32_P), K, fs_in, part.ctypes.data_as(_DOUBLE_P))
        return part

    n_threads = max(1, min(len(os.sched_getaffinity(0)), B // _MIN_WINDOWS_PER_THREAD))
    bounds = np.linspace(0, B, n_threads + 1).astype(int)
    with ThreadPoolExecutor(n_threads) as pool:
        parts = [pool.submit(run, int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:])]
        for (lo, hi), part in zip(zip(bounds[:-1], bounds[1:]), parts):
            out[:, lo:hi] = part.result()
    return {name: out[i] for i, name in enumerate(FIDUCIAL_NAMES)}
