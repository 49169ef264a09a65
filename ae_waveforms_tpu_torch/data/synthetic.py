"""Parametric synthetic ECG generator (the port's own copy of the JAX
package's ``data/synthetic.py``; numpy).

Used for offline operation (no VitalDB network access), tests and
benchmarks.  Produces a P-QRS-T morphology as a sum of Gaussian waves per
beat (ECGSYN-style), with heart-rate variability, amplitude jitter,
measurement noise, baseline wander and optional NaN dropouts — enough
structure for the R-peak detector, QC filters and delineator to operate on
realistically.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "synthetic_ecg_record",
    "synthetic_beat",
    "pathological_ecg_record",
    "pathological_beat",
    "PATHOLOGICAL_WAVES",
    "stressed_ecg_record",
    "STRESSORS",
]

# (latency s relative to R, amplitude mV, width s) per wave
_WAVES = {
    "P": (-0.17, 0.15, 0.024),
    "Q": (-0.025, -0.12, 0.010),
    "R": (0.0, 1.1, 0.011),
    "S": (0.026, -0.20, 0.011),
    "T": (0.24, 0.31, 0.045),
}


def synthetic_beat(t: np.ndarray, amp_scale: float = 1.0) -> np.ndarray:
    """Beat morphology evaluated at times t (s, R peak at 0)."""
    y = np.zeros_like(t)
    for mu, a, s in _WAVES.values():
        y = y + a * amp_scale * np.exp(-((t - mu) ** 2) / (2 * s**2))
    return y


def synthetic_ecg_record(
    duration_s: float = 120.0,
    fs: int = 500,
    hr_bpm: float = 72.0,
    hr_std_bpm: float = 2.0,
    noise_std: float = 0.02,
    wander_amp: float = 0.08,
    nan_gaps: int = 0,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """A (T,) float64 ECG-II-like record at fs Hz."""
    rng = rng or np.random.default_rng(seed)
    T = int(duration_s * fs)
    t = np.arange(T) / fs

    # beat times with HRV
    beat_times = []
    cur = rng.uniform(0.4, 0.9)
    while cur < duration_s:
        beat_times.append(cur)
        rr = 60.0 / max(hr_bpm + rng.normal(0, hr_std_bpm), 20.0)
        cur += rr
    sig = np.zeros(T)
    for bt in beat_times:
        lo = max(0, int((bt - 0.4) * fs))
        hi = min(T, int((bt + 0.45) * fs))
        amp = 1.0 + rng.normal(0, 0.03)
        sig[lo:hi] += synthetic_beat(t[lo:hi] - bt, amp)

    # baseline wander (respiratory) + powerline-ish noise + white noise
    sig += wander_amp * np.sin(2 * np.pi * 0.25 * t + rng.uniform(0, 2 * np.pi))
    sig += noise_std * rng.standard_normal(T)

    for _ in range(nan_gaps):
        g0 = rng.integers(0, T - fs)
        sig[g0 : g0 + rng.integers(fs // 2, 2 * fs)] = np.nan
    return sig


# pathological morphology variants for delineation stress fixtures
# (each entry overrides/extends the default _WAVES gaussian components)
PATHOLOGICAL_WAVES = {
    # T wave with a negative then positive lobe
    "biphasic_t": {
        "P": (-0.17, 0.15, 0.024),
        "Q": (-0.025, -0.12, 0.010),
        "R": (0.0, 1.1, 0.011),
        "S": (0.026, -0.20, 0.011),
        "T_neg": (0.20, -0.18, 0.035),
        "T_pos": (0.30, 0.22, 0.040),
    },
    # no atrial activity (e.g. atrial fibrillation's absent P)
    "absent_p": {
        "Q": (-0.025, -0.12, 0.010),
        "R": (0.0, 1.1, 0.011),
        "S": (0.026, -0.20, 0.011),
        "T": (0.24, 0.31, 0.045),
    },
    # wide, slurred QRS (bundle-branch-block-like): Q/S fused into R
    "fused_qrs": {
        "P": (-0.19, 0.12, 0.024),
        "R": (0.0, 0.9, 0.030),
        "S": (0.05, -0.45, 0.028),
        "T": (0.30, 0.28, 0.050),
    },
    # T taller than R (hyperkalaemia-like) — stresses peak disambiguation
    "tall_t": {
        "P": (-0.17, 0.10, 0.024),
        "Q": (-0.025, -0.10, 0.010),
        "R": (0.0, 0.8, 0.011),
        "S": (0.026, -0.15, 0.011),
        "T": (0.26, 0.75, 0.055),
    },
}


def pathological_beat(t: np.ndarray, morphology: str, amp_scale: float = 1.0) -> np.ndarray:
    """Beat morphology from PATHOLOGICAL_WAVES evaluated at times t."""
    waves = PATHOLOGICAL_WAVES[morphology]
    y = np.zeros_like(t)
    for mu, a, s in waves.values():
        y = y + a * amp_scale * np.exp(-((t - mu) ** 2) / (2 * s**2))
    return y


#: Record-level physiological stressors (rhythm / artefact / noise classes,
#: as opposed to the per-beat morphology variants above): AFib-like
#: irregular RR with absent P, ventricular pacing spikes, large baseline
#: wander at the high-pass filter edge, and low-SNR noise.  Used by the
#: delineation stress fixtures (tests/test_delineate_adversarial.py);
#: per-class device-vs-host exactness is published in PARITY.md.
STRESSORS = ("afib_rr", "paced", "wander_edge", "low_snr")


def stressed_ecg_record(
    stressor: str,
    duration_s: float = 22.0,
    fs: int = 500,
    seed: int = 0,
) -> np.ndarray:
    """A record under one physiologically real stressor (STRESSORS):

    - ``afib_rr``: absent-P beats with grossly irregular RR intervals
      (uniform 0.4-1.1 s — no autocorrelated HRV structure), the
      atrial-fibrillation rhythm pattern;
    - ``paced``: normal beats preceded ~20 ms by a 2.2 mV, ~2-sample
      pacing-stimulus spike (stresses R disambiguation and QRS onsets);
    - ``wander_edge``: baseline wander at 0.9 Hz / 0.5 mV — just inside
      the pipeline's 1.0 Hz 4th-order high-pass edge, so a large residual
      survives filtering;
    - ``low_snr``: white noise at 0.15 mV (SNR ~ 8 dB against the ~1.1 mV
      R wave).
    """
    rng = np.random.default_rng(seed)
    T = int(duration_s * fs)
    t = np.arange(T) / fs
    sig = np.zeros(T)

    cur = rng.uniform(0.4, 0.9)
    noise_std = 0.01
    while cur < duration_s:
        lo = max(0, int((cur - 0.4) * fs))
        hi = min(T, int((cur + 0.5) * fs))
        amp = 1.0 + rng.normal(0, 0.02)
        if stressor == "afib_rr":
            sig[lo:hi] += pathological_beat(t[lo:hi] - cur, "absent_p", amp)
            cur += rng.uniform(0.4, 1.1)
            continue
        sig[lo:hi] += synthetic_beat(t[lo:hi] - cur, amp)
        if stressor == "paced":
            k = int((cur - 0.020) * fs)
            if 0 <= k < T - 1:
                sig[k : k + 2] += 2.2
        cur += 60.0 / max(70.0 + rng.normal(0, 1.5), 20.0)

    if stressor == "wander_edge":
        sig += 0.5 * np.sin(2 * np.pi * 0.9 * t + rng.uniform(0, 2 * np.pi))
    if stressor == "low_snr":
        noise_std = 0.15
    sig += noise_std * rng.standard_normal(T)
    return sig


def pathological_ecg_record(
    morphology: str,
    duration_s: float = 22.0,
    fs: int = 500,
    hr_bpm: float = 70.0,
    noise_std: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """A record built from one PATHOLOGICAL_WAVES morphology — adversarial
    delineation fixtures (biphasic T, absent P, fused QRS, tall T)."""
    rng = np.random.default_rng(seed)
    T = int(duration_s * fs)
    t = np.arange(T) / fs
    sig = np.zeros(T)
    cur = rng.uniform(0.4, 0.9)
    while cur < duration_s:
        lo = max(0, int((cur - 0.4) * fs))
        hi = min(T, int((cur + 0.5) * fs))
        sig[lo:hi] += pathological_beat(t[lo:hi] - cur, morphology, 1.0 + rng.normal(0, 0.02))
        cur += 60.0 / max(hr_bpm + rng.normal(0, 1.5), 20.0)
    sig += noise_std * rng.standard_normal(T)
    return sig
