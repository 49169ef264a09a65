"""Sample quality-control filters over a batch of windows (counterpart of
the JAX package's ``signals/qc.py``; reference: remove_samples.py:8-121).

Operates on fixed-shape padded peak arrays (peaks: (B, max_peaks), -1
padding), batched where the JAX functions are vmapped.

Parity notes
------------
- HR is 60*fs / median(diff(peaks)) ("max" mode of ``estimate_hr``,
  remove_samples.py:85-107); NaN when fewer than 2 peaks.  The median is
  the mean of the two middle values of a sort with the unused slots at
  +inf, as numpy's median (``torch.median`` returns the lower one).
- RMSSD reproduces the reference's unit bug (remove_samples.py:119):
  intervals are divided by ``fs * 1000`` instead of multiplied by
  ``1000 / fs``, making RMSSD ~10^6x too small, so the ``pvc_threshold=150``
  filter never fires.  Kept so that the same samples survive.
- The SD ratio is the population std(sample) / n_peaks
  (remove_samples.py:62-64) with threshold 0.05.

The float32 sums (the std, RMSSD's mean square) are accumulated in float64
and rounded to float32 where the JAX function has its float32 sum, so the
card and the CPU give the same values whatever their reduction order.  A
division by a constant divides by a tensor (``div``): torch's CUDA kernels
turn ``t / 3.0`` into ``t * (1 / 3.0)`` and ``3.0 / t`` is
``t.reciprocal() * 3.0`` on either device, each a second rounding.
"""

from __future__ import annotations

import torch

__all__ = ["estimate_hr", "rmssd", "qc_mask", "masked_median", "sum_f32", "div"]


def div(a, b):
    """a / b, correctly rounded, where either may be a Python number."""
    ref = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, dtype=ref.dtype, device=ref.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=ref.dtype, device=ref.device)
    return torch.div(a, b)


def sum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 sum along ``dim``, accumulated in float64 and rounded once."""
    return x.sum(dim=dim, dtype=torch.float64).to(torch.float32)


def masked_median(values: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """np.median over the masked entries along ``dim`` (NaN where none)."""
    n = mask.sum(dim=dim, keepdim=True)
    s = torch.sort(torch.where(mask, values, float("inf")), dim=dim).values
    last = values.shape[dim] - 1
    lo = torch.gather(s, dim, ((n - 1) // 2).clamp(0, last))
    hi = torch.gather(s, dim, (n // 2).clamp(0, last))
    return torch.where(n > 0, (lo + hi) / 2.0, float("nan")).squeeze(dim)


def estimate_hr(peaks: torch.Tensor, n_peaks: torch.Tensor, sampling_frequency: float) -> torch.Tensor:
    """(B,) HR in bpm from the median inter-peak interval ('max' mode)."""
    d = (peaks[:, 1:] - peaks[:, :-1]).to(torch.float32)
    mask = torch.arange(d.shape[1], device=d.device)[None, :] < (n_peaks[:, None] - 1)
    return div(60.0 * sampling_frequency, masked_median(d, mask))


def rmssd(peaks: torch.Tensor, n_peaks: torch.Tensor, sampling_frequency: float = 500) -> torch.Tensor:
    """(B,) RMSSD of HRV, with the reference's unit bug (see the module
    docs)."""
    d = (peaks[:, 1:] - peaks[:, :-1]).to(torch.float32)
    intervals = div(d, sampling_frequency * 1000.0)  # parity: remove_samples.py:119
    sd = intervals[:, 1:] - intervals[:, :-1]
    mask = torch.arange(sd.shape[1], device=sd.device)[None, :] < (n_peaks[:, None] - 2)
    count = mask.sum(dim=1)
    ms = sum_f32(torch.where(mask, sd**2, 0.0), 1) / count.clamp(min=1).to(torch.float32)
    return torch.where(count > 0, torch.sqrt(ms), float("nan"))


def _std(samples: torch.Tensor) -> torch.Tensor:
    """Population std along the last axis, as ``jnp.std``: mean, centred
    squares, mean of them, sqrt, each in float32."""
    n = float(samples.shape[1])
    mean = div(sum_f32(samples, 1), n)
    centred = samples - mean[:, None]
    return torch.sqrt(div(sum_f32(centred * centred, 1), n))


def qc_mask(
    samples: torch.Tensor,
    peaks: torch.Tensor,
    n_peaks: torch.Tensor,
    sampling_frequency: float = 500,
    pvc_threshold: float = 150.0,
    sd_threshold_ecg: float = 0.05,
) -> torch.Tensor:
    """(B,) keep-mask over a batch of windows.

    samples: (B, T); peaks: (B, max_peaks) padded with -1; n_peaks: (B,).
    Drops windows with any NaN, HR < 30 or > 180 or NaN, RMSSD above the
    PVC threshold, or std/n_peaks above the SD threshold
    (remove_samples.py:29-74)."""
    has_nan = torch.isnan(samples).any(dim=1)
    hr = estimate_hr(peaks, n_peaks, sampling_frequency)
    hrv = rmssd(peaks, n_peaks, sampling_frequency)
    ratio = _std(samples) / n_peaks.clamp(min=1).to(torch.float32)
    ratio = torch.where(n_peaks == 0, float("inf"), ratio)
    bad = (
        has_nan
        | (hr < 30.0)
        | (hr > 180.0)
        | torch.isnan(hr)
        | (hrv > pvc_threshold)
        | (ratio > sd_threshold_ecg)
    )
    return ~bad
