"""Median-beat extraction over a batch of windows (counterpart of the JAX
package's ``signals/median_beat.py``; reference: median_sample.py:6-54).

Per R peak, a 320-sample section is sliced with 1/3 (106 samples) before
and 2/3 (214) after the peak; sections clipped by the window edges are
padded with NaN *at the end* (so beats whose pre-window is clipped start at
sample 0 and are left-shifted: a reference quirk kept for parity).  The
median beat is the per-position nanmedian over all sections: a sort with
NaN at +inf and the mean of the two middle values, as numpy's (not
``torch.nanmedian``, which returns the lower one).
"""

from __future__ import annotations

import torch

from ae_waveforms_tpu_torch.signals.qc import masked_median

__all__ = ["median_beat", "median_beat_batch", "aligned_sections", "BEAT_LENGTH", "PRE_R", "POST_R"]

BEAT_LENGTH = 320  # int(0.8 * (60/75) * 500)
PRE_R = BEAT_LENGTH // 3  # 106
POST_R = BEAT_LENGTH - PRE_R  # 214


def aligned_sections(samples: torch.Tensor, peaks: torch.Tensor, n_peaks: torch.Tensor) -> torch.Tensor:
    """(B, max_peaks, 320) sections; rows beyond n_peaks and clipped tails
    are NaN."""
    B, T = samples.shape
    K = peaks.shape[1]
    start = (peaks - PRE_R).clamp(min=0)
    end = (peaks + POST_R).clamp(max=T)
    idx = start[:, :, None] + torch.arange(BEAT_LENGTH, device=samples.device)
    vals = torch.gather(samples, 1, idx.clamp(0, T - 1).reshape(B, K * BEAT_LENGTH)).reshape(B, K, BEAT_LENGTH)
    valid = (idx < end[:, :, None]) & (torch.arange(K, device=samples.device)[None, :, None] < n_peaks[:, None, None])
    return torch.where(valid, vals, float("nan"))


def median_beat_batch(samples: torch.Tensor, peaks: torch.Tensor, n_peaks: torch.Tensor) -> torch.Tensor:
    """(B, 320) median beats of a (B, T) batch."""
    sec = aligned_sections(samples, peaks, n_peaks)
    return masked_median(sec, ~torch.isnan(sec), dim=1)


def median_beat(sample: torch.Tensor, peaks: torch.Tensor, n_peaks: torch.Tensor) -> torch.Tensor:
    """(320,) median beat of one window."""
    return median_beat_batch(sample[None], peaks[None], n_peaks.reshape(1))[0]
