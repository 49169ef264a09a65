"""ECG signal processing: filters, windows, R peaks, QC, median beats,
delineation (float64 host and float32 device) and features."""

from ae_waveforms_tpu_torch.signals.filters import butter_coefficients, butterworth, filtfilt, zscore
from ae_waveforms_tpu_torch.signals.segment import segment_record
from ae_waveforms_tpu_torch.signals.rpeaks import find_rpeaks, find_rpeaks_batch
from ae_waveforms_tpu_torch.signals.qc import estimate_hr, qc_mask, rmssd
from ae_waveforms_tpu_torch.signals.median_beat import median_beat, median_beat_batch

__all__ = [
    "zscore",
    "butterworth",
    "filtfilt",
    "butter_coefficients",
    "segment_record",
    "find_rpeaks",
    "find_rpeaks_batch",
    "estimate_hr",
    "rmssd",
    "qc_mask",
    "median_beat",
    "median_beat_batch",
]
