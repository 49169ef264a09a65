"""Extraction from ECG records to the three arrays, and the record
sources (synthetic, VitalDB)."""

from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record
from ae_waveforms_tpu_torch.data.extract import extract_case, extract_cases
from ae_waveforms_tpu_torch.data.arrays import build_arrays

__all__ = ["synthetic_ecg_record", "extract_case", "extract_cases", "build_arrays"]
