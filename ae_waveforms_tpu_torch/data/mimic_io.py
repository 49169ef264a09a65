"""MIMIC-IV-ECG ingest, a gated adapter (the port's own copy of the JAX
package's ``data/mimic_io.py``).

The reference consumes MIMIC-IV-derived latents produced by an external
process (its README points at the PhysioNet WFDB records;
``np_latent_spaces_mimiciv.npy`` feeds main_ae_classify.py).  This adapter
reads such a record where the ``wfdb`` client is installed: a 10-second,
12-lead diagnostic record, one lead of it, resampled to the pipeline's
500 Hz.  Without ``wfdb`` (neither this package's test machine nor the
machine with the card has it), ``make_mimic_loader`` raises
``RuntimeError``.

Shared with the JAX package, and kept so that both give the same result:
the extractor cuts windows of ``sampling_frequency * sample_length`` =
500 x 20 = 10,000 samples (``signals/segment.py``), and a 10-s record
resampled to 500 Hz holds 5,000, so it yields no window at the default
settings.  Such records reach the rest of the pipeline only with a
``sample_length`` of 10 s or less.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["have_wfdb", "load_mimic_record", "make_mimic_loader"]


def have_wfdb() -> bool:
    try:
        import wfdb  # noqa: F401

        return True
    except ImportError:
        return False


def load_mimic_record(
    record_path: str,
    lead: str = "II",
    target_fs: int = 500,
) -> Optional[np.ndarray]:
    """One WFDB record -> (T,) float64 signal at target_fs, or None when the
    lead is missing/empty."""
    import wfdb

    rec = wfdb.rdrecord(record_path)
    names = [s.upper() for s in rec.sig_name]
    if lead.upper() not in names:
        return None
    sig = np.asarray(rec.p_signal[:, names.index(lead.upper())], float)
    if not np.isfinite(sig).any():
        return None
    fs = float(rec.fs)
    if fs != target_fs:
        n_out = int(round(len(sig) * target_fs / fs))
        x_out = np.linspace(0.0, 1.0, n_out, endpoint=False)
        x_in = np.linspace(0.0, 1.0, len(sig), endpoint=False)
        sig = np.interp(x_out, x_in, sig)
    return sig


def make_mimic_loader(record_paths: Sequence[str], lead: str = "II", target_fs: int = 500):
    """case_id -> record callable over a list of WFDB record paths (case ids
    index the list)."""
    if not have_wfdb():
        raise RuntimeError("wfdb client not available in this environment")

    def load(case_id: int):
        if not 0 <= case_id < len(record_paths):
            return None
        return load_mimic_record(record_paths[case_id], lead, target_fs)

    return load
