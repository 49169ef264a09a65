"""VitalDB record ingest (the port's own copy of the JAX package's
``data/vitaldb_io.py``; capability twin of
data_load_preprocess/load_record.py and the network side of
data_extract_vitaldb.py).

The ``vitaldb`` client is an optional, gated dependency (the machine with
the card has none, and extraction runs offline there).  When available, records are fetched per track at
1/fs intervals, outer-merged on timestamp, and a record is rejected
(``None``) when any required track is entirely empty — the reference's
acceptance rule.  When unavailable, callers fall back to the synthetic
generator or on-disk records.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["have_vitaldb", "load_record", "find_cases", "make_loader"]


def have_vitaldb() -> bool:
    try:
        import vitaldb  # noqa: F401

        return True
    except ImportError:
        return False


def load_record(case_id: int, track_names: Sequence[str], sampling_frequency: int = 500) -> Optional[np.ndarray]:
    """(T, n_tracks) merged record or None if any track is missing/empty."""
    import vitaldb

    frames = []
    for name in track_names:
        df = vitaldb.vital_recs(
            ipath=case_id,
            track_names=name,
            interval=1.0 / sampling_frequency,
            return_timestamp=True,
            return_pandas=True,
        )
        frames.append(df)
    merged = frames[0]
    for df in frames[1:]:
        merged = merged.merge(df, on="Time", how="outer")
    rec = merged.sort_values(by="Time").reset_index(drop=True).drop(columns=["Time"]).to_numpy()
    if len(rec) == 0:
        return None
    if not np.all(~np.isnan(rec[:, : len(track_names)]).all(axis=0)):
        return None
    return rec


def find_cases(track_names: Sequence[str]) -> List[int]:
    import vitaldb

    return sorted(vitaldb.find_cases(list(track_names)))


def make_loader(track_names: Sequence[str], sampling_frequency: int = 500, synthetic_fallback: bool = True):
    """Returns a case_id -> record callable; synthetic records when the
    vitaldb client is unavailable (offline operation)."""
    if have_vitaldb():
        return lambda cid: _squeeze(load_record(cid, track_names, sampling_frequency))
    if not synthetic_fallback:
        raise RuntimeError("vitaldb client unavailable and synthetic_fallback=False")
    from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record

    return lambda cid: synthetic_ecg_record(duration_s=120.0, seed=int(cid))


def _squeeze(rec):
    if rec is None:
        return None
    return rec[:, 0] if rec.ndim == 2 and rec.shape[1] == 1 else rec
