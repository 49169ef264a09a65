"""Reference cache compatibility (the port's own copy of the JAX package's
``data/parquet_compat.py``): ingest ``{case_id}.parquet`` files written by
the upstream pipeline (data_extract_vitaldb.py:179 contract) so existing
extracted datasets can be reused without re-running extraction.

Expected columns (data_extract_vitaldb.py:104-177): ``ecg_sample_median``
(list[320]), ``indices_samples`` (list[1]), ten fiducial dict columns
({'x','y'} each) and fifteen morphology columns — the trailing 25 columns in
the order of the reference extractor's feature_list, exactly what
data_create_arrays.py:34-45 consumes.

pandas (with a parquet engine) is imported inside the loader: the default
paths of the port need neither, and the machine with the card has neither.
The behaviour is the JAX package's, quirks included: a file name without
leading digits gets case id -1 from ``load_reference_case`` but makes
``load_reference_cache_dir``'s sort raise, and fiducial cells that cannot
be indexed by 'x' (plain numbers, say) give zero features to every row.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import numpy as np

from ae_waveforms_tpu_torch.core.schema import ArraySet
from ae_waveforms_tpu_torch.data.arrays import build_arrays
from ae_waveforms_tpu_torch.data.extract import CaseResult

__all__ = ["load_reference_case", "load_reference_cache_dir", "arrays_from_reference_cache"]


def load_reference_case(path: str, case_id: Optional[int] = None) -> CaseResult:
    """One reference parquet -> CaseResult (waves/features/indices)."""
    import pandas as pd

    df = pd.read_parquet(path)
    if case_id is None:
        m = re.match(r"(\d+)", os.path.splitext(os.path.basename(path))[0])
        case_id = int(m.group(1)) if m else -1
    n = len(df)
    if n == 0:
        return CaseResult(case_id, np.zeros((0, 320), np.float32), np.zeros((0, 35)), np.zeros((0,)), 0)

    waves = np.stack(df["ecg_sample_median"].values).astype(np.float32)
    # the 25 feature columns are the last 25; fiducials are [-25:-15] as
    # {'x','y'} dicts, morphology [-15:] (data_create_arrays.py:34-40)
    try:
        np_nk = np.array(
            df.iloc[:, -25:-15].map(lambda d: [d["x"], d["y"]]).values.tolist()
        ).reshape(n, -1)
        np_trad = np.array(df.iloc[:, -15:], dtype=float)
    except TypeError:
        np_nk = np.zeros((n, 20))
        np_trad = np.zeros((n, 15))
    features = np.concatenate([np_nk, np_trad], axis=1)
    indices = np.stack(df["indices_samples"].values).reshape(-1)
    return CaseResult(case_id, waves, features, indices.astype(float), n)


def load_reference_cache_dir(cache_dir: str) -> List[CaseResult]:
    """All ``*.parquet`` case files in a directory, sorted by case id."""
    paths = sorted(
        glob.glob(os.path.join(cache_dir, "*.parquet")),
        key=lambda p: int(re.match(r"(\d+)", os.path.basename(p)).group(1)),
    )
    return [load_reference_case(p) for p in paths]


def arrays_from_reference_cache(cache_dir: str) -> ArraySet:
    """Directory of reference parquets -> the np_waves/np_features/np_info
    arrays (the data_create_arrays.py capability over upstream caches)."""
    return build_arrays(load_reference_cache_dir(cache_dir))
