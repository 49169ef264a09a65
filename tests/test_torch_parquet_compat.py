"""The port's reference parquet-cache ingestion (``data/parquet_compat.py``
and ``cli.extract --from-parquet``) against the JAX package's, on parquets
written in the upstream on-disk layout from numpy-seeded values."""

import os

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("pyarrow")

from ae_waveforms_tpu.cli import extract as jax_cli  # noqa: E402
from ae_waveforms_tpu.data import parquet_compat as jax_pc  # noqa: E402
from ae_waveforms_tpu_torch.cli import extract as torch_cli  # noqa: E402
from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES, MORPHOLOGY_NAMES  # noqa: E402
from ae_waveforms_tpu_torch.data import parquet_compat as torch_pc  # noqa: E402

ARRAYS = ("waves", "features", "info")


def write_reference_parquet(path, n, rng, fiducials_as_dicts=True):
    """The upstream layout (data_extract_vitaldb.py:104-177): raw window, its
    end index, R peaks, the median beat, ten fiducial {'x', 'y'} columns and
    fifteen morphology columns.  ``fiducials_as_dicts=False`` writes plain
    numbers where the dicts belong."""
    data = {
        "ecg_sample": [rng.standard_normal(100).tolist() for _ in range(n)],
        "indices_samples": [[10000 * (i + 1)] for i in range(n)],
        "ECG_R_Peaks": [[10, 50, 90]] * n,
        "ecg_sample_median": [rng.standard_normal(320).astype(np.float32).tolist() for _ in range(n)],
    }
    for name in FIDUCIAL_NAMES:
        data[name] = [{"x": float(rng.normal()), "y": float(rng.normal())} if fiducials_as_dicts
                      else float(rng.normal()) for _ in range(n)]
    for name in MORPHOLOGY_NAMES:
        data[name] = rng.standard_normal(n).tolist()
    pd.DataFrame(data).to_parquet(path, engine="pyarrow")


def assert_same_case(got, want):
    assert got.case_id == want.case_id
    assert got.n_windows_raw == want.n_windows_raw
    for name in ("waves", "features", "indices"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name, n, dicts, case_id", [
    ("42.parquet", 3, True, 42),  # the case id from the leading digits
    ("7_case.parquet", 2, False, 7),  # not dicts: the TypeError path zeros the 35 features
    ("13.parquet", 0, True, 13),  # an empty file: a (0, 320) case
    ("case.parquet", 2, True, -1),  # no leading digits: id -1
])
def test_load_reference_case_matches_jax(tmp_path, name, n, dicts, case_id):
    path = str(tmp_path / name)
    write_reference_parquet(path, n, np.random.default_rng(n), fiducials_as_dicts=dicts)
    got = torch_pc.load_reference_case(path)
    assert_same_case(got, jax_pc.load_reference_case(path))
    assert got.case_id == case_id and got.waves.shape == (n, 320) and got.features.shape == (n, 35)
    if not dicts:
        assert not got.features.any()
    # an explicit case id wins over the name
    assert torch_pc.load_reference_case(path, case_id=5).case_id == jax_pc.load_reference_case(path, 5).case_id == 5


def test_cache_dir_and_arrays_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    for name, n in (("10.parquet", 2), ("9.parquet", 4), ("11_x.parquet", 0), ("8.parquet", 3)):
        write_reference_parquet(str(tmp_path / name), n, rng)
    cases = torch_pc.load_reference_cache_dir(str(tmp_path))
    want = jax_pc.load_reference_cache_dir(str(tmp_path))
    assert [c.case_id for c in cases] == [c.case_id for c in want] == [8, 9, 10, 11]  # numeric order
    for got, ref in zip(cases, want):
        assert_same_case(got, ref)
    arrays, ref = torch_pc.arrays_from_reference_cache(str(tmp_path)), jax_pc.arrays_from_reference_cache(str(tmp_path))
    assert len(arrays) == 9
    for name in ARRAYS:
        a, b = getattr(arrays, name), getattr(ref, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cache_dir_raises_on_a_name_without_digits(tmp_path):
    rng = np.random.default_rng(2)
    write_reference_parquet(str(tmp_path / "3.parquet"), 1, rng)
    write_reference_parquet(str(tmp_path / "case.parquet"), 1, rng)
    with pytest.raises(AttributeError):
        jax_pc.load_reference_cache_dir(str(tmp_path))
    with pytest.raises(AttributeError):
        torch_pc.load_reference_cache_dir(str(tmp_path))


def test_cli_from_parquet_writes_the_jax_cli_bytes(tmp_path, capsys):
    src = tmp_path / "cache"
    src.mkdir()
    rng = np.random.default_rng(3)
    for cid, n in ((21, 3), (4, 2), (30, 0)):
        write_reference_parquet(str(src / f"{cid}.parquet"), n, rng)
    mine, theirs = tmp_path / "torch", tmp_path / "jax"
    # no --device: the conversion touches no device; it runs before --n_devices, as in the JAX CLI
    out = torch_cli.main(["--out", str(mine), "--from-parquet", str(src), "--n_devices", "2"])
    torch_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_cli.main(["--out", str(theirs), "--from-parquet", str(src)]) is None
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert torch_line == jax_line.replace(str(theirs), str(mine))
    for name in ARRAYS:
        assert (mine / f"np_{name}.npy").read_bytes() == (theirs / f"np_{name}.npy").read_bytes(), name
    assert not os.path.exists(mine / "data_stats.json") and not os.path.exists(theirs / "data_stats.json")
    assert out["stats"] is None and [c.case_id for c in out["results"]] == [4, 21, 30]
    assert out["elapsed_s"] >= 0
