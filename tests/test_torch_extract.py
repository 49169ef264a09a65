"""The port's extraction pipeline and CLI against the JAX package and the
extraction goldens, on the CPU.

Tolerances: the float64 host engine against the goldens as
``tests/test_goldens.py`` holds the JAX one (waves 1e-6, features with the
same NaN pattern within 1e-9, indices exact), and against the JAX
``extract_case`` the same; the float32 device engine against the JAX device
engine: waves 1e-6, features the same NaN pattern within 1e-5, indices
exact.  Batched runs (the host engines' pooled groups, the device engine's
streamed chunks with the full-width re-run) equal the per-case runs
exactly, and a cached re-run writes byte-identical arrays.
"""

import json
import os

import numpy as np
import pytest
import torch

from ae_waveforms_tpu.core.config import ExtractionConfig as JaxExtractionConfig
from ae_waveforms_tpu.data.arrays import build_arrays as jax_build_arrays
from ae_waveforms_tpu.data.extract import extract_case as jax_extract_case
from ae_waveforms_tpu.data.extract import extract_cases as jax_extract_cases
from ae_waveforms_tpu.data.synthetic import synthetic_ecg_record
from ae_waveforms_tpu_torch.cli import extract as cli
from ae_waveforms_tpu_torch.core.config import ExtractionConfig
from ae_waveforms_tpu_torch.data import synthetic
from ae_waveforms_tpu_torch.data.extract import K_LIGHT, ExtractionStats, extract_case, extract_cases
from ae_waveforms_tpu_torch.ops import _build

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "extraction_golden.npz")
HOST = dict(precision="float64", delineation_engine="host")
DEVICE = dict(precision="float32", delineation_engine="device")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops (as in
    ``tests/test_torch_train_loop.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_case(a, b, waves_atol=1e-6, features_atol=1e-9):
    assert a.case_id == b.case_id and a.n_windows_raw == b.n_windows_raw
    assert a.waves.dtype == np.float32 and a.waves.shape == b.waves.shape
    np.testing.assert_allclose(a.waves, b.waves, rtol=0, atol=waves_atol)
    assert np.array_equal(np.isnan(a.features), np.isnan(b.features))
    np.testing.assert_allclose(a.features, b.features, rtol=0, atol=features_atol, equal_nan=True)
    np.testing.assert_array_equal(a.indices, b.indices)


def _identical(a, b):
    _same_case(a, b, 0, 0)


def test_synthetic_records_copy_the_jax_generator():
    for kw in (dict(duration_s=30.0, seed=3), dict(duration_s=30.0, seed=4, nan_gaps=2, hr_bpm=160.0)):
        np.testing.assert_array_equal(synthetic.synthetic_ecg_record(**kw), synthetic_ecg_record(**kw))


def test_host_engine_matches_goldens():
    z = np.load(GOLDEN)
    case = extract_case(1, synthetic.synthetic_ecg_record(duration_s=85.0, seed=1234), ExtractionConfig(**HOST),
                        device="cpu")
    gap = extract_case(2, synthetic.synthetic_ecg_record(duration_s=85.0, seed=4321, nan_gaps=2),
                       ExtractionConfig(**HOST), device="cpu")
    for got, prefix in ((case, ""), (gap, "gap_")):
        np.testing.assert_allclose(got.waves, z[prefix + "waves"], rtol=0, atol=1e-6)
        assert np.array_equal(np.isnan(got.features), np.isnan(z[prefix + "features"]))
        np.testing.assert_allclose(got.features, z[prefix + "features"], rtol=0, atol=1e-9, equal_nan=True)
        np.testing.assert_array_equal(got.indices, z[prefix + "indices"])
    assert gap.n_windows_raw > len(gap.waves)  # the gap drops windows


@pytest.fixture(scope="module")
def record():
    """65 s with a NaN gap: 3 windows, one of them dropped by QC."""
    return synthetic_ecg_record(duration_s=65.0, seed=5, nan_gaps=1)


def test_host_engine_matches_jax(record):
    want = jax_extract_case(3, record, JaxExtractionConfig(**HOST))
    _same_case(extract_case(3, record, ExtractionConfig(**HOST), device="cpu"), want)


def test_python_engine_equals_host_engine(record):
    host = extract_case(3, record, ExtractionConfig(**HOST), device="cpu")
    py = extract_case(3, record, ExtractionConfig(precision="float64", delineation_engine="python"), device="cpu")
    _identical(py, host)


def test_device_engine_matches_jax(record):
    want = jax_extract_case(3, record, JaxExtractionConfig(**DEVICE))
    got = extract_case(3, record, ExtractionConfig(**DEVICE), device="cpu")
    _same_case(got, want, 1e-6, 1e-5)
    assert len(got.waves) >= 1


def _loader(cid):
    # case 3 beats at 160 bpm: windows over K_LIGHT beats, the device engine's full-width re-run
    return synthetic.synthetic_ecg_record(duration_s=45.0, seed=100 + cid, hr_bpm=160.0 if cid == 3 else 72.0,
                                          nan_gaps=1 if cid == 2 else 0)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_batched_equals_per_case(engine):
    cfg = ExtractionConfig(**(HOST if engine == "host" else DEVICE))
    ids = [1, 2, 3, 4]
    per_case = extract_cases(ids, _loader, cfg, device="cpu")
    stats = ExtractionStats()
    batched = extract_cases(ids, _loader, cfg, batched=True, windows_per_batch=3, device="cpu", stats=stats)
    assert [r.case_id for r in batched] == ids
    for a, b in zip(per_case, batched):
        _identical(b, a)
    if engine == "device":
        assert stats.passes == 3 + stats.reruns and stats.reruns >= 1 and stats.syncs == stats.passes
        assert stats.windows == 8 + 3 * stats.reruns
    # the 160-bpm case keeps windows with more than K_LIGHT beats
    peaks_per_window = 20 * 160 / 60
    assert peaks_per_window > K_LIGHT and len(per_case[2].waves) >= 1


def test_device_filter_backend_streams(record):
    """filter_backend="device" runs the float32 batched filter: the same
    windows survive as with the host filter, their beats within 1e-4."""
    host = extract_cases([7], lambda cid: record, ExtractionConfig(**DEVICE), batched=True, device="cpu")[0]
    dev = extract_cases([7], lambda cid: record, ExtractionConfig(filter_backend="device", **DEVICE), batched=True,
                        device="cpu")[0]
    np.testing.assert_array_equal(dev.indices, host.indices)
    np.testing.assert_allclose(dev.waves, host.waves, rtol=0, atol=1e-4)


def test_cache_is_idempotent_and_shared_with_jax(tmp_path, record):
    cfg = ExtractionConfig(**HOST)
    first = extract_cases([3], lambda cid: record, cfg, cache_dir=str(tmp_path), device="cpu")
    path = tmp_path / "3.npz"
    blob = path.read_bytes()

    def no_record(cid):
        raise AssertionError("a cached case must not be loaded")

    again = extract_cases([3], no_record, cfg, cache_dir=str(tmp_path), device="cpu")
    _identical(again[0], first[0])
    assert path.read_bytes() == blob
    jax_read = jax_extract_case(3, None, JaxExtractionConfig(**HOST), cache_dir=str(tmp_path))
    _identical(jax_read, first[0])


def test_cli_matches_jax_extract_and_build_arrays(tmp_path):
    out = tmp_path / "d"
    cli.main(["--out", str(out), "--cases", "4", "--duration", "60", "--device", "cpu"])
    cases = jax_extract_cases([1, 2, 3, 4], lambda cid: synthetic_ecg_record(duration_s=60.0, seed=cid),
                              JaxExtractionConfig(**HOST))
    want = jax_build_arrays(cases)
    waves, feats, info = (np.load(out / f"np_{n}.npy") for n in ("waves", "features", "info"))
    assert waves.dtype == np.float32 and waves.shape == want.waves.shape
    np.testing.assert_allclose(waves, want.waves, rtol=0, atol=1e-6)
    assert np.array_equal(np.isnan(feats), np.isnan(want.features))
    np.testing.assert_allclose(feats, want.features, rtol=0, atol=1e-9, equal_nan=True)
    np.testing.assert_array_equal(info, want.info)
    stats = json.loads((out / "data_stats.json").read_text())
    assert stats["samples_total"] == len(waves) and stats["case_ids"] == [1, 2, 3, 4]
    # the re-run reads the cache and writes byte-identical arrays
    before = {n: (out / f"np_{n}.npy").read_bytes() for n in ("waves", "features", "info")}
    cli.main(["--out", str(out), "--cases", "4", "--duration", "60", "--device", "cpu"])
    assert before == {n: (out / f"np_{n}.npy").read_bytes() for n in ("waves", "features", "info")}


def test_cli_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="--n_devices requires --engine device --batched"):
        cli.main(["--out", str(tmp_path), "--n_devices", "2", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--out", str(tmp_path), "--cases", "1", "--duration", "30"])


def test_host_engine_raises_without_a_compiler(tmp_path, monkeypatch, record):
    """engine="host" needs the C++ delineator; it does not fall back to the
    Python one."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        extract_case(3, record, ExtractionConfig(**HOST), device="cpu")
