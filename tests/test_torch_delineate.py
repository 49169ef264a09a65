"""The port's delineators and device features against the JAX package, on
the CPU.

- ``signals.delineate_device.delineate_batch`` (float32, batched): its
  fiducials equal the JAX ``delineate_batch``'s exactly on the golden
  windows, and the frozen host fiducials there; against the float64 host
  delineator on the adversarial classes it holds ``PARITY.md``'s floors
  (exact >= 0.995 a class, wander_edge >= 0.985), as
  ``tests/test_delineate_adversarial.py`` holds the JAX one.
- ``signals.features_device.feature_rows_batch``: the same NaN pattern as
  the JAX ``feature_rows_batch`` and within 1e-5.
- the C++ delineator's binding (``ops.native_delineate``): exactly equal to
  the JAX package's ``native.delineate_batch_native`` and to the golden
  fiducials; it skips only where no ``g++`` is on PATH.
- the port's copy of the float64 Python delineator and feature helpers:
  equal to the JAX package's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from ae_waveforms_tpu.data.synthetic import (
    PATHOLOGICAL_WAVES,
    STRESSORS,
    pathological_ecg_record,
    stressed_ecg_record,
)
from ae_waveforms_tpu.signals import features as jax_features
from ae_waveforms_tpu.signals.delineate import delineate as jax_delineate
from ae_waveforms_tpu.signals.delineate_jax import delineate_batch as jax_delineate_batch
from ae_waveforms_tpu.signals.features_jax import feature_rows_batch as jax_feature_rows_batch
from ae_waveforms_tpu.signals.filters import butterworth, zscore
from ae_waveforms_tpu_torch.core.schema import FIDUCIAL_NAMES
from ae_waveforms_tpu_torch.signals import features
from ae_waveforms_tpu_torch.signals.delineate import delineate
from ae_waveforms_tpu_torch.signals.delineate_device import delineate_batch
from ae_waveforms_tpu_torch.signals.features_device import feature_rows_batch
from ae_waveforms_tpu_torch.signals.rpeaks import find_rpeaks_batch

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "extraction_golden.npz")
MORPHOLOGIES = sorted(PATHOLOGICAL_WAVES)
ALL_CLASSES = MORPHOLOGIES + list(STRESSORS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops (as in
    ``tests/test_torch_train_loop.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _padded(peak_lists, width=68):
    peaks = np.full((len(peak_lists), width), -1, np.int64)
    for i, p in enumerate(peak_lists):
        peaks[i, : len(p)] = p
    return peaks, np.array([len(p) for p in peak_lists], np.int64)


@pytest.fixture(scope="module")
def golden():
    """The golden window and the four pathological golden windows (float64)
    with their frozen R peaks and host fiducials, and the JAX device
    delineator's and feature rows' results on them."""
    z = np.load(GOLDEN)
    names = ["golden"] + MORPHOLOGIES
    wins = np.stack([z["window"]] + [z[f"patho_{m}_window"] for m in MORPHOLOGIES])
    plists = [list(map(int, z["peaks"]))] + [list(map(int, z[f"patho_{m}_peaks"])) for m in MORPHOLOGIES]
    frozen = [{k: z[f"fid_{k}"] for k in FIDUCIAL_NAMES}] + [
        {k: z[f"patho_{m}_fid_{k}"] for k in FIDUCIAL_NAMES} for m in MORPHOLOGIES]
    peaks, n_peaks = _padded(plists)
    x = wins.astype(np.float32)
    jfid = {k: np.asarray(v) for k, v in jax_delineate_batch(x, peaks.astype(np.int32), n_peaks.astype(np.int32),
                                                             500).items()}
    jrows = np.asarray(jax_feature_rows_batch(x, peaks.astype(np.int32), n_peaks.astype(np.int32), jfid, 500))
    return dict(names=names, wins=wins, plists=plists, frozen=frozen, peaks=peaks, n_peaks=n_peaks,
                jfid=jfid, jrows=jrows)


def _device_fiducials(g):
    out = delineate_batch(torch.from_numpy(g["wins"].astype(np.float32)), torch.from_numpy(g["peaks"]),
                          torch.from_numpy(g["n_peaks"]))
    return {k: v.numpy() for k, v in out.items()}


def test_device_delineator_matches_jax_exactly(golden):
    got = _device_fiducials(golden)
    assert set(got) == set(FIDUCIAL_NAMES)
    for k in FIDUCIAL_NAMES:
        assert got[k].dtype == np.float32 and got[k].shape == golden["peaks"].shape
        np.testing.assert_array_equal(got[k], golden["jfid"][k], err_msg=k)


def test_device_delineator_matches_golden_fiducials(golden):
    got = _device_fiducials(golden)
    for i, name in enumerate(golden["names"]):
        n = golden["n_peaks"][i]
        for k in FIDUCIAL_NAMES:
            np.testing.assert_array_equal(got[k][i][:n], golden["frozen"][i][k], err_msg=f"{name}/{k}")
            assert np.isnan(got[k][i][n:]).all()


def test_device_features_match_jax(golden):
    fid = {k: torch.tensor(v) for k, v in golden["jfid"].items()}
    got = feature_rows_batch(torch.from_numpy(golden["wins"].astype(np.float32)), torch.from_numpy(golden["peaks"]),
                             torch.from_numpy(golden["n_peaks"]), fid).numpy()
    want = golden["jrows"]
    assert got.shape == (len(want), 35)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, equal_nan=True)


def test_device_features_with_missing_fiducials_match_jax(golden):
    """Fiducials knocked out at random (NaN) and a window without peaks:
    the nanmedians and the max-of-two-baselines rule see NaNs."""
    rng = np.random.default_rng(0)
    fid = {k: np.where(rng.random(v.shape) < 0.3, np.nan, v).astype(np.float32) for k, v in golden["jfid"].items()}
    n_peaks = golden["n_peaks"].copy()
    n_peaks[1] = 0
    x = golden["wins"].astype(np.float32)
    want = np.asarray(jax_feature_rows_batch(x, golden["peaks"].astype(np.int32), n_peaks.astype(np.int32), fid, 500))
    got = feature_rows_batch(torch.from_numpy(x), torch.from_numpy(golden["peaks"]), torch.from_numpy(n_peaks),
                             {k: torch.from_numpy(v) for k, v in fid.items()}).numpy()
    assert np.isnan(got[1]).all()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, equal_nan=True)


def _record_for(cls: str, seed: int) -> np.ndarray:
    if cls in PATHOLOGICAL_WAVES:
        return pathological_ecg_record(cls, duration_s=22.0, seed=seed)
    return stressed_ecg_record(cls, duration_s=22.0, seed=seed)


def _windows_for(cls: str, n: int = 2):
    """The adversarial fixtures of ``tests/test_delineate_adversarial.py``."""
    wins = []
    for s in range(n):
        rec = zscore(_record_for(cls, seed=7 * s + 1))
        rec = butterworth(rec, "high", 1.0, 500, 4, precision="float64")
        rec = butterworth(rec, "low", 30.0, 500, 4, precision="float64")
        wins.append(np.asarray(zscore(rec[:10000]), np.float64))
    wins = np.stack(wins)
    peaks, n_peaks = find_rpeaks_batch(torch.from_numpy(wins.astype(np.float32)), 500)
    return wins, peaks.numpy(), n_peaks.numpy()


@pytest.mark.parametrize("cls", ALL_CLASSES)
def test_device_delineator_holds_the_parity_floors(cls):
    wins, peaks, n_peaks = _windows_for(cls)
    out = delineate_batch(torch.from_numpy(wins.astype(np.float32)), torch.from_numpy(peaks),
                          torch.from_numpy(n_peaks))
    total = exact = 0
    audit = []
    for i in range(len(wins)):
        plist = list(map(int, peaks[i][: n_peaks[i]]))
        host = delineate(wins[i], plist, 500)
        for k in FIDUCIAL_NAMES:
            hv = np.asarray(host[k], float)
            dv = out[k][i][: len(plist)].numpy()
            same = (np.isnan(hv) & np.isnan(dv)) | (hv == dv)
            total += len(hv)
            exact += int(same.sum())
            audit += [(k, i, b, hv[b], dv[b]) for b in np.where(~same)[0]]
    if audit:
        print(f"\n{cls}: {len(audit)} device-vs-host disagreements of {total}:", audit[:20])
    assert total > 100
    floor = 0.985 if cls == "wander_edge" else 0.995
    assert exact / total >= floor, (cls, exact, total)


def test_python_delineator_and_features_copy_the_jax_ones(golden):
    for i, plist in enumerate(golden["plists"][:2]):
        win = golden["wins"][i]
        fid = delineate(win, plist, 500)
        want = jax_delineate(win, plist, 500)
        for k in FIDUCIAL_NAMES:
            np.testing.assert_array_equal(np.asarray(fid[k], float), np.asarray(want[k], float))
        rel = features.relative_to_r(win, fid, plist, 500)
        jrel = jax_features.relative_to_r(win, want, plist, 500)
        row = features.median_feature_row(rel, features.morphology_features(rel, len(plist)))
        jrow = jax_features.median_feature_row(jrel, jax_features.morphology_features(jrel, len(plist)))
        np.testing.assert_array_equal(row, jrow)


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain (g++ not on PATH)")


def test_native_binding_matches_jax_native_and_goldens(golden):
    _needs_gxx()
    from native import delineate_batch_native as jax_native

    from ae_waveforms_tpu_torch.ops.native_delineate import delineate_batch_native

    got = delineate_batch_native(golden["wins"], golden["peaks"], golden["n_peaks"], 500)
    want = jax_native(golden["wins"], golden["peaks"], golden["n_peaks"], 500)
    for k in FIDUCIAL_NAMES:
        assert got[k].dtype == np.float64 and got[k].shape == golden["peaks"].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for i in range(len(golden["names"])):
            np.testing.assert_array_equal(got[k][i][: golden["n_peaks"][i]], golden["frozen"][i][k])


@pytest.mark.parametrize("cls", ["afib_rr", "wander_edge", "low_snr"])
def test_native_binding_matches_the_python_delineator(cls):
    _needs_gxx()
    from ae_waveforms_tpu_torch.ops.native_delineate import delineate_batch_native

    wins, peaks, n_peaks = _windows_for(cls)
    out = delineate_batch_native(wins, peaks, n_peaks, 500)
    for i in range(len(wins)):
        plist = list(map(int, peaks[i][: n_peaks[i]]))
        host = delineate(wins[i], plist, 500)
        for k in FIDUCIAL_NAMES:
            np.testing.assert_array_equal(out[k][i][: len(plist)], np.asarray(host[k], float), err_msg=f"{cls}/{k}")


def test_native_binding_rejects_bad_shapes():
    _needs_gxx()
    from ae_waveforms_tpu_torch.ops.native_delineate import delineate_batch_native

    with pytest.raises(ValueError):
        delineate_batch_native(np.zeros((2, 100)), np.zeros((3, 4)), np.zeros(2))
    with pytest.raises(ValueError):
        delineate_batch_native(np.zeros((1, 100)), np.zeros((1, 4)), np.array([5]))
