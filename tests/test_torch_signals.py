"""The port's signal stages (filters, windows, R peaks, QC, median beats)
against the JAX package, on the CPU.

Inputs come from numpy seeds and the extraction goldens.  Tolerances:
``zscore`` and the host ``butterworth`` 1e-12 (the same float64 scipy
math); the device filtfilt 1e-6 against scipy's float64 ``filtfilt``
(tighter than the 1e-5 of ``tests/test_filters.py:46``) and 2e-6 against
the JAX device filter, whose own float32 result sits up to 1.5e-6 from
scipy on these records (it maps its initial state through the
ill-conditioned modal basis of the 1 Hz high-pass in float32; the port
does that map in float64), so no filter closer to scipy than 1e-6 can be
held to it at 1e-6; ``segment_record``, R peaks, peak counts and the QC mask
exact; median beats 1e-6 with the same NaN pattern.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from ae_waveforms_tpu.core.config import ExtractionConfig as JaxExtractionConfig
from ae_waveforms_tpu.data.synthetic import (
    PATHOLOGICAL_WAVES,
    stressed_ecg_record,
    synthetic_ecg_record,
)
from ae_waveforms_tpu.signals import filters as jax_filters
from ae_waveforms_tpu.signals.median_beat import median_beat_batch as jax_median_beat_batch
from ae_waveforms_tpu.signals.qc import qc_mask as jax_qc_mask
from ae_waveforms_tpu.signals.rpeaks import find_rpeaks_batch as jax_find_rpeaks_batch
from ae_waveforms_tpu.signals.segment import segment_record as jax_segment_record
from ae_waveforms_tpu_torch.core.config import ExtractionConfig
from ae_waveforms_tpu_torch.signals import filters
from ae_waveforms_tpu_torch.signals.median_beat import median_beat_batch
from ae_waveforms_tpu_torch.signals.qc import qc_mask
from ae_waveforms_tpu_torch.signals.rpeaks import LIGHT_CANDIDATES, find_rpeaks_batch, xla_cumsum
from ae_waveforms_tpu_torch.signals.segment import segment_record

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "extraction_golden.npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops (as in
    ``tests/test_torch_train_loop.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record(n=20000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 500.0
    return np.sin(2 * np.pi * 1.7 * t) + 0.5 * np.sin(2 * np.pi * 0.3 * t) + 0.3 * rng.standard_normal(n)


def _filtered(rec):
    rec = jax_filters.zscore(rec)
    rec = jax_filters.butterworth(rec, "high", 1.0, 500, 4, precision="float64")
    return jax_filters.butterworth(rec, "low", 30.0, 500, 4, precision="float64")


def _zwin(rec):
    """The per-window z-score of the extraction path."""
    return (rec - rec.mean(axis=-1, keepdims=True)) / rec.std(axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def windows():
    """(B, 10000) float32 windows: the golden window, the four pathological
    golden windows, the windows of a normal record, of an afib_rr and a
    wander_edge record, and one unfiltered noise window with more than
    LIGHT_CANDIDATES local maxima (the provable-bound buffer); with the
    JAX package's R peaks, QC mask and median beats of them."""
    z = np.load(GOLDEN)
    wins = [z["window"]] + [z[f"patho_{m}_window"] for m in sorted(PATHOLOGICAL_WAVES)]
    normal = _filtered(synthetic_ecg_record(duration_s=65.0, seed=11))
    wins += list(_zwin(normal[: 3 * 10000].reshape(3, 10000)))
    for cls in ("afib_rr", "wander_edge"):
        wins.append(_zwin(_filtered(stressed_ecg_record(cls, duration_s=22.0, seed=1))[:10000]))
    noise = np.random.default_rng(3).standard_normal(10000)
    wins.append(noise)
    x = np.stack(wins).astype(np.float32)
    interior = (x[:, 1:-1] > x[:, :-2]) & (x[:, 1:-1] > x[:, 2:])
    assert interior.sum(axis=1)[-1] > LIGHT_CANDIDATES
    peaks, n_peaks = jax_find_rpeaks_batch(x, 500)
    keep = jax_qc_mask(x, peaks, n_peaks, 500, 150.0, 0.05)
    medians = jax_median_beat_batch(x, peaks, n_peaks)
    return x, np.array(peaks), np.array(n_peaks), np.array(keep), np.array(medians)


def test_extraction_config_defaults_match_jax():
    assert dataclasses.asdict(ExtractionConfig()) == dataclasses.asdict(JaxExtractionConfig())
    cfg, jcfg = ExtractionConfig(), JaxExtractionConfig()
    for prop in ("wave_sample_length", "beat_length", "pre_r_length", "post_r_length"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)


def test_zscore_matches_jax():
    x = _record()
    x[100:200] = np.nan
    np.testing.assert_allclose(filters.zscore(x), jax_filters.zscore(x), rtol=0, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("btype,cutoff", [("high", 1.0), ("low", 30.0)])
def test_host_butterworth_matches_jax(btype, cutoff):
    x = _record()
    x[5000:5100] = np.nan
    x[9000:9010] = np.nan
    x[9020:9500] = np.nan  # leaves a 10-sample segment, passed through
    want = jax_filters.butterworth(x, btype, cutoff, 500, 4, precision="float64")
    got = filters.butterworth(x, btype, cutoff, 500, 4, precision="float64")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, equal_nan=True)


#: the non-NaN segments of ``_gapped``, each under 1,024 samples (one JAX
#: compilation a filter), and its 7-sample segment, which passes through
SEGMENTS = [(0, 1000), (1100, 2000), (2020, 3000)]
SHORT = (2010, 2017)


def _gapped():
    x = _record(3000, seed=1)
    x[1000:1100] = np.nan
    x[2000:2010] = np.nan
    x[2017:2020] = np.nan
    return x


@pytest.mark.parametrize("btype,cutoff", [("high", 1.0), ("low", 30.0)])
def test_device_filtfilt_matches_jax_and_scipy(btype, cutoff):
    x = _gapped()
    want = jax_filters.butterworth(x, btype, cutoff, 500, 4, precision="float32")
    got = filters.butterworth(x, btype, cutoff, 500, 4, precision="float32", device="cpu")
    assert np.array_equal(np.isnan(got), np.isnan(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6, equal_nan=True)
    np.testing.assert_array_equal(got[SHORT[0] : SHORT[1]], x[SHORT[0] : SHORT[1]].astype(np.float32))
    b, a, _ = filters.butter_coefficients(4, cutoff, btype, 500.0)
    for s, e in SEGMENTS:
        np.testing.assert_allclose(got[s:e], scipy.signal.filtfilt(b, a, x[s:e].astype(np.float32)), rtol=0, atol=1e-6)


def test_butterworth_batched_matches_jax():
    recs = [_gapped(), _record(1020, seed=2).astype(np.float32), np.full(50, np.nan)]
    want = jax_filters.butterworth_batched(recs, 1.0, 30.0, 500, 4)
    got = filters.butterworth_batched(recs, 1.0, 30.0, 500, 4, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and np.array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, equal_nan=True)
    (b1, a1, _), (b2, a2, _) = (filters.butter_coefficients(4, 1.0, "high", 500.0),
                                filters.butter_coefficients(4, 30.0, "low", 500.0))
    for rec, out, segs in [(recs[0], got[0], SEGMENTS), (recs[1], got[1], [(0, 1020)])]:
        for s, e in segs:
            ref = scipy.signal.filtfilt(b2, a2, scipy.signal.filtfilt(b1, a1, np.float32(rec[s:e]).astype(np.float64)))
            np.testing.assert_allclose(out[s:e], ref, rtol=0, atol=1e-6)


def test_filtfilt_matches_the_fixed_form():
    """The unbatched ``filtfilt`` and ``filtfilt_fixed`` at two lengths in
    one zero-padded batch give the same segments."""
    sos, zi = filters.butter_sos(4, 1.0, "high", 500.0)
    x = _record(3000, seed=4).astype(np.float32)
    full = filters.filtfilt(torch.from_numpy(x), sos, zi, 15).numpy()
    buf = np.zeros((2, 4096), np.float32)
    buf[0, :3000], buf[1, :1000] = x, x[:1000]
    fixed = filters.filtfilt_fixed(torch.from_numpy(buf), torch.tensor([3000, 1000]), 4, 1.0, "high", 500.0).numpy()
    np.testing.assert_allclose(fixed[0, :3000], full, rtol=0, atol=1e-6)
    short = filters.filtfilt(torch.from_numpy(x[:1000]), sos, zi, 15).numpy()
    np.testing.assert_allclose(fixed[1, :1000], short, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,tracks", [(45000, None), (30000, 2), (9999, None)])
def test_segment_record_matches_jax(n, tracks):
    rec = np.random.default_rng(n).standard_normal((n,) if tracks is None else (n, tracks))
    got, gi = segment_record(rec, 500, 20)
    want, wi = jax_segment_record(rec, 500, 20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("n", [5, 16, 17, 10850, 10001])
def test_xla_cumsum_matches_jax_bitwise(n):
    x = np.abs(np.random.default_rng(n).standard_normal((3, n))).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(xla_cumsum(torch.from_numpy(x)).numpy(), want)


def test_rpeaks_match_jax(windows):
    x, peaks, n_peaks, _, _ = windows
    got, got_n = find_rpeaks_batch(torch.from_numpy(x), 500)
    np.testing.assert_array_equal(got_n.numpy(), n_peaks)
    np.testing.assert_array_equal(got.numpy(), peaks)
    assert (n_peaks[:-1] >= 15).all()


def test_rpeaks_light_buffer_matches_the_provable_bound(windows):
    x = torch.from_numpy(windows[0][:-1])  # the band-limited windows fit the light buffer
    light = find_rpeaks_batch(x, 500, candidate_slots=LIGHT_CANDIDATES)
    provable = find_rpeaks_batch(x, 500, candidate_slots=(10000 - 1) // 2 + 1)
    for a, b in zip(light, provable):
        assert torch.equal(a, b)


def test_qc_mask_matches_jax(windows):
    x, peaks, n_peaks, keep, _ = windows
    got = qc_mask(torch.from_numpy(x), torch.from_numpy(peaks), torch.from_numpy(n_peaks), 500, 150.0, 0.05)
    np.testing.assert_array_equal(got.numpy(), keep)
    assert keep.any() and not keep.all()


def test_median_beat_batch_matches_jax(windows):
    x, peaks, n_peaks, _, medians = windows
    got = median_beat_batch(torch.from_numpy(x), torch.from_numpy(peaks), torch.from_numpy(n_peaks)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(medians))
    np.testing.assert_allclose(got, medians, rtol=0, atol=1e-6, equal_nan=True)


def test_median_beat_of_a_clipped_beat_matches_jax():
    """A lone beat 100 samples before the window's end: its section is
    clipped, so the median beat's tail is NaN."""
    x = np.random.default_rng(5).standard_normal((1, 10000)).astype(np.float32)
    peaks = np.full((1, 68), -1, np.int64)
    peaks[0, 0] = 9900
    want = np.asarray(jax_median_beat_batch(x, peaks.astype(np.int32), np.array([1], np.int32)))
    got = median_beat_batch(torch.from_numpy(x), torch.from_numpy(peaks), torch.tensor([1])).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() and not np.isnan(got).all()
