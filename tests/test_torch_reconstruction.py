"""The port's traditional reconstruction, sigma search and traditional-vs-AE
comparison against the JAX package and the numpy oracle of
``tests/test_reconstruction.py``, on the CPU.

Inputs come from numpy seeds (the oracle module's fiducial sampler).
Tolerances: a reconstruction 5e-5 from the oracle (the JAX package's own
tolerance there) and 1e-5 from the JAX package (float32 on both sides, the
same operations in the same order); the objective rtol 1e-5 (a float32
mean over the batch, summed in another order); ``compare``'s results rtol
1e-5 for the traditional method and 1e-4 for the AE (its test pass, as the
training slice holds it); the GP's trajectories and the sweep's pick equal.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from ae_waveforms_tpu.analysis import trad_vs_ae as jax_trad_vs_ae
from ae_waveforms_tpu.core.config import TrainConfig as JaxTrainConfig
from ae_waveforms_tpu.core.schema import ArraySet as JaxArraySet
from ae_waveforms_tpu.traditional import reconstruction as jax_recon
from ae_waveforms_tpu.traditional import sigma_search as jax_search
from ae_waveforms_tpu.train.loop import main_train as jax_main_train
from ae_waveforms_tpu_torch.analysis import trad_vs_ae
from ae_waveforms_tpu_torch.cli import analysis as cli_analysis
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet, N_FEATURES, load_arrays, save_arrays
from ae_waveforms_tpu_torch.traditional import reconstruction as recon
from ae_waveforms_tpu_torch.traditional import sigma_search as search
from tests.test_reconstruction import X_TIME, _sample_fiducials, oracle_reconstruct

MAP = np.array([1, 2, 2, 3, 2, 3, 3, 2, 3, 2, 2, 1], float)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops (as in
    ``tests/test_torch_train_loop.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _beat(rng, case):
    """(x, y, baseline) of one beat: ``case`` is the number of NaN
    fiducials, "nan_baseline" (slots 0 and 12 dropped) or "duplicate" (an
    exact duplicate x)."""
    x, y = _sample_fiducials(rng, case if isinstance(case, int) else 0)
    baseline = float(np.nanmean(y[[1, 2, 8, 10]]))
    if case == "nan_baseline":
        baseline = np.nan
    if case == "duplicate":
        x[4] = x[3]
    return x, y, baseline


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    cases = [0, 1, 3, "nan_baseline", "duplicate"]
    beats = [_beat(rng, cases[i % len(cases)]) for i in range(n)]
    xs, ys, bs = (np.array([b[i] for b in beats]) for i in range(3))
    return xs.astype(np.float32), ys.astype(np.float32), bs.astype(np.float32)


@pytest.mark.parametrize("case", [0, 1, 3, "nan_baseline", "duplicate"])
def test_reconstruct_gaussian_matches_oracle_and_jax(case):
    rng = np.random.default_rng(11)
    for _ in range(4):
        x, y, baseline = _beat(rng, case)
        got = recon.reconstruct_gaussian(x, y, X_TIME, baseline, MAP, device="cpu").numpy()
        assert got.shape == X_TIME.shape and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, oracle_reconstruct(x.copy(), y, X_TIME, baseline, MAP), atol=5e-5)
        want = np.asarray(jax_recon.reconstruct_gaussian(x, y, X_TIME, baseline, MAP))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reconstruct_gaussian_batch_matches_jax():
    xs, ys, bs = _batch(12, 15)
    xt = X_TIME.astype(np.float32)
    got = recon.reconstruct_gaussian_batch(xs, ys, xt, bs, MAP, device="cpu").numpy()
    want = np.asarray(jax_recon.reconstruct_gaussian_batch(xs, ys, xt, bs, MAP.astype(np.float32)))
    assert got.shape == want.shape == (15, 320)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reconstruct_gaussian_sweep_matches_jax_whatever_the_chunk(monkeypatch):
    xs, ys, bs = _batch(13, 12)
    xt = X_TIME.astype(np.float32)
    maps = np.random.default_rng(14).integers(1, 6, size=(8, 12)).astype(np.float32)
    want = np.asarray(jax_recon.reconstruct_gaussian_sweep(xs, ys, xt, bs, maps))
    got = recon.reconstruct_gaussian_sweep(xs, ys, xt, bs, maps, device="cpu").numpy()
    assert got.shape == want.shape == (8, 12, 320)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a chunk of 3 candidates (the bytes of 3 x 12 x BUF x LIVE_BUFFERS floats) gives the same bits
    monkeypatch.setattr(recon, "CHUNK_BYTES", 3 * 12 * recon.BUF * 4 * recon.LIVE_BUFFERS)
    np.testing.assert_array_equal(recon.reconstruct_gaussian_sweep(xs, ys, xt, bs, maps, device="cpu").numpy(), got)


def _objectives(seed=15, n=20):
    xs, ys, bs = _batch(seed, n)
    true = np.random.default_rng(seed).standard_normal((n, 320)).astype(np.float32) * 0.1 - 1.0
    return (search.make_objective(xs, ys, bs, X_TIME, true, device="cpu"),
            jax_search.make_objective(xs, ys, bs, X_TIME, true))


def test_objective_matches_jax():
    port, jax_obj = _objectives()
    maps = np.random.default_rng(16).integers(1, 6, size=(40, 12)).astype(np.float32)
    got, want = port(maps), jax_obj(maps)
    assert got.shape == want.shape == (40,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_sweep_search_picks_the_jax_map():
    """The two packages' sweeps pick the same map where the objective's
    best and second-best candidates differ by more than its tolerance."""
    xs, ys, bs = _batch(17, 16)
    xt = X_TIME.astype(np.float32)
    true = np.asarray(jax_recon.reconstruct_gaussian_batch(xs, ys, xt, bs, MAP.astype(np.float32)))
    port = search.make_objective(xs, ys, bs, X_TIME, true, device="cpu")
    jax_obj = jax_search.make_objective(xs, ys, bs, X_TIME, true)
    kw = dict(n_candidates=48, seed=3, x0=search.SIGMA_MAP_X0)
    first = np.sort(jax_obj(np.vstack([search.SIGMA_MAP_X0, np.random.default_rng(3).integers(1, 6, (48, 12))])))
    assert first[1] - first[0] > 1e-5 * first[1]  # the draw has a clear best
    got_map, got = search.sweep_search(port, **kw)
    want_map, want = jax_search.sweep_search(jax_obj, **kw)
    np.testing.assert_array_equal(got_map, want_map)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_gp_and_sweep_give_identical_trajectories_on_one_objective():
    target = np.array([2, 3, 1, 4, 2, 5, 3, 1, 2, 4, 3, 2], float)
    calls = {"port": [], "jax": []}

    def objective(who):
        def f(maps):
            maps = np.atleast_2d(np.asarray(maps, float))
            calls[who].append(maps.copy())
            return ((maps - target) ** 2).sum(1) + 0.1 * np.sin(maps).sum(1)
        return f

    got = search.gp_minimize(objective("port"), n_calls=36, seed=5, x0=search.SIGMA_MAP_X0, n_initial=12)
    want = jax_search.gp_minimize(objective("jax"), n_calls=36, seed=5, x0=search.SIGMA_MAP_X0, n_initial=12)
    assert got.x == want.x and got.fun == want.fun and got.x_iters == want.x_iters
    np.testing.assert_array_equal(got.func_vals, want.func_vals)
    got_map, got_best = search.sweep_search(objective("port"), 64, seed=1, x0=search.SIGMA_MAP_X0)
    want_map, want_best = jax_search.sweep_search(objective("jax"), 64, seed=1, x0=search.SIGMA_MAP_X0)
    np.testing.assert_array_equal(got_map, want_map)
    assert got_best == want_best
    assert len(calls["port"]) == len(calls["jax"]) > 6
    assert all(np.array_equal(a, b) for a, b in zip(calls["port"], calls["jax"]))


def _features(xs, ys):
    """(n, 35) feature rows holding the sampler's fiducials in the schema's
    columns (R, slot 5, is inserted by ``prepare_reconstruction_inputs``)."""
    f = np.zeros((len(xs), N_FEATURES))
    keep = [0, 1, 2, 3, 4, 6, 7, 8, 9, 10]
    f[:, search.FIDUCIAL_X_ORDER] = xs[:, keep]
    f[:, search.FIDUCIAL_Y_ORDER] = ys[:, keep]
    return f


@pytest.fixture(scope="module")
def compared(tmp_path_factory):
    """48 beats of 24 case ids, a conv run that the JAX ``main_train``
    writes at toy size, and both packages' ``compare`` on it."""
    root = str(tmp_path_factory.mktemp("analysis"))
    rng = np.random.default_rng(21)
    beats = [_beat(rng, i % 2) for i in range(48)]
    xs, ys = (np.array([b[i] for b in beats]) for i in range(2))
    info = np.stack([np.repeat(np.arange(24) + 100, 2), np.arange(48)], 1).astype(np.float64)
    arrays = ArraySet((0.3 * rng.standard_normal((48, 320))).astype(np.float32), _features(xs, ys), info)
    data = os.path.join(root, "data")
    save_arrays(arrays, data)
    kw = dict(dataset_dir=data, results_dir=os.path.join(root, "results"), model_class="LeNet5AutoencoderAvgPool",
              batch_size=8, validation_interval=2, dropout=0.0, split_size_val=0.25, split_size_test=0.25, seed=0,
              plotting=False)
    run_dir = jax_main_train(JaxTrainConfig(**kw), JaxArraySet(arrays.waves, arrays.features, arrays.info),
                             max_steps=3)
    for f in glob.glob(os.path.join(run_dir, "indices_test_*.npy")):
        shutil.copy(f, data)
    runs = [{"trained_model": os.path.basename(run_dir), "latent_size": 10, "model_class": kw["model_class"]}]
    want = jax_trad_vs_ae.compare(JaxTrainConfig(**kw), model_runs=runs)
    got = trad_vs_ae.compare(TrainConfig(**kw), model_runs=runs, device="cpu")
    return got, want, data


@pytest.mark.parametrize("method,rtol", [("traditional", 1e-5), ("ae", 1e-4)])
def test_compare_matches_jax(compared, method, rtol):
    got, want, _ = compared
    assert list(got) == list(want) and len(got) == 2
    key = "traditional" if method == "traditional" else list(want)[1]
    g, w = got[key], want[key]
    assert g.label == w.label
    n = len(w.rmse_per_sample)
    assert n > 0 and g.rmse_per_sample.shape == g.prd_per_sample.shape == g.qs_per_sample.shape == (n,)
    for field in ("mse", "rmse_mean", "rmse_median", "rmse_per_sample", "prd_mean", "prd_median", "prd_per_sample",
                  "qs_per_sample", "qs_median"):
        assert np.all(np.isfinite(getattr(g, field))), field
        np.testing.assert_allclose(getattr(g, field), getattr(w, field), rtol=rtol, atol=0, err_msg=field)


def test_cli_analysis_sweeps_and_prints_the_table(compared, capsys, tmp_path):
    _, want, data = compared
    cli_analysis.main(["--dataset_dir", data, "--search", "sweep", "--search_calls", "16", "--device", "cpu",
                       "--plot_dir", str(tmp_path / "plots")])
    out = capsys.readouterr().out
    assert "sigma search best map" in out and "Traditional, d=20: MSE " in out and "median QS" in out
    assert sorted(os.listdir(tmp_path / "plots")) == ["analysis_local_error_ae_classic.svg", "rmse_boxplots.png"]
    n_test = int(np.load(glob.glob(os.path.join(data, "indices_test_*.npy"))[0]).sum())
    assert n_test == len(want["traditional"].rmse_per_sample) < len(load_arrays(data))


def test_cli_analysis_without_matplotlib_or_a_card_says_so(compared, monkeypatch):
    _, _, data = compared
    real = cli_analysis.importlib.util.find_spec
    monkeypatch.setattr(cli_analysis.importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(SystemExit, match="--plot_dir needs matplotlib"):
        cli_analysis.main(["--dataset_dir", data, "--device", "cpu", "--plot_dir", "plots"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_analysis.main(["--dataset_dir", data])
