"""The port's product paths over several gloo ranks on the CPU, each against
the same path on one device: ``cli.main_ae --n_devices 2``, the GBT and DL
seed axes, multi-config training's config axis and the window-sharded
extraction; the dryrun hooks; and the launcher's failure modes."""

import os
import time

import numpy as np
import pytest
import torch

from ae_waveforms_tpu_torch.core.schema import ArraySet, save_arrays
from ae_waveforms_tpu_torch.parallel import dryrun, launch
from ae_waveforms_tpu_torch.parallel.mesh import Grid

JOBS = {"gbt8": ("gbt", dict(n_seeds=8)), "gbt5": ("gbt", dict(n_seeds=5)), "dl": ("dl", dict(n_seeds=3)),
        "multi": ("multi", dict(seeds=[3, 4, 5], model_class="LeNet5AutoencoderAvgPool")),
        "extract": ("extract", dict(n_records=2))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as a CPU rank has: the references run beside
    spawned ranks and other test workers, and oneDNN's convolutions sum in
    an order that depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_ranks():
    out = dryrun.run_sharded([(name, 1, kw) for name, kw in JOBS.values()], ["cpu"] * 2, "gloo", timeout_s=300)
    assert out["ranks"] == 2
    return dict(zip(JOBS, out["results"]))


def _unsharded(key):
    name, kw = JOBS[key]
    return dryrun.WORKLOADS[name]("cpu", None, **kw)


@pytest.mark.parametrize("key", ["gbt8", "gbt5"])
def test_gbt_seed_axis_is_exact(two_ranks, key):
    """8 seeds split 4 + 4 and 5 split 3 + 2: the probabilities of every
    seed equal one device's, bit for bit."""
    got, want = two_ranks[key], _unsharded(key)
    assert got.shape == want.shape == (JOBS[key][1]["n_seeds"], want.shape[1])
    np.testing.assert_array_equal(got, want)


def test_dl_seed_axis_is_exact(two_ranks):
    got, want = two_ranks["dl"], _unsharded("dl")
    assert len(got) == 3 and got == want


def test_multi_config_axis_is_bit_identical(two_ranks):
    got, want = two_ranks["multi"], _unsharded("multi")
    for k in ("train_losses", "val_losses", "best_val"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for layer in want["best_params"]:
        for k in want["best_params"][layer]:
            np.testing.assert_array_equal(got["best_params"][layer][k], want["best_params"][layer][k])


def test_window_sharded_extraction_is_byte_equal(two_ranks):
    got, want = two_ranks["extract"], _unsharded("extract")
    assert [c[0] for c in got] == [c[0] for c in want] == [1, 2] and sum(len(c[1]) for c in want) > 0
    for g, w in zip(got, want):
        assert g[4] == w[4]
        for a, b in zip(g[1:4], w[1:4]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_extraction_refuses_what_it_cannot_shard():
    """Chunks must divide evenly over the data axis; the host engines are
    not sharded (both raise before any collective)."""
    from ae_waveforms_tpu_torch.core.config import ExtractionConfig
    from ae_waveforms_tpu_torch.data.extract import extract_cases

    grid = Grid(3, 1, 0, None, None)
    with pytest.raises(ValueError, match="must divide evenly"):
        extract_cases([1], lambda c: None, ExtractionConfig(delineation_engine="device"), batched=True,
                      windows_per_batch=4, device="cpu", mesh=grid)
    with pytest.raises(ValueError, match="delineation_engine='device' only"):
        extract_cases([1], lambda c: None, ExtractionConfig(), batched=True, device="cpu", mesh=grid)


def _beats(d, seed):
    rng = np.random.default_rng(seed)
    n, cases = 240, 24
    info = np.stack([np.repeat(np.arange(cases) + 1, n // cases), np.arange(n)], 1).astype(np.float64)
    save_arrays(ArraySet(rng.standard_normal((n, 320)).astype(np.float32), rng.standard_normal((n, 35)), info), d)


def test_cli_main_ae_on_two_cpu_ranks_matches_one(tmp_path):
    """``--n_devices 2 --device cpu`` against ``--n_devices 1``, each on a
    fresh copy of one dataset (a cached split would change the draws):
    the validation rows agree, and the run dir holds its checkpoints."""
    from ae_waveforms_tpu_torch.cli.main_ae import autoencoder

    args = ["-m", "train", "--model_class", "LeNet5AutoencoderAvgPool", "--batch_size", "16", "--epochs", "1",
            "--validation_interval", "3", "--split_size_val", "0.2", "--split_size_test", "0.1", "--plotting", "",
            "--device", "cpu"]
    runs = {}
    for n in ("1", "2"):
        _beats(str(tmp_path / f"data{n}"), seed=4)
        runs[n] = autoencoder([*args, "--dataset_dir", str(tmp_path / f"data{n}"), "--results_dir",
                               str(tmp_path / f"res{n}"), "--n_devices", n])
    rows = {}
    for n, run in runs.items():
        with open(os.path.join(run, "training_log_validation.csv")) as f:
            rows[n] = np.array([[float(v) for v in line.split(",")] for line in f if line.strip()])
    assert rows["1"].shape == rows["2"].shape and len(rows["1"]) >= 3
    np.testing.assert_allclose(rows["2"], rows["1"], rtol=1e-4)
    files = set(os.listdir(runs["2"]))
    assert {"model_autoencoder.npz", "model_init.npz", "training_log.csv"} <= files
    assert any(f.startswith("model_min_val_loss-") and f.endswith("_params.npz") for f in files)
    assert sum(f.startswith("indices_") for f in files) == 3


def test_cli_refuses_more_cuda_devices_than_visible(monkeypatch):
    from ae_waveforms_tpu_torch.cli.main_ae import autoencoder

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="1 CUDA devices are visible"):
        autoencoder(["-m", "train", "--n_devices", "2"])


def test_entry_and_dryrun_multichip_on_four_cpu_ranks():
    fn, (model, x) = dryrun.entry(device="cpu")
    assert tuple(x.shape) == (128, 320, 1) and tuple(fn(model, x).shape) == (128, 320, 1)
    out = dryrun.dryrun_multichip(4, device="cpu", timeout_s=240)
    ae, gbt, ext, multi, tp = out["results"]
    assert out["ranks"] == 4 and gbt.shape[0] == 4 and multi["train_losses"].shape[1] == 4
    assert (8, 4) in tp["shard_shapes"]  # W1 (8, 8) split over the (2, 2) grid's model axis


def test_a_rank_that_raises_fails_the_parent():
    with pytest.raises(Exception, match="no_such_workload"):
        dryrun.run_sharded([("no_such_workload", 1, {})], ["cpu"] * 2, "gloo", timeout_s=120)


def test_a_rank_past_the_deadline_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 8"):
        dryrun.run_sharded([("dl", 1, dict(epochs=10_000))], ["cpu"] * 2, "gloo", timeout_s=8)
    assert time.monotonic() - t0 < 30


def test_devices_for_gives_gloo_ranks_on_the_cpu():
    assert launch.devices_for(3, "cpu") == (["cpu"] * 3, "gloo")


def test_a_rank_that_dies_while_it_starts_fails_the_parent_at_once():
    """A script read from stdin cannot be re-imported by a spawned rank:
    the call fails at once, whatever the size of its arguments."""
    import subprocess
    import sys

    code = ("import numpy as np\nfrom ae_waveforms_tpu_torch.parallel import launch\n"
            "launch.run(launch.devices_for, (np.zeros(2_000_000, np.float32),), ['cpu'], 'gloo', timeout_s=60)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-"], input=code, text=True, capture_output=True, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root), timeout=50)
    assert out.returncode != 0 and "ProcessExitedException" in out.stderr
    assert time.monotonic() - t0 < 45
