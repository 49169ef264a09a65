"""The port's training slice as a whole against the JAX package, for each
model class (the LSTM and the conv autoencoder): both ``main_train``s on
the same toy arrays (320-sample beats, 96 rows of 12 cases, B = 16,
validation every 2 steps, 5 steps over two epochs, dropout 0, the cosine
schedule), the port starting from the JAX run's ``model_init.npz``; then
each package's ``main_test`` on both run directories and its RMSE plot;
the port's CLI; full-state resume.

Tolerances: split files, CSV epochs and steps, and the run directory's file
names equal; learning rates 1e-7 relative (float32 on both sides); train
and validation losses rtol 5e-4, atol 5e-5 (the LSTM tolerance of
``tests/test_training_parity_torch.py``); the test pass's latents 2e-5 and
reconstructions 1e-4, as the serving slice holds them.
"""

import copy
import csv
import glob
import importlib.util
import logging
import os
import re
import shutil

import numpy as np
import pytest
import torch

from ae_waveforms_tpu.core.config import TrainConfig as JaxTrainConfig
from ae_waveforms_tpu.core.schema import ArraySet as JaxArraySet
from ae_waveforms_tpu.train.eval import main_test as jax_main_test
from ae_waveforms_tpu.train.loop import main_train as jax_main_train
from ae_waveforms_tpu_torch.cli.main_ae import autoencoder
from ae_waveforms_tpu_torch.core.config import TrainConfig
from ae_waveforms_tpu_torch.core.schema import ArraySet, save_arrays
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.train import checkpoint as ckpt
from ae_waveforms_tpu_torch.train import loop
from ae_waveforms_tpu_torch.train.eval import main_test
from ae_waveforms_tpu_torch.train.loop import main_train
from ae_waveforms_tpu_torch.train.schedules import cosine_annealing_warm_restarts

KW = dict(batch_size=16, validation_interval=2, dropout=0.0, split_size_val=0.2, split_size_test=0.1, seed=0,
          plotting=False, lr_scheduler_type="CosineAnnealing")
MAX_STEPS = 5  # 4 steps an epoch: validations after steps 0 and 2, then step 0 of epoch 2
SPLIT_FILES = ["indices_train_", "indices_val_", "indices_test_", "subject_ids_used_in_training",
               "subject_ids_used_in_validation", "subject_ids_used_in_testing"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: with the
    suite's workers sharing the cores, torch's thread pool otherwise waits
    on descheduled threads at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy_arrays():
    rng = np.random.default_rng(0)
    n = 96
    info = np.stack([np.repeat(np.arange(12) + 100, 8), np.arange(n)], 1).astype(np.float64)
    return ArraySet(rng.standard_normal((n, 320)).astype(np.float32), np.zeros((n, 35), np.float32), info)


def _rows(run_dir, name="training_log_validation.csv"):
    with open(os.path.join(run_dir, name)) as f:
        return [[float(v) for v in row] for row in csv.reader(f)]


@pytest.fixture(scope="module", params=["LSTMAutoencoder", "LeNet5AutoencoderAvgPool"])
def runs(tmp_path_factory, request):
    root = str(tmp_path_factory.mktemp("train"))
    arrays = _toy_arrays()
    for name in ("jax_data", "port_data"):  # each package draws its own split
        save_arrays(arrays, os.path.join(root, name))
    kw = {**KW, "model_class": request.param}
    jax_arrays = JaxArraySet(arrays.waves, arrays.features, arrays.info)
    jax_cfg = JaxTrainConfig(dataset_dir=os.path.join(root, "jax_data"), results_dir=os.path.join(root, "jax"), **kw)
    jax_run = jax_main_train(jax_cfg, jax_arrays, max_steps=MAX_STEPS)
    init = ckpt.load_state(os.path.join(jax_run, "model_init.npz"),
                           model_def(request.param).build(10, device="cpu").jax_tree())
    cfg = TrainConfig(dataset_dir=os.path.join(root, "port_data"), results_dir=os.path.join(root, "port"), **kw)
    port_run = main_train(cfg, arrays, max_steps=MAX_STEPS, device="cpu", init_params=init)
    tests = {}
    for run, run_dir in (("jax", jax_run), ("port", port_run)):
        test_kw = dict(results_dir=os.path.dirname(os.path.dirname(run_dir)), trained_model=os.path.basename(run_dir))
        tests["jax", run] = jax_main_test(jax_cfg.replace(**test_kw), jax_arrays)
        tests["port", run] = main_test(cfg.replace(**test_kw), arrays, device="cpu")
    return {"jax": jax_run, "port": port_run, "tests": tests, "cfg": cfg, "arrays": arrays}


@pytest.mark.parametrize("stem", SPLIT_FILES)
def test_split_files_identical(runs, stem):
    paths = {k: glob.glob(os.path.join(runs[k], stem + "*")) for k in ("jax", "port")}
    assert len(paths["jax"]) == len(paths["port"]) == 1
    assert os.path.basename(paths["jax"][0]) == os.path.basename(paths["port"][0])
    with open(paths["jax"][0], "rb") as a, open(paths["port"][0], "rb") as b:
        assert a.read() == b.read()


def test_validation_csv_epochs_and_steps_equal(runs):
    got, want = _rows(runs["port"]), _rows(runs["jax"])
    assert [r[:2] for r in got] == [r[:2] for r in want] == [[1, 0], [1, 2], [2, 0]]


def test_learning_rates_match_jax(runs):
    got, want = np.array(_rows(runs["port"]))[:, 2], np.array(_rows(runs["jax"]))[:, 2]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert len(set(want)) == len(want)  # the schedule moved


@pytest.mark.parametrize("column,name", [(3, "train"), (4, "validation")])
def test_losses_match_jax(runs, column, name):
    got, want = np.array(_rows(runs["port"]))[:, column], np.array(_rows(runs["jax"]))[:, column]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)


def test_run_directory_holds_the_same_files(runs):
    def names(run_dir):  # the best checkpoint's name carries its validation loss
        return sorted(re.sub(r"loss-[0-9.]+", "loss-X", f) for f in os.listdir(run_dir))

    assert names(runs["port"]) == names(runs["jax"])


@pytest.mark.parametrize("run", ["jax", "port"])
@pytest.mark.parametrize("what,atol", [("latents", 2e-5), ("reconstruction", 1e-4), ("metrics", 1e-4)])
def test_each_package_reads_the_others_run(runs, run, what, atol):
    """The JAX package's ``main_test`` on the port's run directory and the
    port's on the JAX package's agree with the other package on the same
    run."""
    got, want = runs["tests"]["port", run], runs["tests"]["jax", run]
    if what == "latents":
        g, w = got[3], want[3]
    elif what == "reconstruction":
        g, w = got[2][0], want[2][0]
        np.testing.assert_array_equal(got[2][1], want[2][1])
    else:  # loss, mean RMSE and mean PRD, relative
        g = np.array([got[1][i] for i in (0, 1, 3)]) / np.array([want[1][i] for i in (0, 1, 3)])
        w = np.ones(3)
    assert g.shape == w.shape and np.all(np.isfinite(g))
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("model_args", [[], ["--model_class", "LeNet5AutoencoderAvgPool"]], ids=["default", "conv"])
def test_cli_train_then_test(tmp_path, capsys, model_args):
    arrays = _toy_arrays()
    save_arrays(arrays, str(tmp_path / "data"))
    args = ["--dataset_dir", str(tmp_path / "data"), "--results_dir", str(tmp_path / "results"), "--batch_size",
            "32", "--epochs", "1", "--validation_interval", "2", "--split_size_val", "0.2", "--split_size_test", "0.1",
            "--seed", "0", "--plotting", "", "--device", "cpu", *model_args]
    run_dir = autoencoder(["-m", "train", *args])
    assert [r[:2] for r in _rows(run_dir)] == [[1, 0]]
    assert os.path.isfile(os.path.join(run_dir, "model_autoencoder.npz"))
    loss, rmse, rmse_per, prd, prd_per, pred, true, info = autoencoder(
        ["-m", "test", "--trained_model", os.path.basename(run_dir), *args])
    n = len(pred)
    latents = np.load(str(tmp_path / "results" / "test_autoencoder" / os.path.basename(run_dir)
                          / "np_latent_spaces.npy"))
    assert n > 0 and pred.shape == true.shape == (n, 320) and latents.shape == (n, 10) and info.shape == (n, 2)
    assert rmse_per.shape == prd_per.shape == (n,)
    assert np.all(np.isfinite(pred)) and np.all(np.isfinite(latents)) and np.isfinite(loss)
    out = capsys.readouterr().out
    assert f"Global test MSE loss: {loss:.6f}" in out and f"Sample wise average test PRD loss: {prd:.6f}" in out


@pytest.mark.parametrize("matplotlib", [True, False])
def test_test_pass_plots_where_matplotlib_is_installed(runs, tmp_path, monkeypatch, caplog, matplotlib):
    """With ``plotting`` on, the test pass draws RMSE_distribution.png as
    the JAX package does; without matplotlib it logs a warning naming it
    and writes no plot."""
    if not matplotlib:
        real = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec",
                            lambda name, *a: None if name == "matplotlib" else real(name, *a))
    cfg = runs["cfg"].replace(results_dir=str(tmp_path), trained_model="run", plotting=True)
    shutil.copytree(runs["port"], str(tmp_path / "networks_autoencoder" / "run"))
    with caplog.at_level(logging.WARNING, logger="test"):
        main_test(cfg, runs["arrays"], device="cpu")
    drawn = os.path.isfile(str(tmp_path / "test_autoencoder" / "run" / "RMSE_distribution.png"))
    assert drawn == matplotlib
    assert ("matplotlib is not installed" in caplog.text) != matplotlib


@pytest.mark.parametrize("flag,value", [("--seeds", "1,2"), ("--lr_sweep", "1,0.5"), ("--latent_sizes", "10,20"),
                                        ("--per_config_splits", "1"), ("--multi_checkpoint_every", "5"),
                                        ("--multi_resume_dir", "runs"), ("--n_devices", "2"),
                                        ("--model_parallel", "2")])
def test_cli_flags_of_later_slices_raise(flag, value, monkeypatch):
    """Several devices go to the launcher, alone and with each multi-config
    flag: 2 gloo ranks with --device cpu, which rerun the parsed command.
    A model axis that does not divide the devices raises."""
    from ae_waveforms_tpu_torch.parallel import launch

    class Launched(Exception):
        pass

    def run(fn, args, devices, backend, **kw):
        raise Launched(args, devices, backend)

    monkeypatch.setattr(launch, "run", run)
    devices = [] if flag in ("--n_devices", "--model_parallel") else ["--n_devices", "2"]
    argv = ["-m", "train", flag, value, *devices, "--device", "cpu"]
    if flag == "--model_parallel":
        with pytest.raises(ValueError, match="--model_parallel 2 must divide --n_devices 1"):
            autoencoder(argv)
        return
    with pytest.raises(Launched) as e:
        autoencoder(argv)
    assert e.value.args == ((argv,), ["cpu", "cpu"], "gloo")


def test_resume_round_trips_train_state(tmp_path, monkeypatch):
    """A resumed run starts from the checkpoint's params, optimizer state
    and dropout generator, exactly, at its step (the cosine schedule's lr
    there)."""
    arrays = _toy_arrays()
    cfg = TrainConfig(dataset_dir=str(tmp_path / "data"), results_dir=str(tmp_path / "results"),
                      **{**KW, "dropout": 0.2})
    first = main_train(cfg, arrays, max_steps=1, device="cpu")
    saved = ckpt.load_train_state(ckpt.latest_resumable(first))
    seen, original = {}, loop.train_step

    def first_step(model, optimizer, data_x, idx, mask, lr, generator, rate, loss_kind):
        if not seen:
            seen.update(model=copy.deepcopy(model.state_dict()), optimizer=copy.deepcopy(optimizer.state_dict()),
                        generator=generator.get_state().clone(), lr=lr)
        return original(model, optimizer, data_x, idx, mask, lr, generator, rate, loss_kind)

    monkeypatch.setattr(loop, "train_step", first_step)
    main_train(cfg, arrays, max_steps=saved["step"] + 1, resume_dir=first, device="cpu")
    assert saved["step"] == 1
    assert seen["model"].keys() == saved["model"].keys()
    assert all(torch.equal(seen["model"][k], saved["model"][k]) for k in saved["model"])
    assert torch.equal(seen["generator"], saved["generator"])
    opt_seen, opt_saved = seen["optimizer"]["state"], saved["optimizer"]["state"]
    assert opt_seen.keys() == opt_saved.keys() and len(opt_saved) == 26
    for i in opt_saved:
        assert opt_seen[i].keys() == opt_saved[i].keys()
        for k, v in opt_saved[i].items():
            assert torch.equal(opt_seen[i][k], v) if torch.is_tensor(v) else opt_seen[i][k] == v
    steps_per_epoch = 4
    want_lr = cosine_annealing_warm_restarts(cfg.lr, int(steps_per_epoch / cfg.lr_scheduler_caw_settings[0]))
    assert seen["lr"] == float(want_lr(saved["step"]))
