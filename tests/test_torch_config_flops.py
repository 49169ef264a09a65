"""The port's config and FLOP counts against the JAX package's: ``vars.env``
loading, ``compute_dtype``, and every counter of ``core/flops.py`` with the
card's peak table."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ae_waveforms_tpu.core import flops as jax_flops
from ae_waveforms_tpu_torch.core import flops
from ae_waveforms_tpu_torch.core.config import TrainConfig, load_env_file
from ae_waveforms_tpu_torch.core.schema import ArraySet
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.train.checkpoint import load_state
from ae_waveforms_tpu_torch.train.loop import main_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the training runs here issue many small CPU ops,
    and with one thread per core in every test worker the parallel regions
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_load_env_file(tmp_path, monkeypatch):
    p = tmp_path / "vars.env"
    p.write_text("DATA_FOLDER_PATH=/some/path\n# comment\nNPT_PROJECT=me/proj\n")
    monkeypatch.delenv("NPT_PROJECT", raising=False)
    vals = load_env_file(str(p))
    assert vals["DATA_FOLDER_PATH"] == "/some/path"
    assert os.environ["NPT_PROJECT"] == "me/proj"


def test_both_packages_read_one_vars_env(tmp_path):
    """Run from a directory holding a vars.env, both packages' data
    directory defaults come from it."""
    (tmp_path / "vars.env").write_text("DATA_FOLDER_PATH=/data/from/vars_env\n")
    code = ("import ae_waveforms_tpu.core.config as j, ae_waveforms_tpu_torch.core.config as t\n"
            "print(j.ExtractionConfig().path_data, t.ExtractionConfig().path_data, j.TrainConfig().dataset_dir, "
            "t.TrainConfig().dataset_dir)\n")
    env = {k: v for k, v in os.environ.items() if k != "DATA_FOLDER_PATH"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert out == ["/data/from/vars_env"] * 4


def _toy_arrays(n=120, n_cases=20, seed=0):
    rng = np.random.default_rng(seed)
    info = np.stack([np.repeat(np.arange(n_cases) + 1, n // n_cases), np.arange(n)], 1).astype(np.float64)
    return ArraySet(rng.standard_normal((n, 320)).astype(np.float32), rng.standard_normal((n, 35)), info)


def _final_params(tmp_path, name, compute_dtype):
    cfg = TrainConfig(dataset_dir=str(tmp_path / name / "data"), results_dir=str(tmp_path / name / "results"),
                      model_class="LeNet5AutoencoderAvgPool", latent_size=4, batch_size=16, epochs=1,
                      validation_interval=2, split_size_val=0.25, split_size_test=0.25, seed=1, plotting=False,
                      compute_dtype=compute_dtype)
    run = main_train(cfg, arrays=_toy_arrays(), max_steps=4, device="cpu")
    with open(os.path.join(run, "training_log_validation.csv")) as f:
        val = f.read()
    template = model_def(cfg.model_class).build(cfg.latent_size, device="cpu").jax_tree()
    return val, load_state(os.path.join(run, "model_autoencoder.npz"), template)


def test_compute_dtype_float32_trains_as_the_default(tmp_path):
    """The JAX package's parity mode ("float32") is what the port always
    runs: the same run as "default", bit for bit (tests/test_train.py's
    setting); a lower precision still raises."""
    val, params = _final_params(tmp_path, "f32", "float32")
    want_val, want = _final_params(tmp_path, "default", "default")
    assert val == want_val and len(val.splitlines()) >= 2
    for layer in want:
        for k in want[layer]:
            np.testing.assert_array_equal(params[layer][k], want[layer][k])
    with pytest.raises(NotImplementedError, match="float32 only"):
        _final_params(tmp_path, "bf16", "bfloat16")


COUNTERS = [
    ("lstm_layer_fwd_flops", (320, 1, 128)), ("lstm_layer_fwd_flops", (40, 64, 10)),
    ("lstm_ae_fwd_flops_per_sample", ()), ("lstm_ae_fwd_flops_per_sample", (200, 20, 64, 32)),
    ("lstm_ae_train_flops_per_sample", ()), ("lstm_ae_train_flops_per_sample", (100, 4)),
    ("conv_ae_fwd_flops_per_sample", ()), ("conv_ae_fwd_flops_per_sample", (20,)),
    ("conv_ae_train_flops_per_sample", ()), ("dl_classifier_fwd_flops_per_sample", ()),
    ("dl_classifier_fwd_flops_per_sample", (64,)), ("dl_classifier_train_flops_per_model_epoch", ()),
    ("dl_classifier_train_flops_per_model_epoch", (800, 200, 320)),
]


@pytest.mark.parametrize("name,args", COUNTERS)
def test_flop_counters_equal_jax(name, args):
    got = getattr(flops, name)(*args)
    assert got == getattr(jax_flops, name)(*args) and got > 0


def test_peaks_are_the_cards_and_unknown_cards_raise():
    name = "NVIDIA H100 80GB HBM3"
    assert flops.device_peak_flops(name) == 67e12 and flops.device_peak_flops(name, "bf16") == 989.4e12
    assert flops.device_peak(name)["hbm_bytes_per_s"] == 3.35e12
    assert flops.mfu(6.7e12, name) == pytest.approx(0.1)
    with pytest.raises(KeyError, match="no peak rates"):
        flops.device_peak_flops("TPU v5e")
