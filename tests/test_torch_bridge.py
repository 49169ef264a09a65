"""The PyTorch port's weight bridge, checkpoint format and import rules.

Weights cross between the packages as numpy arrays and must arrive
bit-exactly; each package reads the other's ``.npz`` checkpoints.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ae_waveforms_tpu.models import lstm_ae
from ae_waveforms_tpu.train import checkpoint as jax_ckpt
from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.bridge import lstm_ae_params_from_numpy, lstm_ae_params_to_numpy
from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
from ae_waveforms_tpu_torch.models.registry import model_def
from ae_waveforms_tpu_torch.train import checkpoint as torch_ckpt

ROOT = Path(__file__).resolve().parent.parent


def _jax_params(seed=0, latent=10):
    return jax.tree_util.tree_map(np.asarray, lstm_ae.init(jax.random.PRNGKey(seed), latent))


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name])
        for k in a[name]:
            x, y = np.asarray(a[name][k]), np.asarray(b[name][k])
            assert x.dtype == y.dtype and x.shape == y.shape, (name, k)
            assert np.array_equal(x, y), (name, k)


def test_lstm_ae_bridge_round_trip_bit_exact():
    params = _jax_params()
    model = lstm_ae_params_from_numpy(params, device="cpu")
    _assert_trees_equal(lstm_ae_params_to_numpy(model), params)


def test_leaf_order_matches_jax_tree_util():
    params = _jax_params()
    jax_leaves = jax.tree_util.tree_leaves(params)
    port_leaves = torch_ckpt.tree_leaves(params)
    assert len(jax_leaves) == len(port_leaves) == 26
    assert all(a is b for a, b in zip(jax_leaves, port_leaves))


def test_port_checkpoint_loads_in_jax(tmp_path):
    params = _jax_params(seed=1)
    model = lstm_ae_params_from_numpy(params, device="cpu")
    path = str(tmp_path / "model_autoencoder.npz")
    torch_ckpt.save_state(path, model.jax_tree())
    template = lstm_ae.init(jax.random.PRNGKey(0), 10)
    loaded = jax.tree_util.tree_map(np.asarray, jax_ckpt.load_state(path, template))
    _assert_trees_equal(loaded, params)


def test_jax_checkpoint_loads_in_port(tmp_path):
    params = _jax_params(seed=2)
    path = str(tmp_path / "model_autoencoder.npz")
    jax_ckpt.save_state(path, params)
    model = LSTMAutoencoder(10, device="cpu")
    loaded = torch_ckpt.load_state(path, model.jax_tree())
    _assert_trees_equal(loaded, params)
    model.load_jax_tree(loaded)
    _assert_trees_equal(lstm_ae_params_to_numpy(model), params)


def test_checkpoint_leaf_count_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    torch_ckpt.save_state(path, {"a": np.zeros(2), "b": np.ones(3)})
    with pytest.raises(ValueError, match="2 leaves"):
        torch_ckpt.load_state(path, {"a": np.zeros(2)})


def test_unknown_model_class_raises_jax_text():
    with pytest.raises(ValueError, match=r"unknown model class 'LeNet5Autoencoder'; available: "
                                         r"\['LSTMAutoencoder', 'LeNet5AutoencoderAvgPool'\]"):
        model_def("LeNet5Autoencoder")


def test_import_leaves_jax_out():
    code = "import sys, ae_waveforms_tpu_torch.serve, ae_waveforms_tpu_torch.bridge; print('jax' in sys.modules)"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == p or name.startswith(p + ".") for p in ("jax", "jaxlib", "ae_waveforms_tpu"))


def test_port_imports_no_jax_package():
    files = sorted((ROOT / "ae_waveforms_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.name, m) for f in files for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []
    # the port's own name shares the JAX package's prefix and must not match
    assert not _forbidden("ae_waveforms_tpu_torch.ops") and _forbidden("ae_waveforms_tpu.ops")


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
