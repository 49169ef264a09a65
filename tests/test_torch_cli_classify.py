"""The port's classify CLI on the CPU, on a tiny synthetic data dir with the
reference's file contracts; and its import without sklearn, pandas or
matplotlib, which the machine with the card does not have."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ae_waveforms_tpu_torch.cli import classify as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these fits issue thousands of tiny CPU ops, and
    with one thread per core in every test worker the parallel regions
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data_dir(d, n_per=300, F=10, seed=0):
    """np_info.npy, np_latent_spaces_mimiciv.npy, controls.csv and
    hypopotassium.csv: 2 * n_per cases, the sick half shifted."""
    rng = np.random.default_rng(seed)
    latents = np.concatenate([rng.standard_normal((n_per, F)),
                              rng.standard_normal((n_per, F)) + 0.6 * (np.arange(F) < 3)]).astype(np.float32)
    ids = np.arange(2 * n_per) + 1000
    np.save(os.path.join(d, "np_info.npy"), np.stack([ids, 20 * ids], 1).astype(np.float64))
    np.save(os.path.join(d, "np_latent_spaces_mimiciv.npy"), latents)
    for name, part in (("controls.csv", ids[:n_per]), ("hypopotassium.csv", ids[n_per:])):
        with open(os.path.join(d, name), "w") as f:
            f.write("idx,caseid\n" + "".join(f"{i},{c}\n" for i, c in enumerate(part)))
    return str(d)


def test_ppv_and_latent_tasks_write_their_results(tmp_path, capsys):
    d = _data_dir(tmp_path)
    common = ["--data", d, "--gs_candidates", "1", "--seeds", "2", "--device", "cpu"]
    result = cli.main(["ppv", *common, "--vectorized"])
    assert result["size"] == 50 and len(result["aucs"]) == len(result["ppvs"]) == 2
    assert 0.5 < result["median_auc"] <= 1.0 and 0.0 <= result["median_ppv"] <= 1.0
    out = capsys.readouterr().out
    assert "Best hyperparameters found:" in out and "Median PPV @ threshold 0.5" in out

    records, summary = cli.main(["latent", *common, "--sizes", "20", "50"])
    assert [r["size"] for r in summary] == [20, 50] and len(records) == 4
    res = tmp_path / "results" / "hypopotassium"
    assert {"individual_aucs.csv", "summary_auc_by_size.csv"} <= set(os.listdir(res))
    with open(res / "summary_auc_by_size.csv") as f:
        assert f.readline().strip() == "size,median_auc,q1_auc,q3_auc"


def test_later_slices_raise(tmp_path):
    d = _data_dir(tmp_path, n_per=20)
    with pytest.raises(NotImplementedError, match="DL-classifier slice"):
        cli.main(["deep", "--data", d, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        cli.main(["ppv", "--data", d, "--n_devices", "2", "--device", "cpu"])


def test_cli_imports_without_sklearn_pandas_matplotlib_or_jax():
    code = (
        "import sys\n"
        "for m in ('sklearn', 'pandas', 'matplotlib', 'jax'):\n"
        "    sys.modules[m] = None\n"
        "import ae_waveforms_tpu_torch.cli.classify\n"
        "import ae_waveforms_tpu_torch.classify.harness\n"
        "assert not any(m == 'ae_waveforms_tpu' or m.startswith('ae_waveforms_tpu.') for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
