"""The port's end-to-end run (``examples/run_e2e.py``) on the CPU at the
JAX package's e2e test sizes: its hand-offs held against the JAX package's
(the extraction CLI's arrays byte for byte, the patient split), the JAX
test's own checks, and the resume-and-serve flow."""

import glob
import os

import numpy as np
import pytest

from ae_waveforms_tpu.cli.extract import main as jax_extract_main
from ae_waveforms_tpu.core.schema import load_arrays as jax_load_arrays
from ae_waveforms_tpu.train.data import split_datasets as jax_split_datasets
from ae_waveforms_tpu_torch.classify.harness import ppv_analysis
from ae_waveforms_tpu_torch.examples import run_e2e

CASES, DURATION = 8, 90
# the JAX e2e test's classifier, in place of the grid search (its CPU run
# is tens of seconds; phase 13 of chip_smoke.py runs it on the card)
GBT_PARAMS = dict(max_depth=3, learning_rate=0.2, n_estimators=20, gamma=0.0, min_child_weight=1, subsample=1.0,
                  colsample_bytree=1.0)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    work = tmp_path_factory.mktemp("e2e")
    return run_e2e.run_ae(str(work), cases=CASES, duration=DURATION, epochs=1, device="cpu", max_steps=6,
                          search_candidates=16)


def test_chain_matches_the_jax_hand_offs(chain, tmp_path):
    assert list(chain["seconds"]) == ["extract", "train", "test", "study"]
    assert all(s >= 0 for s in chain["seconds"].values())

    jax_dir = tmp_path / "jax"
    jax_extract_main(["--out", str(jax_dir), "--cases", str(CASES), "--duration", str(DURATION)])
    for name in ("waves", "features", "info"):
        mine = os.path.join(chain["data_dir"], f"np_{name}.npy")
        assert open(mine, "rb").read() == (jax_dir / f"np_{name}.npy").read_bytes(), name

    # the JAX package's patient split of the same arrays under the example's seed and fractions
    np.random.seed(4)
    want = jax_split_datasets(jax_load_arrays(str(jax_dir)).info, str(tmp_path / "split"), None, 0.2, 0.2)
    for split, mask in zip(("train", "val", "test"), want):
        (path,) = glob.glob(os.path.join(chain["run_dir"], f"indices_{split}_*.npy"))
        np.testing.assert_array_equal(np.load(path), mask)
        assert mask.any(), split
    (copied,) = glob.glob(os.path.join(chain["data_dir"], "indices_test_*.npy"))
    np.testing.assert_array_equal(np.load(copied), want[2])

    # the JAX e2e test's checks
    _, (loss, rmse, _, prd, _), _, latents = chain["results"]["test"]
    assert np.isfinite(rmse) and latents.shape == (int(want[2].sum()), 10)
    study = chain["results"]["study"]
    assert "traditional" in study and np.isfinite(study["traditional"].mse)
    data = run_e2e.cohorts(latents)
    out = ppv_analysis(data, GBT_PARAMS, size=min(8, len(data.control_train)), n_seeds=2, device="cpu")
    assert out["median_ppv"] > 0.8  # well-separated synthetic cohorts


def test_resume_and_serve_in_flow(chain, tmp_path):
    out = run_e2e.resume_and_serve(str(tmp_path), chain["data_dir"], device="cpu")
    assert glob.glob(os.path.join(out["run_dir"], "model_min_val_loss-*.npz"))
    assert out["resumed_step"] > 0 and out["resumed_dir"] != out["run_dir"]
    score = out["score"]
    assert score["latents"].shape == (10, 10)
    assert np.isfinite(score["rmse"]).all() and np.isfinite(score["reconstruction"]).all()
    p = out["score_gbt"]["probability"]
    assert p.shape == (10,) and np.all((p >= 0) & (p <= 1))
    np.testing.assert_array_equal(out["score_gbt"]["latents"], score["latents"])
    assert list(out["seconds"]) == ["train", "resume", "score", "gbt_fit", "score_gbt"]


def test_flags_are_the_jax_example_flags_and_device():
    parser = run_e2e.build_parser()
    args = parser.parse_args([])
    assert (args.workdir, args.cases, args.duration, args.epochs, args.device) == ("./e2e_run", 12, 120.0, 2, None)
    with pytest.raises(SystemExit):  # the tests' smaller sizes are no flags of the example
        parser.parse_args(["--max_steps", "3"])
