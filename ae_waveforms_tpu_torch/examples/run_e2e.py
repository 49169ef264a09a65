"""End-to-end run of the port on one device (the counterpart of the repo's
``examples/run_e2e.py``): synthetic VitalDB-like extraction -> conv-AE
training -> test/latent export -> traditional-vs-AE study -> GBT grid
search and PPV on the latents; and a second flow that trains, "crashes",
resumes and serves the resumed model with a GBT head.

Usage: python -m ae_waveforms_tpu_torch.examples.run_e2e [--workdir DIR]
[--cases 12] [--duration 120] [--epochs 2] [--device cpu]

Without ``--device`` every stage runs on the first CUDA device and raises
where there is none.  Needs neither pandas, sklearn nor matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import time
from typing import Dict, Optional

import numpy as np

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import TrainConfig

__all__ = ["run", "run_ae", "classify", "cohorts", "resume_and_serve", "main"]

# the classifier's sizes, the JAX example's own
GS_CANDIDATES, GS_FOLDS, GS_RANDOM_STATE = 4, 2, 1  # the grid search: LHS candidates x CV folds
PPV_SEEDS, PPV_SIZE = 3, 64  # the PPV sweep: seeds, training rows a cohort
FLOW_TREES, FLOW_DEPTH = 10, 2  # resume_and_serve's GBT head


def e2e_config(data_dir: str, results_dir: str, epochs: int) -> TrainConfig:
    """The example's training config, the JAX example's own."""
    return TrainConfig(
        dataset_dir=data_dir,
        results_dir=results_dir,
        model_class="LeNet5AutoencoderAvgPool",
        latent_size=10,
        batch_size=32,
        epochs=epochs,
        validation_interval=5,
        split_size_val=0.2,
        split_size_test=0.2,
        # seed 4: the legacy patient-level draw gives 6/3/3 cases for
        # train/val/test at 12 cases (seed 1 leaves test empty)
        seed=4,
        plotting=False,
    )


class _Stages:
    """Each stage's result and wall seconds, in run order."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.results: Dict[str, object] = {}

    def __call__(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.seconds[name] = time.perf_counter() - t0
        self.results[name] = out
        return out


def run_ae(workdir: str, cases: int = 12, duration: float = 120.0, epochs: int = 2, device=None, *,
           max_steps: Optional[int] = None, search_candidates: int = 128) -> Dict:
    """The chain's first four stages on ``device``: extraction, AE training,
    test with latent export, and the traditional-vs-AE study on the train
    run's test split.  The tests' smaller run: ``max_steps`` caps training
    and ``search_candidates`` sizes the sigma sweep.

    Returns ``{"data_dir", "results_dir", "run_dir", "seconds", "results"}``:
    per stage (extract, train, test, study) its wall seconds and its result
    (the extraction CLI's dict, the run dir, ``main_test``'s tuple,
    ``compare``'s dict)."""
    from ae_waveforms_tpu_torch.analysis.trad_vs_ae import compare
    from ae_waveforms_tpu_torch.cli.extract import main as extract_main
    from ae_waveforms_tpu_torch.train.eval import main_test
    from ae_waveforms_tpu_torch.train.loop import main_train

    device = resolve_device(device)
    data_dir = os.path.join(workdir, "data")
    results_dir = os.path.join(workdir, "results")
    stage = _Stages()

    # 1. extraction (cached, idempotent)
    stage("extract", extract_main, ["--out", data_dir, "--cases", str(cases), "--duration", str(duration),
                                    "--device", str(device)])

    # 2. AE training
    cfg = e2e_config(data_dir, results_dir, epochs)
    run_dir = stage("train", main_train, cfg, max_steps=max_steps, device=device)

    # 3. test + latent export
    stage("test", main_test, cfg.replace(mode="test", trained_model=os.path.basename(run_dir)), device=device)

    # 4. traditional reconstruction comparison on the train run's test split
    for f in glob.glob(os.path.join(run_dir, "indices_test_*.npy")):
        shutil.copy(f, data_dir)
    stage("study", compare, cfg, run_sigma_search=True, search_candidates=search_candidates, device=device)
    return {"data_dir": data_dir, "results_dir": results_dir, "run_dir": run_dir, "seconds": stage.seconds,
            "results": stage.results}


def cohorts(latents: np.ndarray):
    """The exported latents amplified into two synthetic cohorts, the
    second shifted by 0.6 on every latent: the classifier's ``ClassData``."""
    from ae_waveforms_tpu_torch.classify.harness import prepare_class_data

    rng = np.random.default_rng(0)
    reps = max(1, 200 // max(len(latents), 1))
    base = np.tile(latents, (reps, 1))
    control = base + 0.05 * rng.standard_normal(base.shape)
    sick = base + 0.6 + 0.05 * rng.standard_normal(base.shape)
    return prepare_class_data(control, sick, test_size=max(8, len(base) // 4))


def classify(latents: np.ndarray, device=None) -> Dict:
    """The chain's last two stages on ``device``: the GBT grid search
    (``GS_CANDIDATES`` LHS candidates x ``GS_FOLDS`` folds) on the cohorts'
    training rows, then the PPV sweep of its best params over
    ``PPV_SEEDS`` seeds.  Returns ``{"seconds", "results"}`` for the
    stages grid_search (the search's dict) and ppv (the PPV dict)."""
    from ae_waveforms_tpu_torch.classify.harness import grid_search_cv, ppv_analysis

    data = cohorts(latents)
    X = np.concatenate([data.control_train, data.sick_train])
    y = np.concatenate([np.zeros(len(data.control_train)), np.ones(len(data.sick_train))])
    stage = _Stages()
    best = stage("grid_search", grid_search_cv, X, y, n_candidates=GS_CANDIDATES, cv=GS_FOLDS,
                 random_state=GS_RANDOM_STATE, device=device)["best_params"]
    stage("ppv", ppv_analysis, data, best, size=min(PPV_SIZE, len(data.control_train)), n_seeds=PPV_SEEDS,
          device=device)
    return {"seconds": stage.seconds, "results": stage.results}


def run(workdir: str, cases: int = 12, duration: float = 120.0, epochs: int = 2, device=None) -> Dict:
    """The whole chain on ``device``: ``run_ae``, then ``classify`` on the
    exported latents.  Returns ``run_ae``'s dict with the classifier's
    stages added (extract, train, test, study, grid_search, ppv)."""
    out = run_ae(workdir, cases, duration, epochs, device)
    latents = out["results"]["test"][3]
    tail = classify(latents, device)
    out["seconds"].update(tail["seconds"])
    out["results"].update(tail["results"])
    return out


def resume_and_serve(workdir: str, data_dir: str, device=None) -> Dict:
    """Train 4 steps and stop (the "crash"), resume from the run's full
    train state (params, optimizer, dropout generator, step) up to step 8,
    then score 10 beats of ``data_dir`` through ``Scorer`` on the resumed
    run, and again with a GBT head (``FLOW_TREES`` trees of depth
    ``FLOW_DEPTH``) fitted on their latents.

    The config is the example's (2 epochs) at B = 8 with validation every
    2 steps, so that a resumable checkpoint exists before the stop, as in
    the JAX package's flow test.  Each run has its own results dir (run ids are
    the second they start).  Returns ``{"run_dir", "resumed_dir",
    "resumed_step", "score", "score_gbt", "seconds"}``."""
    from ae_waveforms_tpu_torch.classify.gbt import GBTClassifier
    from ae_waveforms_tpu_torch.serve import Scorer
    from ae_waveforms_tpu_torch.train.checkpoint import latest_resumable
    from ae_waveforms_tpu_torch.train.loop import main_train

    device = resolve_device(device)
    cfg = e2e_config(data_dir, os.path.join(workdir, "flow", "stopped"), epochs=2).replace(
        batch_size=8, validation_interval=2)
    stage = _Stages()
    run_dir = stage("train", main_train, cfg, max_steps=4, device=device)
    latest_resumable(run_dir)  # raises where the stopped run left no full train state

    resumed_cfg = cfg.replace(results_dir=os.path.join(workdir, "flow", "resumed"))
    resumed_dir = stage("resume", main_train, resumed_cfg, max_steps=8, resume_dir=run_dir, device=device)
    with open(os.path.join(resumed_dir, "console.log")) as f:
        m = re.search(r"Resumed full train state .* at step (\d+)", f.read())
    if m is None:
        raise RuntimeError(f"the resumed run in {resumed_dir} did not log its restored step")

    waves = np.load(os.path.join(data_dir, "np_waves.npy")).astype(np.float32)[:10]
    name = os.path.basename(resumed_dir)
    scorer = Scorer.from_run(resumed_cfg.results_dir, name, resumed_cfg.replace(trained_model=name), device=device)
    out = stage("score", scorer.score, waves)

    rng = np.random.default_rng(0)
    lat = out["latents"]
    X = np.concatenate([lat, lat + 1.0])
    y = np.concatenate([np.zeros(len(lat)), np.ones(len(lat))])
    head = GBTClassifier(max_depth=FLOW_DEPTH, n_estimators=FLOW_TREES, learning_rate=0.3, device=device)
    gbt = stage("gbt_fit", head.fit, X + 0.01 * rng.standard_normal(X.shape), y)
    out_gbt = stage("score_gbt", scorer.attach_gbt(gbt).score, waves)
    return {"run_dir": run_dir, "resumed_dir": resumed_dir, "resumed_step": int(m.group(1)), "score": out,
            "score_gbt": out_gbt, "seconds": stage.seconds}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="./e2e_run")
    p.add_argument("--cases", type=int, default=12)
    p.add_argument("--duration", type=float, default=120.0)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device of every stage (default: the first CUDA device; 'cpu' runs on the CPU)")
    return p


def main(argv=None) -> Dict:
    """Run the chain (``run``) with the CLI's flags; returns its dict."""
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    out = run(args.workdir, args.cases, args.duration, args.epochs, args.device)
    _, (loss, rmse, _, prd, _), _, _ = out["results"]["test"]
    print("stages (wall s): " + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items()))
    print(f"\nE2E done in {time.perf_counter() - t0:.1f}s  (AE test rmse {rmse:.4f}, prd {prd:.2f}%)")
    return out


if __name__ == "__main__":
    main()
