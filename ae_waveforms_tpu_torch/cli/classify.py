"""Downstream classification CLI of the port (the counterpart of the JAX
package's ``cli/classify.py``; capability twin of main_ae_classify.py,
main_ml_classify.py and analysis_PPV_hypokalaemia.py).

One entry point with a ``task`` selector:

  python -m ae_waveforms_tpu_torch.cli.classify latent   --data DIR [...]
  python -m ae_waveforms_tpu_torch.cli.classify features --data DIR [...]
  python -m ae_waveforms_tpu_torch.cli.classify ppv      --data DIR [...]

Inputs follow the reference's file contracts: ``controls.csv`` /
``<condition>.csv`` id lists (second column), ``np_info.npy`` plus either
``np_latent_spaces_mimiciv.npy`` (latent and ppv tasks) or precomputed
feature .npy pairs (features task).  The GBT runs on ``--device`` (the
first CUDA device unless named; ``--device cpu`` runs the plain versions).
The ``deep`` task and ``--n_devices`` belong to later slices of the port
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ae_waveforms_tpu_torch.classify.harness import (
    DEFAULT_SIZES,
    grid_search_cv,
    ppv_analysis,
    prepare_class_data,
    select_by_ids,
    size_seed_sweep,
)


def _load_ids(path_data: str, fname: str) -> np.ndarray:
    return np.loadtxt(os.path.join(path_data, fname), delimiter=",", dtype=int, skiprows=1, usecols=1)


def _load_info_ids(path_data: str) -> np.ndarray:
    info = np.load(os.path.join(path_data, "np_info.npy"), allow_pickle=True)
    try:
        return np.array(info[:, 0], dtype=int)
    except (ValueError, TypeError):
        return info[:, 0]


def _latent_class_data(args):
    ids = _load_info_ids(args.data)
    latents = np.load(os.path.join(args.data, args.latents), allow_pickle=True)
    control = select_by_ids(ids, latents, _load_ids(args.data, args.control_file))
    sick = select_by_ids(ids, latents, _load_ids(args.data, args.sick_file))
    return prepare_class_data(control, sick)


def _grid_search(args, data):
    X = np.concatenate([data.control_train[: args.gs_size], data.sick_train[: args.gs_size]])
    y = np.concatenate([np.zeros(min(args.gs_size, len(data.control_train))),
                        np.ones(min(args.gs_size, len(data.sick_train)))])
    gs = grid_search_cv(X, y, n_candidates=args.gs_candidates, random_state=1, verbose=True,
                        vectorized=args.vectorized, device=args.device)
    print("Best hyperparameters found:", gs["best_params"])
    return gs


def run_latent(args):
    data = _latent_class_data(args)
    gs = _grid_search(args, data)
    out = os.path.join(args.data, "results", os.path.splitext(args.sick_file)[0].split("_")[-1].lower())
    return size_seed_sweep(data, gs["best_params"], sizes=args.sizes, n_seeds=args.seeds, out_dir=out,
                           vectorized=args.vectorized, device=args.device)


def run_ppv(args):
    data = _latent_class_data(args)
    gs = _grid_search(args, data)
    return ppv_analysis(data, gs["best_params"], size=6000, n_seeds=args.seeds,
                        vectorized=args.vectorized, device=args.device)


def run_features(args):
    """Handcrafted-feature task: precomputed per-class feature matrices,
    column 5 (T Duration) dropped (main_ml_classify.py:110)."""
    control = np.load(os.path.join(args.data, args.control_features))[:12000]
    sick = np.load(os.path.join(args.data, args.sick_features))
    data = prepare_class_data(control, sick, cap=10**9)
    X = np.concatenate([data.control_train[:6000], data.sick_train[:6000]])
    y = np.concatenate([np.zeros(min(6000, len(data.control_train))),
                        np.ones(min(6000, len(data.sick_train)))])
    X = np.delete(X, 5, axis=1)
    gs = grid_search_cv(X, y, n_candidates=args.gs_candidates, random_state=1, verbose=True,
                        vectorized=args.vectorized, device=args.device)
    print("Best hyperparameters found:", gs["best_params"])
    out = os.path.join(args.data, "results")
    stem = os.path.splitext(args.sick_features)[0]
    sizes = args.sizes + [10000, 11500]
    return size_seed_sweep(data, gs["best_params"], sizes=sizes, n_seeds=args.seeds, drop_col=5,
                           out_dir=out, file_stem=stem, vectorized=args.vectorized, device=args.device)


def run_deep(args):
    raise NotImplementedError(
        "the deep task (the LSTM classifier) is not ported yet: it is the DL-classifier slice "
        "(ROADMAP.md, queue 1, item 9); run it with ae_waveforms_tpu.cli.classify"
    )


def main(argv=None):
    """Parse ``argv`` and run the task; returns the task's result."""
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["latent", "features", "deep", "ppv"])
    p.add_argument("--data", required=True)
    p.add_argument("--control_file", default="controls.csv")
    p.add_argument("--sick_file", default="hypopotassium.csv")
    p.add_argument("--latents", default="np_latent_spaces_mimiciv.npy")
    p.add_argument("--control_features", default="control_features14500.npy")
    p.add_argument("--sick_features", default="hyposodium_features12000.npy")
    p.add_argument("--sizes", type=int, nargs="*", default=DEFAULT_SIZES)
    p.add_argument("--seeds", type=int, default=25)
    p.add_argument("--gs_candidates", type=int, default=1000)
    p.add_argument("--gs_size", type=int, default=6000)
    p.add_argument("--epochs", type=int, default=153)
    p.add_argument("--save_models", action="store_true")
    p.add_argument("--vectorized", action="store_true",
                   help="fit all seeds of a size (and chunks of grid-search candidates) together")
    p.add_argument("--n_devices", type=int, default=0,
                   help="shard the seed axis over n devices (not ported yet; must be 0)")
    p.add_argument("--seed_chunk", type=int, default=25, help="deep task: seeds trained together")
    p.add_argument("--remat_chunk", type=int, default=20, help="deep task: chunked LSTM remat length")
    p.add_argument("--device", default=None,
                   help="torch device of the GBT (default: the first CUDA device; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    if args.n_devices:
        raise NotImplementedError(
            "--n_devices: sharding over several devices is the multi-device slice of the port "
            "(ROADMAP.md, queue 1, item 11); run with --n_devices 0"
        )
    return {"latent": run_latent, "features": run_features, "deep": run_deep, "ppv": run_ppv}[args.task](args)


if __name__ == "__main__":
    main()
