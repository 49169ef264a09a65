"""Downstream classification CLI of the port (the counterpart of the JAX
package's ``cli/classify.py``; capability twin of main_ae_classify.py,
main_ml_classify.py and analysis_PPV_hypokalaemia.py).

One entry point with a ``task`` selector:

  python -m ae_waveforms_tpu_torch.cli.classify latent   --data DIR [...]
  python -m ae_waveforms_tpu_torch.cli.classify features --data DIR [...]
  python -m ae_waveforms_tpu_torch.cli.classify ppv      --data DIR [...]
  python -m ae_waveforms_tpu_torch.cli.classify deep     --data DIR [...]

Inputs follow the reference's file contracts: ``controls.csv`` /
``<condition>.csv`` id lists (second column), ``np_info.npy`` plus either
``np_latent_spaces_mimiciv.npy`` (latent and ppv tasks) or precomputed
feature .npy pairs (features task), ``np_waves.npy`` (the ``deep`` task:
the LSTM classifier on raw beats, ``classify/dl.py``).  Every model runs on
``--device`` (the first CUDA device unless named; ``--device cpu`` runs the
plain versions).  ``--n_devices N`` (as in the JAX CLI: it implies
``--vectorized``) splits each sweep's seeds over N ranks, one process a
device (``parallel/launch.py``; ``cuda:0`` to ``cuda:{N-1}`` over NCCL, or N
CPU ranks over gloo with ``--device cpu``); rank 0 runs the grid search and
hands its choice to the others, and alone prints and writes files.
"""

from __future__ import annotations

import argparse
import os
import sys

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
    return _grid_search_once(args, X, y)


def _grid_search_once(args, X, y):
    """The grid search, on rank 0 alone when the seeds are split over
    ranks; every rank returns its result."""
    gs = None
    if args.mesh is None or args.mesh.rank == 0:
        gs = grid_search_cv(X, y, n_candidates=args.gs_candidates, random_state=1, verbose=True,
                            vectorized=args.vectorized, device=args.device)
        print("Best hyperparameters found:", gs["best_params"])
    if args.mesh is not None:
        from ae_waveforms_tpu_torch.parallel.mesh import broadcast_object

        gs = broadcast_object(gs)
    return gs


def run_latent(args):
    data = _latent_class_data(args)
    gs = _grid_search(args, data)
    out = os.path.join(args.data, "results", os.path.splitext(args.sick_file)[0].split("_")[-1].lower())
    return size_seed_sweep(data, gs["best_params"], sizes=args.sizes, n_seeds=args.seeds, out_dir=out,
                           vectorized=args.vectorized, mesh=args.mesh, device=args.device)


def run_ppv(args):
    data = _latent_class_data(args)
    gs = _grid_search(args, data)
    return ppv_analysis(data, gs["best_params"], size=6000, n_seeds=args.seeds,
                        vectorized=args.vectorized, mesh=args.mesh, device=args.device)


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
    gs = _grid_search_once(args, X, y)
    out = os.path.join(args.data, "results")
    stem = os.path.splitext(args.sick_features)[0]
    sizes = args.sizes + [10000, 11500]
    return size_seed_sweep(data, gs["best_params"], sizes=sizes, n_seeds=args.seeds, drop_col=5,
                           out_dir=out, file_stem=stem, vectorized=args.vectorized, mesh=args.mesh,
                           device=args.device)


def run_deep(args):
    """The LSTM classifier's size x seed sweep on raw beats: the first
    12,000 beats of each class (main_dl_classify.py), results under
    ``{data}/{epochs}_{sick_file stem}``."""
    from ae_waveforms_tpu_torch.classify.dl import DL_SIZES, dl_size_seed_sweep

    ids = _load_info_ids(args.data)
    waves = np.load(os.path.join(args.data, "np_waves.npy"), allow_pickle=True)
    control = select_by_ids(ids, waves, _load_ids(args.data, args.control_file))[:12000]
    sick = select_by_ids(ids, waves, _load_ids(args.data, args.sick_file))[:12000]
    out = os.path.join(args.data, f"{args.epochs}_{os.path.splitext(args.sick_file)[0]}")
    return dl_size_seed_sweep(control, sick, sizes=args.sizes or DL_SIZES, n_seeds=args.seeds,
                              num_epochs=args.epochs, out_dir=out, save_models=args.save_models,
                              vectorized=args.vectorized, seed_chunk=args.seed_chunk,
                              remat_chunk=args.remat_chunk or None, device=args.device, mesh=args.mesh)


TASKS = {"latent": run_latent, "features": run_features, "deep": run_deep, "ppv": run_ppv}


def build_parser() -> argparse.ArgumentParser:
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
                   help="fit all seeds of a size (and chunks of grid-search candidates) together; deep task: "
                        "--seed_chunk seeds at a time")
    p.add_argument("--n_devices", type=int, default=0,
                   help="split the vectorized seed axis over n devices, one rank each (0 = one device; "
                        "implies --vectorized)")
    p.add_argument("--seed_chunk", type=int, default=25, help="deep task: seeds trained together")
    p.add_argument("--remat_chunk", type=int, default=20,
                   help="deep task: time steps an LSTM recomputes at once in the backward (identical gradients, "
                        "less memory); 0 = off")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device; 'cpu' runs the plain versions)")
    return p


def main(argv=None):
    """Parse ``argv`` and run the task; returns the task's result (rank 0's
    with ``--n_devices`` above 1)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.mesh = None
    if args.n_devices > 1:
        from ae_waveforms_tpu_torch.parallel import launch

        devices, backend = launch.devices_for(args.n_devices, args.device)
        return launch.run(_rank, (argv,), devices, backend, timeout_s=None)
    args.vectorized = args.vectorized or args.n_devices == 1
    return TASKS[args.task](args)


def _rank(device, argv):
    """One rank of a task whose seeds are split over several devices
    (``parallel.launch.run``)."""
    from ae_waveforms_tpu_torch.parallel.mesh import data_mesh

    args = build_parser().parse_args(argv)
    args.device, args.vectorized, args.mesh = device, True, data_mesh()
    return TASKS[args.task](args)


if __name__ == "__main__":
    main()
