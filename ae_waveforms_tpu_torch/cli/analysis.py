"""Analysis CLI (the port of the JAX package's ``cli/analysis.py``;
capability twin of analysis_performance_traditional_vs_ae.py's command-line role).

  python -m ae_waveforms_tpu_torch.cli.analysis --dataset_dir DIR \
      [--search {sweep,gp,skopt,none}] [--model RUN:LATENT:SEED ...] [--device cpu]

The JAX CLI's flags, plus ``--device`` (the first CUDA device unless named;
``cpu`` runs on the CPU).  ``--plot_dir`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import importlib.util

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import TrainConfig


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--results_dir", default="./results")
    p.add_argument("--search", choices=["sweep", "gp", "skopt", "none"], default="none",
                   help="sweep: device-batched lattice search (recommended); gp: "
                        "from-scratch Matern-5/2+EI optimiser; skopt: the real "
                        "skopt.gp_minimize with the reference's exact settings "
                        "(requires a skopt install)")
    p.add_argument("--search_calls", type=int, default=2000)
    p.add_argument("--model", action="append", default=[],
                   help="trained AE runs to compare, as run_name:latent_size[:seed]")
    p.add_argument("--plot_dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.plot_dir is not None and importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("--plot_dir needs matplotlib, which is not installed")

    cfg = TrainConfig(dataset_dir=args.dataset_dir, results_dir=args.results_dir, plotting=False)
    model_runs = []
    for spec in args.model:
        parts = spec.split(":")
        model_runs.append(
            {
                "trained_model": parts[0],
                "latent_size": int(parts[1]),
                "seed": int(parts[2]) if len(parts) > 2 else 1,
            }
        )

    from ae_waveforms_tpu_torch.analysis.trad_vs_ae import compare

    if args.search in ("gp", "skopt"):
        # procedure-parity modes: a Bayesian optimiser with the reference's
        # call budget/seed/x0 over the device-batched objective — "gp" is the
        # from-scratch Matern-5/2+EI optimiser, "skopt" the real library call
        import numpy as np

        from ae_waveforms_tpu_torch.core.schema import load_arrays
        from ae_waveforms_tpu_torch.traditional.sigma_search import (
            SIGMA_MAP_X0,
            gp_minimize,
            make_objective,
            prepare_reconstruction_inputs,
            skopt_gp_minimize,
        )

        arrays = load_arrays(cfg.dataset_dir)
        beats = np.asarray(arrays.waves, np.float32)
        fx, fy, baselines, x_time = prepare_reconstruction_inputs(np.asarray(arrays.features))
        objective = make_objective(fx, fy, baselines, x_time, beats - beats.max(axis=1, keepdims=True),
                                   device=device)
        search = skopt_gp_minimize if args.search == "skopt" else gp_minimize
        try:
            res = search(objective, n_calls=args.search_calls, seed=42, x0=SIGMA_MAP_X0)
        except ImportError as e:
            raise SystemExit(
                f"--search skopt needs scikit-optimize installed ({e}); "
                "use --search gp for the built-in optimiser with the same "
                "budget/seed/x0 interface"
            ) from e
        print(f"Best Parameters: {res.x}\nBest Test Loss: {res.fun}")
        compare(cfg, model_runs=model_runs, sigma_map=res.x, plot_dir=args.plot_dir, device=device)
    else:
        compare(
            cfg,
            model_runs=model_runs,
            run_sigma_search=(args.search == "sweep"),
            search_candidates=args.search_calls,
            plot_dir=args.plot_dir,
            device=device,
        )


if __name__ == "__main__":
    main()
