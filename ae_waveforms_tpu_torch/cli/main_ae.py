"""Autoencoder train/test CLI (the port of the JAX package's
``cli/main_ae.py``; capability twin of main_ae.py:10-147).

    python -m ae_waveforms_tpu_torch.cli.main_ae -m train --dataset_dir DIR --results_dir RES
    python -m ae_waveforms_tpu_torch.cli.main_ae -m test --dataset_dir DIR --results_dir RES \\
        --trained_model RUN_ID

Same flag surface and defaults as the JAX CLI, including its ``type=bool``
flags (``--train_shuffle``, ``--val_shuffle``, ``--plotting``,
``--per_config_splits``: any non-empty value is true, ``""`` is false),
plus ``--device`` (the first CUDA device unless named; ``cpu`` runs the
plain versions).  Importable as a library (``autoencoder(custom_args)``).  Seeding covers
numpy's legacy stream (splits, batch order) here and the torch generators
(init, dropout) in ``main_train``.

In train mode, ``--seeds``, ``--lr_sweep`` and ``--latent_sizes`` train the
cross of their values together (``train/multi.py``), one run dir a
configuration and one group a latent size; ``--per_config_splits``,
``--multi_checkpoint_every`` and ``--multi_resume_dir`` go with them.

Several devices, as in the JAX CLI: ``--n_devices N`` trains over N ranks,
one process a device (``parallel/launch.py``; ``cuda:0`` to ``cuda:{N-1}``
over NCCL, or N CPU ranks over gloo with ``--device cpu``), the batch split
over the data axis and the model replicated over ``--model_parallel``'s
model axis; a multi-config run splits its configs instead.  ``--n_devices
0`` trains a single run on every visible device (one when ``--device``
names one) and a multi-config run on one, as the JAX package does.  More
devices than are visible exit with a message that names the count.  The
test pass runs on one device.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from ae_waveforms_tpu_torch.core.config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Settings for training or testing autoencoder models.")
    d = TrainConfig()
    p.add_argument("-m", "--mode", dest="mode", type=str, default=d.mode, help="train, or test (inference) mode")
    p.add_argument("--dataset_dir", type=str, default=d.dataset_dir)
    p.add_argument("--results_dir", type=str, default=d.results_dir)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--model_class", type=str, default=d.model_class)
    p.add_argument("--latent_size", type=int, default=d.latent_size)
    p.add_argument("--split_size_val", type=float, default=d.split_size_val)
    p.add_argument("--split_size_test", type=float, default=d.split_size_test)
    p.add_argument("--nr_train_ids", type=int, default=d.nr_train_ids)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--validation_interval", type=int, default=d.validation_interval)
    p.add_argument("--early_stopping_patience", type=int, default=d.early_stopping_patience)
    p.add_argument("--loss", type=str, default=d.loss)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--lr_scheduler_type", type=str, default=d.lr_scheduler_type)
    p.add_argument("--lr_scheduler_val_delay", type=int, default=d.lr_scheduler_val_delay)
    p.add_argument("--lr_scheduler_caw_settings", type=float, nargs=3, default=list(d.lr_scheduler_caw_settings))
    p.add_argument("--optimizer_type", type=str, default=d.optimizer_type)
    p.add_argument("--sgd_momentum", type=float, default=d.sgd_momentum)
    p.add_argument("--ranger_momentum", type=float, default=d.ranger_momentum)
    p.add_argument("--ranger_threshold", type=int, default=d.ranger_threshold)
    p.add_argument("--train_shuffle", type=bool, default=d.train_shuffle)
    p.add_argument("--val_shuffle", type=bool, default=d.val_shuffle)
    p.add_argument("--trained_model", type=str, default=d.trained_model)
    p.add_argument("--plotting", type=bool, default=d.plotting)
    p.add_argument("--tracker", type=str, default=d.tracker or "none")
    p.add_argument("--n_devices", type=int, default=d.n_devices,
                   help="devices in the training grid, one rank each (0 = all visible)")
    p.add_argument("--model_parallel", type=int, default=d.model_parallel,
                   help="size of the model axis of the (data, model) grid")
    # multi-config training: S configurations of this architecture trained together (train/multi.py)
    p.add_argument("--seeds", type=str, default="",
                   help="comma-separated seeds; train mode only: trained together, one run dir per seed")
    p.add_argument("--lr_sweep", type=str, default="",
                   help="comma-separated learning-rate multipliers; train mode only: crossed with --seeds "
                        "(or --seed), one run dir per (seed, multiplier) pair")
    p.add_argument("--latent_sizes", type=str, default="",
                   help="comma-separated latent sizes; train mode only: crossed with --seeds/--lr_sweep, one "
                        "group per latent size")
    p.add_argument("--per_config_splits", type=bool, default=False,
                   help="multi-config runs: redraw the patient split under each config's seed instead of sharing "
                        "one cfg.seed split (type=bool, as the JAX CLI: any non-empty value is true)")
    p.add_argument("--multi_checkpoint_every", type=int, default=0,
                   help="multi-config runs: write the full stacked train state to results_dir every K dispatches "
                        "(0 = off)")
    p.add_argument("--multi_resume_dir", type=str, default="",
                   help="multi-config runs: resume from a checkpoint that --multi_checkpoint_every wrote")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device; 'cpu' runs the plain versions)")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return TrainConfig(
        mode=args.mode,
        dataset_dir=args.dataset_dir,
        results_dir=args.results_dir,
        seed=args.seed,
        model_class=args.model_class,
        latent_size=args.latent_size,
        split_size_val=args.split_size_val,
        split_size_test=args.split_size_test,
        nr_train_ids=args.nr_train_ids,
        batch_size=args.batch_size,
        epochs=args.epochs,
        validation_interval=args.validation_interval,
        early_stopping_patience=args.early_stopping_patience,
        loss=args.loss,
        weight_decay=args.weight_decay,
        dropout=args.dropout,
        lr=args.lr,
        lr_scheduler_type=args.lr_scheduler_type,
        lr_scheduler_val_delay=args.lr_scheduler_val_delay,
        lr_scheduler_caw_settings=tuple(args.lr_scheduler_caw_settings),
        optimizer_type=args.optimizer_type,
        sgd_momentum=args.sgd_momentum,
        ranger_momentum=args.ranger_momentum,
        ranger_threshold=args.ranger_threshold,
        train_shuffle=args.train_shuffle,
        val_shuffle=args.val_shuffle,
        trained_model=args.trained_model,
        plotting=args.plotting,
        tracker=None if args.tracker in ("none", "") else args.tracker,
        n_devices=args.n_devices,
        model_parallel=args.model_parallel,
    )


def autoencoder(custom_args: Optional[List[str]] = None):
    argv = list(sys.argv[1:] if custom_args is None else custom_args)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if str(cfg.mode).lower() == "train":
        multi = bool(args.seeds.strip() or args.lr_sweep.strip() or args.latent_sizes.strip())
        # the JAX package: main_train's mesh spans every visible device by default, train_ae_multi's only
        # the --n_devices given
        n = cfg.n_devices or (0 if multi else torch.cuda.device_count() if args.device is None else 1)
        if n > 1 or (cfg.model_parallel > 1 and not multi):
            from ae_waveforms_tpu_torch.parallel import launch

            devices, backend = launch.devices_for(max(n, 1), args.device)
            if len(devices) % cfg.model_parallel:
                raise ValueError(f"--model_parallel {cfg.model_parallel} must divide --n_devices {len(devices)}")
            return launch.run(_rank, (argv,), devices, backend, timeout_s=None)
    return _run(args, cfg, args.device)


def _rank(device, argv: List[str]):
    """One rank of a run over several devices (``parallel.launch.run``)."""
    from ae_waveforms_tpu_torch.parallel.mesh import data_mesh

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    return _run(args, cfg, device, data_mesh(cfg.model_parallel))


def _run(args, cfg: TrainConfig, device, mesh=None):
    np.random.seed(cfg.seed)
    mode = str(cfg.mode).lower()
    if mode == "train":
        if args.seeds.strip() or args.lr_sweep.strip() or args.latent_sizes.strip():
            return _train_multi(args, cfg, device, mesh)
        from ae_waveforms_tpu_torch.train.loop import main_train

        output_dir = main_train(cfg, device=device, mesh=mesh)
        if mesh is None or mesh.rank == 0:
            print(f"Training done, results and trained model saved at: {output_dir}")
        return output_dir
    if mode in ("test", "inference"):
        from ae_waveforms_tpu_torch.train.eval import main_test

        (_, (test_loss, rmse, rmse_samples, prd, prd_samples), (test_pred, test_true, test_c), _) = main_test(
            cfg, device=device)
        return test_loss, rmse, rmse_samples, prd, prd_samples, test_pred, test_true, test_c
    raise ValueError(f"unknown mode {cfg.mode!r}")


def _train_multi(args, cfg: TrainConfig, device, mesh) -> List[str]:
    """The cross of --seeds x --lr_sweep (x --latent_sizes, one group a
    latent size) trained together; returns the run dirs."""
    from ae_waveforms_tpu_torch.train.multi import train_ae_multi, train_ae_multi_grouped

    seeds = [int(s) for s in args.seeds.split(",") if s.strip()] if args.seeds.strip() else [cfg.seed]
    mults = [float(m) for m in args.lr_sweep.split(",") if m.strip()] if args.lr_sweep.strip() else [1.0]
    kw = dict(per_config_splits=bool(args.per_config_splits), save_runs=True, device=device, mesh=mesh)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    if args.multi_checkpoint_every:
        kw.update(checkpoint_every=args.multi_checkpoint_every, results_dir=cfg.results_dir)
    if args.multi_resume_dir.strip():
        kw.update(resume_dir=args.multi_resume_dir.strip())
    if args.latent_sizes.strip():
        latents = [int(d) for d in args.latent_sizes.split(",") if d.strip()]
        by_latent = train_ae_multi_grouped(cfg, [(d, s, m) for d in latents for s in seeds for m in mults], **kw)
        run_dirs = []
        for d in latents:
            res = by_latent[d]
            for s, m, rd, v in zip(res.seeds, res.lr_multipliers, res.run_dirs, res.best_val):
                say(f"Training done (latent {d}, seed {s}, lr x{m:g}, best val {v:.6f}), saved at: {rd}")
            run_dirs.extend(res.run_dirs)
        return run_dirs
    res = train_ae_multi(cfg, [s for s in seeds for _ in mults], lr_multipliers=[m for _ in seeds for m in mults],
                         **kw)
    for s, m, d, v in zip(res.seeds, res.lr_multipliers, res.run_dirs, res.best_val):
        say(f"Training done (seed {s}, lr x{m:g}, best val {v:.6f}), saved at: {d}")
    return res.run_dirs


if __name__ == "__main__":
    autoencoder()
