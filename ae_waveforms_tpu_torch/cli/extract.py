"""Extraction CLI of the port (the counterpart of the JAX package's
``cli/extract.py``; capability twin of data_extract_vitaldb.py's __main__
plus data_create_arrays.py).

``python -m ae_waveforms_tpu_torch.cli.extract --out DIR [--cases N | --case-ids ...] [--device cpu]``

Online mode uses the VitalDB client where it is installed; offline mode
generates synthetic records.  Per-case caches make the run idempotent and
resumable; the last step stacks all cases into np_waves / np_features /
np_info plus a data_stats.json (case ids and per-case sample counts, the
reference's data_stats.pkl contract in a dependency-free format).  The
device stages run on ``--device`` (the first CUDA device unless named;
``--device cpu`` runs them on the CPU).  ``--n_devices N`` above 1 (with
``--engine device --batched``, as in the JAX CLI) splits each window chunk
over N ranks, one process a device (``parallel/launch.py``; ``cuda:0`` to
``cuda:{N-1}`` over NCCL, or N CPU ranks over gloo with ``--device cpu``);
rank 0 writes the cache and the arrays.  ``--from-parquet DIR`` skips
extraction and builds the three arrays from the reference's per-case
parquet files (``data/parquet_compat.py``; needs pandas and pyarrow, and
no device); it writes no data_stats.json, as the JAX CLI writes none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ae_waveforms_tpu_torch import resolve_device
from ae_waveforms_tpu_torch.core.config import ExtractionConfig
from ae_waveforms_tpu_torch.core.schema import save_arrays
from ae_waveforms_tpu_torch.data.arrays import build_arrays
from ae_waveforms_tpu_torch.data.extract import ExtractionStats, extract_cases
from ae_waveforms_tpu_torch.data.synthetic import synthetic_ecg_record
from ae_waveforms_tpu_torch.data.vitaldb_io import find_cases, have_vitaldb, make_loader


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--out", type=str, required=True, help="output dataset dir")
    p.add_argument("--cases", type=int, default=16, help="number of cases (offline mode)")
    p.add_argument("--case-ids", type=int, nargs="*", default=None)
    p.add_argument("--duration", type=float, default=120.0, help="synthetic record seconds")
    p.add_argument("--precision", type=str, default="float64", choices=["float32", "float64"])
    p.add_argument("--engine", type=str, default="host", choices=["host", "python", "device"],
                   help="delineation engine: host f64 (the C++ delineator; raises if it cannot be "
                        "built), python f64 (pure-python reference-equivalent), or batched device f32")
    p.add_argument("--resample", type=str, default="linear", choices=["linear", "fft", "poly"],
                   help="delineation analysis-rate resampler (python engine only for non-linear; "
                        "signals/delineate.py RESAMPLE_METHODS)")
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--batched", action="store_true", help="pool windows across cases into large device batches")
    p.add_argument("--n_devices", type=int, default=None,
                   help="split each window chunk over this many devices, one rank each (needs --engine device "
                        "--batched)")
    p.add_argument("--from-parquet", type=str, default=None,
                   help="skip extraction: build the arrays from a directory of reference-format per-case "
                        "parquet files")
    p.add_argument("--device", default=None,
                   help="torch device of the device stages (default: the first CUDA device; 'cpu' runs them "
                        "on the CPU)")
    return p


def main(argv=None, stats: ExtractionStats = None) -> dict:
    """Run the CLI; returns ``{"results", "stats", "elapsed_s"}`` (the
    ``stats`` given, or a new ``ExtractionStats``; with ``--n_devices``
    above 1 rank 0's results and time, and stats None; with
    ``--from-parquet`` the parquet files' cases, and stats None)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.from_parquet:
        return _from_parquet(args)
    if args.n_devices is not None and args.n_devices > 1:
        if args.engine != "device" or not args.batched:
            raise SystemExit("--n_devices requires --engine device --batched")
        from ae_waveforms_tpu_torch.parallel import launch

        devices, backend = launch.devices_for(args.n_devices, args.device)
        return launch.run(_rank, (argv,), devices, backend, timeout_s=None)
    return _run(args, resolve_device(args.device), stats)


def _from_parquet(args) -> dict:
    from ae_waveforms_tpu_torch.data.parquet_compat import load_reference_cache_dir

    t0 = time.time()
    results = load_reference_cache_dir(args.from_parquet)
    arrays = build_arrays(results)
    save_arrays(arrays, args.out, allow_pickle=ExtractionConfig(path_data=args.out).use_pickle)
    print(f"converted {len(arrays)} samples from reference parquet cache {args.from_parquet} -> {args.out}")
    return {"results": results, "stats": None, "elapsed_s": time.time() - t0}


def _rank(device, argv) -> dict:
    """One rank of an extraction whose chunks are split over several
    devices (``parallel.launch.run``)."""
    from ae_waveforms_tpu_torch.parallel.mesh import data_mesh

    out = _run(build_parser().parse_args(argv), device, None, data_mesh())
    return dict(out, stats=None)  # its host stage times stay in the rank


def _run(args, device, stats, mesh=None) -> dict:
    writer = mesh is None or mesh.rank == 0

    cfg = ExtractionConfig(path_data=args.out, precision=args.precision, delineation_engine=args.engine,
                           delineation_resample=args.resample)
    if writer:
        os.makedirs(args.out, exist_ok=True)
    cache_dir = None if args.no_cache else os.path.join(args.out, "case_ids")

    if args.case_ids is not None:
        case_ids = args.case_ids
    elif have_vitaldb():
        case_ids = find_cases(cfg.track_names)
    else:
        case_ids = list(range(1, args.cases + 1))
    if have_vitaldb():
        loader = make_loader(cfg.track_names, cfg.sampling_frequency)
    else:
        def loader(cid):
            return synthetic_ecg_record(duration_s=args.duration, seed=int(cid))

    stats = stats if stats is not None else ExtractionStats()
    t0 = time.time()
    results = extract_cases(case_ids, loader, cfg, cache_dir=cache_dir, progress=writer, batched=args.batched,
                            device=device, stats=stats, mesh=mesh)
    if not writer:
        return {"results": results, "stats": stats, "elapsed_s": time.time() - t0}
    with stats.stage("write"):
        save_arrays(build_arrays(results), args.out, allow_pickle=cfg.use_pickle)
        summary = {
            "case_ids": [r.case_id for r in results if len(r.waves)],
            "samples_per_case_id": [len(r.waves) for r in results if len(r.waves)],
            "samples_total": int(sum(len(r.waves) for r in results)),
            "elapsed_s": time.time() - t0,
        }
        with open(os.path.join(args.out, "data_stats.json"), "w") as f:
            json.dump(summary, f)
    stats.finish()
    print(f"extracted {summary['samples_total']} samples from {len(summary['case_ids'])} cases "
          f"in {summary['elapsed_s']:.1f}s -> {args.out}")
    return {"results": results, "stats": stats, "elapsed_s": summary["elapsed_s"]}


if __name__ == "__main__":
    main()
