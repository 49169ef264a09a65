"""Readings for the correctness limits of one cell, at the cell's own size:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 5 [--out FILE]

For each of ``--seeds``, a run of the cell with a short window and its
check (the program's readings); for each of ``--control-seeds``, the
driver's ``control_readings`` (the reference in the program's place in the
precision below the configuration's, and the planted faults).  One JSON
line a reading on standard output, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from portbench.bench import Spec
from portbench.run import CACHE_DIRS, ROOT, Bench, run_cell
from portbench.trace import Tracer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    import torch

    cell = Spec().cell(args.workload)
    cell.traffic["limits"] = dict.fromkeys(cell.driver_module().NUMBERS, float("inf"))
    dev = torch.device("cuda:0")
    lines = []

    def emit(kind, seed, readings):
        line = {"workload": cell.name, "kind": kind, "seed": seed, "readings": readings}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        result = run_cell(cell, seed, args.seconds, False, dev)
        emit("program", seed, {k: v["value"] for k, v in result["compared"].items()})
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        scratch = tempfile.mkdtemp(prefix="portbench-")
        bench = Bench(cell=cell, seed=seed, seconds=args.seconds, trace=False, device=dev,
                      tracer=Tracer(False, dev, scratch), scratch=scratch)
        try:
            for kind, readings in cell.driver_module().control_readings(bench).items():
                emit(kind, seed, readings)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
