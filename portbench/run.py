"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (data and weights from the seed, the cell's warm-up), then the
timed window, then the correctness check against the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number the check compared
beside its limit (also the last lines of standard error).

It exits with 2 and prints no result where there is no CUDA device or
fewer than the cell asks for, and with 3 where JAX or the JAX package is
loaded in the process once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from portbench.bench import ROOT, Cell, Comparison, Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "ae_waveforms_tpu")
# kernel and compiler caches at fixed paths inside the checkout, so that
# only a cell's first run in a checkout builds
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/portbench/triton"}


@dataclass
class Bench:
    """What a driver gets: the cell, the run's seed, window and trace flag,
    the device, the tracer and a scratch directory under ``TMPDIR``."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    tracer: Any
    scratch: str

    def scratch_dir(self, name: str) -> str:
        path = os.path.join(self.scratch, name)
        os.makedirs(path, exist_ok=True)
        return path

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Reading:
    """What a per-layer reader gets."""

    cell: Cell
    device_name: str
    trace: Any
    records: Dict[str, Any]


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device) -> Dict[str, Any]:
    """One run of ``cell`` on ``device``: the result's fields, in order."""
    import torch

    from portbench.trace import Tracer

    scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        cuda = device.type == "cuda"
        tracer = Tracer(trace, device, scratch)
        bench = Bench(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, tracer=tracer,
                      scratch=scratch)
        driver = cell.driver_module()
        if cuda:
            torch.cuda.set_device(device)
            torch.empty(1, device=device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        state = driver.setup(bench)
        bench.synchronize()
        setup_s = time.perf_counter() - t0
        measured = driver.measure(state, bench)
        bench.synchronize()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        name = torch.cuda.get_device_name(device) if cuda else "cpu"
        if trace:
            reading = Reading(cell=cell, device_name=name, trace=tracer.trace, records=measured.records)
            metrics = {}
            for m in cell.per_layer:
                value = cell.reader(m["name"]).read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = dict(measured.end_to_end, setup_s=setup_s)
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        comparisons: List[Comparison] = driver.check(state, bench, measured)
        del state
        device_info = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell.chips,
                       "memory_peak_bytes": int(peak)}
        if trace:
            device_info.update(busy_s=tracer.trace.busy_s, window_s=tracer.trace.window_s)
        result = {
            "correct": bool(comparisons) and all(c.ok for c in comparisons) and measured.failed == 0,
            "attempted": measured.attempted,
            "failed": measured.failed,
            "metrics": metrics,
            "device": device_info,
        }
        if trace:
            result["breakdown"] = tracer.trace.breakdown()
        result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in comparisons}
        return result
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)

    cell = Spec().cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), this machine has {have}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    found = loaded_forbidden()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
