"""Where the GBT routing kernel's time goes, on the card, and which of its
launch paths wins at which shape.

    python -m ae_waveforms_tpu_torch.tools.route_profile [--baseline DIR]

Builds ``csrc/gbt_route.cu`` into ``build/route_profile/`` as:

- ``kernel``: as it is;
- ``stage``: the staging of splits and bins kept, the walk removed (the
  node ids go out as they came in);
- ``copy``: the node ids in and out alone, nothing staged and no walk: the
  floor of the bytes the kernel must move, at its own launch;
- ``empty``: each block returns at once: the floor of a launch.

At each shape (fits x rows x levels: phase 3's of ``chip_smoke.py``, and
one level on either side of each of ``route_plan``'s rules: 1 to 1024
nodes on the fits' rows, 32 nodes on 100 trees of 64 to 4,096 rows) it
prints the device time per call (a CUDA graph of 20 calls) of:

1. each build, with ``route_plan``'s launch;
2. the kernel on each launch path, staged or in place and tasks of 4 ids
   or 1, at ``route_layout``'s chunk and tile for that path, with
   ``route_plan``'s pick marked: the measurements behind its rules;
3. the kernel at the plans around the pick, chunks and tiles from a
   quarter to four times the pick's.

Every kernel result is checked against the plain version; all times go to
``build/route_profile/plans.json``.  With ``--baseline DIR`` (an earlier
checkout, for example a ``git archive`` of the parent commit unpacked into
``build/parent``), DIR's own ``chip_smoke.phase_route`` runs in its own
process before and after, so the earlier kernel is timed in the same call.
Each plan is launched through ``ops._build.launch`` with the plan's fields,
as ``route_levels`` launches ``route_plan``'s.  Inputs are
``tools.common.heap_inputs``': F = 10, 64 bins, node ids uniform over the
first level.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from ae_waveforms_tpu_torch.tools.common import graph_ms, heap_inputs, registers, sub

F, N_BINS = 10, 64
# (S, n, d0, d1): one level of the fit (96 fits x 12,500 rows at 32 nodes,
# the deep bucket's 24 at 512, the PPV sweep's 25 at 128), the fit's rows at
# 128 to 1024 nodes, the deep bucket's and the PPV sweep's shallower levels
# (1 to 256 nodes), the serving head's widest level on 64 to 4,096 rows
# and a 1024-node level, then every level of the serving head's trees and
# of the PPV prediction's in one launch
SHAPES = ([(96, 12500, 5, 6), (24, 12000, 9, 10), (25, 12500, 7, 8)]
          + [(96, 12500, d, d + 1) for d in (7, 8, 9, 10)]
          + [(24, 12000, d, d + 1) for d in (0, 3, 5, 7, 8)] + [(25, 12500, d, d + 1) for d in (0, 5)]
          + [(100, n, 5, 6) for n in (64, 256, 1024, 2048, 4096)] + [(100, 256, 10, 11)]
          + [(100, 64, 0, 6), (100, 256, 0, 6), (12500, 500, 0, 8)])
PATHS = ((True, 4), (True, 1), (False, 4), (False, 1))  # (staged, ids a task)


def variants(src: str) -> dict:
    no_walk = sub(sub(src, "      walk<kVec>(a, task, tasks, rows, node, splits, bins);\n", "      ;\n"),
                  "      walk_direct<kVec>(a, task, tasks, s0, i0, rows, node);\n", "      ;\n")
    copy = sub(sub(no_walk, "  const int table = kStaged ? fits << a.node_shift : 0;\n", "  const int table = 0;\n"),
               "  const int cells = kStaged ? (rows_inner ? a.F : rows) << inner : 0;\n", "  const int cells = 0;\n")
    empty = sub(src, "  const int s0 = blockIdx.y * a.chunk;\n", "  if (a.S > 0) return;\n  const int s0 = blockIdx.y * a.chunk;\n")
    return {"kernel": src, "stage": no_walk, "copy": copy, "empty": empty}


def own() -> int:
    import numpy as np
    import torch

    from ae_waveforms_tpu_torch.ops import _build
    from ae_waveforms_tpu_torch.ops import gbt_route as mod

    out_dir = _build.BUILD_DIR.parent / "route_profile"
    libs = _build.build_variants(out_dir, variants((_build.CSRC / _build.KERNELS["gbt_route"]).read_text()))
    for name in libs:
        print(f"[route] {name}: registers {registers(out_dir, name)}", flush=True)

    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = []
    for S, n, d0, d1 in SHAPES:
        args = heap_inputs(torch, dev, np.random.default_rng(S * 100 + d1), S, n, d0, d1, F=F, n_bins=N_BINS)
        bins_t, node, feat, thresh, split = args[:5]
        width, levels = 2**d0, d1 - d0
        nodes = width * (2**levels - 1)
        tables = (feat[:, width - 1:], thresh[:, width - 1:], split[:, width - 1:])
        out = torch.empty((S, n), dtype=torch.int32, device=dev)
        ref = mod.route_levels_reference(*args)
        chosen = mod.route_plan(S, n, F, levels, width, sms)
        where = f"S={S} n={n} levels [{d0}, {d1})"

        def timed(kind, plan, build_name="kernel"):
            def call():
                _build.launch(libs[build_name].gbt_route_launch, dev, bins_t.data_ptr(), bins_t.stride(0),
                              bins_t.stride(1), 0 if node is None else node.data_ptr(),
                              *(t.data_ptr() for t in tables), *(t.stride(0) for t in tables), out.data_ptr(), S, n,
                              F, width, levels, *map(int, plan))

            ms = graph_ms(torch, call, 20)
            if build_name == "kernel" and not torch.equal(out, ref):
                raise RuntimeError(f"the kernel differs from the plain version at {where} with {plan}")
            results.append(dict(S=S, n=n, d0=d0, d1=d1, kind=kind, build=build_name, **plan._asdict(), ms=ms,
                                chosen=plan == chosen))
            return ms

        def describe(plan):
            return (f"{'staged' if plan.staged else 'in place'}, {plan.vec} ids a task, {plan.chunk} fits x "
                    f"{plan.tile} rows, {plan.blocks} blocks of {plan.threads}, {plan.smem_bytes} bytes")

        times = {name: timed("build", chosen, name) for name in libs}
        print(f"[route] {where}, route_plan {describe(chosen)}: "
              + ", ".join(f"{k} {v:.5f}" for k, v in times.items()) + " ms per call", flush=True)
        for staged, vec in PATHS:
            if vec > 1 and n % vec:
                continue
            try:
                plan = mod.route_layout(S, n, F, nodes, staged, vec, sms)
            except ValueError:
                continue
            mark = " <- route_plan" if plan == chosen else ""
            print(f"[route] path {where} {describe(plan)}: {timed('path', plan):.5f} ms{mark}", flush=True)
        for chunk in sorted({min(max(chosen.chunk * k // 4, 1), S) for k in (1, 2, 4, 8, 16)}):
            for tile in sorted({min(max(chosen.tile * k // 4, 4), max(4, mod._pow2_ceil(n))) for k in (1, 2, 4, 8, 16)}):
                plan = mod._plan(S, n, F, nodes, chunk, tile, chosen.staged, chosen.vec)
                if plan.smem_bytes > mod.SMEM_BYTES or plan == chosen:
                    continue
                print(f"[route] plan {where} {describe(plan)}: {timed('plan', plan):.5f} ms", flush=True)
    (out_dir / "plans.json").write_text(json.dumps(results, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an earlier checkout whose chip_smoke.phase_route to run before and after")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("route_profile: no CUDA device is present", file=sys.stderr)
        return 2
    phase = "import torch, chip_smoke; chip_smoke.phase_route(torch, torch.device('cuda:0'))"
    baseline = [sys.executable, "-c", phase]
    if args.baseline and subprocess.run(baseline, cwd=Path(args.baseline).resolve()).returncode != 0:
        return 1
    rc = own()
    if rc == 0 and args.baseline and subprocess.run(baseline, cwd=Path(args.baseline).resolve()).returncode != 0:
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
