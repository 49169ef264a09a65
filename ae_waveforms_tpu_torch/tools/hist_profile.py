"""Where the GBT histogram kernel's time goes, on the card.

    python -m ae_waveforms_tpu_torch.tools.hist_profile [--baseline DIR]

For this checkout, and for an earlier checkout in DIR when given (for
example a ``git archive`` of the parent commit, unpacked), builds
``csrc/gbt_hist.cu`` into ``build/hist_profile/`` of that checkout as:

- ``kernel``: as it is;
- ``noatomic``: every ``atomicAdd`` replaced by a stand-in that keeps its
  operands alive and adds nothing, every inline ``atom.shared.add`` by a
  move and every ``red.shared.add`` dropped, so its time is the walk and
  the loads without the shared-memory atomics (its results are wrong and
  not used);
- ``atomic64`` (where the source keeps its sums in ``struct Sums``): the
  64-bit shared-memory atomicAdd in place of the two 32-bit words;
- ``stamped`` (this checkout's kernel only): ``clock64()`` stamps of thread
  0 of each block around the clearing of the tile, the walk (with the wait
  at the first cluster barrier) and the reduction and write-out.

It prints, per build, the shared-memory atomics of its SASS
(``cuobjdump -sass``, by opcode) and the device time per call (a CUDA graph
of 20 calls) at the fit's shapes, each build launched through
``ops._build.launch`` with ``hist_plan``'s plan, as ``left_histograms_fixed``
launches it; for ``stamped`` the cycles per block of each part.  For this
checkout it then times every cluster size C at each shape beside
``hist_plan``'s choice, and writes those times to
``build/hist_profile/plans.json``.  A checkout is profiled by its own copy
of this tool (``python -m`` in that checkout), so DIR must hold it too: an
earlier checkout without it is profiled with its own tool.
Inputs are random, from seeds: F = 10, 64 bins, node ids uniform over the
level, and in the "fit-like" shape g = h = 0 on 46% of rows.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.tools.common import graph_ms, registers, sub

F, N_BINS = 10, 64
# (S, n, half, share of rows with g = h = 0)
SHAPES = [(96, 12000, 16, 0.0), (96, 12000, 16, 0.46), (96, 12000, 1, 0.0), (96, 12000, 4, 0.0),
          (24, 12000, 64, 0.0), (24, 12000, 256, 0.0), (25, 12500, 16, 0.0), (25, 12500, 64, 0.0),
          (6, 12000, 1, 0.0), (6, 12000, 16, 0.46), (6, 12000, 256, 0.46)]
PARTS = ("clear", "walk and wait", "reduce and write")

STAND_IN = """template <typename T>
__device__ __forceinline__ T fake_add(T* p, T v) {  // keeps p and v alive, adds nothing
  if (v == static_cast<T>(0x5bd1e995u)) *p = v;
  return T(0);
}
"""


# the body of ``struct Sums`` with 64-bit words: two arrays, 2 * kStride
# words apart, the sums of g, then of h
SUMS64 = """  __device__ __forceinline__ void add(int cell, long long qg, long long qh) const {
    unsigned long long* p = reinterpret_cast<unsigned long long*>(base) + cell;
    atomicAdd(p, static_cast<unsigned long long>(qg));
    atomicAdd(p + kStride, static_cast<unsigned long long>(qh));
  }
  __device__ __forceinline__ void clear(int cells, int t) const {
    for (int i = t; i < cells / 2; i += kThreads)
#pragma unroll
      for (int a = 0; a < 2; ++a) reinterpret_cast<uint4*>(base + 2 * a * kStride)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static void read(const unsigned* src, int cell, unsigned long long& g,
                                              unsigned long long& h) {
    const unsigned long long* p = reinterpret_cast<const unsigned long long*>(src) + cell;
    g = p[0];
    h = p[kStride];
  }
};
"""


def stamped(src: str) -> str:
    """The kernel with clock64 stamps of thread 0 of each block, summed over
    blocks into ``g_stamps`` (cycles of each part, then the block count)."""
    s = sub(src, "namespace {\n", "__device__ unsigned long long g_stamps[4];\nnamespace {\n")
    s = sub(s, "  extern __shared__ uint4 smem[];\n", "  extern __shared__ uint4 smem[];\n  const long long t0 = clock64();\n")
    s = sub(s, "  __syncthreads();\n\n  // the walk", "  __syncthreads();\n  const long long t1 = clock64();\n\n  // the walk")
    s = sub(s, "  cluster.sync();  // every copy of the tile is complete\n",
             "  cluster.sync();  // every copy of the tile is complete\n  const long long t2 = clock64();\n")
    s = sub(s, "  cluster.sync();  // no block leaves while another still reads its copy\n",
             "  cluster.sync();  // no block leaves while another still reads its copy\n"
             "  if (threadIdx.x == 0) {\n    atomicAdd(&g_stamps[0], t1 - t0);\n    atomicAdd(&g_stamps[1], t2 - t1);\n"
             "    atomicAdd(&g_stamps[2], clock64() - t2);\n    atomicAdd(&g_stamps[3], 1ull);\n  }\n")
    s += ('\n// copies the stamps out and clears them\n'
          'extern "C" int read_stamps(unsigned long long* host) {\n'
          '  const cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n'
          '  if (err != cudaSuccess) return (int)err;\n'
          '  void* dev = nullptr;\n'
          '  cudaGetSymbolAddress(&dev, g_stamps);\n'
          '  return (int)cudaMemset(dev, 0, sizeof(g_stamps));\n}\n')
    return s


def atomic64(src: str) -> str:
    """The kernel with ``struct Sums``' members replaced by ``SUMS64``."""
    head = "  unsigned addr;  // ``base`` as a shared-memory address\n"
    start = src.index(head, src.index("struct Sums {")) + len(head)
    return src[:start] + SUMS64 + src[src.index("};\n", start) + 3:]


def variants(src: str, own: bool) -> dict:
    """name -> source text."""
    noatomic = STAND_IN + src.replace("atomicAdd(", "fake_add(")
    noatomic = re.sub(r"atom\.shared\.add\.u32 (\w+), \[[^\]]*\], (%\d+);", r"mov.u32 \1, \2;", noatomic)
    noatomic = re.sub(r"red\.shared\.add\.u32 \[[^\]]*\], \w+;", "", noatomic)
    out = {"kernel": src, "noatomic": noatomic}
    if "struct Sums {" in src:
        out["atomic64"] = atomic64(src)
    if own:
        out["stamped"] = stamped(src)
    return out


def sass_atomics(so: Path) -> dict:
    """Shared-memory atomic instructions of the library's SASS, by opcode."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
    return dict(collections.Counter(re.findall(r"\b(ATOMS\.[A-Z0-9.]+|ATOMS)\b", text)))


def inputs(torch, np, S, n, half, zero):
    rng = np.random.default_rng(S * 100_000 + half)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    binsT = t(rng.integers(0, N_BINS, size=(F, n)).astype(np.int32))
    keep = (rng.random((S, n)) >= zero).astype(np.float32)
    g = t(rng.uniform(-1, 1, (S, n)).astype(np.float32) * keep)
    h = t(rng.uniform(0, 0.25, (S, n)).astype(np.float32) * keep)
    node = t(rng.integers(0, 2 * half, size=(S, n)).astype(np.int32))
    return binsT, g, h, node


def launch(lib, dev, plan, C: int, packed, g, h, node, shift, out, half: int) -> None:
    """One launch of build ``lib`` into ``out`` with ``plan``'s tile and C
    blocks a cluster (one-byte bins)."""
    S, n = g.shape
    _build.launch(lib.gbt_hist_launch, dev, packed.data_ptr(), g.data_ptr(), h.data_ptr(), node.data_ptr(),
                  shift.data_ptr(), out.data_ptr(), S, n, packed.shape[1], 1, F, N_BINS, half, C, plan.node_tile,
                  plan.feature_tile, plan.threads, plan.smem_bytes)


def worker(label: str, own: bool) -> int:
    """Runs in the checkout that is the working directory: builds its
    variants and times each at every shape."""
    import numpy as np
    import torch

    from ae_waveforms_tpu_torch.ops import gbt_hist as mod

    out_dir = _build.BUILD_DIR.parent / "hist_profile"
    libs = _build.build_variants(out_dir, variants((_build.CSRC / _build.KERNELS["gbt_hist"]).read_text(), own))
    for name in libs:
        print(f"[hist] {label} {name}: registers {registers(out_dir, name)}; shared-memory atomics in the SASS "
              f"{sass_atomics(out_dir / f'{name}.so')}", flush=True)

    dev = torch.device("cuda:0")
    active = mod.active_clusters(dev.index)
    data = {}
    for shape in SHAPES:
        S, n, half, zero = shape
        binsT, g, h, node = inputs(torch, np, *shape)
        shift = mod.fixed_point_shift(g, h)
        ref = mod.left_histograms_fixed_reference(binsT, g, h, node, shift, half=half, n_bins=N_BINS)
        plan = mod.hist_plan(S, n, F, N_BINS, half, active)
        data[shape] = (mod.pack_bins(binsT, N_BINS), g, h, node, shift, ref, plan)
    for name, lib in libs.items():
        for shape, (packed, g, h, node, shift, ref, plan) in data.items():
            S, n, half, zero = shape
            out = torch.empty_like(ref)

            def call():
                launch(lib, dev, plan, plan.cluster, packed, g, h, node, shift, out, half)

            ms = graph_ms(torch, call, 20)
            line = (f"[hist] {label} {name} S={S} n={n} half={half} zero rows {zero:.2f}: {ms:.5f} ms per call, "
                    f"exact {torch.equal(out, ref)}")
            if name == "stamped":
                buf = (ctypes.c_ulonglong * 4)()
                lib.read_stamps(buf)  # clears what the timing added
                call()
                torch.cuda.synchronize()
                if lib.read_stamps(buf) != 0:
                    raise RuntimeError("reading the clock64 stamps failed")
                blocks = max(int(buf[3]), 1)
                line += "; cycles per block: " + ", ".join(f"{p} {buf[i] / blocks:.0f}" for i, p in enumerate(PARTS))
            print(line, flush=True)
    if own:
        plans(torch, dev, libs["kernel"], data, active, out_dir)
    return 0


def plans(torch, dev, lib, data, active, out_dir: Path) -> None:
    """Every cluster size at each shape, beside hist_plan's choice."""
    from ae_waveforms_tpu_torch.ops.gbt_hist import CLUSTER_SIZES

    results = []
    for shape, (packed, g, h, node, shift, ref, chosen) in data.items():
        S, n, half, zero = shape
        out = torch.empty_like(ref)
        for C in CLUSTER_SIZES:
            plan = chosen._replace(cluster=C)
            ms = graph_ms(torch, lambda: launch(lib, dev, plan, C, packed, g, h, node, shift, out, half), 20)
            exact = torch.equal(out, ref)
            mark = " <- hist_plan" if C == chosen.cluster else ""
            print(f"[hist] plan S={S} n={n} half={half} zero rows {zero:.2f} C={C} tile {plan.node_tile}x"
                  f"{plan.feature_tile} walks {plan.walks} smem {plan.smem_bytes} active clusters {active[C]}: "
                  f"{ms:.5f} ms, exact {exact}{mark}", flush=True)
            results.append(dict(S=S, n=n, half=half, zero=zero, C=C, ms=ms, active=active[C],
                                smem=plan.smem_bytes, walks=plan.walks, chosen=C == chosen.cluster))
    (out_dir / "plans.json").write_text(json.dumps(results, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an earlier checkout whose kernel to profile as well")
    ap.add_argument("--worker", choices=("own", "baseline"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.worker == "own")
    import torch

    if not torch.cuda.is_available():
        print("hist_profile: no CUDA device is present", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[2]
    runs = [(root, "own")] + ([(Path(args.baseline).resolve(), "baseline")] if args.baseline else [])
    for checkout, label in runs:
        # python -m puts the working directory first on the path: the checkout's own package
        cmd = [sys.executable, "-m", "ae_waveforms_tpu_torch.tools.hist_profile", "--worker", label]
        rc = subprocess.run(cmd, cwd=checkout).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
