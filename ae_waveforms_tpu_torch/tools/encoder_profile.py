"""Where a phase of the LSTM encoder kernel's time loop goes, on the card.

    python -m ae_waveforms_tpu_torch.tools.encoder_profile

Builds ``csrc/lstm_encoder.cu`` three times into ``build/encoder_profile/``:

- ``kernel``: as it is;
- ``relaxed``: the phase's ``cluster.sync()`` made a relaxed arrive and a
  wait, so the barrier carries no release fence.  Its results are then not
  guaranteed (they are checked and printed, not trusted); it is timed to
  show what the fence costs;
- ``stamped``: ``clock64()`` stamps around the parts of a warp's share
  (the k loop, the split sums, the cell update, the remote stores) and the
  barrier, summed over the phases.

For each build it prints the device time per call (a CUDA graph of 10
calls) at B = 64 and 256 with ``encoder_plan``'s plan and at B = 64 with 4
rows per cluster (16 clusters, more than the card holds at once), and for
``stamped`` the cycles per phase of each part for lane 0 of each warp of the
first block.  Widths 1 -> 128 -> 64 -> 10, T = 320, weights from a seed.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ae_waveforms_tpu_torch.models.lstm_ae import LSTMAutoencoder
from ae_waveforms_tpu_torch.ops import _build
from ae_waveforms_tpu_torch.ops.lstm_encoder import _smem_floats, encode_fused_reference, encoder_plan
from ae_waveforms_tpu_torch.tools.common import graph_ms, registers, sub

OUT = _build.BUILD_DIR.parent / "encoder_profile"
T, H1, H2, L = 320, 128, 64, 10
PARTS = ("k loop", "split sums", "cell", "remote stores", "cluster.sync", "phase")


def variants(src: str) -> dict:
    sync = "    cluster.sync();  // the one barrier of the phase"
    relaxed = sub(src, sync, '    asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n\\t'
                             'barrier.cluster.wait.aligned;\\n" ::: "memory");  //')
    s = sub(src, "namespace {\n", "__device__ long long g_stamps[32][6];\nnamespace {\n")
    s = sub(s, "const float4* wx1, int lane,\n", "const float4* wx1, int lane, long long (&tp)[6],\n")
    s = sub(s, "  const int split = lane % kSplit,", "  const long long q0 = clock64();\n  const int split = lane % kSplit,")
    s = sub(s, "  float gate[4];\n", "  const long long q1 = clock64();\n  tp[0] += q1 - q0;\n  float gate[4];\n")
    s = sub(s, "  if (!own) return;\n", "  const long long q2 = clock64();\n  tp[1] += q2 - q1;\n  if (!own) return;\n")
    s = sub(s, "  if (dup == 0) ly.c[", "  const long long q3 = clock64();\n  tp[2] += q3 - q2;\n  if (dup == 0) ly.c[")
    s = sub(s, "cluster.map_shared_rank(hn, dst)[idx] = hv;\n}\n",
            "cluster.map_shared_rank(hn, dst)[idx] = hv;\n  tp[3] += clock64() - q3;\n}\n")
    s = sub(s, "lane, cluster);", "lane, tp, cluster);", 3)
    s = sub(s, "  for (int s = 0; s < T + 2; ++s) {\n",
            "  long long tp[6] = {0, 0, 0, 0, 0, 0};\n  for (int s = 0; s < T + 2; ++s) {\n    const long long c0 = clock64();\n")
    s = sub(s, sync, "    const long long c1 = clock64();\n    cluster.sync();\n"
                     "    tp[4] += clock64() - c1;\n    tp[5] += clock64() - c0;  //")
    s = sub(s, "  // h3 at step T - 1 was written",
            "  if (blockIdx.x == 0 && lane == 0)\n    for (int z = 0; z < 6; ++z) g_stamps[warp][z] = tp[z];\n"
            "  // h3 at step T - 1 was written")
    s += ('\n// copies the stamps out and clears them for the next run\n'
          'extern "C" int read_stamps(long long* host) {\n'
          '  const cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n'
          '  if (err != cudaSuccess) return (int)err;\n'
          '  void* dev = nullptr;\n'
          '  cudaGetSymbolAddress(&dev, g_stamps);\n'
          '  return (int)cudaMemset(dev, 0, sizeof(g_stamps));\n}\n')
    return {"kernel": src, "relaxed": relaxed, "stamped": s}


def main() -> int:
    if not torch.cuda.is_available():
        print("encoder_profile: no CUDA device is present", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    libs = _build.build_variants(OUT, variants((_build.CSRC / _build.KERNELS["lstm_encoder"]).read_text()))
    for name in libs:
        print(f"[build] {name}: registers per thread by instance {registers(OUT, name)}")
    model = LSTMAutoencoder(L, generator=torch.Generator().manual_seed(0), device=dev)
    params = model.jax_tree()
    weights = [params[f"enc{i}"][k] for i in (1, 2, 3) for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    for B, R in ((64, None), (256, None), (64, 4)):
        x = torch.from_numpy(np.random.default_rng(B).standard_normal((B, T, 1)).astype(np.float32)).to(dev)
        with torch.no_grad():
            ref = encode_fused_reference(params, x)
        plan = tuple(encoder_plan(B, H1, H2, L, T)) if R is None else (R, -(-B // R), 4 * _smem_floats(R, T, H1, H2, L))
        for name, lib in libs.items():
            out = torch.empty((B, L), device=dev)

            def call():
                _build.launch(lib.lstm_encoder_launch, dev, x.data_ptr(), *(w.data_ptr() for w in weights),
                              out.data_ptr(), B, T, H1, H2, L, *plan)

            ms = graph_ms(torch, call, 10)
            err = (out - ref).abs().max().item()
            print(f"[encoder] {name} B={B} R={plan[0]} clusters={plan[1]}: {ms:.4f} ms per call, "
                  f"{ms * 1e3 / (T + 2):.3f} us per phase; max_abs_err {err:.3e}")
            if name == "stamped":
                buf = (ctypes.c_longlong * (32 * 6))()
                if lib.read_stamps(buf) != 0:
                    raise RuntimeError("reading the clock64 stamps failed")
                cycles = np.array(buf[:]).reshape(32, 6) / (T + 2)
                print(f"[encoder]   cycles per phase, lane 0 of each warp of block 0: {', '.join(PARTS)}")
                for w in range(32):
                    if cycles[w, 5] > 0:
                        print(f"[encoder]   warp {w:2d}: " + " ".join(f"{v:8.1f}" for v in cycles[w]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
