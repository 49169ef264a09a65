// GBT per-level left-child histograms, for Hopper (sm_90a).
//
// Replaces: ae_waveforms_tpu/ops/gbt_hist_pallas.py, left_histograms and its
// Pallas kernel _hist_kernel.  For S fits at once, one tree level:
//     GH[s, c, f*B + b] = sum_i [node_of[s, i] == 2 * (c mod half)]
//                               * (g if c < half else h)[s, i] * [binsT[f, i] == b]
// Right children come by subtraction in the caller.
//
// What bounds it on the H100: device memory in the byte count (each input
// read once: the binned pool, g, h and node ids; the histograms written
// once), but in practice the shared-memory atomics: two per (matched row,
// feature) in every block whose tile the row's node falls in, and every
// block reads all n rows of its fit.  The work is data dependent: a row
// counts only where its node is a left child.
//
// Design: one block per (fit, tile of left children, tile of features).  The
// tile's histogram lives in shared memory; the block walks all n rows of
// its fit, skips rows outside its tile of nodes, and adds g and h into the
// (node, feature, bin) cells of the rows that match.  One write of the tile
// at the end; each block owns its output cells, so there is no reduction
// across blocks.  Tiles are sized to a shared-memory budget and the
// feature tile is narrowed until there are two blocks per SM.  The TPU
// kernel's one-hot int8 stream, 0/1 expansion matrices, VMEM model and
// row padding existed for Mosaic and the MXU; none is needed here, and any
// level width works.
//
// Determinism: the sums are integer fixed point, and the kernel writes them
// as such.  Each g and h of fit s is scaled by 2^shift[s] and rounded to the
// nearest 64-bit integer (ties to even); shared-memory atomicAdd of integers
// gives the same sum in any order, so the same inputs give bit-identical
// histograms on every run, and the plain version in ops/gbt_hist.py gives
// the same integers on any device.  (Float atomics would reorder the sums
// from run to run, and a flipped near-tie changes the argmax split and so
// the tree.)  The caller picks shift[s] = 62 - L - e with max(|g|, |h|) of
// the fit below 2^e and n <= 2^L, so every term is at most 2^(62 - L) and no
// sum of n terms reaches 2^62.  g and h must be finite.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBudget = 96 * 1024;  // two blocks per SM
constexpr int kMinBlocks = 2 * 132;     // two waves' worth of blocks on 132 SMs

__global__ void __launch_bounds__(kThreads)
gbt_hist_kernel(const int32_t* __restrict__ binsT,   // (F, n)
                const float* __restrict__ g,         // (S, n)
                const float* __restrict__ h,         // (S, n)
                const int32_t* __restrict__ node_of, // (S, n)
                const int32_t* __restrict__ shift,   // (S,)
                long long* __restrict__ out,         // (S, 2 * half, F * B)
                int n, int F, int B, int half, int NT, int FT) {
  extern __shared__ unsigned long long smem[];
  const int n_ftiles = (F + FT - 1) / FT;
  const int c0 = (blockIdx.x / n_ftiles) * NT;
  const int f0 = (blockIdx.x % n_ftiles) * FT;
  const int s = blockIdx.y;
  const int nt = min(NT, half - c0);
  const int ft = min(FT, F - f0);
  const int cells = NT * FT * B;
  unsigned long long* sG = smem;
  unsigned long long* sH = smem + cells;
  for (int t = threadIdx.x; t < 2 * cells; t += blockDim.x) smem[t] = 0ull;
  const int k = shift[s];
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(s) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t node = node_of[row0 + i];
    if (node < 0 || (node & 1)) continue;  // not a left child
    const int j = (node >> 1) - c0;
    if (j < 0 || j >= nt) continue;  // another block's tile
    const long long qg = llrint(ldexp(static_cast<double>(g[row0 + i]), k));
    const long long qh = llrint(ldexp(static_cast<double>(h[row0 + i]), k));
    for (int fl = 0; fl < ft; ++fl) {
      const int32_t b = binsT[static_cast<int64_t>(f0 + fl) * n + i];
      if (b < 0 || b >= B) continue;
      const int cell = (j * FT + fl) * B + b;
      atomicAdd(&sG[cell], static_cast<unsigned long long>(qg));
      atomicAdd(&sH[cell], static_cast<unsigned long long>(qh));
    }
  }
  __syncthreads();

  const int64_t FB = static_cast<int64_t>(F) * B;
  for (int idx = threadIdx.x; idx < nt * ft * B; idx += blockDim.x) {
    const int b = idx % B;
    const int fl = (idx / B) % ft;
    const int jl = idx / (B * ft);
    const int cell = (jl * FT + fl) * B + b;
    const int64_t o = (static_cast<int64_t>(s) * 2 * half + c0 + jl) * FB + static_cast<int64_t>(f0 + fl) * B + b;
    out[o] = static_cast<long long>(sG[cell]);
    out[o + half * FB] = static_cast<long long>(sH[cell]);
  }
}

}  // namespace

// Launches one level's histograms on ``stream``; returns the launch's
// cudaError_t (0 on success).  A (node, feature) cell takes 16 * B bytes of
// shared memory (g and h, B bins of 64-bit integers), so B <= 6144.
extern "C" int gbt_hist_launch(const int32_t* binsT, const float* g, const float* h,
                               const int32_t* node_of, const int32_t* shift, long long* out,
                               int S, int n, int F, int B, int half, cudaStream_t stream) {
  const int cell_bytes = 16 * B;
  const int max_cells = kSmemBudget / cell_bytes;
  if (S < 1 || S > 65535 || n < 1 || F < 1 || B < 1 || half < 1 || max_cells < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NT = min(half, max(1, max_cells / F));
  int FT = min(F, max_cells / NT);
  const int64_t node_tiles = (half + NT - 1) / NT;
  while (FT > 1 && static_cast<int64_t>(S) * node_tiles * ((F + FT - 1) / FT) < kMinBlocks) FT = (FT + 1) / 2;
  const int64_t blocks = node_tiles * ((F + FT - 1) / FT);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);

  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(gbt_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const size_t smem = static_cast<size_t>(2) * NT * FT * B * sizeof(unsigned long long);
  gbt_hist_kernel<<<dim3(static_cast<unsigned int>(blocks), S), kThreads, smem, stream>>>(
      binsT, g, h, node_of, shift, out, n, F, B, half, NT, FT);
  return static_cast<int>(cudaGetLastError());
}
