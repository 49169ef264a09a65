// GBT per-level left-child histograms, for Hopper (sm_90a): each fit's rows
// split over the blocks of a thread-block cluster, one shared-memory copy of
// the tile per block, summed across the cluster through distributed shared
// memory.
//
// Replaces: ae_waveforms_tpu/ops/gbt_hist_pallas.py, left_histograms and its
// Pallas kernel _hist_kernel.  For S fits at once, one tree level:
//     GH[s, c, f*B + b] = sum_i [node_of[s, i] == 2 * (c mod half)]
//                               * (g if c < half else h)[s, i] * [bins[i, f] == b]
// Right children come by subtraction in the caller.
//
// What bounds it on the H100: device memory in the byte count (each input
// read once: the packed bins, g, h and node ids; the histograms written
// once).  In practice the instructions issued per (row, feature) and the
// shared-memory atomics: each (row whose node is a left child of the tile
// and whose g or h is not zero, feature of the tile) adds g and h to one
// cell, four 32-bit atomics.  The work is data dependent: rows of other
// nodes and rows of weight zero cost a load and nothing more.
// tools/hist_profile.py measures each part.
//
// Design (the plan comes from hist_plan in ops/gbt_hist.py):
// - One cluster of C blocks (C in 1, 2, 4, 8) per (fit, tile of left
//   children x features).  Block r of the cluster walks only rows
//   [r*n/C, (r+1)*n/C) of the fit and adds them into its own copy of the
//   tile's histogram in shared memory.  A tile holds as many (node, feature)
//   pairs as the plan gives it, so a fit's rows are walked once per tile
//   (once per level where the whole level fits one block).
// - The walk keeps every lane busy.  A warp reads kRows rows a lane (one per
//   block-stride, so every load is coalesced), their node ids and, for rows
//   of its tile, g and h.  Rows of the tile whose g or h is not zero go into
//   the warp's queue in shared memory; rows of other nodes and rows of weight
//   zero (held-out and subsampled-out rows of a fit) go nowhere.  Whenever the
//   queue holds 32 rows, each lane takes one, reloads its g, h and node id
//   (just read by the warp, so from cache) and its bins, rounds g and h to
//   fixed point and adds every feature of the tile.
// - Bins come packed (pack_bins): a row's bins as bytes (two bytes where
//   n_bins > 255), padded to 16-byte words, so one 16-byte load serves up
//   to 16 features of a row, unrolled.  A bin >= n_bins (the packing's
//   sentinel for a bin outside [0, n_bins)) adds into a spare cell that is
//   never read, so no branch guards an add.
// - Atomics.  A 64-bit shared-memory atomicAdd compiles to a compare-and-swap
//   loop on sm_90 (ATOMS.CAST.SPIN.64; tools/hist_profile.py prints the SASS
//   and times it), so a sum is kept as two 32-bit words: the low word takes
//   the low half with a native atomic add, whose returned old value gives the
//   carry, and the high word takes the high half plus the carry.  The pair
//   holds the sum modulo 2^64, which is the sum itself, since no partial sum
//   reaches 2^62 in magnitude.  The four words of a cell lie in four arrays
//   kStride words apart, so one 32-bit address and immediate offsets reach
//   them, and the lanes' random cells spread over the banks as far as chance
//   allows.  tools/hist_profile.py builds a variant with the 64-bit
//   atomicAdd in their place.
// - After cluster.sync(), block r owns slice r of the tile's (node, feature)
//   pairs: it adds the C copies of each of its cells in rank order, reading
//   the others' shared memory directly, and writes each cell once, adjacent
//   lanes to adjacent words.  A second cluster.sync() keeps every block
//   resident until the others are done reading it.  No global atomics, so no
//   zeroing of the output.
//
// Determinism: the sums are integer fixed point, and the kernel writes them
// as such.  Each g and h of fit s is scaled by 2^shift[s] and rounded to the
// nearest 64-bit integer (ties to even); integer adds give the same sum in
// any order, so the same inputs give bit-identical histograms on every run,
// and the plain version in ops/gbt_hist.py gives the same integers on any
// device.  (Float atomics would reorder the sums from run to run, and a
// flipped near-tie changes the argmax split and so the tree.)  The caller
// picks shift[s] = 62 - L - e with max(|g|, |h|) of the fit below 2^e and
// n <= 2^L, so every term is at most 2^(62 - L) and no sum of n terms reaches
// 2^62.  g and h must be finite.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // a block; with 64 registers a thread, one block an SM
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows a lane reads at a time
constexpr int kQueue = 32 * (kRows + 1);  // a warp's queue: fewer than 32 left over, 32 * kRows new
constexpr int kMaxCluster = 8;
constexpr int kSmemMax = 232448;  // shared memory a block may use on the H100
// words of each of the four arrays of sums; a tile has at most kStride - 1
// cells, the last one being the spare
constexpr int kStride = (kSmemMax - 4 * kWarps * kQueue) / 16 / 4 * 4;

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ double pow2(int k) {  // 2^k, exact for k in [-1022, 1023]
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

// A tile's sums in one block's shared memory: g and h of each cell.
struct Sums {
  unsigned* base;
  unsigned addr;  // ``base`` as a shared-memory address
  // four arrays kStride words apart: low halves of g, high halves of g, low
  // and high halves of h
  __device__ __forceinline__ void add(int cell, long long qg, long long qh) const {
    asm volatile(
        "{\n\t.reg .u32 o, t, c;\n\t"
        "atom.shared.add.u32 o, [%0], %1;\n\t"
        "add.cc.u32 t, o, %1;\n\t"
        "addc.u32 c, %2, 0;\n\t"
        "red.shared.add.u32 [%0+%5], c;\n\t"
        "atom.shared.add.u32 o, [%0+%6], %3;\n\t"
        "add.cc.u32 t, o, %3;\n\t"
        "addc.u32 c, %4, 0;\n\t"
        "red.shared.add.u32 [%0+%7], c;\n\t}"
        ::"r"(addr + 4u * cell), "r"(static_cast<unsigned>(qg)),
        "r"(static_cast<unsigned>(static_cast<unsigned long long>(qg) >> 32)), "r"(static_cast<unsigned>(qh)),
        "r"(static_cast<unsigned>(static_cast<unsigned long long>(qh) >> 32)), "n"(4 * kStride), "n"(8 * kStride),
        "n"(12 * kStride)
        : "memory");
  }
  __device__ __forceinline__ void clear(int cells, int t) const {
    for (int i = t; i < cells / 4; i += kThreads)
#pragma unroll
      for (int a = 0; a < 4; ++a) reinterpret_cast<uint4*>(base + a * kStride)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // the g and h sums of ``cell`` in the copy at ``src``
  __device__ __forceinline__ static void read(const unsigned* src, int cell, unsigned long long& g,
                                              unsigned long long& h) {
    g = static_cast<unsigned long long>(src[kStride + cell]) << 32 | src[cell];
    h = static_cast<unsigned long long>(src[3 * kStride + cell]) << 32 | src[2 * kStride + cell];
  }
};

struct Tile {
  int c0, nt;      // left children [c0, c0 + nt)
  int f0, ft, FT;  // features [f0, f0 + ft) of a tile of FT
  int B, spare;    // bins; the spare cell
};

// Adds row ``i`` of fit s (``row0`` = s * n) into the tile: g and h, rounded
// to fixed point, into cell (j, f - f0, bin) for each feature f of the tile.
template <int ES>
__device__ __forceinline__ void add_row(const Sums& sums, const Tile& t, const uint8_t* __restrict__ packed, int W,
                                        const float* __restrict__ g, const float* __restrict__ h,
                                        const int32_t* __restrict__ node_of, int64_t row0, int i, double scale) {
  constexpr int P = 16 / ES;  // bins a 16-byte word
  const uint4* row = reinterpret_cast<const uint4*>(packed + static_cast<int64_t>(i) * W);
  const int w_lo = t.f0 * ES / 16, w_hi = ((t.f0 + t.ft) * ES - 1) / 16;
  uint4 v = row[w_lo];
  const int j = (node_of[row0 + i] >> 1) - t.c0;
  const long long qg = __double2ll_rn(static_cast<double>(g[row0 + i]) * scale);
  const long long qh = __double2ll_rn(static_cast<double>(h[row0 + i]) * scale);
  for (int w = w_lo; w <= w_hi; ++w) {
    if (w != w_lo) v = row[w];
    const int fw = w * P;  // the feature at the word's first bin
    const int e_lo = min(P, max(0, t.f0 - fw)), e_hi = min(P, max(0, t.f0 + t.ft - fw));  // bins of the tile
    const int cw = (j * t.FT + fw - t.f0) * t.B;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      if (e >= e_hi) break;  // the same for the whole block: no divergence
      if (e < e_lo) continue;
      const unsigned word = (e * ES) / 4 == 0 ? v.x : (e * ES) / 4 == 1 ? v.y : (e * ES) / 4 == 2 ? v.z : v.w;
      const int b = static_cast<int>((word >> ((e * ES) % 4 * 8)) & (ES == 1 ? 0xffu : 0xffffu));
      sums.add(b < t.B ? cw + e * t.B + b : t.spare, qg, qh);
    }
  }
}

template <int ES>
__global__ void __launch_bounds__(kThreads, 1)
gbt_hist_kernel(const uint8_t* __restrict__ packed,  // (n, W) bytes: bins of a row, ES bytes each
                const float* __restrict__ g,         // (S, n)
                const float* __restrict__ h,         // (S, n)
                const int32_t* __restrict__ node_of, // (S, n)
                const int32_t* __restrict__ shift,   // (S,)
                long long* __restrict__ out,         // (S, 2 * half, F * B)
                int n, int W, int F, int B, int half, int NT, int FT) {
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / C;
  const int n_ftiles = (F + FT - 1) / FT;
  Tile t;
  t.c0 = (tile / n_ftiles) * NT;
  t.nt = min(NT, half - t.c0);
  t.f0 = (tile % n_ftiles) * FT;
  t.ft = min(FT, F - t.f0);
  t.FT = FT;
  t.B = B;
  t.spare = NT * FT * B;
  const int s = blockIdx.y;
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  const Sums sums{words, static_cast<unsigned>(__cvta_generic_to_shared(words))};
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned* queue = words + 4 * kStride + warp * kQueue;
  sums.clear(static_cast<int>(cdiv(t.spare + 1, 4) * 4), threadIdx.x);
  const double scale = pow2(shift[s]);
  __syncthreads();

  // the walk: this block's rows of fit s
  const int64_t row0 = static_cast<int64_t>(s) * n;
  const int first = static_cast<int>(static_cast<int64_t>(n) * rank / C);
  const int last = static_cast<int>(static_cast<int64_t>(n) * (rank + 1) / C);
  const unsigned below = (1u << lane) - 1u;
  int queued = 0;  // the same in every lane of the warp
  for (int i0 = first + threadIdx.x - lane; i0 < last; i0 += kRows * kThreads) {
    int node[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = i0 + lane + k * kThreads;
      node[k] = i < last ? node_of[row0 + i] : -1;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = i0 + lane + k * kThreads;
      const int j = (node[k] >> 1) - t.c0;
      bool keep = node[k] >= 0 && !(node[k] & 1) && j >= 0 && j < t.nt;
      if (keep) keep = g[row0 + i] != 0.0f || h[row0 + i] != 0.0f;  // weight zero adds nothing
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) queue[queued + __popc(ballot & below)] = i;
      queued += __popc(ballot);
    }
    __syncwarp();
    while (queued >= 32) {
      add_row<ES>(sums, t, packed, W, g, h, node_of, row0, queue[lane], scale);
      int rest[kRows];  // the rows left over move to the front of the queue
#pragma unroll
      for (int m = 0; m < kRows; ++m) rest[m] = 32 * (m + 1) + lane < queued ? queue[32 * (m + 1) + lane] : 0;
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        if (32 * (m + 1) + lane < queued) queue[32 * m + lane] = rest[m];
      __syncwarp();
      queued -= 32;
    }
  }
  if (lane < queued) add_row<ES>(sums, t, packed, W, g, h, node_of, row0, queue[lane], scale);
  cluster.sync();  // every copy of the tile is complete

  // the reduction: block r takes its share of the tile's (node, feature)
  // pairs; a thread a cell, adjacent threads adjacent bins; it adds the C
  // copies of each cell in rank order and writes the cell once
  const unsigned* copies[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k)
    copies[k] = k == rank ? words : cluster.map_shared_rank(words, k < C ? k : 0);
  const int pairs = NT * FT;
  const int64_t FB = static_cast<int64_t>(F) * B;
  const int c_last = pairs * (rank + 1) / C * B;
  for (int c = pairs * rank / C * B + threadIdx.x; c < c_last; c += 2 * kThreads) {
    unsigned long long sg[2] = {0ull, 0ull}, sh[2] = {0ull, 0ull};
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < C) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (c + u * kThreads < c_last) {
            unsigned long long vg, vh;
            Sums::read(copies[k], c + u * kThreads, vg, vh);
            sg[u] += vg;
            sh[u] += vh;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int cell = c + u * kThreads;
      const int p = cell / B, jl = p / FT, fl = p - jl * FT, b = cell - p * B;
      if (cell >= c_last || jl >= t.nt || fl >= t.ft) continue;
      const int64_t o = (static_cast<int64_t>(s) * 2 * half + t.c0 + jl) * FB + static_cast<int64_t>(t.f0 + fl) * B + b;
      out[o] = static_cast<long long>(sg[u]);
      out[o + half * FB] = static_cast<long long>(sh[u]);
    }
  }
  cluster.sync();  // no block leaves while another still reads its copy
}

using KernelFn = void (*)(const uint8_t*, const float*, const float*, const int32_t*, const int32_t*, long long*,
                          int, int, int, int, int, int, int);

// cudaErrorInvalidValue unless the shapes and the plan are ones the kernel
// takes (``threads`` kThreads, ``smem`` kSmemMax, a tile of at most kStride -
// 1 cells); then the launch configuration (tiles x C blocks by S, clusters of
// C) after raising the kernel's limit on dynamic shared memory.
cudaError_t configure(int S, int n, int W, int es, int F, int B, int half, int C, int NT, int FT, int threads,
                      int smem, cudaStream_t stream, KernelFn* kernel, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (S < 1 || S > 65535 || n < 1 || n > 0x7fffffff - kRows * kThreads || F < 1 || B < 1 || half < 1)
    return cudaErrorInvalidValue;
  if ((es != 1 && es != 2) || W % 16 != 0 || W < F * es || B > (es == 1 ? 255 : 65535)) return cudaErrorInvalidValue;
  if ((C != 1 && C != 2 && C != 4 && C != kMaxCluster) || NT < 1 || NT > half || FT < 1 || FT > F)
    return cudaErrorInvalidValue;
  if (threads != kThreads || smem != kSmemMax || static_cast<int64_t>(NT) * FT * B >= kStride)
    return cudaErrorInvalidValue;
  const int64_t blocks = cdiv(half, NT) * cdiv(F, FT) * C;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  *kernel = es == 1 ? gbt_hist_kernel<1> : gbt_hist_kernel<2>;
  static bool attribute_set[2] = {false, false};
  if (!attribute_set[es - 1]) {
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(*kernel),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attribute_set[es - 1] = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned int>(blocks), S);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The most cells a tile may have (kStride - 1, one word of each array being
// the spare), for hist_plan to check its layout against.
extern "C" int gbt_hist_max_cells() { return kStride - 1; }

// Launches one level's histograms on ``stream`` with the plan of hist_plan:
// clusters of C blocks of ``threads`` threads, tiles of NT left children x
// FT features, ``smem`` bytes of shared memory a block.  ``packed`` is
// pack_bins' (n, W) byte rows, ``es`` bytes per bin.  Returns the
// cudaError_t of the checks, the attribute call or the launch (0 on success).
extern "C" int gbt_hist_launch(const uint8_t* packed, const float* g, const float* h, const int32_t* node_of,
                               const int32_t* shift, long long* out, int S, int n, int W, int es, int F, int B,
                               int half, int C, int NT, int FT, int threads, int smem, cudaStream_t stream) {
  KernelFn kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(S, n, W, es, F, B, half, C, NT, FT, threads, smem, stream, &kernel, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, packed, g, h, node_of, shift, out, n, W, F, B, half, NT, FT);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C blocks of ``threads`` threads and ``smem`` bytes
// the card holds at once (cudaOccupancyMaxActiveClusters), into ``*active``;
// returns the cudaError_t.
extern "C" int gbt_hist_max_active_clusters(int C, int threads, int smem, int* active) {
  KernelFn kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  // a shape that any plan's cluster size, threads and bytes take
  const cudaError_t err = configure(1, 1, 16, 1, 1, 1, 1, C, 1, 1, threads, smem, nullptr, &kernel, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(active, reinterpret_cast<const void*>(kernel), &cfg));
}
