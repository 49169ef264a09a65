// GBT row routing over a range of tree levels, for Hopper (sm_90a).
//
// Replaces: ae_waveforms_tpu/ops/gbt_route_pallas.py, route_rows and its
// Pallas kernel _route_kernel (the pallas_call of _route_batched).  For S
// fits (or S trees) at once, moves every row down L levels:
//     node <- 2 * node + [bins[f, i] > t]  where the node splits on feature f at bin t
//     node <- 2 * node                     where it does not
// An exact integer decision.  Level l has width * 2^l nodes; its splits are
// columns [width * (2^l - 1), width * (2^(l+1) - 1)) of the tables, so the
// levels [d0, d1) of a tree heap (level d at [2^d - 1, 2^(d+1) - 1)) are the
// tables from column 2^d0 - 1 on with width 2^d0, and one level of any width
// is L = 1.  A node id outside [0, level width) takes the left spine.
//
// What bounds it on the H100: device memory by the byte count (the node
// ids in, none from the root, and out, the pool of bins and the split
// tables, each once: one compare per (fit, row, level)).  In practice the
// latency of dependent loads and the instructions a row costs, at the
// small launches of prediction most of all; tools/route_profile.py
// measures each part.
//
// Design (the plan comes from route_plan in ops/gbt_route.py):
// - A block owns a chunk of fits (blockIdx.y) and a tile of rows
//   (blockIdx.x).  Staged (kStaged), it first loads the node ids of its
//   threads' first tasks, then, while those loads are in flight, stages in
//   shared memory the chunk's split tables, one 8-byte pair a node (the
//   threshold and the feature), and the tile's bins, read with coalesced
//   loads along whichever of the pool's two strides is the smaller.  No row
//   then waits on a chain of global loads: the levels cost two shared-memory
//   reads each.  In place (one level whose table has more splits than the
//   tile has rows, or a small launch), a row reads its node's split flag,
//   feature and threshold, then its bin, from global memory.
// - A task is kVec node ids of one fit: a 16-byte vector load and store
//   (kVec = 4) for large launches where n is a multiple of 4, else one id,
//   so a smaller launch spreads its rows over more threads, each with a
//   short chain of loads.  A thread holds kUnroll tasks at once and walks their
//   rows through all the levels in registers without a branch.  Tiles and
//   the staging's strides are powers of two, so no index needs a division.
// - One pair marks both a node that does not split and a feature outside
//   [0, F): feature 0 at threshold kNever, which no int32 bin exceeds.  So
//   every decision is the integer compare bin > threshold, exact for any
//   int32 bins and thresholds, staged or in place.
// - Nothing is read out of bounds whatever the node ids: an id is looked up
//   only inside its level's width.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 2;  // tasks a thread holds at once
constexpr int kStage = 4;   // splits and bins a thread stages in one round
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // so at most 64 registers a thread; BLOCKS_PER_SM in ops/gbt_route.py
constexpr int32_t kNever = 0x7fffffff;  // a threshold no bin exceeds
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100; SMEM_BYTES in ops/gbt_route.py
constexpr int kMaxDevices = 64;  // devices a process may launch on

struct Args {
  const int32_t* bins;  // (F, n) at strides bins_sf, bins_si
  int bins_sf, bins_si;
  const int32_t* node_in;  // (S, n), or null: every row starts at node 0
  const int32_t* feat;     // (S, >= nodes) from the first level's first node, row stride feat_ld
  const int32_t* thresh;
  const uint8_t* split;
  int feat_ld, thresh_ld, split_ld;
  int32_t* node_out;  // (S, n)
  int S, n, F, width, levels, nodes, chunk;
  int tile_shift;  // a block's tile is 1 << tile_shift rows
  int node_shift;  // 1 << node_shift >= nodes: a fit's staging slots
  int feat_shift;  // 1 << feat_shift >= F
};

// The tile's bins lie feature by feature (1 << tile_shift words each), and
// within a feature row r at (r % 4) * (tile / 4) + r / 4, so the lanes of a
// warp, which take consecutive groups of 4 rows, read consecutive words.
__device__ __forceinline__ int bin_at(const Args& a, int f, int r) {
  return (f << a.tile_shift) + (r & 3) * (1 << (a.tile_shift - 2)) + (r >> 2);
}

// Task ``task`` of the block: its fit s and first row r in the block, and
// whether it holds rows of the block's work.
template <int kVec>
__device__ __forceinline__ bool decode(const Args& a, int task, int tasks, int rows, int& s, int& r) {
  const int vshift = a.tile_shift - (kVec == 4 ? 2 : 0);
  s = task >> vshift;
  r = (task & ((1 << vshift) - 1)) * kVec;
  return task < tasks && r < rows;
}

template <int kVec>
__device__ __forceinline__ void load(const Args& a, int task, int tasks, int s0, int i0, int rows,
                                     int32_t (&node)[kVec]) {
  int s, r;
#pragma unroll
  for (int k = 0; k < kVec; ++k) node[k] = 0;
  if (a.node_in == nullptr || !decode<kVec>(a, task, tasks, rows, s, r)) return;
  const int32_t* p = a.node_in + static_cast<long long>(s0 + s) * a.n + (i0 + r);
  if constexpr (kVec == 4) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    node[0] = v.x, node[1] = v.y, node[2] = v.z, node[3] = v.w;
  } else {
    node[0] = __ldcs(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store(const Args& a, int task, int tasks, int s0, int i0, int rows,
                                      const int32_t (&node)[kVec]) {
  int s, r;
  if (!decode<kVec>(a, task, tasks, rows, s, r)) return;
  int32_t* p = a.node_out + static_cast<long long>(s0 + s) * a.n + (i0 + r);
  if constexpr (kVec == 4) {
    __stcs(reinterpret_cast<int4*>(p), make_int4(node[0], node[1], node[2], node[3]));
  } else {
    __stcs(p, node[0]);
  }
}

// Every row of the thread's live tasks down every level, level by level and
// without a branch within a task, so the rows' shared-memory reads overlap.
// An id outside its level reads its fit's first word and keeps its decision
// at 0.
template <int kVec>
__device__ __forceinline__ void walk(const Args& a, int task0, int tasks, int rows, int32_t (&node)[kUnroll][kVec],
                                     const int2* splits, const int32_t* bins) {
  int base[kUnroll], row[kUnroll];
  bool live[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    live[u] = decode<kVec>(a, task0 + u * blockDim.x, tasks, rows, base[u], row[u]);
    base[u] *= a.nodes;
  }
  const int2* level = splits;
  uint32_t width = a.width;
  for (int l = 0; l < a.levels; ++l) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int32_t id = node[u][k];
        const bool in = static_cast<uint32_t>(id) < width;
        const int2 w = level[base[u] + (in ? id : 0)];  // (threshold, feature)
        const int32_t bin = bins[bin_at(a, w.y, row[u] + k)];
        node[u][k] = static_cast<int32_t>(2u * static_cast<uint32_t>(id) + (in && bin > w.x));
      }
    }
    level += width;
    width *= 2;
  }
}

// The same walk without staging, for launches whose tables and tile would
// cost more to stage than the rows read: each row reads its node's split
// flag, feature and threshold, then its bin, from global memory.
template <int kVec>
__device__ __forceinline__ void walk_direct(const Args& a, int task0, int tasks, int s0, int i0, int rows,
                                            int32_t (&node)[kUnroll][kVec]) {
  int fit[kUnroll], row[kUnroll];
  bool live[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) live[u] = decode<kVec>(a, task0 + u * blockDim.x, tasks, rows, fit[u], row[u]);
  int off = 0;
  uint32_t width = a.width;
  for (int l = 0; l < a.levels; ++l) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const long long s = s0 + fit[u];
      const int32_t* fr = a.feat + s * a.feat_ld + off;
      const int32_t* tr = a.thresh + s * a.thresh_ld + off;
      const uint8_t* pr = a.split + s * a.split_ld + off;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int32_t id = node[u][k];
        const bool in = static_cast<uint32_t>(id) < width;
        const int c = in ? id : 0;
        const int32_t f = __ldg(fr + c), t = __ldg(tr + c);
        const bool ok = in && __ldg(pr + c) != 0 && f >= 0 && f < a.F;
        const int r = row[u] + k;
        const int32_t bin = __ldg(a.bins + static_cast<long long>(ok ? f : 0) * a.bins_sf +
                                  static_cast<long long>(i0 + r) * a.bins_si);
        const bool go = ok && bin > t;
        node[u][k] = static_cast<int32_t>(2u * static_cast<uint32_t>(id) + go);
      }
    }
    off += width;
    width *= 2;
  }
}

template <int kVec, bool kStaged>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) gbt_route_kernel(const Args a) {
  extern __shared__ int4 smem[];
  int2* splits = reinterpret_cast<int2*>(smem);                            // [chunk][nodes]
  int32_t* bins = reinterpret_cast<int32_t*>(splits + a.chunk * a.nodes);  // [F][tile], bin_at's order
  const int s0 = blockIdx.y * a.chunk;
  const int i0 = blockIdx.x << a.tile_shift;
  const int fits = min(a.chunk, a.S - s0);
  const int rows = min(1 << a.tile_shift, a.n - i0);
  const int tasks = fits << (a.tile_shift - (kVec == 4 ? 2 : 0));

  // the node ids of this thread's first tasks, in flight during the staging
  int task = threadIdx.x;
  int32_t node[kUnroll][kVec];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) load<kVec>(a, task + u * blockDim.x, tasks, s0, i0, rows, node[u]);

  // the chunk's splits and the tile's bins: a fit's splits at slots of
  // 1 << node_shift, the bins along the pool's smaller stride
  const int table = kStaged ? fits << a.node_shift : 0;
  const bool rows_inner = a.bins_si <= a.bins_sf;
  const int inner = rows_inner ? a.tile_shift : a.feat_shift;
  const int cells = kStaged ? (rows_inner ? a.F : rows) << inner : 0;
  for (int e0 = threadIdx.x; e0 < max(table, cells); e0 += kStage * blockDim.x) {
    int32_t f[kStage], t[kStage], v[kStage];
    uint8_t sp[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * blockDim.x;
      const int s = e >> a.node_shift, k = e & ((1 << a.node_shift) - 1);
      if (e < table && k < a.nodes) {
        f[u] = __ldg(a.feat + static_cast<long long>(s0 + s) * a.feat_ld + k);
        t[u] = __ldg(a.thresh + static_cast<long long>(s0 + s) * a.thresh_ld + k);
        sp[u] = __ldg(a.split + static_cast<long long>(s0 + s) * a.split_ld + k);
      }
      const int hi = e >> inner, lo = e & ((1 << inner) - 1);
      const int ff = rows_inner ? hi : lo, r = rows_inner ? lo : hi;
      if (e < cells && ff < a.F && r < rows)
        v[u] = __ldg(a.bins + static_cast<long long>(ff) * a.bins_sf + static_cast<long long>(i0 + r) * a.bins_si);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * blockDim.x;
      const int s = e >> a.node_shift, k = e & ((1 << a.node_shift) - 1);
      if (e < table && k < a.nodes)
        splits[s * a.nodes + k] = sp[u] != 0 && f[u] >= 0 && f[u] < a.F ? make_int2(t[u], f[u]) : make_int2(kNever, 0);
      const int hi = e >> inner, lo = e & ((1 << inner) - 1);
      const int ff = rows_inner ? hi : lo, r = rows_inner ? lo : hi;
      if (e < cells && ff < a.F && r < rows)
        bins[bin_at(a, ff, r)] = v[u];
    }
  }
  if constexpr (kStaged) __syncthreads();

  for (;;) {
    if constexpr (kStaged)
      walk<kVec>(a, task, tasks, rows, node, splits, bins);
    else
      walk_direct<kVec>(a, task, tasks, s0, i0, rows, node);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) store<kVec>(a, task + u * blockDim.x, tasks, s0, i0, rows, node[u]);
    task += kUnroll * blockDim.x;
    if (task >= tasks) break;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<kVec>(a, task + u * blockDim.x, tasks, s0, i0, rows, node[u]);
  }
}

int log2_ceil(long long x) {
  int k = 0;
  while ((1LL << k) < x) ++k;
  return k;
}

}  // namespace

// Routes rows down ``levels`` levels on ``stream`` with the plan of
// route_plan: ``blocks`` blocks of ``threads`` threads, each a chunk of
// ``chunk`` fits by a tile of ``tile`` rows (a power of two, at least 4) in
// tasks of ``vec`` node ids (1, or 4 where n is a multiple of 4 and the id
// arrays are 16-byte aligned), staging its tables and bins in ``smem`` bytes
// of shared memory where ``staged`` (else none).  Returns the cudaError_t of
// the checks, the attribute calls or the launch (0 on success).
extern "C" int gbt_route_launch(const int32_t* bins, int bins_sf, int bins_si, const int32_t* node_in,
                                const int32_t* feat, const int32_t* thresh, const uint8_t* split, int feat_ld,
                                int thresh_ld, int split_ld, int32_t* node_out, int S, int n, int F, int width,
                                int levels, int chunk, int tile, int vec, int staged, int blocks, int threads,
                                int smem, cudaStream_t stream) {
  const long long nodes = static_cast<long long>(width) * ((1LL << (levels < 1 || levels > 30 ? 1 : levels)) - 1);
  const long long tiles = tile > 0 ? (n + tile - 1LL) / tile : 0, chunks = chunk > 0 ? (S + chunk - 1LL) / chunk : 0;
  const bool aligned = reinterpret_cast<uintptr_t>(node_in) % 16 == 0 && reinterpret_cast<uintptr_t>(node_out) % 16 == 0;
  if (S < 1 || n < 1 || F < 1 || width < 1 || levels < 1 || levels > 30 || nodes > (1LL << 30) ||
      chunk < 1 || tile < 4 || (tile & (tile - 1)) != 0 || !(vec == 1 || (vec == 4 && n % 4 == 0 && aligned)) ||
      threads < 32 || threads > kThreads || threads % 32 != 0 || chunks > 65535 || blocks != chunks * tiles ||
      smem != (staged ? 8 * chunk * nodes + 4LL * F * tile : 0) || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{bins, bins_sf, bins_si, node_in, feat, thresh, split, feat_ld, thresh_ld, split_ld, node_out,
               S, n, F, width, levels, static_cast<int>(nodes), chunk, log2_ceil(tile), log2_ceil(nodes),
               log2_ceil(F)};
  const auto kernel = vec == 4 ? (staged ? gbt_route_kernel<4, true> : gbt_route_kernel<4, false>)
                               : (staged ? gbt_route_kernel<1, true> : gbt_route_kernel<1, false>);
  if (staged) {
    // the plan holds kBlocksPerSm blocks an SM in shared memory: ask for the
    // largest carveout, so that the one chosen at launch holds no fewer, and
    // allow a block all of it; a function's attributes belong to a device:
    // set them once on each, for each staged variant
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    static bool attribute_set[kMaxDevices][2] = {};
    bool& set = attribute_set[device][vec == 4];
    if (!set) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      set = true;
    }
  }
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks)), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
