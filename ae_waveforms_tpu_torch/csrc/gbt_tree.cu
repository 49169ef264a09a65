// GBT fit's per-tree work, for Hopper (sm_90a): for S fits at once, what a
// tree needs before its first level (K5, gbt_grad_kernel) and after its last
// (K6, gbt_leaves_kernel), one launch each.
//
// Replaces no TPU kernel: the JAX package leaves both steps to XLA, and the
// port ran them as about 370 small torch ops a tree (``tree_grad_reference``
// and ``tree_leaves_reference`` in ops/gbt_tree.py, the kernels' oracles).
//
// K5, for every fit s and row i of tree t:
//     row draw      u = lowbias32((key(seed, ROW, t) + i) mod 2^32), kept where
//                   (u >> 8) * 2^-24 < subsample (or the injected row mask)
//     column draw   the same on the COL stream over the F columns, and
//                   column 0 where no column is kept
//     g, h          w = row_weight * kept (float32), p = 1 / (1 + exp(-margin))
//                   in float64, g = float((p - y) * w),
//                   h = float(max(p * (1 - p), 1e-16) * w)
//     shift         62 - bitlen(n - 1) - e, with max |g|, |h| of the fit below
//                   2^e (frexp; e = 0 for a maximum of 0)
//     node ids      0
// One block a fit walks its rows; the block's max of |g| and |h| gives the
// fit's shift, so nothing waits on the host or another block.
//
// K6, for every fit s of tree t, from the last level's leaf sums (GL and HL
// of each node's left child, G and H of the node):
//     leaves        a left child's G, H are GL, HL, a right child's G - GL,
//                   H - HL, each int64 -> double times 2^-shift;
//                   w = float(-G / (H + lam)) * (t < n_active), written to the
//                   ensemble's leaf tensor at tree t
//     margins       margin += lr * w[node] for every row, in float32
// A thread a row (and a leaf): each row recomputes its leaf's weight from the
// four sums, the same operations as the thread that writes the leaf.
//
// What bounds them on the H100: bytes.  K5 reads a fit's row's margin and
// weight and writes its g, h and node id, 20 bytes (y read once a row); K6
// reads a node id and reads and writes a margin, 12 bytes a fit's row.  At
// the fit's sizes that is 1 to 7 microseconds of traffic, and a launch takes
// a few microseconds more than that on the card (chip_smoke.py phase 15),
// less than the host's call costs; their point is to be one launch each in
// place of hundreds of small torch ops.
//
// Exactness: every float64 and float32 operation is the one torch's
// separate ops perform, in the same order, each rounded once (__dmul_rn,
// __dadd_rn, __dsub_rn, __ddiv_rn, __fmul_rn, __fadd_rn: no multiply-add is
// contracted), exp is the device library's as in torch's sigmoid, and the
// hash works in 64-bit integers as the plain version's does, so the outputs
// are bit-identical to the plain version on the card and on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGradThreads = 1024;
constexpr int kLeafThreads = 256;
constexpr unsigned long long kM32 = 0xffffffffull;
constexpr unsigned long long kRowStream = 0x52F1, kColStream = 0xC07A;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double pow2(int k) {  // 2^k, exact for k in [-1022, 1023]
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

// lowbias32 (C. Wellons) on a uint32 value held in 64 bits, as _hash32 does it
__device__ __forceinline__ unsigned long long hash32(unsigned long long x) {
  x ^= x >> 16;
  x = (x * 0x21F0AAADull) & kM32;
  x ^= x >> 15;
  x = (x * 0x735A2D97ull) & kM32;
  return x ^ (x >> 15);
}

__device__ __forceinline__ unsigned long long tree_key(long long seed, unsigned long long stream, long long tree) {
  const unsigned long long s = static_cast<unsigned long long>(seed) & kM32;
  return hash32(hash32(s ^ stream) ^ (static_cast<unsigned long long>(tree) & kM32));
}

// uniform in [0, 1): (u >> 8) * 2^-24, exact in float32
__device__ __forceinline__ float uniform(unsigned long long key, long long i) {
  const unsigned long long u = hash32((key + static_cast<unsigned long long>(i)) & kM32);
  return __fmul_rn(static_cast<float>(u >> 8), 0x1p-24f);
}

// the larger, and NaN over anything, as torch's amax and maximum
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || b != b) ? b : a; }

__global__ void __launch_bounds__(kGradThreads)
gbt_grad_kernel(const float* __restrict__ margin,      // (S, n)
                const float* __restrict__ y,           // (n,)
                const float* __restrict__ row_weight,  // (S, n)
                const long long* __restrict__ seed,    // (S,)
                const float* __restrict__ subsample,   // (S,)
                const float* __restrict__ colsample,   // (S,)
                const uint8_t* __restrict__ row_mask,  // (S, >= n) bool at row stride ld_row_mask, or null
                long long ld_row_mask,
                const uint8_t* __restrict__ col_mask,  // (S, >= F) bool at row stride ld_col_mask, or null
                long long ld_col_mask,
                float* __restrict__ g, float* __restrict__ h,  // (S, n)
                int32_t* __restrict__ node_of,                 // (S, n)
                uint8_t* __restrict__ col,                     // (S, F) bool
                int32_t* __restrict__ shift,                   // (S,)
                int n, int F, long long tree, int shift_base) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // the tree's columns; column 0 where the draw kept none
  const unsigned long long col_key = tree_key(seed[s], kColStream, tree);
  const float col_rate = colsample[s];
  int kept = 0;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const bool keep = col_mask != nullptr ? col_mask[s * ld_col_mask + f] != 0 : uniform(col_key, f) < col_rate;
    col[static_cast<int64_t>(s) * F + f] = keep;
    kept |= keep;
  }
  if (!__syncthreads_or(kept) && threadIdx.x == 0) col[static_cast<int64_t>(s) * F] = 1;

  // the rows: kept or not, g, h and a fresh node id
  const unsigned long long row_key = tree_key(seed[s], kRowStream, tree);
  const float row_rate = subsample[s];
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t r = static_cast<int64_t>(s) * n + i;
    const bool keep = row_mask != nullptr ? row_mask[s * ld_row_mask + i] != 0 : uniform(row_key, i) < row_rate;
    const double w = static_cast<double>(__fmul_rn(row_weight[r], keep ? 1.0f : 0.0f));
    const double p = __ddiv_rn(1.0, __dadd_rn(1.0, exp(-static_cast<double>(margin[r]))));
    const float gv = __double2float_rn(__dmul_rn(__dsub_rn(p, static_cast<double>(y[i])), w));
    double q = __dmul_rn(p, __dsub_rn(1.0, p));
    q = q < 1e-16 ? 1e-16 : q;  // clamp_min: NaN stays NaN
    const float hv = __double2float_rn(__dmul_rn(q, w));
    g[r] = gv;
    h[r] = hv;
    node_of[r] = 0;
    m = nan_max(nan_max(m, fabsf(gv)), fabsf(hv));
  }

  // the fit's largest |g| or |h|, and its shift
  __shared__ float warp_m[kGradThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < blockDim.x / 32; ++w) m = nan_max(m, warp_m[w]);
    int e = 0;
    frexpf(m, &e);
    shift[s] = n > 0 ? shift_base - e : 0;
  }
}

// leaf k's weight from its parent's four sums (GL, HL, G, H)
__device__ __forceinline__ float leaf_weight(const long long* __restrict__ sums, int k, double scale, double lam,
                                             float active) {
  const long long* o = sums + static_cast<int64_t>(k >> 1) * 4;
  const long long gq = (k & 1) ? o[2] - o[0] : o[0];
  const long long hq = (k & 1) ? o[3] - o[1] : o[1];
  const double G = __dmul_rn(__ll2double_rn(gq), scale), H = __dmul_rn(__ll2double_rn(hq), scale);
  return __fmul_rn(__double2float_rn(__ddiv_rn(-G, __dadd_rn(H, lam))), active);
}

__global__ void __launch_bounds__(kLeafThreads)
gbt_leaves_kernel(const long long* __restrict__ leaf_sums,  // (S, leaves / 2, 4)
                  const int32_t* __restrict__ shift,        // (S,)
                  const float* __restrict__ lr,             // (S,)
                  const long long* __restrict__ n_active,   // (S,)
                  const int32_t* __restrict__ node_of,      // (S, n), each in [0, leaves)
                  float* __restrict__ margin,               // (S, n), updated in place
                  float* __restrict__ leaf,                 // (S, >= leaves) at row stride ld_leaf
                  long long ld_leaf, int n, int leaves, long long tree, double lam) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long* sums = leaf_sums + static_cast<int64_t>(s) * (leaves / 2) * 4;
  const double scale = pow2(-shift[s]);
  const float active = tree < n_active[s] ? 1.0f : 0.0f;
  if (i < leaves) leaf[s * ld_leaf + i] = leaf_weight(sums, i, scale, lam, active);
  if (i < n) {
    const int64_t r = static_cast<int64_t>(s) * n + i;
    const float w = leaf_weight(sums, node_of[r], scale, lam, active);
    margin[r] = __fadd_rn(margin[r], __fmul_rn(lr[s], w));
  }
}

}  // namespace

// Launches K5 for S fits of n rows and F columns at tree ``tree`` on
// ``stream``: a block of 1,024 threads a fit.  ``row_mask`` and ``col_mask``
// may each be null (drawn from the hash).  ``shift_base`` is 62 - bitlen(n - 1).
// Returns the cudaError_t of the checks or the launch (0 on success).
extern "C" int gbt_grad_launch(const float* margin, const float* y, const float* row_weight, const long long* seed,
                               const float* subsample, const float* colsample, const uint8_t* row_mask,
                               long long ld_row_mask, const uint8_t* col_mask, long long ld_col_mask, float* g,
                               float* h, int32_t* node_of, uint8_t* col, int32_t* shift, int S, int n, int F,
                               long long tree, int shift_base, cudaStream_t stream) {
  if (S < 1 || n < 0 || F < 1 || tree < 0) return static_cast<int>(cudaErrorInvalidValue);
  gbt_grad_kernel<<<S, kGradThreads, 0, stream>>>(margin, y, row_weight, seed, subsample, colsample, row_mask,
                                                  ld_row_mask, col_mask, ld_col_mask, g, h, node_of, col, shift, n, F,
                                                  tree, shift_base);
  return static_cast<int>(cudaGetLastError());
}

// Launches K6 for S fits of n rows and ``leaves`` leaves a tree (a power of
// two, at least 2) at tree ``tree`` on ``stream``: a thread a row and a leaf,
// 256 a block.  Returns the cudaError_t of the checks or the launch.
extern "C" int gbt_leaves_launch(const long long* leaf_sums, const int32_t* shift, const float* lr,
                                 const long long* n_active, const int32_t* node_of, float* margin, float* leaf,
                                 long long ld_leaf, int S, int n, int leaves, long long tree, double lam,
                                 cudaStream_t stream) {
  if (S < 1 || S > 65535 || n < 0 || leaves < 2 || (leaves & (leaves - 1)) != 0 || tree < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = n > leaves ? n : leaves;
  const dim3 grid((items + kLeafThreads - 1) / kLeafThreads, S);
  gbt_leaves_kernel<<<grid, kLeafThreads, 0, stream>>>(leaf_sums, shift, lr, n_active, node_of, margin, leaf, ld_leaf,
                                                       n, leaves, tree, lam);
  return static_cast<int>(cudaGetLastError());
}
