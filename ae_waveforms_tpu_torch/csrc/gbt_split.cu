// GBT split epilogue of one tree level, for Hopper (sm_90a): for S fits at
// once, every node's histograms, best split, heap slots and leaf sums in one
// launch.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA, and the
// port ran it as about 120 float64 and int64 torch ops a level on full
// (S, nodes, F, B) tensors (``split_level_reference`` in ops/gbt_split.py,
// the kernel's oracle).  For each fit s and node k of the level:
//     node histograms   left child (k even): K1's sums; right child (k odd):
//                       the parent's minus the left sibling's (exact int64)
//     prefix sums       GL, HL over the bins of each feature, exact int64;
//                       GR = G - GL and HR = H - HL with G, H the feature's totals
//     gain              0.5 * ((GL^2 / (HL + lam) + GR^2 / (HR + lam)) - G^2 / (H + lam)) - gamma
//                       in float64, each sum int64 -> double (nearest) times 2^-shift
//     feasible          HL >= mcw, HR >= mcw, the column kept, the bin not the last
//     best              the first f * B + b of the largest feasible gain (0 where none is)
//     do_split          best gain > 0 and depth < the fit's depth limit
// It writes the level's heap slots (feature, bin and flag, zero where the
// node does not split), which the routing kernel reads in place, and either
// the level's node histograms, which the next level's right children are
// taken from, or, at the last level, the four int64 sums the leaves need:
// GL and HL at best where the node splits (at the feature's last bin where
// it does not) and G and H of that feature.
//
// What bounds it on the H100: device memory by the byte count (K1's sums and
// the parent's read once, 16 bytes a cell, and the node histograms written
// once); the float64 divisions come second.  Design: one block a (fit,
// node), so any number of fits or nodes only adds blocks.  Each warp takes
// whole features: a first walk over the feature's bins sums its totals (and
// writes the node histograms), a second scans them 32 bins at a time with
// int64 shuffles and a carry, and evaluates each bin's gain in registers;
// nothing between K1's sums and the outputs goes to device memory.  The
// argmax is a warp and then a block reduction on (gain, index) that keeps
// the smaller index of equal gains.
//
// Exactness: every operation is the one torch's separate ops perform, in
// the same order, each rounded once (__dmul_rn, __dadd_rn, __dsub_rn,
// __ddiv_rn: no multiply-add is contracted), so the outputs are
// bit-identical to the plain version on the card and on the CPU.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double pow2(int k) {  // 2^k, exact for k in [-1022, 1023]
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The larger gain wins; of equal gains the smaller index, as torch's argmax.
__device__ __forceinline__ void argmax_step(double& v, int& i, double ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(double& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) argmax_step(v, i, __shfl_down_sync(kFull, v, o), __shfl_down_sync(kFull, i, o));
}

// One node's G and H rows: its own sums from K1 (a left child) or the
// parent's minus them (a right child).
struct Rows {
  const long long* qg;
  const long long* qh;
  const long long* pg;  // null for a left child
  const long long* ph;
  __device__ __forceinline__ void at(int64_t c, long long& g, long long& h) const {
    g = qg[c];
    h = qh[c];
    if (pg != nullptr) {
      g = pg[c] - g;
      h = ph[c] - h;
    }
  }
};

__global__ void __launch_bounds__(kMaxWarps * 32)
gbt_split_kernel(const long long* __restrict__ q,       // (S, 2 * half, F * B): K1's G rows, then its H rows
                 const long long* __restrict__ parent,  // (S, 2 * half, F * B): the last level's, or null at depth 0
                 const int32_t* __restrict__ shift,     // (S,)
                 const float* __restrict__ gamma,       // (S,)
                 const float* __restrict__ mcw,         // (S,) min_child_weight
                 const uint8_t* __restrict__ col,       // (S, F) bool
                 const long long* __restrict__ depth_limit,  // (S,)
                 int32_t* __restrict__ heap_feat,       // (S, >= nodes) at row stride ld_feat, from the level's slot
                 int32_t* __restrict__ heap_thresh,
                 uint8_t* __restrict__ heap_split,
                 long long ld_feat, long long ld_thresh, long long ld_split,
                 long long* __restrict__ leaf_out,      // (S, nodes, 4), or null
                 long long* __restrict__ hist_out,      // (S, 2 * nodes, F * B), or null
                 int nodes, int F, int B, int depth, double lam) {
  const int k = blockIdx.x, s = blockIdx.y;
  const int half = nodes > 1 ? nodes / 2 : 1;
  const int64_t FB = static_cast<int64_t>(F) * B;
  const int64_t row = (static_cast<int64_t>(s) * 2 * half + (k >> 1)) * FB;
  Rows rows{q + row, q + row + half * FB, nullptr, nullptr};
  if (k & 1) {
    rows.pg = parent + row;
    rows.ph = parent + row + half * FB;
  }
  long long* out_g = hist_out == nullptr ? nullptr : hist_out + (static_cast<int64_t>(s) * 2 * nodes + k) * FB;
  long long* out_h = out_g == nullptr ? nullptr : out_g + nodes * FB;

  const double scale = pow2(-shift[s]);
  const double gam = static_cast<double>(gamma[s]);
  const double min_weight = static_cast<double>(mcw[s]);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  double best_v = -CUDART_INF;
  int best_i = 0x7fffffff;
  for (int f = warp; f < F; f += warps) {
    const int64_t base = static_cast<int64_t>(f) * B;
    // the feature's totals, and the node's histograms for the next level
    long long tg = 0, th = 0;
    for (int b = lane; b < B; b += 32) {
      long long g, h;
      rows.at(base + b, g, h);
      tg += g;
      th += h;
      if (out_g != nullptr) {
        out_g[base + b] = g;
        out_h[base + b] = h;
      }
    }
    tg = warp_sum(tg);
    th = warp_sum(th);
    const bool col_ok = col[static_cast<int64_t>(s) * F + f] != 0;
    const double G = __dmul_rn(__ll2double_rn(tg), scale), H = __dmul_rn(__ll2double_rn(th), scale);
    const double whole = __ddiv_rn(__dmul_rn(G, G), __dadd_rn(H, lam));
    // prefix sums 32 bins at a time, and each bin's gain
    long long carry_g = 0, carry_h = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      long long g = 0, h = 0;
      if (b < B) rows.at(base + b, g, h);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long ug = __shfl_up_sync(kFull, g, o), uh = __shfl_up_sync(kFull, h, o);
        if (lane >= o) {
          g += ug;
          h += uh;
        }
      }
      const long long lg = carry_g + g, lh = carry_h + h;
      carry_g = __shfl_sync(kFull, lg, 31);
      carry_h = __shfl_sync(kFull, lh, 31);
      if (b < B) {
        const double GL = __dmul_rn(__ll2double_rn(lg), scale), HL = __dmul_rn(__ll2double_rn(lh), scale);
        const double GR = __dmul_rn(__ll2double_rn(tg - lg), scale), HR = __dmul_rn(__ll2double_rn(th - lh), scale);
        const double left = __ddiv_rn(__dmul_rn(GL, GL), __dadd_rn(HL, lam));
        const double right = __ddiv_rn(__dmul_rn(GR, GR), __dadd_rn(HR, lam));
        const double gain = __dsub_rn(__dmul_rn(0.5, __dsub_rn(__dadd_rn(left, right), whole)), gam);
        const bool feasible = HL >= min_weight && HR >= min_weight && col_ok && b < B - 1;
        argmax_step(best_v, best_i, feasible ? gain : -CUDART_INF, static_cast<int>(base) + b);
      }
    }
  }

  // the block's argmax: each warp's, then the first warp's over them
  __shared__ double warp_v[kMaxWarps];
  __shared__ int warp_i[kMaxWarps];
  warp_argmax(best_v, best_i);
  if (lane == 0) {
    warp_v[warp] = best_v;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (warp != 0) return;
  best_v = lane < warps ? warp_v[lane] : -CUDART_INF;
  best_i = lane < warps ? warp_i[lane] : 0x7fffffff;
  warp_argmax(best_v, best_i);
  best_v = __shfl_sync(kFull, best_v, 0);
  best_i = __shfl_sync(kFull, best_i, 0);
  const int bf = best_i / B, bb = best_i - bf * B;
  const bool split = best_v > 0.0 && depth < depth_limit[s];
  if (leaf_out != nullptr) {
    // the sums at best (at the feature's last bin where the node does not
    // split) and over the feature
    const int64_t base = static_cast<int64_t>(bf) * B;
    const int at = split ? bb : B - 1;
    long long lg = 0, lh = 0, tg = 0, th = 0;
    for (int b = lane; b < B; b += 32) {
      long long g, h;
      rows.at(base + b, g, h);
      tg += g;
      th += h;
      if (b <= at) {
        lg += g;
        lh += h;
      }
    }
    lg = warp_sum(lg);
    lh = warp_sum(lh);
    tg = warp_sum(tg);
    th = warp_sum(th);
    if (lane == 0) {
      long long* o = leaf_out + (static_cast<int64_t>(s) * nodes + k) * 4;
      o[0] = lg;
      o[1] = lh;
      o[2] = tg;
      o[3] = th;
    }
  }
  if (lane == 0) {
    heap_feat[s * ld_feat + k] = split ? bf : 0;
    heap_thresh[s * ld_thresh + k] = split ? bb : 0;
    heap_split[s * ld_split + k] = split;
  }
}

}  // namespace

// The most warps a block may have; the launcher takes 1 to this many.
extern "C" int gbt_split_max_warps() { return kMaxWarps; }

// Launches one level's epilogue on ``stream``: a block of ``warps`` warps
// for each of the S x ``nodes`` (fit, node) pairs.  ``parent`` may be null
// only at depth 0 (nodes 1); ``leaf`` and ``hist`` may each be null.  Returns
// the cudaError_t of the checks or the launch (0 on success).
extern "C" int gbt_split_launch(const long long* q, const long long* parent, const int32_t* shift, const float* gamma,
                                const float* mcw, const uint8_t* col, const long long* depth_limit, int32_t* heap_feat,
                                int32_t* heap_thresh, uint8_t* heap_split, long long ld_feat, long long ld_thresh,
                                long long ld_split, long long* leaf, long long* hist, int S, int nodes, int F, int B,
                                int depth, double lam, int warps, cudaStream_t stream) {
  if (S < 1 || S > 65535 || nodes < 1 || (nodes & (nodes - 1)) != 0 || F < 1 || B < 1 || depth < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(F) * B > 0x7fffffff || warps < 1 || warps > kMaxWarps || (nodes > 1 && parent == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  gbt_split_kernel<<<dim3(nodes, S), warps * 32, 0, stream>>>(
      q, parent, shift, gamma, mcw, col, depth_limit, heap_feat, heap_thresh, heap_split, ld_feat, ld_thresh, ld_split,
      leaf, hist, nodes, F, B, depth, lam);
  return static_cast<int>(cudaGetLastError());
}
