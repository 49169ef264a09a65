// Fused three-layer LSTM encoder for Hopper (sm_90a): one 8-block cluster per
// tile of batch rows, the weights in the cluster's shared memory.
//
// Replaces: ae_waveforms_tpu/ops/lstm_pallas.py:109, encode_fused and its
// Pallas kernel _encoder_kernel.  Computes the LSTM-AE latent: three stacked
// LSTM cells 1 -> H1 -> H2 -> L over T steps, zero initial state, torch gate
// order (i, f, g, o) with b_ih + b_hh; the output is the last hidden state of
// layer 3, (B, L) float32.
//
// What bounds it on the H100: neither device memory nor the float32 rate.  At
// the serving shape (B = 64, T = 320, 1 -> 128 -> 64 -> 10) the inputs are 82
// KB of beats and 0.45 MB of weights, and the multiply-adds take about 0.07 ms
// of the card's float32 rate.  The recurrence is sequential: T steps of three
// dependent layers, each a small matrix-vector product per batch row.  So the
// time is the latency of a step times T.  The weights (459 KiB) exceed one
// block's 227 KB of shared memory; streamed from L2 at every step they cost
// about 13 us a step.  In this design a step (a phase, below) takes about
// 2.5 us at B = 64: the shared-memory words its dot products read, then the
// split sums and the cell update of the slowest warp, then the cluster
// barrier, whose release fence alone costs about 0.5 us
// (tools/encoder_profile.py measures each part).
//
// Design:
// - Cluster and partition.  A cluster of kCluster = 8 blocks carries R batch
//   rows through the whole time loop.  Block r of the cluster owns hidden
//   units [r*U, (r+1)*U) of each layer (U = ceil(H / 8)) with all four gate
//   rows of those units, so the cell update and the cell state c stay in the
//   block.  At kernel start the block copies its rows of w_ih, w_hh and
//   b_ih + b_hh into shared memory once, in the order its warps read them
//   (below), so the 32 lanes of a warp read 32 consecutive words.  At the
//   serving widths that is 61 KB a block.
// - Layer skew.  Phase s (0 <= s < T + 2) runs layer 1 at step s, layer 2 at
//   step s - 1 and layer 3 at step s - 2; a layer skips a step out of range.
//   Each layer then reads only h written by the previous phase: its own and
//   the previous layer's.  Every block holds the full-width h of all three
//   layers, double-buffered by the parity of the phase; a block writes its
//   new h slice into the next buffer of all 8 blocks through distributed
//   shared memory, then calls cluster.sync() once.  Phase s reads buffer s%2
//   and writes buffer (s+1)%2, which is read in phase s+1 and written again
//   in phase s+2, so the one barrier covers the read-after-write and the
//   write-after-read hazards.  One more cluster.sync() after the shared
//   memory is set up keeps remote writes out of a block that has not
//   started; the last phase's barrier keeps every block resident until the
//   last remote write into it has landed.
// - A warp owns two units of one layer and up to 16 rows of the tile.  A
//   lane holds all four gate rows of its unit and takes every 16th input
//   (lane = unit * 16 + split), so each input costs it one vector load of 4
//   weights and the h values of its rows, for 4 multiply-adds per row: that
//   ratio of loads to multiply-adds bounds the dot products, since shared
//   memory delivers one word per lane per cycle and the SM issues four warp
//   multiply-adds.  Shuffles sum the 16 splits and leave each lane its unit's four
//   gates for one row, so the lane applies the cell update itself, with no
//   exchange between gates.  A warp needs nothing from another warp within
//   a phase, so the phase has no block-wide barrier; the cluster barrier is
//   its one synchronisation.  The card holds 15 clusters of 8 such blocks at
//   once (cudaOccupancyMaxActiveClusters), so the launch plan keeps the grid
//   to 15 clusters, one wave.
// - Layer 1 has in_features == 1: its input projection x_t * w_ih1[j] +
//   b[j] is computed in the kernel from the tile's R x T beats, read into
//   shared memory once.
// Sums run in float32, each lane's in order of k and then over the 16
// splits, with accurate expf/tanhf (no fast math, no tensor cores): the
// result agrees with the plain version to 2e-5, the difference being the
// order of the sums.  The launch plan (R, clusters, shared-memory bytes) is
// made by encoder_plan in ops/lstm_encoder.py; the launcher checks the bytes
// against the layout below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // blocks per cluster, the portable maximum
constexpr int kMaxWarps = 16;
constexpr int kSplit = 16;            // lanes that share one unit, each taking every 16th input
constexpr int kUnits = 32 / kSplit;   // units per warp
constexpr int kRowsMax = kSplit;      // rows of the tile one warp carries
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// Floats between the h values of consecutive inputs.  Eight lanes of a
// quarter-warp read 8 consecutive inputs with one vector load each; an odd
// number of 16-byte words between them keeps the loads in distinct banks.
__host__ __device__ constexpr int row_stride(int R) { return R < 4 || (R / 4) % 2 == 1 ? R : R + 4; }

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

// A block's shared memory, in floats.  Regions are sized for the widest
// share of units (U = ceil(H / 8)), so all blocks of a cluster have the same
// layout; encoder_plan computes the same total.
struct Layout {
  int h, x, c, w[3], b[3], wx1, total;
  __host__ __device__ Layout(int R, int T, int H1, int H2, int L) {
    const int Hs[3] = {H1, H2, L};
    const int K[3] = {H1, H1 + H2, H2 + L};
    int o = 0;
    h = o;  // two buffers of the h row [h1 | h2 | h3] and kSplit inputs of padding
    o += align4(2 * (H1 + H2 + L + kSplit) * row_stride(R));
    x = o;
    o += align4(R * T);
    c = o;
    o += align4((cdiv(H1, kCluster) + cdiv(H2, kCluster) + cdiv(L, kCluster)) * R);
    for (int l = 0; l < 3; ++l) {
      const int pairs = cdiv(cdiv(Hs[l], kCluster), kUnits);
      w[l] = o;
      o += pairs * cdiv(K[l], kSplit) * 32 * 4;
      b[l] = o;
      o += pairs * kUnits * 4;
    }
    wx1 = o;
    o += cdiv(cdiv(H1, kCluster), kUnits) * kUnits * 4;
    total = o;
  }
};

// One layer as this block sees it.
struct Layer {
  int n;        // units this block owns
  int unit0;    // the first of them
  int pairs;    // warp shares of units: ceil(n / 2)
  int K;        // inputs of a gate row
  int KK;       // inputs a lane takes, ceil(K / 16)
  int in_off;   // first input in the h row [h1 | h2 | h3]
  int out_off;  // the layer's own h in that row
  const float4* w;  // (pairs, KK, 32): a lane's (i, f, g, o) weights of one input, zero past K and n
  const float4* b;  // (pairs * 2,): b_ih + b_hh of a unit's four gates
  float* c;         // (U, R) cell state
};

// Loads the R rows of one input: R floats at p (16-byte aligned for R >= 4).
template <int R>
__device__ __forceinline__ void load_rows(float (&v)[R], const float* p) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
    }
  } else if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

__host__ __device__ constexpr int halve(int n) { return n > 1 ? n / 2 : 1; }

// The sum of acc over the kSplit splits of a unit, one level (lanes `mask`
// apart) at a time.  While a lane holds more than one row it keeps half of
// them (those whose bit matches its own bit of `mask`) and takes its
// partner's sums of those; with one row left both partners keep it.  At the
// end lane `split` holds the four gates of row split % N.
template <int N, int kMask = 1>
__device__ __forceinline__ void split_sum(const float (&acc)[4][N], float (&gate)[4], int split) {
  if constexpr (kMask == kSplit) {
    static_assert(N == 1, "a warp carries at most kSplit rows");
#pragma unroll
    for (int g = 0; g < 4; ++g) gate[g] = acc[g][0];
  } else {
    const bool hi = split & kMask;
    float out[4][halve(N)];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if constexpr (N > 1) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const float keep = hi ? acc[g][2 * i + 1] : acc[g][2 * i];
          const float send = hi ? acc[g][2 * i] : acc[g][2 * i + 1];
          out[g][i] = keep + __shfl_xor_sync(kFull, send, kMask);
        }
      } else {
        out[g][0] = acc[g][0] + __shfl_xor_sync(kFull, acc[g][0], kMask);
      }
    }
    split_sum<halve(N), 2 * kMask>(out, gate, split);
  }
}

// One phase of one warp: units 2p, 2p+1 of layer `ly`, rows [r0, r0 + RW) of
// the tile, at time `step`; reads buffer hc and writes h into buffer hn of
// every block of the cluster.
template <int R, bool kFirst>
__device__ __forceinline__ void unit_share(const Layer& ly, int p, int r0, int step, const float* hc, float* hn,
                                           const float* xs, const float4* wx1, int lane,
                                           cg::cluster_group& cluster) {
  constexpr int RW = R < kRowsMax ? R : kRowsMax;
  constexpr int RP = row_stride(R);
  const int split = lane % kSplit, u = p * kUnits + lane / kSplit;
  // after the split sums lane `split` holds row r0 + split % RW; the
  // kSplit / RW lanes that hold the same row share its remote writes
  const int r = r0 + split % RW, dup = split / RW;
  const bool own = u < ly.n;
  // loads that do not wait for the sums; c is read before the shuffles,
  // which order it before the write below
  const float c_old = own ? ly.c[u * R + r] : 0.0f;
  const float4 b = ly.b[u];
  const float4 wx = kFirst ? wx1[u] : float4{};
  const float xt = kFirst ? xs[step * R + r] : 0.0f;
  float acc[4][RW];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < RW; ++i) acc[g][i] = 0.0f;
  const float4* w = ly.w + p * ly.KK * 32 + lane;
  const float* h = hc + (ly.in_off + split) * RP + r0;
#pragma unroll 2
  for (int kk = 0; kk < ly.KK; ++kk) {
    const float4 wk = w[kk * 32];
    float hv[RW];
    load_rows<RW>(hv, h + kk * kSplit * RP);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      acc[0][i] = fmaf(wk.x, hv[i], acc[0][i]);
      acc[1][i] = fmaf(wk.y, hv[i], acc[1][i]);
      acc[2][i] = fmaf(wk.z, hv[i], acc[2][i]);
      acc[3][i] = fmaf(wk.w, hv[i], acc[3][i]);
    }
  }
  float gate[4];
  split_sum<RW>(acc, gate, split);
  if (!own) return;
  float pi = gate[0] + b.x, pf = gate[1] + b.y, pg = gate[2] + b.z, po = gate[3] + b.w;
  if constexpr (kFirst)
    pi = fmaf(xt, wx.x, pi), pf = fmaf(xt, wx.y, pf), pg = fmaf(xt, wx.z, pg), po = fmaf(xt, wx.w, po);
  const float cn = sigmoid_f(pf) * c_old + sigmoid_f(pi) * tanhf(pg);
  const float hv = sigmoid_f(po) * tanhf(cn);
  if (dup == 0) ly.c[u * R + r] = cn;
  const int idx = (ly.out_off + ly.unit0 + u) * RP + r;
  for (int dst = dup; dst < kCluster; dst += kSplit / RW) cluster.map_shared_rank(hn, dst)[idx] = hv;
}

template <int R>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) lstm_encoder_kernel(
    const float* __restrict__ x,  // (B, T): the beats, in_features == 1
    const float* __restrict__ w_ih1, const float* __restrict__ w_hh1,  // (4*H1, 1), (4*H1, H1)
    const float* __restrict__ b_ih1, const float* __restrict__ b_hh1,  // (4*H1,)
    const float* __restrict__ w_ih2, const float* __restrict__ w_hh2,  // (4*H2, H1), (4*H2, H2)
    const float* __restrict__ b_ih2, const float* __restrict__ b_hh2,
    const float* __restrict__ w_ih3, const float* __restrict__ w_hh3,  // (4*L, H2), (4*L, L)
    const float* __restrict__ b_ih3, const float* __restrict__ b_hh3,
    float* __restrict__ out,  // (B, L)
    int B, int T, int H1, int H2, int L) {
  constexpr int RP = row_stride(R);
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / kCluster) * R;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;
  const Layout lay(R, T, H1, H2, L);
  const int HB = (H1 + H2 + L + kSplit) * RP;  // one h buffer

  const int Hs[3] = {H1, H2, L};
  const int Kin[3] = {0, H1, H2};  // inputs from the layer below (layer 1's x is apart)
  const float* w_ih[3] = {w_ih1, w_ih2, w_ih3};
  const float* w_hh[3] = {w_hh1, w_hh2, w_hh3};
  const float* b_ih[3] = {b_ih1, b_ih2, b_ih3};
  const float* b_hh[3] = {b_hh1, b_hh2, b_hh3};
  constexpr int NH = R > kRowsMax ? R / kRowsMax : 1;  // warp shares per pair of units: row halves
  Layer ly[3];
  int c_off = lay.c;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int U = cdiv(Hs[l], kCluster);
    Layer& y = ly[l];
    y.unit0 = rank * U;
    y.n = max(0, min(U, Hs[l] - y.unit0));
    y.pairs = cdiv(y.n, kUnits);
    y.K = Kin[l] + Hs[l];
    y.KK = cdiv(y.K, kSplit);
    y.in_off = l == 2 ? H1 : 0;
    y.out_off = l == 0 ? 0 : (l == 1 ? H1 : H1 + H2);
    y.w = reinterpret_cast<const float4*>(smem + lay.w[l]);
    y.b = reinterpret_cast<const float4*>(smem + lay.b[l]);
    y.c = smem + c_off;
    c_off += U * R;
  }
  float* hbuf = smem + lay.h;
  float* xs = smem + lay.x;
  const float4* wx1 = reinterpret_cast<const float4*>(smem + lay.wx1);

  // set-up: shared memory zero, then the weights in lane order (zero past K
  // and past n), the biases summed and the tile's beats as xs[t * R + r]
  // (rows past B read as 0)
  for (int i = tid; i < lay.total; i += nthreads) smem[i] = 0.0f;
  __syncthreads();
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const Layer& y = ly[l];
    const int H = Hs[l], Ki = Kin[l];
    float* w = smem + lay.w[l];
    for (int i = tid; i < 4 * y.n * y.K; i += nthreads) {  // global reads along k
      const int k = i % y.K, u = (i / y.K) % y.n, g = i / (y.K * y.n);
      const size_t grow = static_cast<size_t>(g * H + y.unit0 + u);
      const int lane = (u % kUnits) * kSplit + k % kSplit;
      w[(((u / kUnits) * y.KK + k / kSplit) * 32 + lane) * 4 + g] =
          k < Ki ? w_ih[l][grow * Ki + k] : w_hh[l][grow * H + (k - Ki)];
    }
    float* bias = smem + lay.b[l];
    for (int i = tid; i < y.pairs * kUnits * 4; i += nthreads) {
      const int g = i % 4, u = i / 4, grow = g * H + y.unit0 + u;
      const bool ok = u < y.n;
      bias[i] = ok ? b_ih[l][grow] + b_hh[l][grow] : 0.0f;
      if (l == 0) smem[lay.wx1 + i] = ok ? w_ih1[grow] : 0.0f;
    }
  }
  for (int i = tid; i < R * T; i += nthreads) {
    const int r = i / T, t = i - r * T;
    xs[t * R + r] = row0 + r < B ? x[static_cast<size_t>(row0 + r) * T + t] : 0.0f;
  }
  cluster.sync();  // every block's buffers are ready before the first remote write

  // warp shares: (layer, pair of units, row half), layer by layer
  const int a1 = ly[0].pairs * NH, a2 = a1 + ly[1].pairs * NH, shares = a2 + ly[2].pairs * NH;
  for (int s = 0; s < T + 2; ++s) {
    const float* hc = hbuf + (s & 1) * HB;
    float* hn = hbuf + ((s + 1) & 1) * HB;
    for (int a = warp; a < shares; a += nwarps) {
      if (a < a1) {
        if (s < T) unit_share<R, true>(ly[0], a / NH, a % NH * kRowsMax, s, hc, hn, xs, wx1, lane, cluster);
      } else if (a < a2) {
        if (s >= 1 && s - 1 < T)
          unit_share<R, false>(ly[1], (a - a1) / NH, (a - a1) % NH * kRowsMax, s - 1, hc, hn, xs, wx1, lane, cluster);
      } else if (s >= 2) {
        unit_share<R, false>(ly[2], (a - a2) / NH, (a - a2) % NH * kRowsMax, s - 2, hc, hn, xs, wx1, lane, cluster);
      }
    }
    cluster.sync();  // the one barrier of the phase; the last one also ends all remote writes
  }

  // h3 at step T - 1 was written in phase T + 1, into buffer (T + 2) % 2
  if (rank == 0) {
    const float* h3 = hbuf + (T & 1) * HB + (H1 + H2) * RP;
    for (int i = tid; i < R * L; i += nthreads) {
      const int u = i / R, r = i - u * R;
      if (row0 + r < B) out[static_cast<size_t>(row0 + r) * L + u] = h3[u * RP + r];
    }
  }
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, const float*, const float*, const float*,
                          const float*, const float*, const float*, float*, int, int, int, int, int);

// The rows per cluster the kernel is built for.
KernelFn kernel_for(int R) {
  switch (R) {
    case 1: return lstm_encoder_kernel<1>;
    case 2: return lstm_encoder_kernel<2>;
    case 4: return lstm_encoder_kernel<4>;
    case 8: return lstm_encoder_kernel<8>;
    case 16: return lstm_encoder_kernel<16>;
    case 32: return lstm_encoder_kernel<32>;
    default: return nullptr;
  }
}

// Warps a block runs: one per share of its widest part (pair of units, row
// half), at most 16.
int block_threads(int R, int H1, int H2, int L) {
  const int shares = (cdiv(cdiv(H1, kCluster), kUnits) + cdiv(cdiv(H2, kCluster), kUnits) +
                      cdiv(cdiv(L, kCluster), kUnits)) * (R > kRowsMax ? R / kRowsMax : 1);
  return 32 * (shares < kMaxWarps ? shares : kMaxWarps);
}

// cudaErrorInvalidValue unless R is one the kernel is built for and ``smem``
// holds the layout; then the launch configuration of ``clusters`` clusters
// of kCluster blocks, after setting the kernel's shared-memory limit.
cudaError_t configure(int R, int T, int H1, int H2, int L, int clusters, int smem, cudaStream_t stream,
                      KernelFn* kernel, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *kernel = kernel_for(R);
  if (*kernel == nullptr || clusters < 1) return cudaErrorInvalidValue;
  if (static_cast<long>(Layout(R, T, H1, H2, L).total) * 4 > smem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(*kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * kCluster);
  cfg->blockDim = dim3(block_threads(R, H1, H2, L));
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Launches the encoder on ``stream`` as ``clusters`` clusters of 8 blocks,
// ``R`` batch rows each, ``smem`` bytes of shared memory a block (the plan
// of encoder_plan).  The weights are the module's own: w_ih and w_hh (4H, K)
// row-major, b_ih and b_hh (4H,).  Returns the cudaError_t of the attribute
// call or of the launch (0 on success).
extern "C" int lstm_encoder_launch(const float* x, const float* w_ih1, const float* w_hh1,
                                   const float* b_ih1, const float* b_hh1, const float* w_ih2,
                                   const float* w_hh2, const float* b_ih2, const float* b_hh2,
                                   const float* w_ih3, const float* w_hh3, const float* b_ih3,
                                   const float* b_hh3, float* out, int B, int T, int H1, int H2,
                                   int L, int R, int clusters, int smem, cudaStream_t stream) {
  KernelFn kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(R, T, H1, H2, L, clusters, smem, stream, &kernel, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, x, w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2,
                           w_ih3, w_hh3, b_ih3, b_hh3, out, B, T, H1, H2, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters), into ``*active``; returns the cudaError_t.
extern "C" int lstm_encoder_max_active_clusters(int T, int H1, int H2, int L, int R, int clusters,
                                                int smem, int* active) {
  KernelFn kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = configure(R, T, H1, H2, L, clusters, smem, nullptr, &kernel, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(active, reinterpret_cast<const void*>(kernel), &cfg));
}
