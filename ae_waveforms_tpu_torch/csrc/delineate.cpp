// Host delineator — float64 twin of ae_waveforms_tpu_torch/signals/delineate.py
// (a copy of the JAX package's native/delineate.cpp, built by ops/_build.py
// with g++ and bound in ops/native_delineate.py).
//
// The float64 parity extraction path runs the DWT delineation per 20-s
// window; in Python that is the CPU bottleneck (the reference spends its
// extraction time inside the equivalent third-party numpy loops).  This
// translation unit implements the identical algorithm in C++ (index-exact
// against the Python implementation, enforced by tests), exposed through a
// minimal C ABI for ctypes.
//
// Layout of the output buffer: fiducial-major, [10][n_windows][max_peaks]
// doubles, NaN for undetected/padded beats, indices at the original rate.
// Fiducial order matches core.schema.FIDUCIAL_NAMES.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kAnalysisRate = 2000;
constexpr double kNaN = std::numeric_limits<double>::quiet_NaN();

// linear resample by an integer factor, np.interp over endpoint=False grids
std::vector<double> resample_up(const double* x, int n, int factor) {
  std::vector<double> out(static_cast<size_t>(n) * factor);
  const double step = 1.0 / factor;
  for (size_t i = 0; i < out.size(); ++i) {
    const double f = i * step;
    const int lo = static_cast<int>(f);
    const int hi = std::min(lo + 1, n - 1);
    const double w = f - lo;
    out[i] = x[lo] * (1.0 - w) + x[hi] * w;
  }
  return out;
}

// a-trous quadratic-spline detail signals; dwt[deg] has length n.
//
// The reference computation lets intermediate approximations *grow* (full
// convolutions), so values past the original length feed later scales near
// the signal tail.  Computing every scale over a zero-padded extended
// buffer (n + 2048 covers the 9-scale growth) reproduces exactly the
// entries that survive the final trim-to-n.
void dwt_scales(const std::vector<double>& x, int max_degree,
                std::vector<std::vector<double>>& dwt) {
  const int n = static_cast<int>(x.size());
  const int m = n + 2048;
  std::vector<double> approx(m, 0.0);
  std::copy(x.begin(), x.end(), approx.begin());
  dwt.assign(max_degree, {});
  std::vector<double> detail(m), smooth(m);
  for (int deg = 0; deg < max_degree; ++deg) {
    const int gap = (1 << deg);  // tap spacing; time-shift compensation == gap
    auto at = [&](int idx) -> double {
      return (idx >= 0 && idx < m) ? approx[idx] : 0.0;
    };
    for (int i = 0; i < m; ++i) {
      const int j = i + gap;
      detail[i] = 2.0 * at(j) - 2.0 * at(j - gap);
      smooth[i] = 0.125 * at(j) + 0.375 * at(j - gap) + 0.375 * at(j - 2 * gap) +
                  0.125 * at(j - 3 * gap);
    }
    dwt[deg].assign(detail.begin(), detail.begin() + n);
    approx = smooth;
  }
}

// strict local maxima of v over [0, len)
void local_maxima(const double* v, int len, std::vector<int>* out) {
  out->clear();
  for (int k = 1; k + 1 < len; ++k)
    if (v[k] > v[k - 1] && v[k] > v[k + 1]) out->push_back(k);
}

// T/P peak search over the window [start, start+len) of dwt_row
double tp_peak(const std::vector<double>& ecg, const std::vector<double>& dwt_row,
               int start, int len, double eps_weight, double expected_latency,
               bool symmetric) {
  const int n = static_cast<int>(ecg.size());
  if (start < 0) return kNaN;
  const int end = std::min(start + len, n);
  const int L = end - start;
  if (L <= 0) return kNaN;
  const double* d = dwt_row.data() + start;

  double sumsq = 0.0, dmax = -std::numeric_limits<double>::infinity();
  for (int k = 0; k < L; ++k) {
    sumsq += d[k] * d[k];
    dmax = std::max(dmax, d[k]);
  }
  const double height = eps_weight * std::sqrt(sumsq / L);

  std::vector<double> absd(L);
  for (int k = 0; k < L; ++k) absd[k] = std::fabs(d[k]);
  std::vector<int> locmax;
  local_maxima(absd.data(), L, &locmax);

  std::vector<int> peaks;
  for (int p : locmax)
    if (absd[p] > height && absd[p] > 0.025 * dmax) peaks.push_back(p);
  if (d[0] > 0) peaks.insert(peaks.begin(), 0);

  double best_score = -std::numeric_limits<double>::infinity();
  int best_idx = -1;
  for (size_t i = 0; i + 1 < peaks.size(); ++i) {
    const int p = peaks[i], q = peaks[i + 1];
    if (!(d[p] > 0 && d[q] < 0)) continue;
    int idx_zero = -1;  // first sign change in [p, q]
    for (int k = p; k < q; ++k) {
      const double s0 = (d[k] > 0) - (d[k] < 0);
      const double s1 = (d[k + 1] > 0) - (d[k + 1] < 0);
      if (s1 != s0) { idx_zero = k; break; }
    }
    if (idx_zero < 0) continue;
    const double latency = static_cast<double>(idx_zero) / kAnalysisRate - expected_latency;
    const double score = ecg[start + idx_zero] - (symmetric ? std::fabs(latency) : latency);
    if (score > best_score) { best_score = score; best_idx = idx_zero; }
  }
  return best_idx < 0 ? kNaN : static_cast<double>(best_idx + start);
}

// onset pattern: last sub-threshold point before the last slope peak
double onset_like(const std::vector<double>& row, int start, int end, double weight,
                  bool negate, bool last_slope_peak) {
  const int n = static_cast<int>(row.size());
  start = std::max(start, 0);
  end = std::min(end, n);
  const int L = end - start;
  if (L <= 0) return kNaN;
  std::vector<double> d(L);
  for (int k = 0; k < L; ++k) d[k] = negate ? -row[start + k] : row[start + k];
  std::vector<int> sp;
  local_maxima(d.data(), L, &sp);
  if (sp.empty()) return kNaN;
  if (last_slope_peak) {
    const int s = sp.back();
    const double eps = weight * d[s];
    for (int k = s - 1; k >= 0; --k)
      if (d[k] < eps) return static_cast<double>(k + start);
    return kNaN;
  }
  const int s = sp.front();
  const double eps = weight * d[s];
  for (int k = s; k < L; ++k)
    if (d[k] < eps) return static_cast<double>(k + start);
  return kNaN;
}

double argmin_window(const std::vector<double>& ecg, int lo, int hi) {
  const int n = static_cast<int>(ecg.size());
  lo = std::max(lo, 0);
  hi = std::min(hi, n);
  if (hi <= lo) return kNaN;
  int best = lo;
  for (int k = lo + 1; k < hi; ++k)
    if (ecg[k] < ecg[best]) best = k;
  return static_cast<double>(best);
}

}  // namespace

extern "C" {

// out: [10][n_windows][max_peaks] doubles (fiducial-major, schema order)
void delineate_batch_f64(const double* samples, int n_windows, int window_len,
                         const int32_t* peaks, const int32_t* n_peaks,
                         int max_peaks, int fs_in, double* out) {
  const int up = kAnalysisRate / fs_in;
  const int deg_add = 3;  // log2(2000 / 250)
  const int srch_bndry = static_cast<int>(0.5 * 0.13 * kAnalysisRate);
  const int t_dur = 2 * static_cast<int>(0.25 * kAnalysisRate);
  const int p_back = 2 * static_cast<int>(0.2 * kAnalysisRate);
  const size_t plane = static_cast<size_t>(n_windows) * max_peaks;

  for (int w = 0; w < n_windows; ++w) {
    auto ecg = resample_up(samples + static_cast<size_t>(w) * window_len, window_len, up);
    std::vector<std::vector<double>> dwt;
    dwt_scales(ecg, 9, dwt);
    const auto& row2 = dwt[2 + deg_add];
    const auto& row3 = dwt[3 + deg_add];
    const int K = n_peaks[w];

    for (int b = 0; b < max_peaks; ++b) {
      double fid[10];
      for (double& v : fid) v = kNaN;
      const int32_t pk = peaks[static_cast<size_t>(w) * max_peaks + b];
      if (b < K && pk >= 0) {
        const int r = pk * up;
        const double tpk = tp_peak(ecg, row3, r + srch_bndry, t_dur - srch_bndry,
                                   0.25, 0.25 - 0.5 * 0.13, false);
        const int p_start = r - p_back;
        const double ppk = (p_start < 0)
                               ? kNaN
                               : tp_peak(ecg, row2, p_start, (r - srch_bndry) - p_start,
                                         0.02, 0.2, true);
        double r_on = kNaN, r_off = kNaN;
        if (!std::isnan(ppk))
          r_on = onset_like(row2, static_cast<int>(ppk), r, 0.5, true, true);
        if (!std::isnan(tpk))
          r_off = onset_like(row2, r, static_cast<int>(tpk), 0.5, true, false);

        double p_on = kNaN, p_off = kNaN, t_on = kNaN, t_off = kNaN;
        if (!std::isnan(ppk)) {
          const int pp = static_cast<int>(ppk);
          p_on = onset_like(row2, pp - static_cast<int>(0.3 * kAnalysisRate), pp, 0.4, false, true);
          p_off = onset_like(row2, pp, pp + static_cast<int>(0.3 * kAnalysisRate), 0.4, true, false);
        }
        if (!std::isnan(tpk)) {
          const int tp = static_cast<int>(tpk);
          t_on = onset_like(row2, tp - static_cast<int>(0.6 * kAnalysisRate), tp, 0.6, false, true);
          t_off = onset_like(row2, tp, tp + static_cast<int>(0.3 * kAnalysisRate), 0.4, true, false);
        }

        double q_pk = kNaN, s_pk = kNaN;
        if (!std::isnan(r_on) && static_cast<int>(r_on) < r)
          q_pk = argmin_window(ecg, static_cast<int>(r_on), r);
        if (!std::isnan(r_off) && r + 1 < static_cast<int>(r_off))
          s_pk = argmin_window(ecg, r + 1, static_cast<int>(r_off));

        const double down = 1.0 / up;
        auto ds = [&](double v) { return std::isnan(v) ? kNaN : std::floor(v * down); };
        fid[0] = ds(ppk);
        fid[1] = ds(p_on);
        fid[2] = ds(p_off);
        fid[3] = ds(q_pk);
        fid[4] = ds(r_on);
        fid[5] = ds(r_off);
        fid[6] = ds(s_pk);
        fid[7] = ds(tpk);
        fid[8] = ds(t_on);
        fid[9] = ds(t_off);
      }
      for (int f = 0; f < 10; ++f)
        out[f * plane + static_cast<size_t>(w) * max_peaks + b] = fid[f];
    }
  }
}

}  // extern "C"
