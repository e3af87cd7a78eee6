// KLD calibration threshold sweep — native implementation.
//
// TPU-native equivalent of the reference's only native code path
// (reference: kernels/gemmlowp.cu is its CUDA hot loop; the quant math here
// lives in Pallas kernels instead, so the native component is the *host*
// hot loop: the TensorRT-style entropy-calibration sweep, which in Python
// costs ~1000 histogram-KL evaluations per layer per batch —
// reference: pytorch_quantizer/quantization/inference/kld_threshold.py).
//
// Algorithm (identical contract to calib/kld.py::kld_threshold):
//   histogram the tensor symmetrically around 0; for every candidate
//   threshold i, fold outliers into the edge bins (p), build the
//   num_quantized_bins-merged reconstruction (q), smooth both, take
//   KL(p||q); return the threshold minimizing it.
//
// Built as a shared library (see Makefile); loaded via ctypes with a numpy
// fallback (calib/kld.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kSmoothEps = 1e-4;

// smooth in place: zeros get eps, nonzeros are debited proportionally.
// returns false if the distribution is all-zero.
bool Smooth(std::vector<double>& p) {
  int64_t n_zero = 0;
  for (double v : p) n_zero += (v == 0.0);
  const int64_t n_nonzero = static_cast<int64_t>(p.size()) - n_zero;
  if (n_nonzero == 0) return false;
  const double debit = kSmoothEps * static_cast<double>(n_zero) /
                       static_cast<double>(n_nonzero);
  for (double& v : p) v = (v == 0.0) ? kSmoothEps : v - debit;
  return true;
}

double KlDivergence(const std::vector<double>& p, const std::vector<double>& q) {
  double sp = 0, sq = 0;
  for (double v : p) sp += v;
  for (double v : q) sq += v;
  double kl = 0;
  for (size_t i = 0; i < p.size(); ++i) {
    const double pi = p[i] / sp;
    const double qi = q[i] / sq;
    if (pi > 0) kl += pi * std::log(pi / qi);
  }
  return kl;
}

}  // namespace

extern "C" {

// Returns the optimal symmetric clip threshold for `data[0..n)`.
double kld_threshold(const float* data, int64_t n, int num_bins,
                     int num_quantized_bins) {
  if (n <= 0) return 0.0;
  float lo = data[0], hi = data[0];
  for (int64_t i = 1; i < n; ++i) {
    lo = std::min(lo, data[i]);
    hi = std::max(hi, data[i]);
  }
  const double th = std::max(std::fabs((double)lo), std::fabs((double)hi));
  if (th == 0.0) return 0.0;

  // symmetric histogram over [-th, th]
  std::vector<int64_t> hist(num_bins, 0);
  const double inv_width = num_bins / (2.0 * th);
  for (int64_t i = 0; i < n; ++i) {
    int b = static_cast<int>((data[i] + th) * inv_width);
    b = std::min(std::max(b, 0), num_bins - 1);
    ++hist[b];
  }
  // prefix sums for O(1) outlier folding
  std::vector<int64_t> prefix(num_bins + 1, 0);
  for (int i = 0; i < num_bins; ++i) prefix[i + 1] = prefix[i] + hist[i];

  const int zero = num_bins / 2;
  const int half_q = num_quantized_bins / 2;
  const double bin_width = 2.0 * th / num_bins;

  double best_div = HUGE_VAL;
  double best_th = th;

  std::vector<double> p, q;
  for (int i = half_q; i <= num_bins / 2; ++i) {
    const int lo_idx = zero - i;
    const int hi_idx = zero + i + 1;  // exclusive
    const int m = hi_idx - lo_idx;

    p.assign(m, 0.0);
    for (int j = 0; j < m; ++j) p[j] = static_cast<double>(hist[lo_idx + j]);
    p[0] += static_cast<double>(prefix[lo_idx]);                 // left outliers
    p[m - 1] += static_cast<double>(prefix[num_bins] - prefix[hi_idx]);

    // merged reconstruction q over the *sliced* histogram
    q.assign(m, 0.0);
    const int merged = m / num_quantized_bins;
    for (int g = 0; g < num_quantized_bins; ++g) {
      const int start = g * merged;
      const int stop = (g == num_quantized_bins - 1) ? m : start + merged;
      int64_t total = 0;
      int nonzero = 0;
      for (int j = start; j < stop; ++j) {
        total += hist[lo_idx + j];
        nonzero += (hist[lo_idx + j] != 0);
      }
      if (nonzero == 0) continue;
      const double share = static_cast<double>(total) / nonzero;
      for (int j = start; j < stop; ++j) {
        if (hist[lo_idx + j] != 0) q[j] = share;
      }
    }

    if (!Smooth(p) || !Smooth(q)) continue;
    const double div = KlDivergence(p, q);
    if (div < best_div) {
      best_div = div;
      best_th = -th + hi_idx * bin_width;  // right edge of the slice
    }
  }
  return best_th;
}

// Batched variant: thresholds[i] = kld_threshold(data + i*stride, stride).
void kld_threshold_batch(const float* data, int64_t batch, int64_t stride,
                         int num_bins, int num_quantized_bins,
                         double* thresholds) {
  for (int64_t i = 0; i < batch; ++i) {
    thresholds[i] = kld_threshold(data + i * stride, stride, num_bins,
                                  num_quantized_bins);
  }
}

}  // extern "C"
