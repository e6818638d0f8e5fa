// Polyphase windowed-sinc resampler for the audio front end (a copy of
// enhance_cb_whisper_tpu/audio/native/resample.cpp: the same source built
// with the same g++ flags gives the same samples).  Host code, no CUDA.
//
// Algorithm: rational-ratio polyphase FIR.  For upsample factor L and
// downsample factor M (reduced by gcd), a Kaiser-windowed sinc lowpass with
// cutoff min(1/L, 1/M)*Nyquist is applied at phase offsets so only the
// needed output samples are computed — O(taps) per output sample,
// no O(n log n) FFT and no full upsampled buffer.
//
// Exported C ABI (ctypes):
//   int resample_poly(const float* in, long n_in, float* out, long n_out,
//                     int up, int down)
// Returns 0 on success; `n_out` must be ceil(n_in * up / down).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

double bessel_i0(double x) {
  // series expansion; converges quickly for the beta values used here
  double sum = 1.0, term = 1.0;
  const double half_x = x / 2.0;
  for (int k = 1; k < 64; ++k) {
    term *= (half_x / k) * (half_x / k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

std::vector<float> design_filter(int up, int down, int zeros, double beta) {
  // lowpass at min(pi/up, pi/down), gain `up` (to preserve amplitude after
  // zero-stuffing), Kaiser window
  const double cutoff = 0.5 / static_cast<double>(std::max(up, down));
  const int half = zeros * std::max(up, down);
  const int n_taps = 2 * half + 1;
  std::vector<float> h(static_cast<size_t>(n_taps));
  const double i0_beta = bessel_i0(beta);
  for (int i = 0; i < n_taps; ++i) {
    const double t = static_cast<double>(i - half);
    const double x = 2.0 * cutoff * t;
    const double sinc = (t == 0.0) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    const double w_arg = t / static_cast<double>(half);
    const double window = bessel_i0(beta * std::sqrt(std::max(0.0, 1.0 - w_arg * w_arg))) / i0_beta;
    h[static_cast<size_t>(i)] =
        static_cast<float>(2.0 * cutoff * up * sinc * window);
  }
  return h;
}

}  // namespace

extern "C" int resample_poly(const float* in, int64_t n_in, float* out,
                             int64_t n_out, int up, int down) {
  if (up <= 0 || down <= 0 || n_in <= 0 || n_out <= 0) return 1;
  static thread_local std::vector<float> filter;
  static thread_local int cached_up = -1, cached_down = -1;
  if (cached_up != up || cached_down != down) {
    filter = design_filter(up, down, /*zeros=*/24, /*beta=*/14.769656459379492);
    cached_up = up;
    cached_down = down;
  }
  const int64_t n_taps = static_cast<int64_t>(filter.size());
  const int64_t half = n_taps / 2;

  for (int64_t j = 0; j < n_out; ++j) {
    // output sample j sits at upsampled index j*down; the filter is centered
    // there: y[j] = sum_t h[t] * x_up[j*down - half + t]
    const int64_t up_center = j * down;
    double acc = 0.0;
    // x_up[k] is nonzero only when k % up == 0 (k/up indexes the input)
    const int64_t k_start = up_center - half;
    // first nonzero tap: smallest t >= 0 with (k_start + t) % up == 0
    int64_t rem = k_start % up;
    if (rem < 0) rem += up;
    int64_t t0 = (rem == 0) ? 0 : (up - rem);
    for (int64_t t = t0; t < n_taps; t += up) {
      const int64_t idx = (k_start + t) / up;
      if (idx < 0 || idx >= n_in) continue;
      acc += static_cast<double>(filter[static_cast<size_t>(t)]) *
             static_cast<double>(in[idx]);
    }
    out[j] = static_cast<float>(acc);
  }
  return 0;
}
