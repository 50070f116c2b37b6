// Host compressors for the dataset tool's host backend, and the test oracles
// of the compressor family's plain versions and kernel C.
//
// The reference's only compiled code is a pair of numba-JIT compressor
// kernels (reference: signaltrain/audio.py:348-426). These are the same two
// loops in C++, with float64 arithmetic (numba promotes the mixed
// float32 / python-float expressions to double) and float32 outputs. This is
// host code, built with g++ (utils/native.py), not a kernel for the card.
//
// C ABI, bound with ctypes.

#include <cmath>
#include <cstdint>

extern "C" {

// 4-knob compressor (audio.py:380-426; Tarr, Hack Audio p.428).
//   x_dB  = max(20*log10(|x| + 1e-8), -96)
//   gc_dB = thresh + (x_dB - thresh)/ratio - x_dB    where x_dB > thresh
//   s[0]  = 0;  s[n] = (1-a)*gc[n] + a*s[n-1],
//           a = alphaA if gc[n] < s[n-1] else alphaR
//   y     = x * 10^(s/20)
void compressor_4controls(const float* x, float* y, int64_t n, double thresh,
                          double ratio, double attack_time,
                          double release_time, double sr) {
  const double alpha_a = std::exp(-std::log(9.0) / (sr * attack_time));
  const double alpha_r = std::exp(-std::log(9.0) / (sr * release_time));
  double prev = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double x_db = 20.0 * std::log10(std::fabs((double)x[i]) + 1e-8);
    if (x_db < -96.0) x_db = -96.0;
    double gc = 0.0;
    if (x_db > thresh) gc = thresh + (x_db - thresh) / ratio - x_db;
    double s;
    if (i == 0) {
      s = 0.0;  // the reference's loop starts at n=1, leaving s[0] = 0
    } else {
      const double a = (gc < prev) ? alpha_a : alpha_r;
      s = (1.0 - a) * gc + a * prev;
    }
    prev = s;
    y[i] = (float)(std::pow(10.0, s / 20.0) * (double)x[i]);
  }
}

// 3-knob compressor (audio.py:348-371): first-order butterworth envelope of
// the dB signal (scipy butter(1, fc) + lfilter seeded with zi*dB[0]), static
// gain curve above threshold.
void compressor_3knob(const float* x, float* y, int64_t n, double thresh,
                      double ratio, double attackrel, double sr) {
  const double fc = 1.0 / (attackrel * sr);  // normalized to Nyquist
  // butter(1, fc): w = tan(pi*fc/2); b0 = b1 = w/(1+w); a1 = (w-1)/(1+w)
  const double w = std::tan(M_PI * fc / 2.0);
  const double b0 = w / (1.0 + w);
  const double b1 = b0;
  const double a1 = (w - 1.0) / (1.0 + w);
  // lfilter_zi for order 1: zi = (b1 - a1*b0) / (1 + a1)
  const double zi = (b1 - a1 * b0) / (1.0 + a1);

  double z = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double db = 20.0 * std::log10(std::fabs((double)x[i]) + 1e-6);
    if (i == 0) z = zi * db;
    // direct form II transposed, order 1
    const double in_env = b0 * db + z;
    z = b1 * db - a1 * in_env;
    const double out_env =
        (in_env > thresh) ? thresh + (in_env - thresh) / ratio : in_env;
    y[i] = (float)((double)x[i] * std::pow(10.0, (out_env - in_env) / 20.0));
  }
}

// Switched one-pole smoother alone (kernel C's contract).
void switched_one_pole(const float* g, float* s, int64_t n, double alpha_a,
                       double alpha_r) {
  double prev = 0.0;
  s[0] = 0.0f;
  for (int64_t i = 1; i < n; ++i) {
    const double a = ((double)g[i] < prev) ? alpha_a : alpha_r;
    prev = (1.0 - a) * (double)g[i] + a * prev;
    s[i] = (float)prev;
  }
}

}  // extern "C"
