// IIR filter (direct form II transposed), kernel L, for Hopper (sm_90a).
//
// The JAX package runs lfilter (signaltrain_tpu/dsp/iir.py:102-129) as a
// lax.scan, not as a Pallas kernel, so L replaces no pallas_call; on the card
// a sequential recursion has no PyTorch call, and its plain version
// (lfilter_reference in signaltrain_tpu_torch/dsp/iir.py) walks each row on
// the host. The effects Compressor (order 1, with an initial state) and
// LowPass (order 3) filter through it; it is built for those two orders.
//
// Per row r, with per-row coefficients normalised by a[0] (one IEEE division
// each, as the JAX code divides):
//   y[n]   = fma(b0, x[n], z0)
//   z_i    = fma(-a_{i+1}, y[n], fma(b_{i+1}, x[n], z_{i+1}))   i < order-1
//   z_o-1  = fma(b_o, x[n], -(a_o * y[n]))
// the rounding of the JAX package's compiled scan (XLA contracts its step
// into these fmas; found by matching it bit for bit) and of the plain
// version. The intrinsics (__fmaf_rn, __fmul_rn) keep nvcc from contracting
// anything else. A third-order low-pass near 10 Hz has poles within 1.5e-3
// of z = 1 and amplifies any other rounding by orders of magnitude.
//
// What bounds it on an H100: by the roofline it is bytes (8 B a sample, each
// read and written once, ~4*order+1 flops), but a row is one dependent
// chain, so one row takes N steps of its latency: order 1 is fma -> mul ->
// fma a step (z0 -> y -> a1*y -> z0); order 3's longest cycle, y -> a3*y ->
// z2 -> z1 -> z0 -> y, is 7 dependent operations over 3 steps. The design is kernel C's row schedule (csrc/smoother.cu): one
// thread owns one row and walks it in time with its state (at most 3 floats)
// in registers; warp 0 owns up to 8 rows a block and only computes; warps 1-3
// stage time-major tiles of x through shared memory (so a warp's loads
// coalesce, even for one row) and write the finished tiles back, double
// buffered, so the loads and stores overlap the recursion. A batch of rows
// spreads over the card, 8 rows a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L_ROWS = 8;        // rows a block: lanes 0-7 of warp 0
constexpr int L_TT = 256;        // time steps a staged tile
constexpr int L_THREADS = 128;   // warp 0 computes, warps 1-3 stage
constexpr int L_STAGERS = L_THREADS - 32;
constexpr int L_BURST = 8;       // loads a stager keeps in flight

template <int ORDER>
__device__ __forceinline__ float step(float xv, float (&z)[ORDER], const float (&bn)[ORDER + 1],
                                      const float (&neg_a)[ORDER + 1]) {
  const float y = __fmaf_rn(bn[0], xv, z[0]);
#pragma unroll
  for (int i = 0; i + 1 < ORDER; ++i)
    z[i] = __fmaf_rn(neg_a[i + 1], y, __fmaf_rn(bn[i + 1], xv, z[i + 1]));
  z[ORDER - 1] = __fmaf_rn(bn[ORDER], xv, __fmul_rn(neg_a[ORDER], y));
  return y;
}

template <int ORDER>
__global__ void __launch_bounds__(L_THREADS) lfilter_kernel(
    const float* __restrict__ x, const float* __restrict__ b, const float* __restrict__ a,
    const float* __restrict__ zi, float* __restrict__ out, int batch, int64_t n) {
  // two tiles, time-major per row; +1 so row owners read without bank conflicts
  __shared__ float tile[2][L_ROWS][L_TT + 1];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * L_ROWS;
  const int64_t left = (int64_t)batch - row0;
  const int rows = left < L_ROWS ? (int)left : L_ROWS;
  const int64_t ntiles = (n + L_TT - 1) / L_TT;

  // stager thread tid-32 of warps 1-3 writes tile `store` of buffer buf back
  // and loads tile `load` into it (-1 skips either); the same thread writes
  // an element back before it refills it
  auto stage = [&](int buf, int64_t store, int64_t load) {
    const int total = rows * L_TT;
    for (int i0 = tid - 32; i0 < total; i0 += L_STAGERS * L_BURST) {
      float v[L_BURST];
#pragma unroll
      for (int u = 0; u < L_BURST; ++u) {
        const int idx = i0 + L_STAGERS * u;
        v[u] = 0.f;
        if (idx < total) {
          const int r = idx / L_TT;
          const int k = idx % L_TT;
          const int64_t base = (row0 + r) * n;
          if (store >= 0) out[base + store * L_TT + k] = tile[buf][r][k];
          if (load >= 0 && load * L_TT + k < n) v[u] = x[base + load * L_TT + k];
        }
      }
      if (load >= 0) {
#pragma unroll
        for (int u = 0; u < L_BURST; ++u) {
          const int idx = i0 + L_STAGERS * u;
          if (idx < total) tile[buf][idx / L_TT][idx % L_TT] = v[u];
        }
      }
    }
  };

  if (tid >= 32) stage(0, -1, 0);
  __syncthreads();

  const bool owner = tid < rows;
  float bn[ORDER + 1], neg_a[ORDER + 1], z[ORDER];
#pragma unroll
  for (int k = 0; k <= ORDER; ++k) bn[k] = neg_a[k] = 0.f;
#pragma unroll
  for (int k = 0; k < ORDER; ++k) z[k] = 0.f;
  if (owner) {
    const int64_t r = row0 + tid;
    const float a0 = a[r * (ORDER + 1)];
#pragma unroll
    for (int k = 0; k <= ORDER; ++k) {
      bn[k] = __fdiv_rn(b[r * (ORDER + 1) + k], a0);
      neg_a[k] = -__fdiv_rn(a[r * (ORDER + 1) + k], a0);
    }
#pragma unroll
    for (int k = 0; k < ORDER; ++k) z[k] = zi[r * ORDER + k];
  }

  for (int64_t i = 0; i < ntiles; ++i) {
    const int cur = (int)(i & 1);
    if (tid < 32) {
      if (owner) {
        float* row = tile[cur][tid];
        const int64_t t0 = i * L_TT;
        const int len = n - t0 < L_TT ? (int)(n - t0) : L_TT;
        // unrolled, so the shared-memory loads of the next steps are read ahead
        // of the chain
#pragma unroll 8
        for (int k = 0; k < len; ++k) row[k] = step<ORDER>(row[k], z, bn, neg_a);
      }
    } else {
      // the other buffer: write back tile i-1, then fetch tile i+1 into it
      stage(cur ^ 1, i >= 1 ? i - 1 : -1, i + 1 < ntiles ? i + 1 : -1);
    }
    __syncthreads();
  }
  // the last tile, by every thread
  const int last = (int)((ntiles - 1) & 1);
  const int64_t tl = (ntiles - 1) * L_TT;
  for (int idx = tid; idx < rows * L_TT; idx += L_THREADS) {
    const int r = idx / L_TT;
    const int k = idx % L_TT;
    if (tl + k < n) out[(row0 + r) * n + tl + k] = tile[last][r][k];
  }
}

template <int ORDER>
cudaError_t launch(const float* x, const float* b, const float* a, const float* zi, float* out,
                   int batch, int64_t n, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((batch + L_ROWS - 1) / L_ROWS);
  lfilter_kernel<ORDER><<<blocks, L_THREADS, 0, stream>>>(x, b, a, zi, out, batch, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x, out (batch, n) float32; b, a (batch, order+1) float32; zi (batch, order)
// float32, the initial state. order 1 or 3.
int st_lfilter(const void* x, const void* b, const void* a, const void* zi, void* out, int batch,
               long long n, int order, void* stream) {
  if (batch < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x, *bf = (const float*)b, *af = (const float*)a,
              *zf = (const float*)zi;
  float* of = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 1: return (int)launch<1>(xf, bf, af, zf, of, batch, (int64_t)n, s);
    case 3: return (int)launch<3>(xf, bf, af, zf, of, batch, (int64_t)n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
