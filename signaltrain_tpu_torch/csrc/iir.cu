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
// fma a step (z0 -> y -> a1*y -> z0), 12 cycles; order 3's longest cycle,
// y -> a3*y -> z2 -> z1 -> z0 -> y, is 7 dependent operations over 3 steps,
// 9.33 cycles a step. The design is the row scan of row_scan.cuh, shared
// with kernel C (csrc/smoother.cu): one thread owns one row and walks it in
// time with its state (at most 3 floats) in registers, the next 8 inputs read
// ahead of the chain; a producer warp keeps a ring of tiles filled and
// drained by asynchronous copies, so the chain waits neither on shared nor
// on device memory; a batch spreads over the card's SMs first, the rows a
// block chosen by ops/cuda_kernels.rows_per_block. Measured with clock64 on
// an H100 (cycles a step): one row alone, a staged tile with no producer,
// order 1 12.7 and order 3 11.4-11.9; in the kernel 13-14 for order 1 and
// ~15.5 for order 3 (the per-tile handshakes and each call's fill and drain).
// Before this design, order 1 ran at 18.4 alone (its loads read only 4 steps
// ahead and each group waited for them) and 27 at 8 rows a block (its
// stagers).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_scan.cuh"

namespace {

// One step of the filter on one row: the state z, the normalised
// coefficients bn and -a.
template <int ORDER>
struct IirStep {
  static constexpr bool kZeroFirst = false;
  using In = float;  // the sample alone: every product but b_i * x involves the state
  float z[ORDER], bn[ORDER + 1], neg_a[ORDER + 1];

  __device__ __forceinline__ float prep(float xv) const { return xv; }
  __device__ __forceinline__ float operator()(float xv) {
    const float y = __fmaf_rn(bn[0], xv, z[0]);
#pragma unroll
    for (int i = 0; i + 1 < ORDER; ++i)
      z[i] = __fmaf_rn(neg_a[i + 1], y, __fmaf_rn(bn[i + 1], xv, z[i + 1]));
    z[ORDER - 1] = __fmaf_rn(bn[ORDER], xv, __fmul_rn(neg_a[ORDER], y));
    return y;
  }
};

template <int ORDER>
__global__ void __launch_bounds__(rs::THREADS) lfilter_kernel(
    const float* __restrict__ x, const float* __restrict__ b, const float* __restrict__ a,
    const float* __restrict__ zi, float* __restrict__ out, int batch, int64_t n, int per_block) {
  const int64_t row0 = (int64_t)blockIdx.x * per_block;
  const int64_t left = (int64_t)batch - row0;
  const int rows = left < per_block ? (int)left : per_block;
  IirStep<ORDER> st{};
  if (threadIdx.x < rows) {
    const int64_t r = row0 + threadIdx.x;
    const float a0 = a[r * (ORDER + 1)];
#pragma unroll
    for (int k = 0; k <= ORDER; ++k) {
      st.bn[k] = __fdiv_rn(b[r * (ORDER + 1) + k], a0);
      st.neg_a[k] = -__fdiv_rn(a[r * (ORDER + 1) + k], a0);
    }
#pragma unroll
    for (int k = 0; k < ORDER; ++k) st.z[k] = zi[r * ORDER + k];
  }
  rs::scan(x, out, rs::Rows{row0, n}, rows, st, [](int64_t) {});
}

template <int ORDER>
cudaError_t launch(const float* x, const float* b, const float* a, const float* zi, float* out,
                   int batch, int64_t n, int per_block, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((batch + per_block - 1) / per_block);
  lfilter_kernel<ORDER><<<blocks, rs::THREADS, rs::smem_bytes(per_block), stream>>>(
      x, b, a, zi, out, batch, n, per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x, out (batch, n) float32; b, a (batch, order+1) float32; zi (batch, order)
// float32, the initial state. order 1 or 3; per_block (1-8) rows a block.
int st_lfilter(const void* x, const void* b, const void* a, const void* zi, void* out, int batch,
               long long n, int order, int per_block, void* stream) {
  if (batch < 1 || n < 1 || per_block < 1 || per_block > rs::MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const float *xf = (const float*)x, *bf = (const float*)b, *af = (const float*)a,
              *zf = (const float*)zi;
  float* of = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 1: return (int)launch<1>(xf, bf, af, zf, of, batch, (int64_t)n, per_block, s);
    case 3: return (int)launch<3>(xf, bf, af, zf, of, batch, (int64_t)n, per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
