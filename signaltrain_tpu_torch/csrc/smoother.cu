// Switched one-pole envelope smoother, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of signaltrain_tpu/ops/pallas_kernels.py:
//   C  st_smoother  <- _make_kernel / _smoother_kernel (l.84-116), driven by
//                      _smoother_local (l.132-193), public entry
//                      switched_one_pole_batched (l.281-295)
// The plain PyTorch version is switched_one_pole in
// signaltrain_tpu_torch/dsp/iir.py.
//
// Per row b, with per-row coefficients:
//   s[0] = 0;  s[n] = (1-a)*g[n] + a*s[n-1],  a = alpha_a if g[n] < s[n-1] else alpha_r
// The switch makes the recursion non-associative, so no parallel scan is
// exact: one thread owns one row and steps through time, with the carry in
// a register for the whole row and nothing carried between blocks.
//
// What bounds it on an H100: by the roofline it is bytes (each sample read
// once and written once, a handful of flops each), but in truth it is the
// latency of the dependent chain, one step per few cycles on one thread per
// row: the serving call smooths a whole clip as ONE row, so a single thread
// walks millions of samples while the rest of the card idles. The design
// keeps that chain as short as it can be and off memory. Warp 0 owns the
// rows and only computes; warps 1-3 stage time-major tiles of g through
// shared memory (so the loads of a warp's rows coalesce, even for one row)
// and write the finished tiles back, double-buffered, so the loads and
// stores of the next and previous tiles overlap the recursion on this one.
// A row owner reads 8 steps ahead into registers, and forms both candidate
// updates beside the compare, so each step is one fma and a select on the
// chain. Each step is fma(alpha, s[n-1], (1-alpha)*g[n]): the rounding of
// the JAX package's compiled scan, and of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SM_ROWS = 8;       // rows per block: lanes 0-7 of warp 0 (few rows per
                                 // block, so a batch spreads over many SMs)
constexpr int SM_TT = 256;       // time steps per staged tile
constexpr int SM_THREADS = 128;  // warp 0 computes, warps 1-3 stage tiles
constexpr int SM_STAGERS = SM_THREADS - 32;
constexpr int SM_BURST = 8;      // loads a stager keeps in flight
constexpr int SM_AHEAD = 8;      // steps a row owner reads ahead

__global__ void __launch_bounds__(SM_THREADS) smoother_kernel(
    const float* __restrict__ g, const float* __restrict__ alpha_a,
    const float* __restrict__ alpha_r, float* __restrict__ out,
    int batch, int64_t n) {
  // two tiles, time-major per row; +1 so row owners read without bank conflicts
  __shared__ float tile[2][SM_ROWS][SM_TT + 1];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * SM_ROWS;
  const int64_t left = (int64_t)batch - row0;
  const int rows = left < SM_ROWS ? (int)left : SM_ROWS;
  const int64_t ntiles = (n + SM_TT - 1) / SM_TT;

  // stager: thread tid-32 of warps 1-3 moves elements i0 + 96*u of a tile,
  // SM_BURST loads in flight; the same thread writes an element back before
  // it refills it
  auto stage = [&](int buf, int64_t store_tile, int64_t load_tile) {
    const int total = rows * SM_TT;
    for (int i0 = tid - 32; i0 < total; i0 += SM_STAGERS * SM_BURST) {
      float v[SM_BURST];
#pragma unroll
      for (int u = 0; u < SM_BURST; ++u) {
        const int idx = i0 + SM_STAGERS * u;
        v[u] = 0.f;
        if (idx < total) {
          const int r = idx / SM_TT;
          const int k = idx % SM_TT;
          const int64_t base = (row0 + r) * n;
          if (store_tile >= 0) out[base + store_tile * SM_TT + k] = tile[buf][r][k];
          if (load_tile >= 0 && load_tile * SM_TT + k < n) v[u] = g[base + load_tile * SM_TT + k];
        }
      }
      if (load_tile >= 0) {
#pragma unroll
        for (int u = 0; u < SM_BURST; ++u) {
          const int idx = i0 + SM_STAGERS * u;
          if (idx < total) tile[buf][idx / SM_TT][idx % SM_TT] = v[u];
        }
      }
    }
  };

  if (tid >= 32) stage(0, -1, 0);
  __syncthreads();

  const bool owner = tid < rows;
  float aa = 0.f, ar = 0.f;
  if (owner) {
    aa = alpha_a[row0 + tid];
    ar = alpha_r[row0 + tid];
  }
  const float one_aa = __fsub_rn(1.f, aa);  // 1 - alpha, rounded like the plain version
  const float one_ar = __fsub_rn(1.f, ar);
  float carry = 0.f;

  for (int64_t i = 0; i < ntiles; ++i) {
    const int cur = (int)(i & 1);
    if (tid < 32) {
      if (owner) {
        float* row = tile[cur][tid];
        const int64_t t0 = i * SM_TT;
        const int len = n - t0 < SM_TT ? (int)(n - t0) : SM_TT;
        int k = 0;
        if (t0 == 0) {  // s[0] = 0 exactly
          row[0] = 0.f;
          k = 1;
        }
        float v[SM_AHEAD];
        if (k + SM_AHEAD <= len) {
#pragma unroll
          for (int u = 0; u < SM_AHEAD; ++u) v[u] = row[k + u];
        }
        for (; k + SM_AHEAD <= len; k += SM_AHEAD) {
          float next[SM_AHEAD];  // the following steps' inputs, read before this chain
          const bool more = k + 2 * SM_AHEAD <= len;
          if (more) {
#pragma unroll
            for (int u = 0; u < SM_AHEAD; ++u) next[u] = row[k + SM_AHEAD + u];
          }
#pragma unroll
          for (int u = 0; u < SM_AHEAD; ++u) {
            const float sa = __fmaf_rn(aa, carry, __fmul_rn(one_aa, v[u]));
            const float sr = __fmaf_rn(ar, carry, __fmul_rn(one_ar, v[u]));
            carry = v[u] < carry ? sa : sr;
            row[k + u] = carry;
          }
          if (more) {
#pragma unroll
            for (int u = 0; u < SM_AHEAD; ++u) v[u] = next[u];
          }
        }
        for (; k < len; ++k) {
          const float gn = row[k];
          const float sa = __fmaf_rn(aa, carry, __fmul_rn(one_aa, gn));
          const float sr = __fmaf_rn(ar, carry, __fmul_rn(one_ar, gn));
          carry = gn < carry ? sa : sr;
          row[k] = carry;
        }
      }
    } else {
      // the other buffer: write back tile i-1, then fetch tile i+1 into it
      stage(cur ^ 1, i >= 1 ? i - 1 : -1, i + 1 < ntiles ? i + 1 : -1);
    }
    __syncthreads();
  }
  // the last tile, by every thread (all tiles before it are full-length)
  const int last = (int)((ntiles - 1) & 1);
  const int64_t tl = (ntiles - 1) * SM_TT;
  for (int idx = tid; idx < rows * SM_TT; idx += SM_THREADS) {
    const int r = idx / SM_TT;
    const int k = idx % SM_TT;
    if (tl + k < n) out[(row0 + r) * n + tl + k] = tile[last][r][k];
  }
}

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// g, out (batch, n) float32; alpha_a, alpha_r (batch,) float32.
int st_smoother(const void* g, const void* alpha_a, const void* alpha_r, void* out,
                int batch, long long n, void* stream) {
  const unsigned blocks = (unsigned)((batch + SM_ROWS - 1) / SM_ROWS);
  smoother_kernel<<<blocks, SM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha_a, (const float*)alpha_r, (float*)out,
      batch, (int64_t)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
