// Fused STFT analysis and iSTFT synthesis, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of signaltrain_tpu/ops/pallas_frontend.py:
//   A  st_analysis_fwd   <- _an_fwd_kernel (l.174-192), launched by
//                           _fused_analysis_fwd_impl (l.270-303)
//   B  st_synthesis_fwd  <- _syn_fwd_kernel (l.355-377), launched by
//                           _fused_synthesis_fwd_impl (l.448-475)
// The plain PyTorch versions are fused_analysis_reference and
// fused_synthesis_reference in signaltrain_tpu_torch/ops/cuda_frontend.py.
// Their backward kernels (D, E) are in frontend_bwd.cu.
//
// What bounds them on an H100: both are f32-accurate matrix products with
// fused prologues and epilogues. At the flagship geometry A does
// 2*25*1024*1026 flops per window against ~0.35 MB of its own traffic,
// B 2*1026*5376 flops against ~0.05 MB. So both are bound by operations, and
// the bytes that the XLA formulation sends through HBM (the framed signal,
// the spectrum, the untrimmed frames) never leave the SM.
//   A runs its product on the tensor cores: the split-TF32 main loop of
//     tc_product.cuh (three TF32 mma products per f32 product, as accurate as
//     an f32 one, so the 2e-5 magnitude tolerance holds), fed by a cp.async
//     ring of shared-memory stages. Its bound is 165 TFLOP/s of f32-accurate
//     work. Framing is folded into the loads (frame t of window b is the row
//     of xp at offset t*hop) and the magnitude/phase into the epilogue: re and
//     im of a bin are neighbouring columns of the repacked weights, so the
//     thread that finishes bin k holds both. Kernel D's first product is the
//     same code, so it finds the spectrum A found, bit for bit.
//   B is a register-tiled SIMT product on the CUDA cores (bound: 67 TFLOP/s).
//     It builds mag*cos(phs) and mag*sin(phs) as it stages the spectrum tile,
//     and writes the overlap-add as a gather: output sample m only sums the
//     frames t with t*hop <= m < t*hop+ft, so every output is owned by one
//     thread, the result is deterministic and no atomics are needed. Only the
//     trimmed output is computed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_product.cuh"

namespace {

// ---------------------------------------------------------------- A
// The spectrum product of tc_product.cuh; a finished (re, im) pair becomes
// the magnitude with the 1e-36 floor (edge frames give exactly 1e-18) and the
// phase atan2(im, re + 1e-7) (edge frames give exactly 0).
struct AnalysisFwd : tc::Spectrum {
  float* mag;
  float* phs;
  __device__ void pair(int r, int n, float re2, float im2, int) const {
    const int bin = n >> 1;
    if (r >= frames * batch || bin >= half) return;
    const float re = 0.5f * re2;  // the model's x/2
    const float im = 0.5f * im2;
    mag[(int64_t)r * half + bin] = sqrtf(fmaxf(re * re + im * im, 1e-36f));
    phs[(int64_t)r * half + bin] = atan2f(im, re + 1e-7f);
  }
};

// ---------------------------------------------------------------- B
// One block: 64 batch rows x 128 trimmed output samples, K step 16 over the
// 2*half spectrum channels (re then im), looping over the frames that reach
// the tile. 256 threads as 16 x 16; thread (tx, ty) owns rows ty*4+i (i < 4)
// and samples 64*h + tx*4 + q (h < 2, q < 4): 32 accumulators, read from
// shared memory as float4s. The next step's magnitude, phase and weights are
// loaded into registers while this step's products run; the trig happens
// when they are staged.
constexpr int SY_BM = 64;
constexpr int SY_BN = 128;
constexpr int SY_BK = 16;
constexpr int SY_TM = 4;
constexpr int SY_TN = 8;
constexpr int SY_LDS = SY_BM + 4;  // padded row, still 16-byte aligned

__global__ void __launch_bounds__(256) synthesis_fwd_kernel(
    const float* __restrict__ mag, const float* __restrict__ phs,
    const float* __restrict__ w, float* __restrict__ out,
    int batch, int out_frames, int ft, int hop, int half, int out_len) {
  __shared__ __align__(16) float ss[SY_BK][SY_LDS];  // spectrum tile, channel-major
  __shared__ __align__(16) float ws[SY_BK][SY_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b0 = blockIdx.y * SY_BM;
  const int n0 = blockIdx.x * SY_BN;  // first trimmed output sample of the tile
  const int m0 = ft + n0;             // its position in the untrimmed buffer
  const int kdim = 2 * half;
  const int nck = (kdim + SY_BK - 1) / SY_BK;

  // frames t that reach [m0, m0 + SY_BN): t*hop <= m0 + SY_BN - 1 and
  // t*hop + ft > m0, i.e. t*hop > n0
  const int t_lo = n0 / hop + 1;
  int t_hi = (m0 + SY_BN - 1) / hop;
  if (t_hi > out_frames - 1) t_hi = out_frames - 1;
  const int steps = t_hi >= t_lo ? (t_hi - t_lo + 1) * nck : 0;

  // loads: this thread fetches channel s_c of rows tid/16 + 16*e, and W
  // elements tid + 256*e of the 16 x 128 tile
  const int s_c = tid % SY_BK;
  float m_reg[SY_TM], p_reg[SY_TM], w_reg[8];
  int c_cur = 0;
  auto fetch = [&](int step) {
    const int t = t_lo + step / nck;
    const int c0 = (step % nck) * SY_BK;
    const int c = c0 + s_c;
    c_cur = c;
#pragma unroll
    for (int e = 0; e < SY_TM; ++e) {
      const int b = b0 + tid / SY_BK + 16 * e;
      m_reg[e] = 0.f;
      p_reg[e] = 0.f;
      if (b < batch && c < kdim) {
        const int64_t o = ((int64_t)t * batch + b) * half + (c < half ? c : c - half);
        m_reg[e] = mag[o];
        p_reg[e] = phs[o];
      }
    }
    const int shift = m0 - t * hop;  // sample of frame t that lands on output n0
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = tid + 256 * e;
      const int cg = c0 + idx / SY_BN;
      const int j = shift + idx % SY_BN;
      const bool ok = cg < kdim && j >= 0 && j < ft;
      w_reg[e] = ok ? w[(int64_t)cg * ft + j] : 0.f;
    }
  };
  auto stash = [&]() {
    const bool is_re = c_cur < half;
#pragma unroll
    for (int e = 0; e < SY_TM; ++e)
      ss[s_c][tid / SY_BK + 16 * e] = is_re ? m_reg[e] * cosf(p_reg[e]) : m_reg[e] * sinf(p_reg[e]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = tid + 256 * e;
      ws[idx / SY_BN][idx % SY_BN] = w_reg[e];
    }
  };

  float acc[SY_TM][SY_TN];
#pragma unroll
  for (int i = 0; i < SY_TM; ++i)
#pragma unroll
    for (int j = 0; j < SY_TN; ++j) acc[i][j] = 0.f;

  if (steps > 0) {
    fetch(0);
    stash();
    __syncthreads();
  }
  for (int step = 0; step < steps; ++step) {
    const bool more = step + 1 < steps;
    if (more) fetch(step + 1);
#pragma unroll
    for (int kk = 0; kk < SY_BK; ++kk) {
      const float4 s4 = *reinterpret_cast<const float4*>(&ss[kk][ty * SY_TM]);
      const float4 w0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
      const float a[SY_TM] = {s4.x, s4.y, s4.z, s4.w};
      const float bv[SY_TN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < SY_TM; ++i)
#pragma unroll
        for (int j = 0; j < SY_TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < SY_TM; ++i) {
    const int b = b0 + ty * SY_TM + i;
    if (b >= batch) continue;
#pragma unroll
    for (int j = 0; j < SY_TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (n < out_len) out[(int64_t)b * out_len + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// xp (batch, lp) padded signal, not halved; w (ft, 2*half) stacked analysis
// weights; wp scratch (ft, 2*half rounded up to a multiple of 4); mag, phs
// (frames, batch, half) with frames = (lp - ft)/hop + 1. vec is 4 when hop,
// lp, ft and the pointers allow 16-byte copies, else 1.
int st_analysis_fwd(const void* xp, const void* w, void* wp, void* mag, void* phs,
                    int batch, int lp, int ft, int hop, int half, int frames, int vec,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = tc::pack((const float*)w, (float*)wp, ft, half, s);
  if (err) return err;
  AnalysisFwd p;
  p.xp = (const float*)xp;
  p.wp = (const float*)wp;
  p.batch = batch, p.lp = lp, p.ft = ft, p.hop = hop, p.half = half, p.frames = frames;
  p.ldc = tc::packed_width(half);
  p.mag = (float*)mag;
  p.phs = (float*)phs;
  return tc::launch(p, (int64_t)frames * batch, p.ldc, 1, vec, s);
}

// How many blocks of kernel A's product (16-byte loader) fit one SM at once,
// by the runtime's occupancy calculation; for reports.
int st_analysis_blocks_per_sm(void) {
  int blocks = 0;
  void (*kernel)(const AnalysisFwd, int, int) = tc::product<AnalysisFwd, 4>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, tc::THREADS,
                                                    tc::SMEM_BYTES) != cudaSuccess)
    return -1;
  return blocks;
}

// mag, phs (out_frames, batch, half) frame-major; w (2*half, ft) stacked
// synthesis weights with the conjugate mirror folded in; out (batch, out_len)
// with out_len = (out_frames - 1)*hop + ft - 2*ft.
int st_synthesis_fwd(const void* mag, const void* phs, const void* w, void* out,
                     int batch, int out_frames, int ft, int hop, int half, int out_len,
                     void* stream) {
  dim3 grid((unsigned)((out_len + SY_BN - 1) / SY_BN), (unsigned)((batch + SY_BM - 1) / SY_BM));
  synthesis_fwd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)mag, (const float*)phs, (const float*)w, (float*)out,
      batch, out_frames, ft, hop, half, out_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
