// Fused STFT analysis and iSTFT synthesis, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of signaltrain_tpu/ops/pallas_frontend.py:
//   A  st_analysis_fwd   <- _an_fwd_kernel (l.174-192), launched by
//                           _fused_analysis_fwd_impl (l.270-303)
//   B  st_synthesis_fwd  <- _syn_fwd_kernel (l.355-377), launched by
//                           _fused_synthesis_fwd_impl (l.448-475)
// The plain PyTorch versions are fused_analysis_reference and
// fused_synthesis_reference in signaltrain_tpu_torch/ops/cuda_frontend.py.
//
// What bounds them on an H100: both are f32 GEMMs with fused prologues and
// epilogues. The serving path is f32 and TF32 would miss the tolerances
// (magnitude 2e-5), so the tensor cores are out and the bound is the f32
// CUDA-core rate (67 TFLOP/s): at the flagship geometry A does
// 2*25*1024*1026 flops per window against ~0.35 MB of its own traffic,
// B 2*1026*5376 flops against ~0.05 MB. So both are bound by operations.
// The design answer here is a register-tiled SIMT GEMM: shared-memory tiles,
// every thread holding a block of accumulators, and the bytes that the XLA
// formulation sends through HBM (the framed signal, the spectrum, the
// untrimmed frames) never leave the SM:
//   A folds the framing into its loads (frame t of window b is the row of xp
//     at offset t*hop) and the magnitude/phase into its epilogue; each thread
//     keeps the re and im accumulators of the same bins together, so the
//     thread that finishes bin k has both.
//   B builds mag*cos(phs) and mag*sin(phs) as it stages the spectrum tile,
//     and writes the overlap-add as a gather: output sample m only sums the
//     frames t with t*hop <= m < t*hop+ft, so every output is owned by one
//     thread, the result is deterministic and no atomics are needed. Only the
//     trimmed output is computed.
// Faster versions (wgmma with split-f32 operands, TMA, warp specialisation)
// are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- A
// One block: 128 frame rows x 64 bins (re and im of each), K step 16.
// 256 threads as 16 x 16; thread (tx, ty) owns rows ty*8+i (i < 8) and bins
// tx*4+j (j < 4): 64 accumulators, read from shared memory as float4s. The
// next K step's operands are loaded into registers while this one's
// products run, so the global loads' latency hides behind the FMAs.
constexpr int AN_BM = 128;
constexpr int AN_BN = 64;
constexpr int AN_BK = 16;
constexpr int AN_TM = 8;
constexpr int AN_TN = 4;
constexpr int AN_LDA = AN_BM + 4;  // padded row, still 16-byte aligned

__global__ void __launch_bounds__(256) analysis_fwd_kernel(
    const float* __restrict__ xp, const float* __restrict__ w,
    float* __restrict__ mag, float* __restrict__ phs,
    int batch, int lp, int ft, int hop, int half, int frames) {
  __shared__ __align__(16) float as[AN_BK][AN_LDA];  // frame tile, k-major
  __shared__ __align__(16) float wr[AN_BK][AN_BN];
  __shared__ __align__(16) float wi[AN_BK][AN_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t rows = (int64_t)frames * batch;  // row r = t*batch + b (frame-major output)
  const int64_t row0 = (int64_t)blockIdx.x * AN_BM;
  const int bin0 = blockIdx.y * AN_BN;
  const int ldw = 2 * half;

  // loads: this thread fetches column a_k of frame rows tid/16 + 16*e, and
  // W elements tid + 256*e of the 16 x 64 re and im tiles
  const int a_k = tid % AN_BK;
  const float* a_src[AN_TM];
  bool a_ok[AN_TM];
#pragma unroll
  for (int e = 0; e < AN_TM; ++e) {
    const int64_t r = row0 + tid / AN_BK + 16 * e;
    a_ok[e] = r < rows;
    const int64_t t = a_ok[e] ? r / batch : 0;
    const int64_t b = a_ok[e] ? r % batch : 0;
    a_src[e] = xp + b * lp + t * hop;  // framing folded into the load address
  }
  float a_reg[AN_TM], wr_reg[4], wi_reg[4];
  auto fetch = [&](int k0) {
    const int k = k0 + a_k;
#pragma unroll
    for (int e = 0; e < AN_TM; ++e) a_reg[e] = (a_ok[e] && k < ft) ? a_src[e][k] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + 256 * e;
      const int kg = k0 + idx / AN_BN;
      const int bin = bin0 + idx % AN_BN;
      const bool ok = kg < ft && bin < half;
      wr_reg[e] = ok ? w[(int64_t)kg * ldw + bin] : 0.f;
      wi_reg[e] = ok ? w[(int64_t)kg * ldw + half + bin] : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int e = 0; e < AN_TM; ++e) as[a_k][tid / AN_BK + 16 * e] = a_reg[e] * 0.5f;  // the x/2
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + 256 * e;
      wr[idx / AN_BN][idx % AN_BN] = wr_reg[e];
      wi[idx / AN_BN][idx % AN_BN] = wi_reg[e];
    }
  };

  float acc_re[AN_TM][AN_TN];
  float acc_im[AN_TM][AN_TN];
#pragma unroll
  for (int i = 0; i < AN_TM; ++i)
#pragma unroll
    for (int j = 0; j < AN_TN; ++j) {
      acc_re[i][j] = 0.f;
      acc_im[i][j] = 0.f;
    }

  fetch(0);
  stash();
  __syncthreads();
  for (int k0 = 0; k0 < ft; k0 += AN_BK) {
    const bool more = k0 + AN_BK < ft;
    if (more) fetch(k0 + AN_BK);
#pragma unroll
    for (int kk = 0; kk < AN_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * AN_TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * AN_TM + 4]);
      const float4 r4 = *reinterpret_cast<const float4*>(&wr[kk][tx * AN_TN]);
      const float4 i4 = *reinterpret_cast<const float4*>(&wi[kk][tx * AN_TN]);
      const float a[AN_TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[AN_TN] = {r4.x, r4.y, r4.z, r4.w};
      const float bi[AN_TN] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
      for (int i = 0; i < AN_TM; ++i)
#pragma unroll
        for (int j = 0; j < AN_TN; ++j) {
          acc_re[i][j] = fmaf(a[i], br[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(a[i], bi[j], acc_im[i][j]);
        }
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }

  // epilogue: magnitude with the 1e-36 floor (edge frames give exactly
  // 1e-18) and phase atan2(im, re + 1e-7) (edge frames give exactly 0)
#pragma unroll
  for (int i = 0; i < AN_TM; ++i) {
    const int64_t r = row0 + ty * AN_TM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < AN_TN; ++j) {
      const int bin = bin0 + tx * AN_TN + j;
      if (bin >= half) continue;
      const float re = acc_re[i][j];
      const float im = acc_im[i][j];
      mag[r * half + bin] = sqrtf(fmaxf(re * re + im * im, 1e-36f));
      phs[r * half + bin] = atan2f(im, re + 1e-7f);
    }
  }
}

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
// weights; mag, phs (frames, batch, half) with frames = (lp - ft)/hop + 1.
int st_analysis_fwd(const void* xp, const void* w, void* mag, void* phs,
                    int batch, int lp, int ft, int hop, int half, int frames,
                    void* stream) {
  const int64_t rows = (int64_t)frames * batch;
  dim3 grid((unsigned)((rows + AN_BM - 1) / AN_BM), (unsigned)((half + AN_BN - 1) / AN_BN));
  analysis_fwd_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)xp, (const float*)w, (float*)mag, (float*)phs,
      batch, lp, ft, hop, half, frames);
  return (int)cudaGetLastError();
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
