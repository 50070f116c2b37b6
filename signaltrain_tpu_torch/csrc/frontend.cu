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
// B 2*1026*5376 (the frame samples that reach the trimmed output) against
// ~0.05 MB. So both are bound by operations. Both run their product on the
// tensor cores: the split-TF32 main loop of tc_product.cuh (three TF32 mma
// products per f32 product, as accurate as an f32 one, so the 2e-5 magnitude
// and 3e-4 waveform tolerances hold), fed by a cp.async ring of shared-memory
// stages. Their bound is 165 TFLOP/s of f32-accurate work.
//   A: framing is folded into the loads (frame t of window b is the row of xp
//     at offset t*hop) and the magnitude/phase into the epilogue: re and im of
//     a bin are neighbouring columns of the repacked weights, so the thread
//     that finishes bin k holds both. Kernel D's first product is the same
//     code, so it finds the spectrum A found, bit for bit.
//   B: three steps. An elementwise pass writes the spectrum (mag*cos(phs),
//     mag*sin(phs)) of the live frames once, interleaved like the repacked
//     weights (7 MB at batch 200, a few us); the frame product
//     frames = spec . w (tc::Frames, kernel D's frame product) runs over the
//     live frames only, those with samples inside the trimmed output (frames
//     1 .. OT-2); a gather writes the trimmed output, each sample owned by one
//     thread that adds the frames covering it in a fixed order (no atomics,
//     so the result is bit-equal from run to run). 7 frames x 200 windows are
//     88 output tiles against 264 resident blocks, so the product's K (the
//     2*half spectrum columns) is cut into slices by the rule of
//     cuda_frontend.k_slices and the gather adds them in order.

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
// spec[r, 2 * bin + part] = mag * (cos, sin)(phs) at frame-major row r + row0
// of the (frames, batch, half) magnitude and phase, for r < rows; the columns
// past 2 * half zero: the first operand of B's frame product.
__global__ void spectrum_rows(const float* __restrict__ mag, const float* __restrict__ phs,
                              float* __restrict__ spec, int64_t rows, int64_t row0, int half,
                              int ldc) {
  const int pairs = ldc / 2;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * pairs) return;
  const int64_t r = i / pairs;
  const int bin = (int)(i - r * pairs);
  float2 v = make_float2(0.f, 0.f);
  if (bin < half) {
    const int64_t o = (r + row0) * half + bin;
    float s, c;
    sincosf(phs[o], &s, &c);
    v = make_float2(mag[o] * c, mag[o] * s);
  }
  *reinterpret_cast<float2*>(spec + r * ldc + 2 * bin) = v;
}

int synthesis_spectrum(const float* mag, const float* phs, float* spec, int64_t rows,
                       int64_t row0, int half, cudaStream_t stream) {
  const int ldc = tc::packed_width(half);
  if (rows <= 0) return 0;
  spectrum_rows<<<tc::blocks(rows * (ldc / 2), 256), 256, 0, stream>>>(mag, phs, spec, rows,
                                                                       row0, half, ldc);
  return (int)cudaGetLastError();
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
  p.live_lo = 0, p.live_hi = lp;  // every sample
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
// with out_len = (out_frames - 1)*hop - ft. Scratch: wp (ft, ldc), spec (rows,
// ldc) and frames (nsplit, rows, ft), with ldc = 2*half rounded up to a
// multiple of 4 and rows = (out_frames - 2)*batch, the live frames. vec is 4
// when spec and wp allow 16-byte copies, else 1.
int st_synthesis_fwd(const void* mag, const void* phs, const void* w, void* wp, void* spec,
                     void* frames, void* out, int batch, int out_frames, int ft, int hop,
                     int half, int out_len, int nsplit, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int64_t rows = (int64_t)live * batch;
  int err = tc::pack_synthesis((const float*)w, (float*)wp, ft, half, s);
  if (err) return err;
  err = synthesis_spectrum((const float*)mag, (const float*)phs, (float*)spec, rows, batch,
                               half, s);
  if (err) return err;
  // live frame t's sample j lies at position (t + 1)*hop + j; the trimmed
  // output is [ft, ft + out_len)
  err = tc::launch(tc::Frames{(const float*)spec, (const float*)wp, (float*)frames, (int)rows, ft,
                              tc::packed_width(half), batch, hop, ft - hop, ft + out_len - hop},
                   rows, ft, nsplit, vec, s);
  if (err) return err;
  return tc::gather((const float*)frames, (float*)out, batch, out_len, ft, ft, hop, 1, live,
                    nsplit, 1.f, s);
}

}  // extern "C"
