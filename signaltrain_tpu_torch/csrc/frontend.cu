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
// Each has two modes, the JAX kernels' compute_dtype: float32 (the split-TF32
// product below) and bfloat16, where the operands that the JAX kernel casts
// are rounded to bf16 (to nearest even) by the pass that writes them and the
// product runs on the bf16 tensor cores with f32 accumulation (tc_product.cuh):
// A rounds the halved frame (_an_fwd_kernel l.181-183: a pass writes
// bf16(0.5 * xp)) and the weights (the call's w.astype, l.302: the pack); B
// rounds its spectrum after the trig (l.371) and the weights (l.474). The
// magnitude, phase, trig and overlap-add stay in f32, as in JAX. In bf16 both
// are bound by operations at the 989 TFLOP/s dense bf16 rate only at large
// batch; at batch 200 B's bound is its bytes.
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
//     that finishes bin k holds both. Kernel D's first product on the same
//     loop is the same code, so it finds the spectrum A found, bit for bit.
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
//
// The bf16 modes have two schedules (cuda_frontend.schedule_for): the
// mma.sync loop above, and the wgmma one at the end of this file, on
// wgmma_product.cuh (TMA into a ring of 128-byte-swizzled stages, two
// consumer warpgroups on wgmma.mma_async, persistent blocks, no K slices).
// At the dense bf16 rate (989 TFLOP/s) and 3.35 TB/s, A is bound by
// operations (batch 200: 10.5 GFLOP, 0.0106 ms, against 33 MB in and out,
// 0.0098 ms; the operations grow their lead above batch 200) and B at
// batch 200 by bytes (11.6 MB, 0.0035 ms: magnitude and phase of the live
// frames, the weights and the output; its products over the live frames
// 0.0022 ms). Neither comes near either bound: what holds the wgmma products
// back is the hand-over between TMA and the consumers (wgmma_product.cuh's
// note), so the design moves the fewest bytes through it and adds no pass:
//   A: kernel D's spectrum product itself (wg::FrameSpectrum, 128-column
//     tiles of 128 padded rows R = t * bpad + b, the frames read through a
//     3-D tensor map), with AnalysisFwd's magnitude and phase as its
//     epilogue, staged in shared memory so that a warp writes contiguous
//     bins. The same instance, K steps and pieces as D's: the spectrum A
//     finds on this schedule is the one D's wgmma schedule forms again.
//   B: kernel D's frame product (wg::RowProduct: the spectrum rows and the
//     packed weights both K-major) in 128 x 128 tiles: 11 x 8 = 88 tiles at
//     batch 200 (0.67 of a wave on 132 SMs), 36 x 8 = 288 at 643 windows
//     (2.2 waves). The frames (rows, ft) are written once in f32 and the
//     gather adds one slice. 128 x 64 tiles (176 at batch 200) read the
//     spectrum twice as often: the product took 0.0224 ms against 0.0155.
// Two consumer schedules were built and measured on both and not kept
// (PERF.md, section 6): alternate 64-row tiles, one warpgroup's epilogue beside
// the other's products (A's product 0.0902 ms against 0.0925 at batch 200,
// 0.2190-0.2277 against 0.2150 at 643; B's 0.0226 against 0.0155), and each
// tile's epilogue drained a share a K step beside the next tile's products
// (A 0.0927-0.0932 against 0.0925; B 0.0185 against 0.0153).
//
// The float32 modes have the wgmma schedule too, on the split-TF32 products
// of wgmma_product.cuh (bound: 165 TFLOP/s of f32-accurate work, three TF32
// products at the dense 495):
//   A (the rule takes it where ft, hop and lp are multiples of 4 floats and
//     xp is 16-byte aligned): the same epilogue on wg::FrameSpectrum32, which
//     reads the frames of xp itself through a 3-D map of floats and splits
//     them in registers, against the planes hi, lo of the packed weights'
//     transpose (ldc, ft) that tc::pack_split_t writes (TF32 wgmma reads its
//     shared-memory operand K-major only); the model's x/2 is applied to the
//     finished sums, as on the mma.sync loop.
//   B (at every geometry, as in bf16: it reads no frames through TMA): the
//     same three passes, the spectrum rows in f32 and the frame product on
//     wg::RowProduct32 (the rows split in registers, one 128-row box a step;
//     the planes (ft, ldc) of the packed synthesis weights that
//     tc::pack_split_synthesis writes), 128 x 128 tiles, no K slices. K is
//     ldc: at the flagship geometry 1,028 columns are 33 steps of 32, the last
//     holding the Nyquist bin's two columns and two of zeros (the maps read
//     zeros past ldc); bounding K by 2 * half would not save that step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_product.cuh"
#include "wgmma_product.cuh"

namespace {

// ---------------------------------------------------------------- A
// The spectrum product of tc_product.cuh; a finished (re, im) pair, times
// `scale` (the model's x/2 where the products read the unhalved signal),
// becomes the magnitude with the 1e-36 floor (edge frames give exactly 1e-18)
// and the phase atan2(im, re + 1e-7) (edge frames give exactly 0).
template <class T>
struct AnalysisFwd : tc::Spectrum<T> {
  float* mag;
  float* phs;
  float scale;
  __device__ void pair(int r, int n, float re2, float im2, int) const {
    const int bin = n >> 1;
    if (r >= this->frames * this->batch || bin >= this->half) return;
    const float re = scale * re2;
    const float im = scale * im2;
    mag[(int64_t)r * this->half + bin] = sqrtf(fmaxf(re * re + im * im, 1e-36f));
    phs[(int64_t)r * this->half + bin] = atan2f(im, re + 1e-7f);
  }
};

template <class T>
int analysis_fwd(const float* xp, const float* w, T* xq, T* wp, float* mag, float* phs, int batch,
                 int lp, int ft, int hop, int half, int frames, int vec, cudaStream_t s) {
  int err = tc::pack(w, wp, ft, half, s);
  if (err) return err;
  AnalysisFwd<T> p;
  err = tc::signal(xp, xq, (int64_t)batch * lp, &p.xp, s);
  if (err) return err;
  p.wp = wp;
  p.batch = batch, p.lp = lp, p.ft = ft, p.hop = hop, p.half = half, p.frames = frames;
  p.ldc = tc::packed_width<T>(half);
  p.live_lo = 0, p.live_hi = lp;  // every sample
  p.mag = mag;
  p.phs = phs;
  p.scale = tc::SIGNAL_SCALE<T>;
  return tc::launch(p, (int64_t)frames * batch, p.ldc, 1, vec, s);
}

// ---------------------------------------------------------------- B
// spec[r, 2 * bin + part] = mag * (cos, sin)(phs) at frame-major row r + row0
// of the (frames, batch, half) magnitude and phase, for r < rows, in the
// operand type (bf16: rounded after the trig, as the JAX kernel rounds
// `spec.astype(compute_dtype)`); the columns past 2 * half zero: the first
// operand of B's frame product.
template <class T>
__global__ void spectrum_rows(const float* __restrict__ mag, const float* __restrict__ phs,
                              T* __restrict__ spec, int64_t rows, int64_t row0, int half,
                              int ldc) {
  const int pairs = ldc / 2;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * pairs) return;
  const int64_t r = i / pairs;
  const int bin = (int)(i - r * pairs);
  float re = 0.f, im = 0.f;
  if (bin < half) {
    const int64_t o = (r + row0) * half + bin;
    float s, c;
    sincosf(phs[o], &s, &c);
    re = mag[o] * c;
    im = mag[o] * s;
  }
  tc::store2(spec + r * ldc + 2 * bin, re, im);
}

template <class T>
int synthesis_fwd(const float* mag, const float* phs, const float* w, T* wp, T* spec,
                  float* frames, float* out, int batch, int out_frames, int ft, int hop, int half,
                  int out_len, int nsplit, int vec, cudaStream_t s) {
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int64_t rows = (int64_t)live * batch;
  const int ldc = tc::packed_width<T>(half);
  int err = tc::pack_synthesis(w, wp, ft, half, s);
  if (err) return err;
  if (rows > 0) {
    spectrum_rows<T><<<tc::blocks(rows * (ldc / 2), 256), 256, 0, s>>>(mag, phs, spec, rows,
                                                                       batch, half, ldc);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  // live frame t's sample j lies at position (t + 1)*hop + j; the trimmed
  // output is [ft, ft + out_len)
  err = tc::launch(tc::Frames<T>{spec, wp, frames, (int)rows, ft, ldc, batch, hop, ft - hop,
                                 ft + out_len - hop},
                   rows, ft, nsplit, vec, s);
  if (err) return err;
  return tc::gather(frames, out, batch, out_len, ft, ft, hop, 1, live, nsplit, 1.f, s);
}

// ======================================================= the wgmma schedule
// The bf16 modes of A and B on wgmma_product.cuh: the same passes around the
// products (tc::pack / pack_synthesis, halve_to_bf16, spectrum_rows,
// tc::gather) and the same arithmetic in the epilogues, but no K slices.

// A: kernel D's spectrum product (wg::FrameSpectrum over the frames of the
// halved bf16 signal, padded rows R = t * bpad + b, 128-column tiles), its
// finished (re, im) pairs made magnitude and phase as AnalysisFwd makes them;
// padding rows and columns past 2 * half write nothing. In float32 the same
// on wg::FrameSpectrum32 (the frames of xp itself, split in registers, and
// the split planes of W^T), with the model's x/2 on the finished sums.
template <class Product>
struct AnalysisFwdT : Product {
  float* mag;
  float* phs;
  int batch, half;
  float scale;  // 1 in bf16 (the frames were halved), 0.5 in float32
  __device__ void pair(int r, int n, float re2, float im2, wg::NoAux) const {
    const int t = r / this->bpad, b = r - t * this->bpad, bin = n >> 1;
    if (r >= this->m || b >= batch || bin >= half) return;
    const float re = scale * re2, im = scale * im2;
    const int64_t at = ((int64_t)t * batch + b) * half + bin;
    mag[at] = sqrtf(fmaxf(re * re + im * im, 1e-36f));
    phs[at] = atan2f(im, re + 1e-7f);
  }
};
using AnalysisFwdW = AnalysisFwdT<wg::FrameSpectrum<128>>;
using AnalysisFwdW32 = AnalysisFwdT<wg::FrameSpectrum32<128>>;

int analysis_fwd_wgmma(const float* xp, const float* w, tc::bf16* xq, tc::bf16* wp, float* mag,
                       float* phs, int batch, int lp, int ft, int hop, int half, int frames,
                       cudaStream_t s) {
  int err = tc::pack(w, wp, ft, half, s);
  if (err) return err;
  const tc::bf16* signal;
  if ((err = tc::signal(xp, xq, (int64_t)batch * lp, &signal, s))) return err;
  AnalysisFwdW p;
  p.m = frames * wg::pad_rows(batch), p.n = tc::packed_width<tc::bf16>(half);
  if ((err = wg::frames_map(&p.frames, signal, ft, batch, frames, lp, hop))) return err;
  if ((err = wg::matrix_map(&p.w, wp, ft, p.n))) return err;
  p.bpad = wg::pad_rows(batch), p.ft = ft, p.hop = hop, p.live_lo = 0, p.live_hi = lp;
  p.mag = mag, p.phs = phs, p.batch = batch, p.half = half, p.scale = 1.f;
  return wg::launch(p, s);
}

// float32: the frames of xp itself (16-byte aligned, hop, lp and ft
// multiples of 4) and W^T's split planes wt_hi, wt_lo (ldc, ft).
int analysis_fwd_wgmma32(const float* xp, const float* w, float* wt_hi, float* wt_lo, float* mag,
                         float* phs, int batch, int lp, int ft, int hop, int half, int frames,
                         cudaStream_t s) {
  int err = tc::pack_split_t(w, wt_hi, wt_lo, ft, half, s);
  if (err) return err;
  AnalysisFwdW32 p;
  p.m = frames * wg::pad_rows(batch), p.n = tc::packed_width<float>(half);
  if ((err = wg::frames_map32(&p.frames, xp, ft, batch, frames, lp, hop))) return err;
  if ((err = wg::split_maps(&p, wt_hi, wt_lo, p.n, ft))) return err;
  p.bpad = wg::pad_rows(batch), p.ft = ft, p.hop = hop, p.live_lo = 0, p.live_hi = lp;
  p.mag = mag, p.phs = phs, p.batch = batch, p.half = half, p.scale = tc::SIGNAL_SCALE<float>;
  return wg::launch(p, s);
}

// B: the live frames' samples frames[r, j] = sum_c spec[r, c] * wp[j, c]
// (kernel D's DxFramesW product: spec and the packed weights both K-major,
// rows r = t * batch + b of the live frames), written once in f32 for the
// overlap-add.
template <class Product>
struct SynthesisFrames : Product {
  float* frames;
  int ft;
  __device__ void pair(int r, int j, float v0, float v1, wg::NoAux) const {
    if (r >= this->m || j >= ft) return;
    float* dst = frames + (int64_t)r * ft + j;
    if (j + 1 < ft && !(ft & 1)) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);  // ft even: aligned
    } else {
      dst[0] = v0;
      if (j + 1 < ft) dst[1] = v1;
    }
  }
};
using SynthesisFramesW = SynthesisFrames<wg::RowProduct<128>>;

// float32: the spectrum rows split in registers, the planes of the packed
// synthesis weights (ft, ldc).
using SynthesisFramesW32 = SynthesisFrames<wg::RowProduct32<128>>;

int synthesis_fwd_wgmma(const float* mag, const float* phs, const float* w, tc::bf16* wp,
                        tc::bf16* spec, float* frames, float* out, int batch, int out_frames,
                        int ft, int hop, int half, int out_len, cudaStream_t s) {
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int rows = live * batch;
  const int ldc = tc::packed_width<tc::bf16>(half);
  int err = tc::pack_synthesis(w, wp, ft, half, s);
  if (err) return err;
  if (rows <= 0)  // no frame reaches the trimmed output
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * batch * out_len, s);
  spectrum_rows<tc::bf16><<<tc::blocks((int64_t)rows * (ldc / 2), 256), 256, 0, s>>>(
      mag, phs, spec, rows, batch, half, ldc);
  if ((err = (int)cudaGetLastError())) return err;
  SynthesisFramesW p;
  p.m = rows, p.n = ft;
  if ((err = wg::matrix_map(&p.d, spec, rows, ldc))) return err;
  if ((err = wg::matrix_map(&p.w, wp, ft, ldc))) return err;
  p.k = ldc, p.frames = frames, p.ft = ft;
  if ((err = wg::launch(p, s))) return err;
  return tc::gather(frames, out, batch, out_len, ft, ft, hop, 1, live, 1, 1.f, s);
}

int synthesis_fwd_wgmma32(const float* mag, const float* phs, const float* w, float* wp_hi,
                          float* wp_lo, float* spec, float* frames, float* out, int batch,
                          int out_frames, int ft, int hop, int half, int out_len, cudaStream_t s) {
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int rows = live * batch;
  const int ldc = tc::packed_width<float>(half);
  int err = tc::pack_split_synthesis(w, wp_hi, wp_lo, ft, half, false, s);
  if (err) return err;
  if (rows <= 0)  // no frame reaches the trimmed output
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * batch * out_len, s);
  spectrum_rows<float><<<tc::blocks((int64_t)rows * (ldc / 2), 256), 256, 0, s>>>(
      mag, phs, spec, rows, batch, half, ldc);
  if ((err = (int)cudaGetLastError())) return err;
  SynthesisFramesW32 p;
  p.m = rows, p.n = ft;
  if ((err = wg::matrix_map32(&p.d, spec, rows, ldc, wg::BM))) return err;
  if ((err = wg::split_maps(&p, wp_hi, wp_lo, ft, ldc))) return err;
  p.k = ldc, p.frames = frames, p.ft = ft;
  if ((err = wg::launch(p, s))) return err;
  return tc::gather(frames, out, batch, out_len, ft, ft, hop, 1, live, 1, 1.f, s);
}

template <class T>
int blocks_per_sm() {
  using S = tc::Smem<T>;
  void (*kernel)(const AnalysisFwd<T>, int, int) = tc::product<AnalysisFwd<T>, S::WIDE>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, tc::THREADS, S::BYTES) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" {

const char* st_error_string(int code) {
  if (code >= wg::ENCODE_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// xp (batch, lp) padded signal, not halved; w (ft, 2*half) stacked analysis
// weights; mag, phs (frames, batch, half) with frames = (lp - ft)/hop + 1.
// bf16 selects the compute dtype: 0 float32 (split TF32), 1 bfloat16. Scratch
// in that dtype: wp (ft, ldc), ldc = 2*half rounded up to a multiple of 16
// bytes, and for bf16 xq (batch, lp), the halved and rounded signal (null for
// float32). vec, elements a copy: 16 bytes' worth when hop, lp, ft and the
// pointers allow, else 1.
int st_analysis_fwd(const void* xp, const void* w, void* xq, void* wp, void* mag, void* phs,
                    int batch, int lp, int ft, int hop, int half, int frames, int vec, int bf16,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return analysis_fwd((const float*)xp, (const float*)w, (tc::bf16*)xq, (tc::bf16*)wp,
                        (float*)mag, (float*)phs, batch, lp, ft, hop, half, frames, vec, s);
  return analysis_fwd((const float*)xp, (const float*)w, (float*)nullptr, (float*)wp, (float*)mag,
                      (float*)phs, batch, lp, ft, hop, half, frames, vec, s);
}

// How many blocks of kernel A's product (16-byte loader) fit one SM at once,
// by the runtime's occupancy calculation, in float32 (bf16 = 0) or bfloat16
// (bf16 = 1); for reports.
int st_analysis_blocks_per_sm(int bf16) {
  return bf16 ? blocks_per_sm<tc::bf16>() : blocks_per_sm<float>();
}

// mag, phs (out_frames, batch, half) frame-major; w (2*half, ft) stacked
// synthesis weights with the conjugate mirror folded in; out (batch, out_len)
// with out_len = (out_frames - 1)*hop - ft. bf16 as for st_analysis_fwd.
// Scratch, in the compute dtype: wp (ft, ldc) and spec (rows, ldc), with ldc
// = 2*half rounded up to a multiple of 16 bytes and rows = (out_frames -
// 2)*batch, the live frames; in float32: frames (nsplit, rows, ft). vec,
// elements a copy: 16 bytes' worth when spec and wp allow, else 1.
int st_synthesis_fwd(const void* mag, const void* phs, const void* w, void* wp, void* spec,
                     void* frames, void* out, int batch, int out_frames, int ft, int hop,
                     int half, int out_len, int nsplit, int vec, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return synthesis_fwd((const float*)mag, (const float*)phs, (const float*)w, (tc::bf16*)wp,
                         (tc::bf16*)spec, (float*)frames, (float*)out, batch, out_frames, ft,
                         hop, half, out_len, nsplit, vec, s);
  return synthesis_fwd((const float*)mag, (const float*)phs, (const float*)w, (float*)wp,
                       (float*)spec, (float*)frames, (float*)out, batch, out_frames, ft, hop,
                       half, out_len, nsplit, vec, s);
}

// The bf16 mode of st_analysis_fwd on the wgmma schedule (wgmma_product.cuh),
// for geometries whose hop, lp and ft are multiples of 8 (16 bytes). Scratch,
// in bf16, as for st_analysis_fwd: xq (batch, lp), wp (ft, ldc).
int st_analysis_fwd_wgmma(const void* xp, const void* w, void* xq, void* wp, void* mag, void* phs,
                          int batch, int lp, int ft, int hop, int half, int frames, void* stream) {
  return analysis_fwd_wgmma((const float*)xp, (const float*)w, (tc::bf16*)xq, (tc::bf16*)wp, (float*)mag,
             (float*)phs, batch, lp, ft, hop, half, frames, (cudaStream_t)stream);
}

// The float32 mode of st_analysis_fwd on the wgmma schedule (split TF32 on
// wgmma_product.cuh), for geometries whose hop, lp and ft are multiples of 4
// (16 bytes) and a 16-byte aligned xp. Scratch, in float32, with ldc =
// 2*half rounded up to a multiple of 4: wt_hi, wt_lo (ldc, ft), the split
// planes of the packed weights' transpose.
int st_analysis_fwd_wgmma_f32(const void* xp, const void* w, void* wt_hi, void* wt_lo, void* mag,
                              void* phs, int batch, int lp, int ft, int hop, int half, int frames,
                              void* stream) {
  return analysis_fwd_wgmma32((const float*)xp, (const float*)w, (float*)wt_hi, (float*)wt_lo,
                              (float*)mag, (float*)phs, batch, lp, ft, hop, half, frames,
                              (cudaStream_t)stream);
}

// The bf16 mode of st_synthesis_fwd on the wgmma schedule, for any geometry
// (its operands are rows of ldc bf16, 16-byte multiples). Scratch, in bf16:
// wp (ft, ldc), spec (rows, ldc); in float32 frames (rows, ft), rows =
// (out_frames - 2)*batch. No K slices.
int st_synthesis_fwd_wgmma(const void* mag, const void* phs, const void* w, void* wp, void* spec,
                           void* frames, void* out, int batch, int out_frames, int ft, int hop,
                           int half, int out_len, void* stream) {
  return synthesis_fwd_wgmma((const float*)mag, (const float*)phs, (const float*)w, (tc::bf16*)wp,
             (tc::bf16*)spec, (float*)frames, (float*)out, batch, out_frames, ft, hop, half,
             out_len, (cudaStream_t)stream);
}

// The float32 mode of st_synthesis_fwd on the wgmma schedule (split TF32 on
// wgmma_product.cuh), for any geometry (its operands are rows of ldc floats,
// 16-byte multiples). Scratch, in float32, with ldc = 2*half rounded up to a
// multiple of 4 and rows = (out_frames - 2)*batch: wp_hi, wp_lo (ft, ldc),
// the split planes of the packed synthesis weights; spec (rows, ldc); frames
// (rows, ft). No K slices.
int st_synthesis_fwd_wgmma_f32(const void* mag, const void* phs, const void* w, void* wp_hi,
                               void* wp_lo, void* spec, void* frames, void* out, int batch,
                               int out_frames, int ft, int hop, int half, int out_len,
                               void* stream) {
  return synthesis_fwd_wgmma32((const float*)mag, (const float*)phs, (const float*)w,
                               (float*)wp_hi, (float*)wp_lo, (float*)spec, (float*)frames,
                               (float*)out, batch, out_frames, ft, hop, half, out_len,
                               (cudaStream_t)stream);
}

}  // extern "C"
