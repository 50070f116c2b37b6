// Backward of the fused STFT analysis and iSTFT synthesis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of signaltrain_tpu/ops/pallas_frontend.py:
//   D  st_analysis_bwd   <- _an_bwd_kernel (l.195-254), launched by
//                           _fused_analysis_bwd (l.312-345, pallas_call l.326)
//   E  st_synthesis_bwd  <- _syn_bwd_kernel (l.380-433), launched by
//                           _fused_synthesis_bwd (l.484-523, pallas_call l.499)
// The plain PyTorch versions are fused_analysis_bwd_reference and
// fused_synthesis_bwd_reference in signaltrain_tpu_torch/ops/cuda_frontend.py.
//
// What they compute. D, from the saved (xp, w) and the cotangents (dmag, dphs):
// the spectrum of every frame again (bit-equal to kernel A's: same products in
// the same order), (dmag, dphs) -> (d_re, d_im) with a zero magnitude term
// under the 1e-36 floor and plain division in the atan2 adjoint, then
//   dxp[b, n] = 0.5 * sum over frames t that cover n of dspec[t, b, :] . w[n - t*hop, :]
//   dw[j, c]  = sum over all (t, b) of 0.5 * xp[b, t*hop + j] * dspec[t, b, c].
// E, from the saved (mag, phs, w) and dout: dframe[t, b, j] is dout padded by
// ft zeros on both sides, read at t*hop + j;
//   dspec[t, b, c] = sum_j dframe[t, b, j] * w[c, j]
//   dmag = d_re*cos + d_im*sin,  dphs = mag*(d_im*cos - d_re*sin)
//   dw[c, j] = sum over (t, b) of spec[t, b, c] * dframe[t, b, j],
// with spec = (mag*cos, mag*sin).
//
// Each has two modes, the JAX kernels' compute_dtype: float32 (split TF32)
// and bfloat16, where every operand the JAX kernel casts is rounded to bf16
// (to nearest even) by the pass that writes it and the products run on the
// bf16 tensor cores with f32 accumulation (tc_product.cuh). D recomputes the
// spectrum from the bf16 frame bf16(0.5 * xp) and bf16 weights (l.215-216),
// forms dspec in f32 and rounds it once (l.239) for its dxp and dW products;
// dW is the bf16 frame's product with it, so no 0.5 is left for the sum. E
// rounds its padded dframe (l.402), and the spectrum for dW after the trig
// (l.424). Weights are rounded by the pack (the calls' w.astype, l.344, 522).
//
// What bounds them on an H100: f32-accurate matrix products with fused
// prologues and epilogues (D three of 2*B*T*ft*2*half flops, E two over the
// frame samples that reach the trimmed output), against a few tens of MB of
// traffic: operations, not bytes. dspec's trip through device memory between
// D's products (20.5 MB at batch 200, written once and read twice) is ~18 us
// at 3.35 TB/s, a few percent of D; the product rate is what counts.
//
// Every product of D and E runs on the tensor cores through the split-TF32
// main loop of tc_product.cuh (as accurate as f32, bound 165 TFLOP/s of
// f32-accurate work, cp.async ring, 128 x 128 tiles); each instance only says
// how an operand element is addressed and what happens to a finished pair of
// columns. Every load is bounds-checked to an exact 0 (cp.async zero fill).
//
// The design of D:
//   * the first product is kernel A's (tc::Spectrum, the same code, so the
//     spectrum is A's bit for bit and `sq >= 1e-36` decides as the forward
//     did); re and im of a bin are neighbouring columns, so one thread holds
//     both for the magnitude / phase adjoints. dspec is written in that
//     interleaved order, (rows, ldc) with ldc = 2*half rounded up to a
//     multiple of 4 and zeros in the padding columns, so that every later
//     16-byte copy of it is aligned;
//   * framing of the input stays an address offset (xp + b*lp + t*hop + j):
//     no framed copy of xp exists;
//   * dxp comes from the gradient of every frame, dframes = dspec . w^T
//     (tc::Frames), and the overlap-add gather tc::gather: a sample is owned
//     by one thread, which adds the frames that cover it in order. dframes
//     (B*T, ft) exists only when dxp is asked for (training does not);
//   * dW (FrameDw) sums over all (t, b) rows as one flat K. The TPU kernel
//     adds each grid step's dW into one buffer, serially. Here every dW tile
//     is owned by one block per K slice: the rows are cut into `nsplit`
//     contiguous slices (as many as keep all blocks on the card at once), each
//     block writes its partial tile to scratch, and a second pass adds the
//     slices in a fixed order (tc::sum_slices) and undoes the interleave. No
//     atomics, so dW is bit-equal from run to run.
// The design of E: the same patterns on the padded output gradient.
//   * dout is copied once into doutp (B, out_len + 2*ft) with zero margins, so
//     that a frame is an address offset as in A (3.3 MB at batch 200). Only
//     the live frames 1 .. OT-2 are read: frames 0 and OT-1 lie wholly in the
//     trimmed margin and their dmag / dphs are written as exact zeros;
//   * dspec = dframe . w^T is tc::Spectrum on doutp (offset by one hop) with
//     the synthesis weights packed transposed and interleaved (ft, ldc), so
//     that d_re and d_im of a bin are neighbouring columns. 7 frames x 200
//     windows are only 99 output tiles, so K (the frame sample) is cut into
//     slices and the pass that adds them in order also forms dmag and dphs;
//   * dW^T[j, c] = sum over (t, b) of dframe[t, b, j] * spec[t, b, c] is D's
//     FrameDw with doutp for xp and the spectrum (written by the dmag / dphs
//     pass, which has the sine and cosine at hand) for dspec, no 1/2; its
//     ordered pass adds the K slices and writes the (2*half, ft) transpose
//     through shared memory.
// K slices come from one rule for every product, cuda_frontend.k_slices.
//
// The bf16 modes have a second schedule, on wgmma_product.cuh (TMA into a
// ring of swizzled shared-memory stages, wgmma, persistent blocks): the same
// products with their epilogues (D: the spectrum and dspec, the frame
// gradients for dxp, dW written straight from the accumulators; E: dspec
// with dmag / dphs and the spectrum in its epilogue, dW transposed from the
// accumulators), no K slices and so no partials and no pass to add them
// (synthesis_adjoint, sum_*_partials are the mma.sync schedule's). The
// wrapper picks it by a rule on the shape (cuda_frontend.uses_wgmma: every
// frame offset a multiple of 16 bytes, which TMA needs); other shapes run
// the mma.sync loop above. The float32 modes have the wgmma schedule too,
// on the split-TF32 products of wgmma_product.cuh, under the same rule on
// the floats (D: xp 16-byte aligned besides; E reads only its own scratch).
// D's spectrum pass (wg::FrameSpectrum32) forms dspec in f32 and writes it
// twice when asked, in rows for dxp's frame product (wg::RowProduct32,
// against the split planes of W) and transposed, split into hi and lo
// planes, for dW (wg::FrameGrad32, whose A, the frames, is read M-major into
// registers): TF32 wgmma reads its shared-memory operand K-major only, and
// the transpose costs the epilogue one more walk over its staged tile
// instead of a pass. E's dspec pass (wg::FrameSpectrum32 on the padded dout,
// against the planes (ldc, ft) of the synthesis weights, whose rows are w's
// rows interleaved) forms dmag / dphs in its epilogue as in bf16 and writes
// the spectrum (mag*cos, mag*sin) the same way, transposed and split, for dW
// (wg::FrameGrad32 on the frames of the padded dout). No K slices, so no
// sum_analysis_partials, synthesis_adjoint or sum_synthesis_partials.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_product.cuh"
#include "wgmma_product.cuh"

namespace {

// ------------------------------------------------------------------ D, part 1
// The spectrum again (tc::Spectrum), then (dmag, dphs) -> dspec, interleaved,
// in the operand type (bf16: dspec is formed in f32 and rounded once, as the
// JAX kernel rounds `dspec.astype(compute_dtype)`).
template <class T>
struct AnalysisDspec : tc::Spectrum<T> {
  const float* dmag;
  const float* dphs;
  T* dspec;
  float scale;  // the model's x/2 where the products read the unhalved signal
  __device__ void pair(int r, int n, float re2, float im2, int) const {
    if (r >= this->frames * this->batch || n >= this->ldc) return;
    float d_re = 0.f, d_im = 0.f;  // the padding columns stay zero
    const int bin = n >> 1;
    const int half = this->half;
    if (bin < half) {
      const float re = scale * re2;
      const float im = scale * im2;
      const float dm = dmag[(int64_t)r * half + bin];
      const float dp = dphs[(int64_t)r * half + bin];
      // mag = sqrt(max(sq, 1e-36)): no gradient under the floor
      const float sq = re * re + im * im;
      const float gm = sq >= 1e-36f ? dm / sqrtf(fmaxf(sq, 1e-36f)) : 0.f;
      // phs = atan2(im, re + 1e-7)
      const float rr = re + 1e-7f;
      const float den = rr * rr + im * im;
      d_re = gm * re - dp * im / den;
      d_im = gm * im + dp * rr / den;
    }
    tc::store2(dspec + (int64_t)r * this->ldc + n, d_re, d_im);
  }
};

// ------------------------------------------------------------------ D, part 2
// dframes[r, j] = sum over channels c of dspec[r, c] * wp[j, c] (tc::Frames),
// the gradient of every frame; dxp is its overlap-add (tc::gather). (One
// product whose K runs over the covering frames too would spare dframes' trip
// through device memory, ~20 MB at batch 200 or ~10 us, but a 128-sample tile
// is covered by 3 frames where a sample is covered by 2.67, and 200 windows
// fill 2 tiles of 128 rows by 78%: it did 58% more work and took 0.47 ms
// against 0.29.)

// ------------------------------------------------------ D, part 3 and E, part 2
// partial[z][j, c] = sum over the rows r = t*batch + b of slice z of
// xp[b, t*hop + j] * spec[r, c] (c interleaved). K is the flat row index.
// D: xp the signal operand (tc::signal), spec its dspec (in f32 the x/2 is
// applied by the second pass). E: xp the padded output gradient from the
// first live frame on, spec the spectrum of the live frames; a tile of
// samples j takes only the K steps of the frames with a live sample among
// them (tc_product.cuh, live samples).
template <class T_>
struct FrameDw {
  using T = T_;
  static constexpr bool A_KFAST = false;
  static constexpr bool B_KFAST = false;
  const T* xp;
  const T* spec;
  float* partial;
  int batch, lp, ft, hop, frames, ldc, live_lo, live_hi;
  struct Tile {
    int s0;  // first K step of the tile
  };
  struct Step {
    int r0;  // first row of the step, = t0 * batch + b0
    int t0;
    int b0;
  };
  __device__ int begin_tile(Tile& tile, int j0, int) const {
    // frames t with t*hop + j in [live_lo, live_hi) for some j of the tile
    const int t_lo = max(0, -tc::floor_div(j0 + tc::TILE - 1 - live_lo, hop));
    const int t_hi = min(frames - 1, tc::floor_div(live_hi - 1 - j0, hop));
    if (t_hi < t_lo) return 0;
    tile.s0 = t_lo * batch / tc::BK;
    return ((t_hi + 1) * batch + tc::BK - 1) / tc::BK - tile.s0;
  }
  __device__ int row_a(const Tile&, int j) const { return j; }
  __device__ int col_b(const Tile&, int c) const { return c; }
  __device__ void begin_step(const Tile& tile, int step, Step& st) const {
    st.r0 = (tile.s0 + step) * tc::BK;
    st.t0 = st.r0 / batch;  // the step's one division
    st.b0 = st.r0 - st.t0 * batch;
  }
  __device__ const T* src_a(int j, const Step& st, int kk, int& n) const {
    int t = st.t0, b = st.b0 + kk;
    while (b >= batch) {
      b -= batch;
      ++t;
    }
    n = st.r0 + kk < frames * batch ? ft - j : 0;
    return xp + (int64_t)b * lp + t * hop + j;
  }
  __device__ const T* src_b(int c, const Step& st, int kk, int& n) const {
    const int r = st.r0 + kk;
    n = r < frames * batch ? ldc - c : 0;
    return spec + (int64_t)r * ldc + c;
  }
  __device__ const T* base_a() const { return xp; }
  __device__ const T* base_b() const { return spec; }
  __device__ void pair(int j, int c, float v0, float v1, int z) const {
    if (j >= ft || c >= ldc) return;
    *reinterpret_cast<float2*>(partial + ((int64_t)z * ft + j) * ldc + c) = make_float2(v0, v1);
  }
};

// dw[j, part*half + bin] = scale * (partial[0] + partial[1] + ...)[j, 2*bin + part],
// the slices in that order for every run.
__global__ void sum_analysis_partials(const float* __restrict__ partial, float* __restrict__ dw,
                                      int ft, int half, int ldc, int nsplit, float scale) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)ft * 2 * half) return;
  const int j = (int)(i / (2 * half)), col = (int)(i % (2 * half));
  const int part = col >= half, bin = col - part * half;
  dw[i] = scale * tc::sum_slices(partial + (int64_t)j * ldc + 2 * bin + part, (int64_t)ft * ldc,
                                 nsplit);
}

template <class T>
int analysis_bwd(const float* xp, const float* w, const float* dmag, const float* dphs, T* xq,
                 T* wp, T* dspec, float* dw_partial, float* dframes, float* dxp, float* dw,
                 int batch, int lp, int ft, int hop, int half, int frames, int nsplit,
                 int need_dxp, int need_dw, int vec, cudaStream_t s) {
  const int ldc = tc::packed_width<T>(half);
  const int64_t rows = (int64_t)frames * batch;
  int err = tc::pack(w, wp, ft, half, s);
  if (err) return err;
  AnalysisDspec<T> p1;
  err = tc::signal(xp, xq, (int64_t)batch * lp, &p1.xp, s);
  if (err) return err;
  p1.wp = wp;
  p1.batch = batch, p1.lp = lp, p1.ft = ft, p1.hop = hop, p1.half = half, p1.frames = frames;
  p1.ldc = ldc;
  p1.live_lo = 0, p1.live_hi = lp;  // every sample
  p1.dmag = dmag;
  p1.dphs = dphs;
  p1.dspec = dspec;
  p1.scale = tc::SIGNAL_SCALE<T>;
  err = tc::launch(p1, rows, ldc, 1, vec, s);
  if (err) return err;
  if (need_dxp) {
    err = tc::launch(tc::Frames<T>{dspec, wp, dframes, (int)rows, ft, ldc, batch, hop, 0, lp},
                     rows, ft, 1, vec, s);
    if (err) return err;
    err = tc::gather(dframes, dxp, batch, lp, 0, ft, hop, 0, frames, 1, 0.5f, s);
    if (err) return err;
  }
  if (need_dw) {
    err = tc::launch(FrameDw<T>{p1.xp, dspec, dw_partial, batch, lp, ft, hop, frames, ldc, 0, lp},
                     ft, ldc, nsplit, vec, s);
    if (err) return err;
    const int64_t size = (int64_t)ft * 2 * half;
    sum_analysis_partials<<<tc::blocks(size, 256), 256, 0, s>>>(dw_partial, dw, ft, half, ldc,
                                                                nsplit, tc::SIGNAL_SCALE<T>);
    err = (int)cudaGetLastError();
  }
  return err;
}

// ------------------------------------------------------------------ E, part 1
// doutp[b, p] = dout[b, p - ft] inside the trimmed output, 0 in the margins,
// in the operand type (bf16: the JAX kernel's `dframe.astype(compute_dtype)`).
template <class T>
__global__ void pad_dout(const float* __restrict__ dout, T* __restrict__ doutp, int batch,
                         int out_len, int ft, int lp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)batch * lp) return;
  const int b = (int)(i / lp), p = (int)(i % lp) - ft;
  doutp[i] = tc::round_to<T>(p >= 0 && p < out_len ? dout[(int64_t)b * out_len + p] : 0.f);
}

// pad_dout, and the exact zeros of dmag and dphs on frames 0 and
// out_frames - 1 (wholly in the trimmed margin), which the wgmma schedule's
// dspec product, over the live frames only, does not write.
template <class T>
__global__ void pad_dout_zero_edges(const float* __restrict__ dout, T* __restrict__ doutp,
                                    float* __restrict__ dmag, float* __restrict__ dphs, int batch,
                                    int out_len, int ft, int lp, int out_frames, int half) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t edge = (int64_t)batch * half;
  if (i < 2 * edge) {
    const int64_t at = i < edge ? i : (int64_t)(out_frames - 1) * edge + (i - edge);
    dmag[at] = 0.f;
    dphs[at] = 0.f;
  }
  if (i >= (int64_t)batch * lp) return;
  const int b = (int)(i / lp), p = (int)(i % lp) - ft;
  doutp[i] = tc::round_to<T>(p >= 0 && p < out_len ? dout[(int64_t)b * out_len + p] : 0.f);
}

// dspec of the live frames, interleaved: slice z of the K steps (frame samples)
// of tc::Spectrum on doutp, written to partial[z] (rows, ldc).
template <class T>
struct SynthesisDspec : tc::Spectrum<T> {
  float* partial;
  __device__ void pair(int r, int n, float d_re, float d_im, int z) const {
    const int rows = this->frames * this->batch;
    if (r >= rows || n >= this->ldc) return;
    *reinterpret_cast<float2*>(partial + ((int64_t)z * rows + r) * this->ldc + n) =
        make_float2(d_re, d_im);
  }
};

// dmag, dphs (out_frames, batch, half): (d_re, d_im) of a bin is the ordered
// sum of dspec's K slices at columns 2*bin, 2*bin + 1 of the live row, then
// dmag = d_re*cos + d_im*sin and dphs = mag*(d_im*cos - d_re*sin). Frames 0
// and out_frames - 1 lie wholly in the trimmed margin: exact zeros. When spec
// is given, the live rows' spectrum (mag*cos, mag*sin) goes there too, in the
// layout kernel B's product reads and in the operand type (bf16: the JAX
// kernel's `spec.astype(compute_dtype)`), for the dW product.
template <class T>
__global__ void synthesis_adjoint(const float* __restrict__ mag, const float* __restrict__ phs,
                                  const float* __restrict__ dspec, float* __restrict__ dmag,
                                  float* __restrict__ dphs, T* __restrict__ spec, int batch,
                                  int out_frames, int half, int ldc, int nsplit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)out_frames * batch * half) return;
  const int64_t r = i / half;  // frame-major row t*batch + b
  const int bin = (int)(i - r * half);
  const int t = (int)(r / batch);
  float dm = 0.f, dp = 0.f;
  if (t >= 1 && t <= out_frames - 2) {
    const int64_t slice = (int64_t)(out_frames - 2) * batch * ldc;
    const float* d = dspec + (r - batch) * ldc + 2 * bin;
    const float d_re = tc::sum_slices(d, slice, nsplit);
    const float d_im = tc::sum_slices(d + 1, slice, nsplit);
    float s, c;
    sincosf(phs[i], &s, &c);
    const float m = mag[i];
    dm = d_re * c + d_im * s;
    dp = m * (d_im * c - d_re * s);
    if (spec) {
      T* row = spec + (r - batch) * ldc;
      tc::store2(row + 2 * bin, m * c, m * s);
      if (bin == half - 1)
        for (int col = 2 * half; col < ldc; ++col) row[col] = tc::round_to<T>(0.f);  // padding
    }
  }
  dmag[i] = dm;
  dphs[i] = dp;
}

// ------------------------------------------------------------------ E, part 2
// dw[part*half + bin, j] = (partial[0] + partial[1] + ...)[j, 2*bin + part],
// the slices in that order for every run; 32 x 32 tiles through shared memory
// (32 x 8 threads), so that the reads run along c and the writes along j.
__global__ void sum_synthesis_partials(const float* __restrict__ partial, float* __restrict__ dw,
                                       int ft, int half, int ldc, int nsplit) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  const int64_t slice = (int64_t)ft * ldc;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int j = j0 + i, c = c0 + tx;
    tile[i][tx] = j < ft && c < ldc ? tc::sum_slices(partial + (int64_t)j * ldc + c, slice, nsplit)
                                    : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, j = j0 + tx;
    if (c < 2 * half && j < ft) dw[(int64_t)((c & 1) * half + (c >> 1)) * ft + j] = tile[tx][i];
  }
}

template <class T>
int synthesis_bwd(const float* mag, const float* phs, const float* w, const float* dout, T* wp,
                  T* doutp, float* dspec, T* spec, float* dw_partial, float* dmag, float* dphs,
                  float* dw, int batch, int out_frames, int ft, int hop, int half, int out_len,
                  int nsplit_dspec, int nsplit_dw, int need_dw, int vec, cudaStream_t s) {
  const int ldc = tc::packed_width<T>(half);
  const int lp = out_len + 2 * ft;
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int64_t rows = (int64_t)live * batch;
  const T* frame1 = doutp + hop;  // frame t of the live ones at t*hop
  const int live_lo = ft - hop, live_hi = ft + out_len - hop;  // the trimmed output, from frame1
  int err = tc::pack_synthesis(w, wp, ft, half, s);
  if (err) return err;
  pad_dout<T><<<tc::blocks((int64_t)batch * lp, 256), 256, 0, s>>>(dout, doutp, batch, out_len,
                                                                   ft, lp);
  err = (int)cudaGetLastError();
  if (err) return err;
  SynthesisDspec<T> p1;
  p1.xp = frame1;
  p1.wp = wp;
  p1.batch = batch, p1.lp = lp, p1.ft = ft, p1.hop = hop, p1.half = half, p1.frames = live;
  p1.ldc = ldc;
  p1.live_lo = live_lo, p1.live_hi = live_hi;
  p1.partial = dspec;
  err = tc::launch(p1, rows, ldc, nsplit_dspec, vec, s);
  if (err) return err;
  const int64_t size = (int64_t)out_frames * batch * half;
  synthesis_adjoint<T><<<tc::blocks(size, 256), 256, 0, s>>>(
      mag, phs, dspec, dmag, dphs, need_dw ? spec : nullptr, batch, out_frames, half, ldc,
      nsplit_dspec);
  err = (int)cudaGetLastError();
  if (err || !need_dw) return err;
  err = tc::launch(FrameDw<T>{frame1, spec, dw_partial, batch, lp, ft, hop, live, ldc, live_lo,
                              live_hi},
                   ft, ldc, nsplit_dw, vec, s);
  if (err) return err;
  sum_synthesis_partials<<<dim3(tc::blocks(ft, 32), tc::blocks(ldc, 32)), dim3(32, 8), 0, s>>>(
      dw_partial, dw, ft, half, ldc, nsplit_dw);
  return (int)cudaGetLastError();
}

// ======================================================= the wgmma schedule
// The bf16 modes of D and E on wgmma_product.cuh: the same passes around the
// products (tc::pack / pack_synthesis, halve_to_bf16, pad_dout, tc::gather)
// and the same arithmetic in the epilogues, but no K slices, so no partials
// and no pass to add them: D's dW and E's dmag / dphs / spec and dW are
// written by the products that finish them. The rows of the products are
// padded rows R = t * bpad + b (wgmma_product.cuh); dspec and E's spectrum
// are stored that way, zero on the padding rows. D's spectrum product is
// kernel A's on the same schedule (frontend.cu's AnalysisFwdW: the same
// wg::FrameSpectrum<128>, K steps and pieces), so where A and D both run on
// wgmma, as training does at the flagship geometry, D forms again the
// spectrum A found (by construction: the card holds each against its plain
// version and float64, not the two against each other); across schedules
// the order of the sums differs.
// `sq >= 1e-36` decides as the forward did either way, since a frame that is
// all padding gives an exact 0 in any order (A's edge frames are exactly
// 1e-18 on both schedules, chip_smoke.py 2b) and a frame with signal in it
// gives sq many orders of magnitude above the floor.

// The spectrum product of D and E, whose epilogues read two (frames, batch,
// half) arrays at the tile's bins: prefetch_bins has the producer warp hint
// the tile's lines of both into L2 when the tile starts (a row's bins
// [n0 / 2, (n0 + w) / 2) of frame t + t_off), so that the epilogue's reads,
// which first touch them in device memory, overlap the tile's products.
template <class Spectrum>
struct Bins : Spectrum {
  int batch, half, ldc;
  __device__ void prefetch_bins(const float* x, const float* y, int t_off, int m0, int n0, int w,
                                int lane) const {
    const int lo = n0 / 2, hi = min(half, (n0 + w + 1) / 2);
    if (hi <= lo) return;
    const int lines = (hi - lo + 31) / 32 + 1;  // 128-byte lines a row, at any alignment
    for (int i = lane; i < wg::BM * lines; i += 32) {
      const int r = m0 + i / lines;
      const int t = r / this->bpad, b = r - t * this->bpad;
      if (r >= this->m || b >= batch) continue;
      const int bin = min(lo + (i % lines) * 32, hi - 1);
      const int64_t at = ((int64_t)(t + t_off) * batch + b) * half + bin;
      wg::prefetch_l2(x + at);
      wg::prefetch_l2(y + at);
    }
  }
};
template <int TN>
using BinsSpectrum = Bins<wg::FrameSpectrum<TN>>;

// D's spectrum again, then (dmag, dphs) -> dspec, interleaved, rounded once to
// bf16 (the JAX kernel's `dspec.astype(compute_dtype)`); padding rows and
// columns 0.
struct AnalysisDspecW : BinsSpectrum<128> {
  const float* dmag;
  const float* dphs;
  tc::bf16* dspec;
  using Aux = float2;  // (dmag, dphs) of the bin, 0 outside
  __device__ float2 fetch(int r, int n) const {
    const int t = r / bpad, b = r - t * bpad, bin = n >> 1;
    if (r >= m || b >= batch || bin >= half) return make_float2(0.f, 0.f);
    const int64_t at = ((int64_t)t * batch + b) * half + bin;
    return make_float2(__ldg(dmag + at), __ldg(dphs + at));
  }
  __device__ void prefetch(int m0, int n0, int w, int lane) const {
    prefetch_bins(dmag, dphs, 0, m0, n0, w, lane);
  }
  __device__ void pair(int r, int n, float re, float im, float2 cot) const {
    if (r >= m || n >= ldc) return;
    const int t = r / bpad, b = r - t * bpad;
    float d_re = 0.f, d_im = 0.f;
    const int bin = n >> 1;
    if (b < batch && bin < half) {
      const float dm = cot.x;
      const float dp = cot.y;
      // mag = sqrt(max(sq, 1e-36)): no gradient under the floor
      const float sq = re * re + im * im;
      const float gm = sq >= 1e-36f ? dm / sqrtf(fmaxf(sq, 1e-36f)) : 0.f;
      // phs = atan2(im, re + 1e-7)
      const float rr = re + 1e-7f;
      const float den = rr * rr + im * im;
      d_re = gm * re - dp * im / den;
      d_im = gm * im + dp * rr / den;
    }
    tc::store2(dspec + (int64_t)r * ldc + n, d_re, d_im);
  }
};

// The restaged rows of a float32 spectrum pass's epilogue (RESTAGE) written
// once more, transposed and split: the warpgroup's 64 staged rows from row
// m0, columns n0 .. n0 + w, into the planes (ldc, m) of `out`, consecutive
// threads on consecutive rows of a column. D's dspec and E's spectrum, for
// their dW products' B operand (TF32 wgmma reads it K-major only).
__device__ __forceinline__ void split_transposed(const float* stg, int ld, int m0, int n0, int w,
                                                 int th, int m, int ldc, tc::Split out) {
  for (int i = th; i < 64 * (w / 2); i += 128) {
    const int row = i % 64, c = 2 * (i / 64);
    const int r = m0 + row, n = n0 + c;
    if (r >= m || n >= ldc) continue;
    const float2 v = *reinterpret_cast<const float2*>(stg + row * ld + c);
    out((int64_t)n * m + r, v.x);
    if (n + 1 < ldc) out((int64_t)(n + 1) * m + r, v.y);
  }
}

// D's spectrum again in float32 (wg::FrameSpectrum32, the model's x/2 on the
// finished sums), then dspec as AnalysisDspecW forms it, in f32: written
// row by row to dspec (rows, ldc) when dxp is asked for (the frame product's
// A, split in registers there), and handed back to the staging buffer
// (RESTAGE), from which transposed() writes it as the split planes dspect_hi,
// dspect_lo (ldc, rows) when dW is asked for (the dW product's B, which TF32
// wgmma reads K-major only): the epilogue reads dmag / dphs along the rows
// and writes the planes along their rows, both contiguous across a warp.
struct AnalysisDspecW32 : Bins<wg::FrameSpectrum32<128>> {
  static constexpr bool RESTAGE = true;
  const float* dmag;
  const float* dphs;
  float* dspec;      // (rows, ldc) or null
  float* dspect_hi;  // (ldc, rows) or null, with dspect_lo
  float* dspect_lo;
  using Aux = float2;  // (dmag, dphs) of the bin, 0 outside
  __device__ float2 fetch(int r, int n) const {
    const int t = r / bpad, b = r - t * bpad, bin = n >> 1;
    if (r >= m || b >= batch || bin >= half) return make_float2(0.f, 0.f);
    const int64_t at = ((int64_t)t * batch + b) * half + bin;
    return make_float2(__ldg(dmag + at), __ldg(dphs + at));
  }
  __device__ void prefetch(int m0, int n0, int w, int lane) const {
    prefetch_bins(dmag, dphs, 0, m0, n0, w, lane);
  }
  __device__ float2 pair(int r, int n, float re2, float im2, float2 cot) const {
    const int t = r / bpad, b = r - t * bpad;
    float d_re = 0.f, d_im = 0.f;
    const int bin = n >> 1;
    if (r < m && b < batch && bin < half) {
      const float re = tc::SIGNAL_SCALE<float> * re2, im = tc::SIGNAL_SCALE<float> * im2;
      const float dm = cot.x;
      const float dp = cot.y;
      // mag = sqrt(max(sq, 1e-36)): no gradient under the floor
      const float sq = re * re + im * im;
      const float gm = sq >= 1e-36f ? dm / sqrtf(fmaxf(sq, 1e-36f)) : 0.f;
      // phs = atan2(im, re + 1e-7)
      const float rr = re + 1e-7f;
      const float den = rr * rr + im * im;
      d_re = gm * re - dp * im / den;
      d_im = gm * im + dp * rr / den;
    }
    if (dspec && r < m && n < ldc) tc::store2(dspec + (int64_t)r * ldc + n, d_re, d_im);
    return make_float2(d_re, d_im);
  }
  __device__ void transposed(const float* stg, int ld, int m0, int n0, int w, int th) const {
    if (dspect_hi) split_transposed(stg, ld, m0, n0, w, th, m, ldc, {dspect_hi, dspect_lo});
  }
};

// dframes[t * batch + b, j] for dxp's overlap-add (tc::gather).
template <class Product>
struct DxFrames : Product {
  float* dframes;
  int batch, bpad, ft;
  __device__ void pair(int r, int j, float v0, float v1, wg::NoAux) const {
    if (r >= this->m) return;
    const int t = r / bpad, b = r - t * bpad;
    if (b >= batch) return;
    float* dst = dframes + ((int64_t)t * batch + b) * ft + j;
    if (j + 1 < ft) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);  // ft is even: aligned
    } else if (j < ft) {
      dst[0] = v0;
    }
  }
};
using DxFramesW = DxFrames<wg::RowProduct<128>>;
using DxFramesW32 = DxFrames<wg::RowProduct32<128>>;

// dw[j, part * half + bin] from column 2 * bin + part, times scale (1 in
// bf16, whose frames were halved; the model's x/2 in float32).
template <class Product>
struct AnalysisDw : Product {
  float* dw;
  int half;
  float scale;
  __device__ void pair(int j, int c, float v0, float v1, wg::NoAux) const {
    if (j >= this->m || c >= 2 * half) return;
    float* row = dw + (int64_t)j * 2 * half;
    row[c >> 1] = scale * v0;
    row[half + (c >> 1)] = scale * v1;
  }
};
using AnalysisDwW = AnalysisDw<wg::FrameGrad<64>>;
using AnalysisDwW32 = AnalysisDw<wg::FrameGrad32<64>>;

int analysis_bwd_wgmma(const float* xp, const float* w, const float* dmag, const float* dphs,
                       tc::bf16* xq, tc::bf16* wp, tc::bf16* dspec, float* dframes, float* dxp,
                       float* dw, int batch, int lp, int ft, int hop, int half, int frames,
                       int need_dxp, int need_dw, cudaStream_t s) {
  const int ldc = tc::packed_width<tc::bf16>(half);
  const int bpad = wg::pad_rows(batch);
  const int rows = frames * bpad;
  int err = tc::pack(w, wp, ft, half, s);
  if (err) return err;
  const tc::bf16* signal;
  err = tc::signal(xp, xq, (int64_t)batch * lp, &signal, s);
  if (err) return err;
  AnalysisDspecW p1;
  p1.m = rows, p1.n = ldc;
  if ((err = wg::frames_map(&p1.frames, signal, ft, batch, frames, lp, hop))) return err;
  if ((err = wg::matrix_map(&p1.w, wp, ft, ldc))) return err;
  p1.bpad = bpad, p1.ft = ft, p1.hop = hop, p1.live_lo = 0, p1.live_hi = lp;  // every sample
  p1.dmag = dmag, p1.dphs = dphs, p1.dspec = dspec;
  p1.batch = batch, p1.half = half, p1.ldc = ldc;
  if ((err = wg::launch(p1, s))) return err;
  CUtensorMap dspec_map;
  if ((err = wg::matrix_map(&dspec_map, dspec, rows, ldc))) return err;
  if (need_dxp) {
    DxFramesW p2;
    p2.m = rows, p2.n = ft;
    p2.d = dspec_map;
    p2.w = p1.w;  // wp (ft, ldc): row j of W is K-major
    p2.k = ldc;
    p2.dframes = dframes, p2.batch = batch, p2.bpad = bpad, p2.ft = ft;
    if ((err = wg::launch(p2, s))) return err;
    if ((err = tc::gather(dframes, dxp, batch, lp, 0, ft, hop, 0, frames, 1, 0.5f, s))) return err;
  }
  if (need_dw) {
    AnalysisDwW p3;
    p3.m = ft, p3.n = ldc;
    p3.frames = p1.frames, p3.s = dspec_map;
    p3.bpad = bpad, p3.hop = hop, p3.n_frames = frames, p3.live_lo = 0, p3.live_hi = lp;
    p3.dw = dw, p3.half = half, p3.scale = 1.f;
    if ((err = wg::launch(p3, s))) return err;
  }
  return 0;
}

// The float32 mode on the same schedule: the frames of xp itself (16-byte
// aligned, hop, lp and ft multiples of 4), split in registers; B's split
// planes: W^T's (ldc, ft) for the spectrum, W's (ft, ldc) for dxp's frame
// product, dspec's transpose (ldc, rows) for dW, which the spectrum pass
// writes. dspec (rows, ldc) in f32 only for dxp.
int analysis_bwd_wgmma32(const float* xp, const float* w, const float* dmag, const float* dphs,
                         float* wt_hi, float* wt_lo, float* wp_hi, float* wp_lo, float* dspec,
                         float* dspect_hi, float* dspect_lo, float* dframes, float* dxp, float* dw,
                         int batch, int lp, int ft, int hop, int half, int frames, int need_dxp,
                         int need_dw, cudaStream_t s) {
  const int ldc = tc::packed_width<float>(half);
  const int bpad = wg::pad_rows(batch);
  const int rows = frames * bpad;
  int err = tc::pack_split_t(w, wt_hi, wt_lo, ft, half, s);
  if (err) return err;
  AnalysisDspecW32 p1;
  p1.m = rows, p1.n = ldc;
  if ((err = wg::frames_map32(&p1.frames, xp, ft, batch, frames, lp, hop))) return err;
  if ((err = wg::split_maps(&p1, wt_hi, wt_lo, ldc, ft))) return err;
  p1.bpad = bpad, p1.ft = ft, p1.hop = hop, p1.live_lo = 0, p1.live_hi = lp;  // every sample
  p1.dmag = dmag, p1.dphs = dphs;
  p1.dspec = need_dxp ? dspec : nullptr;
  p1.dspect_hi = need_dw ? dspect_hi : nullptr, p1.dspect_lo = need_dw ? dspect_lo : nullptr;
  p1.batch = batch, p1.half = half, p1.ldc = ldc;
  if ((err = wg::launch(p1, s))) return err;
  if (need_dxp) {
    if ((err = tc::pack_split(w, wp_hi, wp_lo, ft, half, s))) return err;
    DxFramesW32 p2;
    p2.m = rows, p2.n = ft;
    if ((err = wg::matrix_map32(&p2.d, dspec, rows, ldc, wg::BM))) return err;
    if ((err = wg::split_maps(&p2, wp_hi, wp_lo, ft, ldc))) return err;
    p2.k = ldc;
    p2.dframes = dframes, p2.batch = batch, p2.bpad = bpad, p2.ft = ft;
    if ((err = wg::launch(p2, s))) return err;
    if ((err = tc::gather(dframes, dxp, batch, lp, 0, ft, hop, 0, frames, 1, 0.5f, s))) return err;
  }
  if (need_dw) {
    AnalysisDwW32 p3;
    p3.m = ft, p3.n = ldc;
    p3.frames = p1.frames;
    if ((err = wg::split_maps(&p3, dspect_hi, dspect_lo, ldc, rows))) return err;
    p3.bpad = bpad, p3.hop = hop, p3.n_frames = frames, p3.live_lo = 0, p3.live_hi = lp;
    p3.dw = dw, p3.half = half, p3.scale = tc::SIGNAL_SCALE<float>;
    if ((err = wg::launch(p3, s))) return err;
  }
  return 0;
}

// E's dspec product, whose epilogue fetches (mag, phs) of the bin (frame t +
// 1: t counts the live frames) and does what synthesis_adjoint does with
// dspec: dmag = d_re*cos + d_im*sin, dphs = mag*(d_im*cos - d_re*sin).
// adjoint() writes them and returns the spectrum (mag*cos, mag*sin) of the
// bin, 0 on padding rows and columns.
template <class Spectrum>
struct SynthesisBins : Bins<Spectrum> {
  const float* mag;
  const float* phs;
  float* dmag;
  float* dphs;
  using Aux = float2;  // (mag, phs) of the bin, 0 outside
  __device__ float2 fetch(int r, int n) const {
    const int t = r / this->bpad, b = r - t * this->bpad, bin = n >> 1;
    if (r >= this->m || b >= this->batch || bin >= this->half) return make_float2(0.f, 0.f);
    const int64_t at = ((int64_t)(t + 1) * this->batch + b) * this->half + bin;
    return make_float2(__ldg(mag + at), __ldg(phs + at));
  }
  __device__ void prefetch(int m0, int n0, int w, int lane) const {
    this->prefetch_bins(mag, phs, 1, m0, n0, w, lane);
  }
  __device__ float2 adjoint(int r, int n, float d_re, float d_im, float2 mp) const {
    const int t = r / this->bpad, b = r - t * this->bpad, bin = n >> 1;
    if (r >= this->m || b >= this->batch || bin >= this->half) return make_float2(0.f, 0.f);
    const int64_t at = ((int64_t)(t + 1) * this->batch + b) * this->half + bin;
    float sn, cs;
    sincosf(mp.y, &sn, &cs);
    const float mg = mp.x;
    dmag[at] = d_re * cs + d_im * sn;
    dphs[at] = mg * (d_im * cs - d_re * sn);
    return make_float2(mg * cs, mg * sn);
  }
};

// bf16: the spectrum, when spec is given, in bf16 (the JAX kernel's
// `spec.astype(compute_dtype)`) for the dW product.
struct SynthesisDspecW : SynthesisBins<wg::FrameSpectrum<128>> {
  tc::bf16* spec;
  __device__ void pair(int r, int n, float d_re, float d_im, float2 mp) const {
    if (r >= m || n >= ldc) return;
    const float2 s = adjoint(r, n, d_re, d_im, mp);
    if (spec) tc::store2(spec + (int64_t)r * ldc + n, s.x, s.y);
  }
};

// float32 (wg::FrameSpectrum32 on the frames of the padded dout, split in
// registers, against the planes (ldc, ft) of the synthesis weights): the
// spectrum handed back to the staging buffer (RESTAGE), from which
// transposed() writes its split planes spect_hi, spect_lo (ldc, rows) when dW
// is asked for (the dW product's B, which TF32 wgmma reads K-major only).
struct SynthesisDspecW32 : SynthesisBins<wg::FrameSpectrum32<128>> {
  static constexpr bool RESTAGE = true;
  float* spect_hi;  // (ldc, rows) or null, with spect_lo
  float* spect_lo;
  __device__ float2 pair(int r, int n, float d_re, float d_im, float2 mp) const {
    return adjoint(r, n, d_re, d_im, mp);
  }
  __device__ void transposed(const float* stg, int ld, int m0, int n0, int w, int th) const {
    if (spect_hi) split_transposed(stg, ld, m0, n0, w, th, m, ldc, {spect_hi, spect_lo});
  }
};

// dw[part * half + bin, j] from column 2 * bin + part: the transpose, the
// epilogue walking the tile down its rows (j).
template <class Product>
struct SynthesisDw : Product {
  static constexpr bool ROW_FAST = true;  // consecutive j: a warp writes along dw's rows
  float* dw;
  int half;
  __device__ void pair(int j, int c, float v0, float v1, wg::NoAux) const {
    if (j >= this->m || c >= 2 * half) return;
    dw[(int64_t)(c >> 1) * this->m + j] = v0;
    dw[(int64_t)(half + (c >> 1)) * this->m + j] = v1;
  }
};
using SynthesisDwW = SynthesisDw<wg::FrameGrad<64>>;
using SynthesisDwW32 = SynthesisDw<wg::FrameGrad32<64>>;

int synthesis_bwd_wgmma(const float* mag, const float* phs, const float* w, const float* dout,
                        tc::bf16* wp, tc::bf16* doutp, tc::bf16* spec, float* dmag, float* dphs,
                        float* dw, int batch, int out_frames, int ft, int hop, int half,
                        int out_len, int need_dw, cudaStream_t s) {
  const int ldc = tc::packed_width<tc::bf16>(half);
  const int lp = out_len + 2 * ft;
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int bpad = wg::pad_rows(batch);
  const int rows = live * bpad;
  const tc::bf16* frame1 = doutp + hop;  // frame t of the live ones at t*hop
  const int live_lo = ft - hop, live_hi = ft + out_len - hop;  // the trimmed output, from frame1
  int err = tc::pack_synthesis(w, wp, ft, half, s);
  if (err) return err;
  const int64_t size = (int64_t)batch * lp;
  pad_dout_zero_edges<tc::bf16><<<tc::blocks(size, 256), 256, 0, s>>>(
      dout, doutp, dmag, dphs, batch, out_len, ft, lp, out_frames, half);
  if ((err = (int)cudaGetLastError())) return err;
  if (live <= 0)  // no frame reaches the trimmed output: every gradient is 0
    return need_dw ? (int)cudaMemsetAsync(dw, 0, sizeof(float) * 2 * half * ft, s) : 0;
  SynthesisDspecW p1;
  p1.m = rows, p1.n = ldc;
  if ((err = wg::frames_map(&p1.frames, frame1, ft, batch, live, lp, hop))) return err;
  if ((err = wg::matrix_map(&p1.w, wp, ft, ldc))) return err;
  p1.bpad = bpad, p1.ft = ft, p1.hop = hop, p1.live_lo = live_lo, p1.live_hi = live_hi;
  p1.mag = mag, p1.phs = phs, p1.dmag = dmag, p1.dphs = dphs, p1.spec = need_dw ? spec : nullptr;
  p1.batch = batch, p1.half = half, p1.ldc = ldc;
  if ((err = wg::launch(p1, s)) || !need_dw) return err;
  SynthesisDwW p2;
  p2.m = ft, p2.n = ldc;
  p2.frames = p1.frames;
  if ((err = wg::matrix_map(&p2.s, spec, rows, ldc))) return err;
  p2.bpad = bpad, p2.hop = hop, p2.n_frames = live, p2.live_lo = live_lo, p2.live_hi = live_hi;
  p2.dw = dw, p2.half = half;
  return wg::launch(p2, s);
}

// The float32 mode on the same schedule: doutp in f32 (hop, ft and lp
// multiples of 4, so that every frame of it is 16-byte aligned), its frames
// split in registers; B's split planes: the synthesis weights' (ldc, ft) for
// dspec, the spectrum's transpose (ldc, rows) for dW, which the dspec pass
// writes.
int synthesis_bwd_wgmma32(const float* mag, const float* phs, const float* w, const float* dout,
                          float* wt_hi, float* wt_lo, float* doutp, float* spect_hi,
                          float* spect_lo, float* dmag, float* dphs, float* dw, int batch,
                          int out_frames, int ft, int hop, int half, int out_len, int need_dw,
                          cudaStream_t s) {
  const int ldc = tc::packed_width<float>(half);
  const int lp = out_len + 2 * ft;
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int bpad = wg::pad_rows(batch);
  const int rows = live * bpad;
  const float* frame1 = doutp + hop;  // frame t of the live ones at t*hop
  const int live_lo = ft - hop, live_hi = ft + out_len - hop;  // the trimmed output, from frame1
  int err = tc::pack_split_synthesis(w, wt_hi, wt_lo, ft, half, true, s);
  if (err) return err;
  const int64_t size = (int64_t)batch * lp;
  pad_dout_zero_edges<float><<<tc::blocks(size, 256), 256, 0, s>>>(
      dout, doutp, dmag, dphs, batch, out_len, ft, lp, out_frames, half);
  if ((err = (int)cudaGetLastError())) return err;
  if (live <= 0)  // no frame reaches the trimmed output: every gradient is 0
    return need_dw ? (int)cudaMemsetAsync(dw, 0, sizeof(float) * 2 * half * ft, s) : 0;
  SynthesisDspecW32 p1;
  p1.m = rows, p1.n = ldc;
  if ((err = wg::frames_map32(&p1.frames, frame1, ft, batch, live, lp, hop))) return err;
  if ((err = wg::split_maps(&p1, wt_hi, wt_lo, ldc, ft))) return err;
  p1.bpad = bpad, p1.ft = ft, p1.hop = hop, p1.live_lo = live_lo, p1.live_hi = live_hi;
  p1.mag = mag, p1.phs = phs, p1.dmag = dmag, p1.dphs = dphs;
  p1.spect_hi = need_dw ? spect_hi : nullptr, p1.spect_lo = need_dw ? spect_lo : nullptr;
  p1.batch = batch, p1.half = half, p1.ldc = ldc;
  if ((err = wg::launch(p1, s)) || !need_dw) return err;
  SynthesisDwW32 p2;
  p2.m = ft, p2.n = ldc;
  p2.frames = p1.frames;
  if ((err = wg::split_maps(&p2, spect_hi, spect_lo, ldc, rows))) return err;
  p2.bpad = bpad, p2.hop = hop, p2.n_frames = live, p2.live_lo = live_lo, p2.live_hi = live_hi;
  p2.dw = dw, p2.half = half;
  return wg::launch(p2, s);
}

}  // namespace

extern "C" {

const char* st_error_string(int code) {
  if (code >= wg::ENCODE_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// xp (batch, lp) padded signal, not halved; w (ft, 2*half); dmag, dphs
// (frames, batch, half); dxp (batch, lp), written when need_dxp; dw (ft,
// 2*half), written when need_dw. bf16 selects the compute dtype: 0 float32
// (split TF32), 1 bfloat16. Scratch, with ldc = 2*half rounded up to a
// multiple of 16 bytes, in the compute dtype: wp (ft, ldc), dspec
// (frames*batch, ldc), and for bf16 xq (batch, lp), the halved and rounded
// signal (null for float32); in float32: dw_partial (nsplit, ft, ldc) and
// dframes (frames*batch, ft), read and written when need_dxp. vec, elements a
// copy: 16 bytes' worth when hop, lp, ft and the pointers allow, else 1.
int st_analysis_bwd(const void* xp, const void* w, const void* dmag, const void* dphs, void* xq,
                    void* wp, void* dspec, void* dw_partial, void* dframes, void* dxp, void* dw,
                    int batch, int lp, int ft, int hop, int half, int frames, int nsplit,
                    int need_dxp, int need_dw, int vec, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return analysis_bwd((const float*)xp, (const float*)w, (const float*)dmag, (const float*)dphs,
                        (tc::bf16*)xq, (tc::bf16*)wp, (tc::bf16*)dspec, (float*)dw_partial,
                        (float*)dframes, (float*)dxp, (float*)dw, batch, lp, ft, hop, half,
                        frames, nsplit, need_dxp, need_dw, vec, s);
  return analysis_bwd((const float*)xp, (const float*)w, (const float*)dmag, (const float*)dphs,
                      (float*)nullptr, (float*)wp, (float*)dspec, (float*)dw_partial,
                      (float*)dframes, (float*)dxp, (float*)dw, batch, lp, ft, hop, half, frames,
                      nsplit, need_dxp, need_dw, vec, s);
}

// mag, phs (out_frames, batch, half); w (2*half, ft); dout (batch, out_len)
// with out_len = (out_frames - 1)*hop - ft; dmag, dphs like mag; dw (2*half,
// ft), written when need_dw. bf16 as for st_analysis_bwd. Scratch, with ldc =
// 2*half rounded up to a multiple of 16 bytes and rows = (out_frames -
// 2)*batch, the live frames: in the compute dtype wp (ft, ldc), doutp (batch,
// out_len + 2*ft) and, when need_dw, spec (rows, ldc); in float32 dspec
// (nsplit_dspec, rows, ldc) and, when need_dw, dw_partial (nsplit_dw, ft,
// ldc). vec, elements a copy: 16 bytes' worth when hop, ft, out_len + 2*ft
// and the pointers allow, else 1.
int st_synthesis_bwd(const void* mag, const void* phs, const void* w, const void* dout,
                     void* wp, void* doutp, void* dspec, void* spec, void* dw_partial,
                     void* dmag, void* dphs, void* dw,
                     int batch, int out_frames, int ft, int hop, int half, int out_len,
                     int nsplit_dspec, int nsplit_dw, int need_dw, int vec, int bf16,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return synthesis_bwd((const float*)mag, (const float*)phs, (const float*)w,
                         (const float*)dout, (tc::bf16*)wp, (tc::bf16*)doutp, (float*)dspec,
                         (tc::bf16*)spec, (float*)dw_partial, (float*)dmag, (float*)dphs,
                         (float*)dw, batch, out_frames, ft, hop, half, out_len, nsplit_dspec,
                         nsplit_dw, need_dw, vec, s);
  return synthesis_bwd((const float*)mag, (const float*)phs, (const float*)w, (const float*)dout,
                       (float*)wp, (float*)doutp, (float*)dspec, (float*)spec,
                       (float*)dw_partial, (float*)dmag, (float*)dphs, (float*)dw, batch,
                       out_frames, ft, hop, half, out_len, nsplit_dspec, nsplit_dw, need_dw,
                       vec, s);
}

// The bf16 mode of st_analysis_bwd on the wgmma schedule (wgmma_product.cuh),
// for geometries whose hop, lp and ft are multiples of 8 (16 bytes) and
// 16-byte aligned pointers. Scratch, in bf16, with ldc as above and bpad =
// batch rounded up to 8: wp (ft, ldc), xq (batch, lp), dspec (frames*bpad,
// ldc); in float32 dframes (frames*batch, ft) when need_dxp. No partials.
int st_analysis_bwd_wgmma(const void* xp, const void* w, const void* dmag, const void* dphs,
                          void* xq, void* wp, void* dspec, void* dframes, void* dxp, void* dw,
                          int batch, int lp, int ft, int hop, int half, int frames, int need_dxp,
                          int need_dw, void* stream) {
  return analysis_bwd_wgmma((const float*)xp, (const float*)w, (const float*)dmag,
                            (const float*)dphs, (tc::bf16*)xq, (tc::bf16*)wp, (tc::bf16*)dspec,
                            (float*)dframes, (float*)dxp, (float*)dw, batch, lp, ft, hop, half,
                            frames, need_dxp, need_dw, (cudaStream_t)stream);
}

// The float32 mode of st_analysis_bwd on the wgmma schedule (split TF32 on
// wgmma_product.cuh), for geometries whose hop, lp and ft are multiples of 4
// (16 bytes) and a 16-byte aligned xp. Scratch, in float32, with ldc as above
// and rows = frames * bpad: wt_hi, wt_lo (ldc, ft); when need_dxp wp_hi,
// wp_lo (ft, ldc), dspec (rows, ldc) and dframes (frames*batch, ft); when
// need_dw dspect_hi, dspect_lo (ldc, rows). No partials.
int st_analysis_bwd_wgmma_f32(const void* xp, const void* w, const void* dmag, const void* dphs,
                              void* wt_hi, void* wt_lo, void* wp_hi, void* wp_lo, void* dspec,
                              void* dspect_hi, void* dspect_lo, void* dframes, void* dxp, void* dw,
                              int batch, int lp, int ft, int hop, int half, int frames,
                              int need_dxp, int need_dw, void* stream) {
  return analysis_bwd_wgmma32(
      (const float*)xp, (const float*)w, (const float*)dmag, (const float*)dphs, (float*)wt_hi,
      (float*)wt_lo, (float*)wp_hi, (float*)wp_lo, (float*)dspec, (float*)dspect_hi,
      (float*)dspect_lo, (float*)dframes, (float*)dxp, (float*)dw, batch, lp, ft, hop, half,
      frames, need_dxp, need_dw, (cudaStream_t)stream);
}

// The bf16 mode of st_synthesis_bwd on the wgmma schedule, for geometries
// whose hop, ft and out_len + 2*ft are multiples of 8. Scratch, in bf16: wp
// (ft, ldc), doutp (batch, out_len + 2*ft) and, when need_dw, spec
// ((out_frames - 2)*bpad, ldc). No partials.
int st_synthesis_bwd_wgmma(const void* mag, const void* phs, const void* w, const void* dout,
                           void* wp, void* doutp, void* spec, void* dmag, void* dphs, void* dw,
                           int batch, int out_frames, int ft, int hop, int half, int out_len,
                           int need_dw, void* stream) {
  return synthesis_bwd_wgmma((const float*)mag, (const float*)phs, (const float*)w,
                             (const float*)dout, (tc::bf16*)wp, (tc::bf16*)doutp,
                             (tc::bf16*)spec, (float*)dmag, (float*)dphs, (float*)dw, batch,
                             out_frames, ft, hop, half, out_len, need_dw, (cudaStream_t)stream);
}

// The float32 mode of st_synthesis_bwd on the wgmma schedule (split TF32 on
// wgmma_product.cuh), for geometries whose hop, ft and out_len + 2*ft are
// multiples of 4. Scratch, in float32, with ldc = 2*half rounded up to a
// multiple of 4 and rows = (out_frames - 2)*bpad: wt_hi, wt_lo (ldc, ft), the
// split planes of the packed synthesis weights' transpose; doutp (batch,
// out_len + 2*ft); when need_dw spect_hi, spect_lo (ldc, rows). No partials.
int st_synthesis_bwd_wgmma_f32(const void* mag, const void* phs, const void* w, const void* dout,
                               void* wt_hi, void* wt_lo, void* doutp, void* spect_hi,
                               void* spect_lo, void* dmag, void* dphs, void* dw, int batch,
                               int out_frames, int ft, int hop, int half, int out_len,
                               int need_dw, void* stream) {
  return synthesis_bwd_wgmma32(
      (const float*)mag, (const float*)phs, (const float*)w, (const float*)dout, (float*)wt_hi,
      (float*)wt_lo, (float*)doutp, (float*)spect_hi, (float*)spect_lo, (float*)dmag,
      (float*)dphs, (float*)dw, batch, out_frames, ft, hop, half, out_len, need_dw,
      (cudaStream_t)stream);
}

}  // extern "C"
