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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_product.cuh"

namespace {

// ------------------------------------------------------------------ D, part 1
// The spectrum again (tc::Spectrum), then (dmag, dphs) -> dspec, interleaved.
struct AnalysisDspec : tc::Spectrum {
  const float* dmag;
  const float* dphs;
  float* dspec;
  __device__ void pair(int r, int n, float re2, float im2, int) const {
    if (r >= frames * batch || n >= ldc) return;
    float2 d = make_float2(0.f, 0.f);  // the padding columns stay zero
    const int bin = n >> 1;
    if (bin < half) {
      const float re = 0.5f * re2;  // the model's x/2
      const float im = 0.5f * im2;
      const float dm = dmag[(int64_t)r * half + bin];
      const float dp = dphs[(int64_t)r * half + bin];
      // mag = sqrt(max(sq, 1e-36)): no gradient under the floor
      const float sq = re * re + im * im;
      const float gm = sq >= 1e-36f ? dm / sqrtf(fmaxf(sq, 1e-36f)) : 0.f;
      // phs = atan2(im, re + 1e-7)
      const float rr = re + 1e-7f;
      const float den = rr * rr + im * im;
      d.x = gm * re - dp * im / den;
      d.y = gm * im + dp * rr / den;
    }
    *reinterpret_cast<float2*>(dspec + (int64_t)r * ldc + n) = d;
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
// D: xp the padded signal, spec its dspec (the x/2 is applied by the second
// pass). E: xp the padded output gradient from the first live frame on, spec
// the spectrum of the live frames; a tile of samples j takes only the K steps
// of the frames with a live sample among them (tc_product.cuh, live samples).
struct FrameDw {
  static constexpr bool A_KFAST = false;
  static constexpr bool B_KFAST = false;
  const float* xp;
  const float* spec;
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
  __device__ const float* src_a(int j, const Step& st, int kk, int& n) const {
    int t = st.t0, b = st.b0 + kk;
    while (b >= batch) {
      b -= batch;
      ++t;
    }
    n = st.r0 + kk < frames * batch ? ft - j : 0;
    return xp + (int64_t)b * lp + t * hop + j;
  }
  __device__ const float* src_b(int c, const Step& st, int kk, int& n) const {
    const int r = st.r0 + kk;
    n = r < frames * batch ? ldc - c : 0;
    return spec + (int64_t)r * ldc + c;
  }
  __device__ const float* base_a() const { return xp; }
  __device__ const float* base_b() const { return spec; }
  __device__ void pair(int j, int c, float v0, float v1, int z) const {
    if (j >= ft || c >= ldc) return;
    *reinterpret_cast<float2*>(partial + ((int64_t)z * ft + j) * ldc + c) = make_float2(v0, v1);
  }
};

// dw[j, part*half + bin] = 0.5 * (partial[0] + partial[1] + ...)[j, 2*bin + part],
// the slices in that order for every run.
__global__ void sum_analysis_partials(const float* __restrict__ partial, float* __restrict__ dw,
                                      int ft, int half, int ldc, int nsplit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)ft * 2 * half) return;
  const int j = (int)(i / (2 * half)), col = (int)(i % (2 * half));
  const int part = col >= half, bin = col - part * half;
  dw[i] = 0.5f * tc::sum_slices(partial + (int64_t)j * ldc + 2 * bin + part, (int64_t)ft * ldc,
                                nsplit);
}

// ------------------------------------------------------------------ E, part 1
// doutp[b, p] = dout[b, p - ft] inside the trimmed output, 0 in the margins.
__global__ void pad_dout(const float* __restrict__ dout, float* __restrict__ doutp, int batch,
                         int out_len, int ft, int lp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)batch * lp) return;
  const int b = (int)(i / lp), p = (int)(i % lp) - ft;
  doutp[i] = p >= 0 && p < out_len ? dout[(int64_t)b * out_len + p] : 0.f;
}

// dspec of the live frames, interleaved: slice z of the K steps (frame samples)
// of tc::Spectrum on doutp, written to partial[z] (rows, ldc).
struct SynthesisDspec : tc::Spectrum {
  float* partial;
  __device__ void pair(int r, int n, float d_re, float d_im, int z) const {
    const int rows = frames * batch;
    if (r >= rows || n >= ldc) return;
    *reinterpret_cast<float2*>(partial + ((int64_t)z * rows + r) * ldc + n) =
        make_float2(d_re, d_im);
  }
};

// dmag, dphs (out_frames, batch, half): (d_re, d_im) of a bin is the ordered
// sum of dspec's K slices at columns 2*bin, 2*bin + 1 of the live row, then
// dmag = d_re*cos + d_im*sin and dphs = mag*(d_im*cos - d_re*sin). Frames 0
// and out_frames - 1 lie wholly in the trimmed margin: exact zeros. When spec
// is given, the live rows' spectrum (mag*cos, mag*sin) goes there too, in the
// layout kernel B's product reads, for the dW product.
__global__ void synthesis_adjoint(const float* __restrict__ mag, const float* __restrict__ phs,
                                  const float* __restrict__ dspec, float* __restrict__ dmag,
                                  float* __restrict__ dphs, float* __restrict__ spec, int batch,
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
      float* row = spec + (r - batch) * ldc;
      *reinterpret_cast<float2*>(row + 2 * bin) = make_float2(m * c, m * s);
      if (bin == half - 1)
        for (int col = 2 * half; col < ldc; ++col) row[col] = 0.f;  // the padding columns
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

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// xp (batch, lp) padded signal, not halved; w (ft, 2*half); dmag, dphs
// (frames, batch, half); scratch: wp (ft, ldc), dspec (frames*batch, ldc),
// dw_partial (nsplit, ft, ldc), with ldc = 2*half rounded up to a multiple of
// 4, and dframes (frames*batch, ft), read and written when need_dxp; dxp
// (batch, lp), written when need_dxp; dw (ft, 2*half), written when need_dw.
// vec is 4 when hop, lp, ft and the pointers allow 16-byte copies, else 1.
int st_analysis_bwd(const void* xp, const void* w, const void* dmag, const void* dphs,
                    void* wp, void* dspec, void* dw_partial, void* dframes, void* dxp, void* dw,
                    int batch, int lp, int ft, int hop, int half, int frames,
                    int nsplit, int need_dxp, int need_dw, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ldc = tc::packed_width(half);
  const int64_t rows = (int64_t)frames * batch;
  int err = tc::pack((const float*)w, (float*)wp, ft, half, s);
  if (err) return err;
  AnalysisDspec p1;
  p1.xp = (const float*)xp;
  p1.wp = (const float*)wp;
  p1.batch = batch, p1.lp = lp, p1.ft = ft, p1.hop = hop, p1.half = half, p1.frames = frames;
  p1.ldc = ldc;
  p1.live_lo = 0, p1.live_hi = lp;  // every sample
  p1.dmag = (const float*)dmag;
  p1.dphs = (const float*)dphs;
  p1.dspec = (float*)dspec;
  err = tc::launch(p1, rows, ldc, 1, vec, s);
  if (err) return err;
  if (need_dxp) {
    err = tc::launch(tc::Frames{(const float*)dspec, (const float*)wp, (float*)dframes, (int)rows,
                                ft, ldc, batch, hop, 0, lp},
                     rows, ft, 1, vec, s);
    if (err) return err;
    err = tc::gather((const float*)dframes, (float*)dxp, batch, lp, 0, ft, hop, 0, frames, 1, 0.5f,
                     s);
    if (err) return err;
  }
  if (need_dw) {
    err = tc::launch(FrameDw{(const float*)xp, (const float*)dspec, (float*)dw_partial,
                             batch, lp, ft, hop, frames, ldc, 0, lp},
                     ft, ldc, nsplit, vec, s);
    if (err) return err;
    const int64_t size = (int64_t)ft * 2 * half;
    sum_analysis_partials<<<tc::blocks(size, 256), 256, 0, s>>>(
        (const float*)dw_partial, (float*)dw, ft, half, ldc, nsplit);
    err = (int)cudaGetLastError();
  }
  return err;
}

// mag, phs (out_frames, batch, half); w (2*half, ft); dout (batch, out_len)
// with out_len = (out_frames - 1)*hop - ft; dmag, dphs like mag; dw (2*half,
// ft), written when need_dw. Scratch, with ldc = 2*half rounded up to a
// multiple of 4 and rows = (out_frames - 2)*batch, the live frames: wp (ft,
// ldc), doutp (batch, out_len + 2*ft), dspec (nsplit_dspec, rows, ldc), and
// when need_dw spec (rows, ldc) and dw_partial (nsplit_dw, ft, ldc). vec is 4
// when hop, ft, out_len + 2*ft and the pointers allow 16-byte copies, else 1.
int st_synthesis_bwd(const void* mag, const void* phs, const void* w, const void* dout,
                     void* wp, void* doutp, void* dspec, void* spec, void* dw_partial,
                     void* dmag, void* dphs, void* dw,
                     int batch, int out_frames, int ft, int hop, int half, int out_len,
                     int nsplit_dspec, int nsplit_dw, int need_dw, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ldc = tc::packed_width(half);
  const int lp = out_len + 2 * ft;
  const int live = out_frames - 2;  // frames 1 .. out_frames - 2 reach the trimmed output
  const int64_t rows = (int64_t)live * batch;
  const float* frame1 = (const float*)doutp + hop;  // frame t of the live ones at t*hop
  const int live_lo = ft - hop, live_hi = ft + out_len - hop;  // the trimmed output, from frame1
  int err = tc::pack_synthesis((const float*)w, (float*)wp, ft, half, s);
  if (err) return err;
  pad_dout<<<tc::blocks((int64_t)batch * lp, 256), 256, 0, s>>>(
      (const float*)dout, (float*)doutp, batch, out_len, ft, lp);
  err = (int)cudaGetLastError();
  if (err) return err;
  SynthesisDspec p1;
  p1.xp = frame1;
  p1.wp = (const float*)wp;
  p1.batch = batch, p1.lp = lp, p1.ft = ft, p1.hop = hop, p1.half = half, p1.frames = live;
  p1.ldc = ldc;
  p1.live_lo = live_lo, p1.live_hi = live_hi;
  p1.partial = (float*)dspec;
  err = tc::launch(p1, rows, ldc, nsplit_dspec, vec, s);
  if (err) return err;
  const int64_t size = (int64_t)out_frames * batch * half;
  synthesis_adjoint<<<tc::blocks(size, 256), 256, 0, s>>>(
      (const float*)mag, (const float*)phs, (const float*)dspec, (float*)dmag, (float*)dphs,
      need_dw ? (float*)spec : nullptr, batch, out_frames, half, ldc, nsplit_dspec);
  err = (int)cudaGetLastError();
  if (err || !need_dw) return err;
  err = tc::launch(FrameDw{frame1, (const float*)spec, (float*)dw_partial, batch, lp, ft, hop,
                           live, ldc, live_lo, live_hi},
                   ft, ldc, nsplit_dw, vec, s);
  if (err) return err;
  sum_synthesis_partials<<<dim3(tc::blocks(ft, 32), tc::blocks(ldc, 32)), dim3(32, 8), 0, s>>>(
      (const float*)dw_partial, (float*)dw, ft, half, ldc, nsplit_dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
