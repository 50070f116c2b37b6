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
// What bounds them on an H100: five f32-accurate matrix products with fused
// prologues and epilogues (D three of 2*B*T*ft*2*half flops, E two over the
// frame samples that reach the trimmed output), against a few tens of MB of
// traffic: operations, not bytes. dspec's trip through device memory between
// D's products (20.5 MB at batch 200, written once and read twice) is ~18 us
// at 3.35 TB/s, a few percent of D; the product rate is what counts.
//
// The design of D: its three products run on the tensor cores through the
// split-TF32 main loop of tc_product.cuh (as accurate as f32, bound 165
// TFLOP/s of f32-accurate work, cp.async ring, 128 x 128 tiles); each
// instance only says how an operand element is addressed and what happens to
// a finished pair of columns:
//   * the first product is kernel A's (tc::Spectrum, the same code, so the
//     spectrum is A's bit for bit and `sq >= 1e-36` decides as the forward
//     did); re and im of a bin are neighbouring columns, so one thread holds
//     both for the magnitude / phase adjoints. dspec is written in that
//     interleaved order, (rows, ldc) with ldc = 2*half rounded up to a
//     multiple of 4 and zeros in the padding columns, so that every later
//     16-byte copy of it is aligned;
//   * framing of the input stays an address offset (xp + b*lp + t*hop + j):
//     no framed copy of xp exists;
//   * dxp comes from the gradient of every frame, dframes = dspec . w^T, one
//     plain product, and an overlap-add written as a gather: a sample is owned
//     by one thread, which adds the frames that cover it in order. dframes
//     (B*T, ft) exists only when dxp is asked for (training does not);
//   * dW sums over all (t, b) rows as one flat K. The TPU kernel adds each
//     grid step's dW into one buffer, serially. Here every dW tile is owned by
//     one block per K slice: the rows are cut into `nsplit` contiguous slices
//     (as many as keep all blocks on the card at once), each block writes its
//     partial tile to scratch, and a second kernel adds the slices in a fixed
//     order and undoes the interleave. No atomics, so dW is bit-equal from
//     run to run;
//   * every load is bounds-checked to an exact 0 (cp.async zero fill).
// The design of E: one register-tiled SIMT product on the CUDA cores (128 x 64
// tile, K step 16, 256 threads, 8 x 4 accumulators a thread, the next step's
// operands fetched into registers while this step's products run),
// instantiated twice. E skips what is zero by construction: a frame's samples
// outside the trimmed output (frames 0 and OT-1 entirely) take no K steps, and
// their dmag / dphs come out as exact zeros; its dW is cut into K slices as
// D's. E's spectrum passes through device memory between its products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_product.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 4;
constexpr int LDA = BM + 4;  // padded rows, still 16-byte aligned
constexpr int LDB = BN + 4;
constexpr int THREADS = 256;
constexpr int A_PER_THREAD = BM * BK / THREADS;  // 8
constexpr int B_PER_THREAD = BN * BK / THREADS;  // 4

// C[m, n] = sum_k A[m, k] * B[k, n] over the K steps of one tile, or of slice
// blockIdx.z of them. P says what A and B are:
//   begin_tile(tile, m0, n0) -> number of K steps (of BK) this tile needs
//   row_a(tile, m), col_b(tile, n): what is fixed per row / column
//   begin_step(tile, step, st): what is fixed per K step
//   load_a(row, st, kk), load_b(col, st, kk): one element, 0 out of range
//   epilogue(m, n, acc, z): rows m..m+7, columns n..n+3 of the finished tile
// A_KFAST / B_KFAST: whether neighbouring threads fetch neighbouring k (the
// operand is contiguous along K) or neighbouring rows / columns.
template <class P>
__global__ void __launch_bounds__(THREADS, 2) tiled_product(const P p) {
  __shared__ __align__(16) float as[BK][LDA];
  __shared__ __align__(16) float bs[BK][LDB];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  typename P::Tile tile;
  const int total = p.begin_tile(tile, m0, n0);
  const int nsplit = gridDim.z;
  const int z = blockIdx.z;
  const int s_begin = (int)((int64_t)total * z / nsplit);
  const int s_end = (int)((int64_t)total * (z + 1) / nsplit);

  int a_m[A_PER_THREAD], a_kk[A_PER_THREAD], b_n[B_PER_THREAD], b_kk[B_PER_THREAD];
  typename P::RowA rows[A_PER_THREAD];
  typename P::ColB cols[B_PER_THREAD];
#pragma unroll
  for (int e = 0; e < A_PER_THREAD; ++e) {
    if constexpr (P::A_KFAST) {
      a_kk[e] = tid % BK;
      a_m[e] = tid / BK + (THREADS / BK) * e;
    } else {
      a_m[e] = tid % BM;
      a_kk[e] = tid / BM + (THREADS / BM) * e;
    }
    rows[e] = p.row_a(tile, m0 + a_m[e]);
  }
#pragma unroll
  for (int e = 0; e < B_PER_THREAD; ++e) {
    if constexpr (P::B_KFAST) {
      b_kk[e] = tid % BK;
      b_n[e] = tid / BK + (THREADS / BK) * e;
    } else {
      b_n[e] = tid % BN;
      b_kk[e] = tid / BN + (THREADS / BN) * e;
    }
    cols[e] = p.col_b(tile, n0 + b_n[e]);
  }

  float a_reg[A_PER_THREAD], b_reg[B_PER_THREAD];
  auto fetch = [&](int step) {
    typename P::Step st;
    p.begin_step(tile, step, st);
#pragma unroll
    for (int e = 0; e < A_PER_THREAD; ++e) a_reg[e] = p.load_a(rows[e], st, a_kk[e]);
#pragma unroll
    for (int e = 0; e < B_PER_THREAD; ++e) b_reg[e] = p.load_b(cols[e], st, b_kk[e]);
  };
  auto stash = [&]() {
#pragma unroll
    for (int e = 0; e < A_PER_THREAD; ++e) as[a_kk[e]][a_m[e]] = a_reg[e];
#pragma unroll
    for (int e = 0; e < B_PER_THREAD; ++e) bs[b_kk[e]][b_n[e]] = b_reg[e];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (s_begin < s_end) {
    fetch(s_begin);
    stash();
    __syncthreads();
  }
  for (int step = s_begin; step < s_end; ++step) {
    const bool more = step + 1 < s_end;
    if (more) fetch(step + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * TM + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stash();
      __syncthreads();
    }
  }
  p.epilogue(m0 + ty * TM, n0 + tx * TN, acc, z);
}

struct KStep {
  int k0;
};
struct FrameStep {  // one frame t, and 16 batch rows or 16 spectrum channels of it
  int t;
  int k0;
};

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
// dframes[r, j] = sum over channels c of dspec[r, c] * wp[j, c]: the gradient
// of every frame, both operands contiguous along c. dxp is its overlap-add,
// taken as a gather by a second kernel: sample n of window b is owned by one
// thread, which adds the <= ceil(ft/hop) frames that cover it, in order. (One
// product whose K runs over the covering frames too would spare dframes' trip
// through device memory, ~20 MB at batch 200 or ~10 us, but a 128-sample tile
// is covered by 3 frames where a sample is covered by 2.67, and 200 windows
// fill 2 tiles of 128 rows by 78%: it did 58% more work and took 0.47 ms
// against 0.29.)
struct AnalysisDframes {
  static constexpr bool A_KFAST = true;
  static constexpr bool B_KFAST = true;
  const float* dspec;
  const float* wp;
  float* dframes;
  int rows, ft, ldc;
  struct Tile {};
  struct Step {
    int c0;
  };
  __device__ int begin_tile(Tile&, int, int) const { return (ldc + tc::BK - 1) / tc::BK; }
  __device__ int row_a(const Tile&, int r) const { return r < rows ? r * ldc : -1; }
  __device__ int col_b(const Tile&, int j) const { return j < ft ? j * ldc : -1; }
  __device__ void begin_step(const Tile&, int step, Step& st) const { st.c0 = step * tc::BK; }
  __device__ const float* src_a(int row, const Step& st, int kk, int& n) const {
    n = row < 0 ? 0 : ldc - st.c0 - kk;
    return dspec + row + st.c0 + kk;
  }
  __device__ const float* src_b(int col, const Step& st, int kk, int& n) const {
    n = col < 0 ? 0 : ldc - st.c0 - kk;
    return wp + col + st.c0 + kk;
  }
  __device__ const float* base_a() const { return dspec; }
  __device__ const float* base_b() const { return wp; }
  __device__ void pair(int r, int j, float v0, float v1, int) const {
    if (r >= rows) return;
    float* dst = dframes + (int64_t)r * ft + j;
    if (j < ft) dst[0] = v0;
    if (j + 1 < ft) dst[1] = v1;
  }
};

// dxp[b, n] = 0.5 * sum over the frames t covering n of dframes[t*batch + b, n - t*hop]
// (the 0.5 is the chain of the model's x/2); 0 past the last frame.
__global__ void overlap_add_dx(const float* __restrict__ dframes, float* __restrict__ dxp,
                               int batch, int lp, int ft, int hop, int frames) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)batch * lp) return;
  const int b = (int)(i / lp), n = (int)(i % lp);
  const int t_lo = n >= ft ? (n - ft) / hop + 1 : 0;
  const int t_hi = n / hop < frames - 1 ? n / hop : frames - 1;
  float s = 0.f;
  for (int t = t_lo; t <= t_hi; ++t) s += dframes[((int64_t)t * batch + b) * ft + n - t * hop];
  dxp[i] = 0.5f * s;
}

// ------------------------------------------------------------------ D, part 3
// partial[z][j, c] = sum over the rows r = t*batch + b of slice z of
// xp[b, t*hop + j] * dspec[r, c] (c interleaved; the x/2 is applied by the
// second pass). K is the flat row index.
struct AnalysisDw {
  static constexpr bool A_KFAST = false;
  static constexpr bool B_KFAST = false;
  const float* xp;
  const float* dspec;
  float* partial;
  int batch, lp, ft, hop, frames, ldc;
  struct Tile {};
  struct Step {
    int r0;  // first row of the step, = t0 * batch + b0
    int t0;
    int b0;
  };
  __device__ int begin_tile(Tile&, int, int) const {
    return (frames * batch + tc::BK - 1) / tc::BK;
  }
  __device__ int row_a(const Tile&, int j) const { return j; }
  __device__ int col_b(const Tile&, int c) const { return c; }
  __device__ void begin_step(const Tile&, int step, Step& st) const {
    st.r0 = step * tc::BK;
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
    return dspec + (int64_t)r * ldc + c;
  }
  __device__ const float* base_a() const { return xp; }
  __device__ const float* base_b() const { return dspec; }
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
  const int64_t src = (int64_t)j * ldc + 2 * bin + part;
  float s = partial[src];
  for (int z = 1; z < nsplit; ++z) s += partial[(int64_t)z * ft * ldc + src];
  dw[i] = 0.5f * s;
}

// ------------------------------------------------------------------ E, part 1
// dspec[t, b, c] = sum_j dframe[t, b, j] * w[c, j], then dmag, dphs and the
// spectrum (mag*cos, mag*sin) that part 2 needs. dframe[t, b, j] is dout at
// t*hop + j - ft where that is inside the trimmed output, else 0; K covers only
// the j range that is live for some frame of the tile.
struct SynthesisDspec {
  static constexpr bool A_KFAST = true;
  static constexpr bool B_KFAST = true;
  const float* mag;
  const float* phs;
  const float* w;
  const float* dout;
  float* dmag;
  float* dphs;
  float* spec;
  int batch, out_frames, ft, hop, half, out_len;
  struct Tile {
    int j_lo;
  };
  using Step = KStep;
  struct RowA {
    const float* src;  // dout row of this window
    int off;           // position of frame sample 0 in the trimmed output
    bool ok;
  };
  struct ColB {
    const float* src;
    bool ok;
  };
  __device__ int begin_tile(Tile& tile, int m0, int) const {
    const int rows = out_frames * batch;
    const int last = (m0 + BM < rows ? m0 + BM : rows) - 1;
    const int t_first = m0 / batch;
    const int t_last = last / batch;
    // frame t is live for j in [ft - t*hop, (out_frames - 1 - t)*hop), cut to [0, ft)
    int j_lo = ft - t_last * hop;
    if (j_lo < 0) j_lo = 0;
    int j_hi = (out_frames - 1 - t_first) * hop;
    if (j_hi > ft) j_hi = ft;
    tile.j_lo = (j_lo / BK) * BK;
    return j_hi > tile.j_lo ? (j_hi - tile.j_lo + BK - 1) / BK : 0;
  }
  __device__ RowA row_a(const Tile&, int r) const {
    const bool ok = r < out_frames * batch;
    const int t = ok ? r / batch : 0;
    const int b = ok ? r % batch : 0;
    return {dout + (int64_t)b * out_len, t * hop - ft, ok};
  }
  __device__ ColB col_b(const Tile&, int n) const {
    const int bin = n >> 1;
    const bool ok = bin < half;
    return {w + ((int64_t)(n & 1) * half + (ok ? bin : 0)) * ft, ok};
  }
  __device__ void begin_step(const Tile& tile, int step, Step& st) const {
    st.k0 = tile.j_lo + step * BK;
  }
  __device__ float load_a(const RowA& r, const Step& st, int kk) const {
    const int j = st.k0 + kk;
    const int pos = r.off + j;
    return (r.ok && j < ft && pos >= 0 && pos < out_len) ? r.src[pos] : 0.f;
  }
  __device__ float load_b(const ColB& c, const Step& st, int kk) const {
    const int j = st.k0 + kk;
    return (c.ok && j < ft) ? c.src[j] : 0.f;
  }
  __device__ void epilogue(int m, int n, const float (&acc)[TM][TN], int) const {
    const int64_t rows = (int64_t)out_frames * batch;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t r = m + i;
      if (r >= rows) continue;
#pragma unroll
      for (int q = 0; q < TN / 2; ++q) {
        const int bin = n / 2 + q;
        if (bin >= half) continue;
        const float d_re = acc[i][2 * q];
        const float d_im = acc[i][2 * q + 1];
        const float mg = mag[r * half + bin];
        float s, c;
        sincosf(phs[r * half + bin], &s, &c);
        dmag[r * half + bin] = d_re * c + d_im * s;
        dphs[r * half + bin] = mg * (d_im * c - d_re * s);
        spec[r * 2 * half + bin] = mg * c;
        spec[r * 2 * half + half + bin] = mg * s;
      }
    }
  }
};

// ------------------------------------------------------------------ E, part 2
// dw[c, j] = sum over (t, b) of spec[t, b, c] * dframe[t, b, j]. K runs over
// the frames that are live somewhere in the tile's j range, and within a frame
// over the batch in steps of 16.
struct SynthesisDw {
  static constexpr bool A_KFAST = false;
  static constexpr bool B_KFAST = false;
  const float* spec;
  const float* dout;
  float* out;  // dw, or nsplit partial copies of it
  int batch, out_frames, ft, hop, half, out_len;
  struct Tile {
    int t_lo;
    int nbt;
  };
  using Step = FrameStep;
  struct RowA {
    int c;
    bool ok;
  };
  struct ColB {
    int j;
    bool ok;
  };
  __device__ int begin_tile(Tile& tile, int, int n0) const {
    tile.nbt = (batch + BK - 1) / BK;
    int t_lo = out_frames, t_hi = -1;
    for (int t = 0; t < out_frames; ++t) {
      const int lo = ft - t * hop;                  // live j are [lo, hi) cut to [0, ft)
      const int hi = (out_frames - 1 - t) * hop;
      if (lo < n0 + BN && hi > n0) {
        if (t < t_lo) t_lo = t;
        t_hi = t;
      }
    }
    tile.t_lo = t_lo;
    return t_hi >= t_lo ? (t_hi - t_lo + 1) * tile.nbt : 0;
  }
  __device__ RowA row_a(const Tile&, int m) const { return {m, m < 2 * half}; }
  __device__ ColB col_b(const Tile&, int n) const { return {n, n < ft}; }
  __device__ void begin_step(const Tile& tile, int step, Step& st) const {
    st.t = tile.t_lo + step / tile.nbt;
    st.k0 = (step % tile.nbt) * BK;
  }
  __device__ float load_a(const RowA& r, const Step& st, int kk) const {
    const int b = st.k0 + kk;
    return (r.ok && b < batch) ? spec[((int64_t)st.t * batch + b) * 2 * half + r.c] : 0.f;
  }
  __device__ float load_b(const ColB& col, const Step& st, int kk) const {
    const int b = st.k0 + kk;
    const int pos = st.t * hop + col.j - ft;
    return (col.ok && b < batch && pos >= 0 && pos < out_len) ? dout[(int64_t)b * out_len + pos]
                                                              : 0.f;
  }
  __device__ void epilogue(int m, int n, const float (&acc)[TM][TN], int z) const {
    float* dst = out + (int64_t)z * 2 * half * ft;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (m + i >= 2 * half) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < ft) dst[(int64_t)(m + i) * ft + n + j] = acc[i][j];
    }
  }
};

// dw = partial[0] + partial[1] + ... in that order, for every run.
__global__ void sum_partials(const float* __restrict__ partial, float* __restrict__ out,
                             int64_t size, int nsplit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = partial[i];
  for (int z = 1; z < nsplit; ++z) s += partial[(int64_t)z * size + i];
  out[i] = s;
}

inline unsigned tiles(int64_t n, int tile) { return (unsigned)((n + tile - 1) / tile); }

template <class P>
int launch(const P& p, int64_t m, int64_t n, int nsplit, cudaStream_t stream) {
  dim3 grid(tiles(m, BM), tiles(n, BN), (unsigned)nsplit);
  tiled_product<P><<<grid, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

int reduce(const float* partial, float* out, int64_t size, int nsplit, cudaStream_t stream) {
  sum_partials<<<tiles(size, 256), 256, 0, stream>>>(partial, out, size, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// xp (batch, lp) padded signal, not halved; w (ft, 2*half); dmag, dphs
// (frames, batch, half); scratch: wp (ft, ldc), dspec (frames*batch, ldc),
// dw_partial (nsplit, ft, ldc), with ldc = 2*half rounded up to a multiple of
// 4, and dframes (frames*batch, ft), read and written when need_dxp; dxp
// (batch, lp), written when need_dxp; dw (ft, 2*half), written when need_dw. vec is 4 when hop, lp, ft and the pointers allow 16-byte copies,
// else 1.
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
  p1.dmag = (const float*)dmag;
  p1.dphs = (const float*)dphs;
  p1.dspec = (float*)dspec;
  err = tc::launch(p1, rows, ldc, 1, vec, s);
  if (err) return err;
  if (need_dxp) {
    err = tc::launch(AnalysisDframes{(const float*)dspec, (const float*)wp, (float*)dframes,
                                     (int)rows, ft, ldc},
                     rows, ft, 1, vec, s);
    if (err) return err;
    overlap_add_dx<<<tiles((int64_t)batch * lp, 256), 256, 0, s>>>(
        (const float*)dframes, (float*)dxp, batch, lp, ft, hop, frames);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (need_dw) {
    err = tc::launch(AnalysisDw{(const float*)xp, (const float*)dspec, (float*)dw_partial,
                                batch, lp, ft, hop, frames, ldc},
                     ft, ldc, nsplit, vec, s);
    if (err) return err;
    const int64_t size = (int64_t)ft * 2 * half;
    sum_analysis_partials<<<tiles(size, 256), 256, 0, s>>>(
        (const float*)dw_partial, (float*)dw, ft, half, ldc, nsplit);
    err = (int)cudaGetLastError();
  }
  return err;
}

// mag, phs (out_frames, batch, half); w (2*half, ft); dout (batch, out_len)
// with out_len = (out_frames - 1)*hop - ft; dmag, dphs like mag; spec scratch
// (out_frames*batch, 2*half); dw_partial scratch (nsplit, 2*half, ft), read
// only when nsplit > 1; dw (2*half, ft), written when need_dw.
int st_synthesis_bwd(const void* mag, const void* phs, const void* w, const void* dout,
                     void* dmag, void* dphs, void* spec, void* dw_partial, void* dw,
                     int batch, int out_frames, int ft, int hop, int half, int out_len,
                     int nsplit, int need_dw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = (int64_t)out_frames * batch;
  int err = launch(SynthesisDspec{(const float*)mag, (const float*)phs, (const float*)w,
                                  (const float*)dout, (float*)dmag, (float*)dphs, (float*)spec,
                                  batch, out_frames, ft, hop, half, out_len},
                   rows, 2 * (int64_t)half, 1, s);
  if (err) return err;
  if (need_dw) {
    float* out = nsplit > 1 ? (float*)dw_partial : (float*)dw;
    err = launch(SynthesisDw{(const float*)spec, (const float*)dout, out,
                             batch, out_frames, ft, hop, half, out_len},
                 2 * (int64_t)half, ft, nsplit, s);
    if (err) return err;
    if (nsplit > 1) err = reduce(out, (float*)dw, (int64_t)2 * half * ft, nsplit, s);
  }
  return err;
}

}  // extern "C"
