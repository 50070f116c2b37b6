// One tensor-core matrix product with float32 accuracy, for Hopper (sm_90a),
// shared by kernels A and B (frontend.cu) and the products of kernels D and E
// (frontend_bwd.cu), with the passes around it that more than one of them
// uses: the weight repacks, the ordered sum of K slices and the overlap-add
// gather.
//
// Arithmetic: split TF32. Every f32 operand x is cut in registers into
// hi = tf32(x), rounded as cvt.rna.tf32.f32 rounds, and lo = x - hi, of which
// the tensor core reads the leading 11 bits (so hi + lo recovers x to
// 2^-21 |x|), and a . b is formed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
// small terms first, by three mma.sync.m16n8k8 TF32 products with f32
// accumulation. The tensor cores round their running sum toward zero, so the
// three products of one K chunk of 8 start from zero and their sum is added
// to the thread's f32 accumulator by an ordinary (round-to-nearest) add: 128
// such adds at K = 1024 instead of a chain of 384 truncations. Zeros split
// into zeros, so an all-padding frame still gives an exact 0 spectrum.
//
// What bounds it: operations. Three TF32 products at 495 TFLOP/s dense are
// 165 TFLOP/s of f32-accurate work, 2.5x the CUDA cores' 67 TFLOP/s.
//
// Feeding it: a 128 x 128 output tile a block (256 threads, 8 warps as 2 x 4,
// 4 x 4 mma tiles a warp, 64 accumulators a thread), K step
// 32, a ring of 3 shared-memory stages (110,592 bytes of dynamic shared
// memory, two blocks an SM) filled by cp.async with one __syncthreads() a
// step. An operand tile is stored as it lies in device memory: K-fast
// ([row][36]) or M/N-fast ([k][136]); both paddings make the mma fragment
// reads (32-bit scalars per thread) free of bank conflicts, so no operand is
// transposed anywhere. Out-of-range elements are zero-filled by cp.async's
// source size. VEC says how the tile is copied: 4 (16-byte copies, when hop,
// lp, ft and the pointers are multiples of 4 floats, as at the flagship
// geometry) or 1 (4-byte copies, any geometry). It is a choice between two
// loaders of the same kernel.
//
// An instance P says what the operands are and what happens to a finished
// tile:
//   A_KFAST / B_KFAST   which direction is contiguous in device memory
//   begin_tile(tile, m0, n0) -> K steps (of 32) this tile needs
//   row_a(tile, m), col_b(tile, n) -> int, what is fixed per row / column
//   begin_step(tile, step, st)
//   src_a(row, st, kk, n), src_b(col, st, kk, n) -> address of the element
//       (row, K index kk of this step), and in n how many elements from there
//       on, along the contiguous direction, are in range (<= 0: none)
//   base_a(), base_b(): any valid address of the operand
//   pair(m, n, v0, v1, z): elements (m, n) and (m, n + 1) of the finished
//       tile (n is even), K slice z
// The K steps of a tile can be cut into gridDim.z contiguous slices; slice z
// writes its own copy of the output and the pass that follows adds the copies
// in the order 0, 1, ... (sum_slices), so a result is bit-equal from run to
// run with no atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {
namespace {  // each library that includes this gets its own copy

constexpr int TILE = 128;    // rows and columns of a block's output tile
constexpr int BK = 32;       // K step
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDK = BK + 4;     // K-fast tile: [TILE][LDK]
constexpr int LDM = TILE + 8;   // M/N-fast tile: [BK][LDM]
constexpr int OPERAND = TILE * LDK;  // floats per operand and stage (>= BK * LDM)
constexpr int SMEM_BYTES = STAGES * 2 * OPERAND * (int)sizeof(float);
static_assert(BK * LDM <= OPERAND, "an M/N-fast tile must fit the operand's room");

// hi = x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away),
// done on the integer pipe, which is faster than the conversion unit; lo is
// the exact rest x - hi, whose low 13 bits the tensor core ignores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = a . b (16 x 8 x 8, TF32 operands, f32 sum from zero)
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d += a . b
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy VEC floats to the shared-memory address d, the first n of them from
// src and zeros for the rest.
template <int VEC>
__device__ __forceinline__ void copy_async(unsigned d, const float* src, int n) {
  const int bytes = (n < 0 ? 0 : (n > VEC ? VEC : n)) * 4;
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  }
}

// One TILE x TILE tile of the m x n output, K slice blockIdx.z. blockIdx.x is
// the row tile; the column tiles are taken from the last one down, so that
// the cheap blocks of a narrow last column tile start first and fill in
// beside full ones, instead of forming a round of their own at the end.
template <class P, int VEC>
__global__ void __launch_bounds__(THREADS, 2) product(const P p, int m, int n) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TILE;
  const int n0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const int m_rows = min(TILE, m - m0);
  const int n_cols = min(TILE, n - n0);

  typename P::Tile tile;
  const int total = p.begin_tile(tile, m0, n0);
  const int z = blockIdx.z;
  const int s_begin = (int)((int64_t)total * z / gridDim.z);
  const int s_end = (int)((int64_t)total * (z + 1) / gridDim.z);

  // ---- loaders: copies of VEC floats, COPIES of them a thread and operand.
  // K-fast operand: a thread keeps one K offset (k_lane) and takes rows
  // k_row + K_ROWS * e; M/N-fast: it keeps one row offset (m_lane) and takes K
  // indices m_k + M_KS * e. Rows and columns outside the block's part of the
  // output are zero-filled without a read.
  constexpr int COPIES = TILE * BK / (THREADS * VEC);
  constexpr int K_LANES = BK / VEC, K_ROWS = THREADS / K_LANES;
  constexpr int M_LANES = TILE / VEC, M_KS = THREADS / M_LANES;
  constexpr int NA = P::A_KFAST ? COPIES : 1;
  constexpr int NB = P::B_KFAST ? COPIES : 1;
  const int k_lane = (tid % K_LANES) * VEC, k_row = tid / K_LANES;
  const int m_lane = (tid % M_LANES) * VEC, m_k = tid / M_LANES;
  int rows[NA], cols[NB];
#pragma unroll
  for (int e = 0; e < NA; ++e)
    rows[e] = p.row_a(tile, m0 + (P::A_KFAST ? k_row + K_ROWS * e : m_lane));
#pragma unroll
  for (int e = 0; e < NB; ++e)
    cols[e] = p.col_b(tile, n0 + (P::B_KFAST ? k_row + K_ROWS * e : m_lane));

  const unsigned smem_at = (unsigned)__cvta_generic_to_shared(smem);
  auto load = [&](int step, int stage) {
    const unsigned sa = smem_at + stage * 2 * OPERAND * 4;  // byte addresses
    const unsigned sb = sa + OPERAND * 4;
    typename P::Step st;
    p.begin_step(tile, step, st);
#pragma unroll
    for (int e = 0; e < COPIES; ++e) {
      int c;
      if constexpr (P::A_KFAST) {
        const float* src = p.src_a(rows[e], st, k_lane, c);
        if (k_row + K_ROWS * e >= m_rows) c = 0;
        copy_async<VEC>(sa + ((k_row + K_ROWS * e) * LDK + k_lane) * 4,
                        c > 0 ? src : p.base_a(), c);
      } else {
        const int kk = m_k + M_KS * e;
        const float* src = p.src_a(rows[0], st, kk, c);
        c = min(c, m_rows - m_lane);
        copy_async<VEC>(sa + (kk * LDM + m_lane) * 4, c > 0 ? src : p.base_a(), c);
      }
      if constexpr (P::B_KFAST) {
        const float* src = p.src_b(cols[e], st, k_lane, c);
        if (k_row + K_ROWS * e >= n_cols) c = 0;
        copy_async<VEC>(sb + ((k_row + K_ROWS * e) * LDK + k_lane) * 4,
                        c > 0 ? src : p.base_b(), c);
      } else {
        const int kk = m_k + M_KS * e;
        const float* src = p.src_b(cols[0], st, kk, c);
        c = min(c, n_cols - m_lane);
        copy_async<VEC>(sb + (kk * LDM + m_lane) * 4, c > 0 ? src : p.base_b(), c);
      }
    }
  };

  // ---- mma fragments: lane = 4 * g + tig. A (16 x 8): rows g, g + 8,
  // K columns tig, tig + 4. B (8 x 8): K rows tig, tig + 4, column g.
  // C (16 x 8): rows g, g + 8, columns 2 * tig, 2 * tig + 1.
  // The 8 warps lie 2 x 4 over the tile. The 16-row mma tiles are dealt to
  // the two warp rows in turn (tile i of warp row r is rows 32 i + 16 r ...),
  // so a ragged last row tile (batch 200 = 128 + 72) leaves both with the same
  // work; a warp column owns 32 columns. A warp skips the mma tiles outside
  // the output, so a narrow last column tile (2*half = 1026 columns leave 2)
  // costs its block little.
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 32;
  const int mt = max(0, (m_rows - wm + 31) / 32);
  const int nt = max(0, min(4, (n_cols - wn + 7) / 8));
  const int a_base = P::A_KFAST ? (wm + g) * LDK + tig : tig * LDM + wm + g;
  const int b_base = P::B_KFAST ? (wn + g) * LDK + tig : tig * LDM + wn + g;
  constexpr int A_ROW = P::A_KFAST ? LDK : 1, A_K = P::A_KFAST ? 1 : LDM;
  constexpr int B_COL = P::B_KFAST ? LDK : 1, B_K = P::B_KFAST ? 1 : LDM;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // One stage's products. FULL: the warp has all four of its column tiles
  // (every warp of every block but those of a narrow last column tile), and
  // the code carries no test of nt.
  auto compute = [&](int stage, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const float* sa = smem + stage * 2 * OPERAND + a_base;
    const float* sb = smem + stage * 2 * OPERAND + OPERAND + b_base;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (FULL || j < nt) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            split_tf32(sb[j * 8 * B_COL + (k8 + 4 * q) * B_K], bh[j][q], bl[j][q]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < mt) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split_tf32(sa[(i * 32 + (q & 1) * 8) * A_ROW + (k8 + (q >> 1) * 4) * A_K], ah[q],
                       al[q]);
          // the chunk's three products on the tensor core, from zero, small
          // terms first; then one round-to-nearest add into the long sum
          float part[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || j < nt) mma_zero(part[j], al, bh[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || j < nt) mma_add(part[j], ah, bl[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || j < nt) mma_add(part[j], ah, bh[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || j < nt) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += part[j][q];
            }
        }
    }
  };

  // ---- the ring: STAGES - 1 steps in flight, one barrier a step
  const int steps = s_end - s_begin;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s_begin + s, s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int i = 0; i < steps; ++i) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // step i has landed; everyone is done with step i - 1's stage
    const int ahead = i + STAGES - 1;
    if (ahead < steps) load(s_begin + ahead, ahead % STAGES);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (nt == 4) {
      compute(i % STAGES, std::true_type{});
    } else if (nt > 0) {
      compute(i % STAGES, std::false_type{});
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= mt) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nt) break;
      const int row = m0 + wm + i * 32 + g;
      const int col = n0 + wn + j * 8 + 2 * tig;
      p.pair(row, col, acc[i][j][0], acc[i][j][1], z);
      p.pair(row + 8, col, acc[i][j][2], acc[i][j][3], z);
    }
  }
}

inline unsigned tiles(int64_t n) { return (unsigned)((n + TILE - 1) / TILE); }

inline unsigned blocks(int64_t n, int per) { return (unsigned)((n + per - 1) / per); }

// Launch an (m x n) product in nsplit K slices; vec as for `product`. An
// empty output launches nothing.
template <class P>
int launch(const P& p, int64_t m, int64_t n, int nsplit, int vec, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return 0;
  dim3 grid(tiles(m), tiles(n), (unsigned)nsplit);
  void (*kernel)(const P, int, int) = vec == 4 ? product<P, 4> : product<P, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(p, (int)m, (int)n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- K slices, in order
// The sum of the nsplit copies of one output element that a K-sliced product
// wrote, `slice` floats apart, added in the order 0, 1, ... for every run.
__device__ __forceinline__ float sum_slices(const float* p, int64_t slice, int nsplit) {
  float s = p[0];
  for (int z = 1; z < nsplit; ++z) s += p[z * slice];
  return s;
}

// ---------------------------------------------------------------- the weights
// Both stacked weights are repacked into wp (ft, ldc) before a product: column
// 2 * bin + part holds the stacked column part * half + bin, so that the
// thread that finishes a bin holds its re and im; ldc = 2 * half rounded up to
// a multiple of 4, the columns past 2 * half zero. Every row of wp then starts
// on a 16-byte boundary and a tile's columns are one contiguous run.
//   pack: the analysis weights w (ft, 2 * half), read as they lie.
//   pack_synthesis: the synthesis weights w (2 * half, ft), read transposed,
//     wp[j, 2 * bin + part] = w[part * half + bin, j]. Kernel B reads it
//     K-fast (K is the spectrum column), kernel E as the weights of its
//     spectrum product (K is the frame sample).
inline int packed_width(int half) { return (2 * half + 3) / 4 * 4; }

__global__ void pack_weights(const float* __restrict__ w, float* __restrict__ wp,
                             int ft, int half, int ldc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)ft * ldc) return;
  const int k = (int)(i / ldc), c = (int)(i % ldc);
  wp[i] = c < 2 * half ? w[(int64_t)k * 2 * half + (c & 1) * half + (c >> 1)] : 0.f;
}

inline int pack(const float* w, float* wp, int ft, int half, cudaStream_t stream) {
  const int ldc = packed_width(half);
  const int64_t size = (int64_t)ft * ldc;
  pack_weights<<<blocks(size, 256), 256, 0, stream>>>(w, wp, ft, half, ldc);
  return (int)cudaGetLastError();
}

// 32 x 32 tiles through shared memory (32 x 8 threads), so that the reads run
// along the rows of w and the writes along the rows of wp.
__global__ void pack_transposed(const float* __restrict__ w, float* __restrict__ wp,
                                int ft, int half, int ldc) {
  __shared__ float tile[32][33];
  const int j0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, j = j0 + tx;
    tile[i][tx] = c < 2 * half && j < ft ? w[(int64_t)((c & 1) * half + (c >> 1)) * ft + j] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int j = j0 + i, c = c0 + tx;
    if (j < ft && c < ldc) wp[(int64_t)j * ldc + c] = tile[tx][i];
  }
}

inline int pack_synthesis(const float* w, float* wp, int ft, int half, cudaStream_t stream) {
  const int ldc = packed_width(half);
  pack_transposed<<<dim3(blocks(ft, 32), blocks(ldc, 32)), dim3(32, 8), 0, stream>>>(
      w, wp, ft, half, ldc);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ live samples
// Kernels B and E work on the padded output (gradient), of which only the
// positions [live_lo, live_hi) of a row (counted from the first frame the
// kernel reads) can be non-zero: the trimmed output. A tile whose frames have
// no live sample in its part of a product skips the K steps or the whole tile
// that would only add zeros. For A and D every sample is live (0, lp), and
// nothing is skipped.
__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

// ------------------------------------------------------- the spectrum product
// spec2[r, 2 * bin + part] = sum_k xp[b, t * hop + k] * wp[k, 2 * bin + part]
// for row r = t * batch + b < frames * batch. Framing is an address offset.
// Kernel A: xp is the padded signal and the result twice the spectrum (the
// model's x/2 is a factor 0.5 on the finished sum, which is exact); kernel D's
// first product is the same code, so D's spectrum is A's bit for bit. Kernel E:
// xp is the padded output gradient, offset to the first frame that reaches
// the trimmed output, and wp the packed synthesis weights; a tile takes only
// the K steps (frame samples) that are live for one of its frames.
struct Spectrum {
  static constexpr bool A_KFAST = true;
  static constexpr bool B_KFAST = false;
  const float* xp;
  const float* wp;
  int batch, lp, ft, hop, half, frames, ldc;
  int live_lo, live_hi;
  struct Tile {
    int k0;  // first K index of the tile's steps
  };
  struct Step {
    int k0;
  };
  __device__ int begin_tile(Tile& tile, int m0, int) const {
    const int t_first = m0 / batch;
    const int t_last = (min(m0 + TILE, frames * batch) - 1) / batch;
    const int lo = max(0, live_lo - t_last * hop);
    const int hi = min(ft, live_hi - t_first * hop);
    tile.k0 = lo / BK * BK;
    return hi > tile.k0 ? (hi - tile.k0 + BK - 1) / BK : 0;
  }
  __device__ int row_a(const Tile&, int r) const {  // offset of the frame in xp, or -1
    if (r >= frames * batch) return -1;
    const int t = r / batch;
    return (r - t * batch) * lp + t * hop;
  }
  __device__ int col_b(const Tile&, int n) const { return n; }
  __device__ void begin_step(const Tile& tile, int step, Step& st) const {
    st.k0 = tile.k0 + step * BK;
  }
  __device__ const float* src_a(int row, const Step& st, int kk, int& n) const {
    n = row < 0 ? 0 : ft - st.k0 - kk;
    return xp + row + st.k0 + kk;
  }
  __device__ const float* src_b(int col, const Step& st, int kk, int& n) const {
    n = st.k0 + kk < ft ? ldc - col : 0;
    return wp + (int64_t)(st.k0 + kk) * ldc + col;
  }
  __device__ const float* base_a() const { return xp; }
  __device__ const float* base_b() const { return wp; }
};

// --------------------------------------------------------- the frame product
// out[z][r, j] = sum over the columns c of K slice z of spec[r, c] * wp[j, c],
// for r < rows: every sample of every frame, from an interleaved spectrum
// (rows, ldc) and packed weights (ft, ldc), both contiguous along c. Kernel
// D's frame gradients (its dspec and the analysis weights, one slice) and
// kernel B's frames (the spectrum and the synthesis weights) are this product.
// Row r is frame r / batch, whose sample j lies at position (r / batch) * hop
// + j; a tile with no live sample is skipped (its output is never read).
struct Frames {
  static constexpr bool A_KFAST = true;
  static constexpr bool B_KFAST = true;
  const float* spec;
  const float* wp;
  float* out;
  int rows, ft, ldc, batch, hop, live_lo, live_hi;
  struct Tile {};
  struct Step {
    int c0;
  };
  __device__ int begin_tile(Tile&, int m0, int n0) const {
    const int t_first = m0 / batch;
    const int t_last = (min(m0 + TILE, rows) - 1) / batch;
    const bool dead = n0 >= live_hi - t_first * hop || n0 + TILE <= live_lo - t_last * hop;
    return dead ? 0 : (ldc + BK - 1) / BK;
  }
  __device__ int row_a(const Tile&, int r) const { return r < rows ? r * ldc : -1; }
  __device__ int col_b(const Tile&, int j) const { return j < ft ? j * ldc : -1; }
  __device__ void begin_step(const Tile&, int step, Step& st) const { st.c0 = step * BK; }
  __device__ const float* src_a(int row, const Step& st, int kk, int& n) const {
    n = row < 0 ? 0 : ldc - st.c0 - kk;
    return spec + row + st.c0 + kk;
  }
  __device__ const float* src_b(int col, const Step& st, int kk, int& n) const {
    n = col < 0 ? 0 : ldc - st.c0 - kk;
    return wp + col + st.c0 + kk;
  }
  __device__ const float* base_a() const { return spec; }
  __device__ const float* base_b() const { return wp; }
  __device__ void pair(int r, int j, float v0, float v1, int z) const {
    if (r >= rows) return;
    float* dst = out + ((int64_t)z * rows + r) * ft + j;
    if (j < ft) dst[0] = v0;
    if (j + 1 < ft) dst[1] = v1;
  }
};

// ------------------------------------------------------------ the overlap-add
// out[b, n] = scale * sum over the frames t that cover sample p = n + offset,
// in order of t, of frames[(t - t_first) * batch + b, p - t * hop] (the sum
// of its nsplit K slices), for n < len. Only frames t_first ..
// t_first + n_frames - 1 are stored. A gather: every output is owned by one
// thread. Kernel D's dxp (offset 0, every frame, scale 0.5: the chain of the
// model's x/2) and kernel B's trimmed waveform (offset ft, the live frames).
__global__ void overlap_add(const float* __restrict__ frames, float* __restrict__ out, int batch,
                            int len, int offset, int ft, int hop, int t_first, int n_frames,
                            int nsplit, float scale) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)batch * len) return;
  const int b = (int)(i / len), p = (int)(i % len) + offset;
  const int t_lo = max(t_first, p >= ft ? (p - ft) / hop + 1 : 0);
  const int t_hi = min(p / hop, t_first + n_frames - 1);
  const int64_t slice = (int64_t)n_frames * batch * ft;
  float s = 0.f;
  for (int t = t_lo; t <= t_hi; ++t)
    s += sum_slices(frames + ((int64_t)(t - t_first) * batch + b) * ft + p - t * hop, slice, nsplit);
  out[i] = scale * s;
}

inline int gather(const float* frames, float* out, int batch, int len, int offset, int ft, int hop,
                  int t_first, int n_frames, int nsplit, float scale, cudaStream_t stream) {
  const int64_t size = (int64_t)batch * len;
  if (size <= 0) return 0;
  overlap_add<<<blocks(size, 256), 256, 0, stream>>>(frames, out, batch, len, offset, ft, hop,
                                                     t_first, n_frames, nsplit, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tc
