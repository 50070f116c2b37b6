// One tensor-core matrix product for Hopper (sm_90a), in two operand modes,
// shared by kernels A and B (frontend.cu) and the products of kernels D and E
// (frontend_bwd.cu), with the passes around it that more than one of them
// uses: the weight repacks, the ordered sum of K slices and the overlap-add
// gather. An instance P names its operand type P::T; the loop is one template
// for both.
//
// float operands (the float32 compute dtype): split TF32. Every f32 operand x
// is cut in registers into hi = tf32(x), rounded as cvt.rna.tf32.f32 rounds,
// and lo = x - hi, of which the tensor core reads the leading 11 bits (so
// hi + lo recovers x to 2^-21 |x|), and a . b is formed as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, small terms first, by three
// mma.sync.m16n8k8 TF32 products with f32 accumulation. The tensor cores
// round their running sum toward zero, so the three products of one K chunk
// of 8 start from zero and their sum is added to the thread's f32
// accumulator by an ordinary (round-to-nearest) add: 128 such adds at
// K = 1024 instead of a chain of 384 truncations. Zeros split into zeros, so
// an all-padding frame still gives an exact 0 spectrum. Bound: three TF32
// products at 495 TFLOP/s dense are 165 TFLOP/s of f32-accurate work, 2.5x
// the CUDA cores' 67 TFLOP/s.
//
// bf16 operands (the bfloat16 compute dtype, the JAX package's
// `dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32)`): the
// operands were rounded to bf16 (to nearest even) by the pass that wrote
// them, and one mma.sync.m16n8k16 bf16 product with f32 accumulation a K
// chunk of 16 forms the exact products; as above, each chunk starts from
// zero and is added to the f32 accumulator by a round-to-nearest add (64 adds
// at K = 1024). Bound: the dense bf16 rate, 989 TFLOP/s; mma.sync reaches
// about half of it. The wgmma schedule of wgmma_product.cuh takes over every
// mode of A, B, D and E, in bf16 and in float32, where TMA can read its
// operands; this loop stays as their second schedule and as the only one
// where TMA cannot read the frames (a hop or row that is no multiple of 16
// bytes, or float32 A's and D's signal off a 16-byte boundary).
//
// Feeding it: a 128 x 128 output tile a block (256 threads, 8 warps as 2 x 4,
// 4 x 4 mma tiles a warp, 64 accumulators a thread), K step 32, a ring of 3
// shared-memory stages (f32: 110,592 bytes of dynamic shared memory; bf16:
// 61,440; two blocks an SM) filled by cp.async with one __syncthreads() a
// step. An operand tile is stored as it lies in device memory: K-fast
// ([row][LDK]) or M/N-fast ([k][136]). f32: LDK 36, the fragments are
// 32-bit scalars; bf16: LDK 40, a fragment register is two K-adjacent
// values, one 32-bit read from a K-fast tile and two 16-bit reads from an
// M/N-fast one. Every one of these paddings keeps the fragment reads free of
// bank conflicts, so no operand is transposed anywhere. Out-of-range elements
// are zero-filled by cp.async's source size. VEC says how the tile is copied:
// 16 bytes (4 floats or 8 bf16, when hop, lp, ft and the pointers are
// multiples of 16 bytes, as at the flagship geometry) or one element (any
// geometry: a 4-byte cp.async for f32; for bf16, whose 2 bytes are below
// cp.async's smallest copy, an ordinary load and shared-memory store). It is
// a choice between two loaders of the same kernel.
//
// An instance P says what the operands are and what happens to a finished
// tile:
//   T                   the operand type, float or __nv_bfloat16
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {
namespace {  // each library that includes this gets its own copy

constexpr int TILE = 128;    // rows and columns of a block's output tile
constexpr int BK = 32;       // K step
constexpr int STAGES = 3;
constexpr int THREADS = 256;

using bf16 = __nv_bfloat16;

template <class T>
__host__ __device__ constexpr bool is_f32() { return std::is_same<T, float>::value; }

// The shared-memory layout of one operand type T.
template <class T>
struct Smem {
  static_assert(is_f32<T>() || std::is_same<T, bf16>::value, "float or bf16 operands");
  static constexpr int LDK = BK + (is_f32<T>() ? 4 : 8);  // K-fast tile: [TILE][LDK]
  static constexpr int LDM = TILE + 8;                    // M/N-fast tile: [BK][LDM]
  static constexpr int OPERAND = TILE * LDK;  // elements per operand and stage (>= BK * LDM)
  static constexpr int BYTES = STAGES * 2 * OPERAND * (int)sizeof(T);
  static constexpr int WIDE = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  static_assert(BK * LDM <= OPERAND, "an M/N-fast tile must fit the operand's room");
};

// x rounded to the operand type: bf16 to nearest even, as JAX's astype rounds.
template <class T>
__device__ __forceinline__ T round_to(float x) {
  if constexpr (is_f32<T>()) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// p[0] = a, p[1] = b in the operand type (p is 2-element aligned).
template <class T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (is_f32<T>()) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

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

// d = a . b (16 x 8 x 16, bf16 operands, f32 sum from zero)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// Copy VEC elements of type T to the shared-memory address d, the first n of
// them from src and zeros for the rest.
template <class T, int VEC>
__device__ __forceinline__ void copy_async(unsigned d, const T* src, int n) {
  constexpr int SIZE = VEC * (int)sizeof(T);
  const int bytes = (n < 0 ? 0 : (n > VEC ? VEC : n)) * (int)sizeof(T);
  if constexpr (SIZE == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  } else if constexpr (SIZE == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    static_assert(SIZE == 2, "16-, 4- or 2-byte copies");
    // below cp.async's smallest copy: an ordinary load and store, which the
    // ring's barrier orders like a landed cp.async
    const unsigned short v = bytes > 0 ? *reinterpret_cast<const unsigned short*>(src) : 0;
    asm volatile("st.shared.u16 [%0], %1;" ::"r"(d), "h"(v) : "memory");
  }
}

// Two K-adjacent bf16 (K indices k and k + 1, the first in the low half) of
// row (or column) r of an operand tile: one 32-bit read from a K-fast tile
// [r][LD], two 16-bit reads from an M/N-fast one [k][LD].
template <bool KFAST, int LD>
__device__ __forceinline__ uint32_t bf16_pair(const unsigned short* s, int r, int k) {
  if constexpr (KFAST) {
    return *reinterpret_cast<const uint32_t*>(s + r * LD + k);
  } else {
    return (uint32_t)s[k * LD + r] | ((uint32_t)s[(k + 1) * LD + r] << 16);
  }
}

// One TILE x TILE tile of the m x n output, K slice blockIdx.z. blockIdx.x is
// the row tile; the column tiles are taken from the last one down, so that
// the cheap blocks of a narrow last column tile start first and fill in
// beside full ones, instead of forming a round of their own at the end.
template <class P, int VEC>
__global__ void __launch_bounds__(THREADS, 2) product(const P p, int m, int n) {
  using T = typename P::T;
  using S = Smem<T>;
  constexpr int LDK = S::LDK, LDM = S::LDM, OPERAND = S::OPERAND;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const T* smem = reinterpret_cast<const T*>(smem_bytes);

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

  // ---- loaders: copies of VEC elements, COPIES of them a thread and operand.
  // K-fast operand: a thread keeps one K offset (k_lane) and takes rows
  // k_row + K_ROWS * e; M/N-fast: it keeps one row offset (m_lane) and takes K
  // indices m_k + M_KS * e. Rows and columns outside the block's part of the
  // output are zero-filled without a read.
  constexpr int COPIES = TILE * BK / (THREADS * VEC);
  constexpr int K_LANES = BK / VEC, K_ROWS = THREADS / K_LANES;
  constexpr int M_LANES = TILE / VEC, M_KS = THREADS / M_LANES;
  constexpr int NA = P::A_KFAST ? COPIES : 1;
  constexpr int NB = P::B_KFAST ? COPIES : 1;
  constexpr int ES = (int)sizeof(T);
  const int k_lane = (tid % K_LANES) * VEC, k_row = tid / K_LANES;
  const int m_lane = (tid % M_LANES) * VEC, m_k = tid / M_LANES;
  int rows[NA], cols[NB];
#pragma unroll
  for (int e = 0; e < NA; ++e)
    rows[e] = p.row_a(tile, m0 + (P::A_KFAST ? k_row + K_ROWS * e : m_lane));
#pragma unroll
  for (int e = 0; e < NB; ++e)
    cols[e] = p.col_b(tile, n0 + (P::B_KFAST ? k_row + K_ROWS * e : m_lane));

  const unsigned smem_at = (unsigned)__cvta_generic_to_shared(smem_bytes);
  auto load = [&](int step, int stage) {
    const unsigned sa = smem_at + stage * 2 * OPERAND * ES;  // byte addresses
    const unsigned sb = sa + OPERAND * ES;
    typename P::Step st;
    p.begin_step(tile, step, st);
#pragma unroll
    for (int e = 0; e < COPIES; ++e) {
      int c;
      if constexpr (P::A_KFAST) {
        const T* src = p.src_a(rows[e], st, k_lane, c);
        if (k_row + K_ROWS * e >= m_rows) c = 0;
        copy_async<T, VEC>(sa + ((k_row + K_ROWS * e) * LDK + k_lane) * ES,
                           c > 0 ? src : p.base_a(), c);
      } else {
        const int kk = m_k + M_KS * e;
        const T* src = p.src_a(rows[0], st, kk, c);
        c = min(c, m_rows - m_lane);
        copy_async<T, VEC>(sa + (kk * LDM + m_lane) * ES, c > 0 ? src : p.base_a(), c);
      }
      if constexpr (P::B_KFAST) {
        const T* src = p.src_b(cols[e], st, k_lane, c);
        if (k_row + K_ROWS * e >= n_cols) c = 0;
        copy_async<T, VEC>(sb + ((k_row + K_ROWS * e) * LDK + k_lane) * ES,
                           c > 0 ? src : p.base_b(), c);
      } else {
        const int kk = m_k + M_KS * e;
        const T* src = p.src_b(cols[0], st, kk, c);
        c = min(c, n_cols - m_lane);
        copy_async<T, VEC>(sb + (kk * LDM + m_lane) * ES, c > 0 ? src : p.base_b(), c);
      }
    }
  };

  // ---- mma fragments: lane = 4 * g + tig. The 8 warps lie 2 x 4 over the
  // tile. The 16-row mma tiles are dealt to the two warp rows in turn (tile i
  // of warp row r is rows 32 i + 16 r ...), so a ragged last row tile (batch
  // 200 = 128 + 72) leaves both with the same work; a warp column owns 32
  // columns. A warp skips the mma tiles outside the output, so a narrow last
  // column tile (2*half = 1026 columns leave 2) costs its block little.
  // C (16 x 8), both modes: rows g, g + 8, columns 2 * tig, 2 * tig + 1.
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * 32;
  const int mt = max(0, (m_rows - wm + 31) / 32);
  const int nt = max(0, min(4, (n_cols - wn + 7) / 8));

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // One stage's products, split TF32 (f32 operands). Fragments: A (16 x 8)
  // rows g, g + 8, K columns tig, tig + 4; B (8 x 8) K rows tig, tig + 4,
  // column g. FULL: the warp has all four of its column tiles (every warp of
  // every block but those of a narrow last column tile), and the code carries
  // no test of nt.
  auto compute_tf32 = [&](int stage, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const int a_base = P::A_KFAST ? (wm + g) * LDK + tig : tig * LDM + wm + g;
    const int b_base = P::B_KFAST ? (wn + g) * LDK + tig : tig * LDM + wn + g;
    constexpr int A_ROW = P::A_KFAST ? LDK : 1, A_K = P::A_KFAST ? 1 : LDM;
    constexpr int B_COL = P::B_KFAST ? LDK : 1, B_K = P::B_KFAST ? 1 : LDM;
    const float* sa = reinterpret_cast<const float*>(smem) + stage * 2 * OPERAND + a_base;
    const float* sb = reinterpret_cast<const float*>(smem) + stage * 2 * OPERAND + OPERAND + b_base;
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

  // One stage's products, bf16 operands. Fragments, each register two
  // K-adjacent values: A (16 x 16) register q holds row g + 8 (q & 1), K
  // columns 2 tig + 8 (q >> 1) and the next; B (16 x 8) register q holds K
  // rows 2 tig + 8 q and the next, column g.
  auto compute_bf16 = [&](int stage, auto full) {
    constexpr bool FULL = decltype(full)::value;
    const unsigned short* sa = reinterpret_cast<const unsigned short*>(smem) + stage * 2 * OPERAND;
    const unsigned short* sb = sa + OPERAND;
    constexpr int LDA = P::A_KFAST ? LDK : LDM, LDB = P::B_KFAST ? LDK : LDM;
#pragma unroll
    for (int k16 = 0; k16 < BK; k16 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (FULL || j < nt) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            b[j][q] = bf16_pair<P::B_KFAST, LDB>(sb, wn + j * 8 + g, k16 + 2 * tig + 8 * q);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < mt) {
          uint32_t a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = bf16_pair<P::A_KFAST, LDA>(sa, wm + i * 32 + (q & 1) * 8 + g,
                                              k16 + 2 * tig + (q >> 1) * 8);
          // the chunk's product on the tensor core, from zero; then one
          // round-to-nearest add into the long sum
          float part[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || j < nt) mma_bf16_zero(part[j], a, b[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (FULL || j < nt) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][j][q] += part[j][q];
            }
        }
    }
  };

  auto compute = [&](int stage, auto full) {
    if constexpr (is_f32<T>()) {
      compute_tf32(stage, full);
    } else {
      compute_bf16(stage, full);
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

// Launch an (m x n) product in nsplit K slices; vec, elements a copy, is
// Smem<P::T>::WIDE (16 bytes) or 1 (one element), as for `product`. An empty
// output launches nothing.
template <class P>
int launch(const P& p, int64_t m, int64_t n, int nsplit, int vec, cudaStream_t stream) {
  using S = Smem<typename P::T>;
  if (m <= 0 || n <= 0) return 0;
  if (vec != S::WIDE && vec != 1) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles(m), tiles(n), (unsigned)nsplit);
  void (*kernel)(const P, int, int) = vec == S::WIDE ? product<P, S::WIDE> : product<P, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, S::BYTES, stream>>>(p, (int)m, (int)n);
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
// Both stacked weights are repacked into wp (ft, ldc) of the operand type T
// before a product (bf16: rounded to nearest even, the counterpart of the JAX
// package's `w.astype(compute_dtype)` at the call): column 2 * bin + part
// holds the stacked column part * half + bin, so that the thread that
// finishes a bin holds its re and im; ldc = 2 * half rounded up to a multiple
// of 16 bytes (4 floats, 8 bf16), the columns past 2 * half zero. Every row of
// wp then starts on a 16-byte boundary and a tile's columns are one
// contiguous run.
//   pack: the analysis weights w (ft, 2 * half), read as they lie.
//   pack_synthesis: the synthesis weights w (2 * half, ft), read transposed,
//     wp[j, 2 * bin + part] = w[part * half + bin, j]. Kernel B reads it
//     K-fast (K is the spectrum column), kernel E as the weights of its
//     spectrum product (K is the frame sample).
template <class T>
inline int packed_width(int half) {
  constexpr int a = Smem<T>::WIDE;
  return (2 * half + a - 1) / a * a;
}

template <class T>
__global__ void pack_weights(const float* __restrict__ w, T* __restrict__ wp, int ft, int half,
                             int ldc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)ft * ldc) return;
  const int k = (int)(i / ldc), c = (int)(i % ldc);
  wp[i] = round_to<T>(c < 2 * half ? w[(int64_t)k * 2 * half + (c & 1) * half + (c >> 1)] : 0.f);
}

template <class T>
inline int pack(const float* w, T* wp, int ft, int half, cudaStream_t stream) {
  const int ldc = packed_width<T>(half);
  const int64_t size = (int64_t)ft * ldc;
  pack_weights<T><<<blocks(size, 256), 256, 0, stream>>>(w, wp, ft, half, ldc);
  return (int)cudaGetLastError();
}

// Where a repack puts element i of its output: rounded to the operand type
// T (wp), or cut by split_tf32 into the planes hi and lo (the float32 wgmma
// products' pre-split B operand, below).
template <class T>
struct Rounded {
  T* wp;
  __device__ void operator()(int64_t i, float x) const { wp[i] = round_to<T>(x); }
};

struct Split {
  float* hi;
  float* lo;
  __device__ void operator()(int64_t i, float x) const {
    uint32_t h, l;
    split_tf32(x, h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
};

// 32 x 32 tiles through shared memory (32 x 8 threads), so that the reads run
// along the rows of w and the writes along the rows of wp.
template <class Out>
__global__ void pack_transposed(const float* __restrict__ w, Out out, int ft, int half, int ldc) {
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
    if (j < ft && c < ldc) out((int64_t)j * ldc + c, tile[tx][i]);
  }
}

template <class Out>
inline int pack_synthesis_as(const float* w, Out out, int ft, int half, int ldc,
                             cudaStream_t stream) {
  pack_transposed<Out><<<dim3(blocks(ft, 32), blocks(ldc, 32)), dim3(32, 8), 0, stream>>>(
      w, out, ft, half, ldc);
  return (int)cudaGetLastError();
}

template <class T>
inline int pack_synthesis(const float* w, T* wp, int ft, int half, cudaStream_t stream) {
  return pack_synthesis_as(w, Rounded<T>{wp}, ft, half, packed_width<T>(half), stream);
}

// The split-TF32 planes of the packed weights, for the float32 products of
// wgmma_product.cuh (whose TF32 B operand is read from shared memory,
// K-major, and split in advance): hi and lo of every element of wp, as
// split_tf32 cuts it, each plane f32 values that are TF32 numbers.
//   pack_split: wp's own layout (ft, ldc), K the interleaved column (D's
//     frame product, dframes = dspec . W^T, reads W's rows j).
//   pack_split_transposed: its transpose (ldc, ft), K the frame sample (the
//     spectrum product of A and D reads W^T's rows c).
// pack_split_synthesis, below, cuts the synthesis weights the same two ways.
__device__ __forceinline__ float analysis_weight(const float* w, int k, int c, int half) {
  return w[(int64_t)k * 2 * half + (c & 1) * half + (c >> 1)];
}

__global__ void pack_split_weights(const float* __restrict__ w, float* __restrict__ hi,
                                   float* __restrict__ lo, int ft, int half, int ldc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)ft * ldc) return;
  const int k = (int)(i / ldc), c = (int)(i % ldc);
  uint32_t h, l;
  split_tf32(c < 2 * half ? analysis_weight(w, k, c, half) : 0.f, h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

inline int pack_split(const float* w, float* hi, float* lo, int ft, int half, cudaStream_t stream) {
  const int ldc = packed_width<float>(half);
  pack_split_weights<<<blocks((int64_t)ft * ldc, 256), 256, 0, stream>>>(w, hi, lo, ft, half, ldc);
  return (int)cudaGetLastError();
}

// 32 x 32 tiles through shared memory (32 x 8 threads): reads along w's rows,
// writes along the planes' rows.
__global__ void pack_split_transposed(const float* __restrict__ w, float* __restrict__ hi,
                                      float* __restrict__ lo, int ft, int half, int ldc) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, c = c0 + tx;
    tile[i][tx] = k < ft && c < 2 * half ? analysis_weight(w, k, c, half) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, k = k0 + tx;
    if (c < ldc && k < ft) {
      uint32_t h, l;
      split_tf32(tile[tx][i], h, l);
      hi[(int64_t)c * ft + k] = __uint_as_float(h);
      lo[(int64_t)c * ft + k] = __uint_as_float(l);
    }
  }
}

inline int pack_split_t(const float* w, float* hi, float* lo, int ft, int half,
                        cudaStream_t stream) {
  const int ldc = packed_width<float>(half);
  pack_split_transposed<<<dim3(blocks(ft, 32), blocks(ldc, 32)), dim3(32, 8), 0, stream>>>(
      w, hi, lo, ft, half, ldc);
  return (int)cudaGetLastError();
}

// The same planes of the packed synthesis weights (pack_synthesis's values,
// wp[j, 2 * bin + part] = w[part * half + bin, j], w (2 * half, ft)):
//   pack_split_synthesis(..., false): wp's own layout (ft, ldc), K the
//     interleaved column (kernel B's frame product reads W's rows j);
//     pack_synthesis's transposing tiles;
//   pack_split_synthesis(..., true): its transpose (ldc, ft), K the frame
//     sample (kernel E's dspec product reads its rows c), which is w's own
//     rows interleaved (row c = w's row (c & 1) * half + (c >> 1)): a copy
//     row by row, no transpose.
__global__ void pack_split_synthesis_rows(const float* __restrict__ w, Split out, int ft,
                                          int half, int ldc) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)ldc * ft) return;
  const int c = (int)(i / ft), j = (int)(i % ft);
  out(i, c < 2 * half ? w[(int64_t)((c & 1) * half + (c >> 1)) * ft + j] : 0.f);
}

inline int pack_split_synthesis(const float* w, float* hi, float* lo, int ft, int half,
                                bool transposed, cudaStream_t stream) {
  const int ldc = packed_width<float>(half);
  if (!transposed) return pack_synthesis_as(w, Split{hi, lo}, ft, half, ldc, stream);
  pack_split_synthesis_rows<<<blocks((int64_t)ldc * ft, 256), 256, 0, stream>>>(w, Split{hi, lo},
                                                                               ft, half, ldc);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- the signal
// Kernels A and D read the padded signal xp as frames of the model's x/2. In
// f32 the products read xp itself and the 0.5 is applied to the finished sums
// (exact); in bf16 the frame is rounded after the halving, as the JAX kernels
// round `(xp * 0.5).astype(compute_dtype)`, so a pass writes xq = bf16(0.5 * xp)
// and nothing is scaled after the product. signal() returns the operand the
// products read; SIGNAL_SCALE<T> is the factor left for their results.
template <class T>
constexpr float SIGNAL_SCALE = is_f32<T>() ? 0.5f : 1.f;

__global__ void halve_to_bf16(const float* __restrict__ x, bf16* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = __float2bfloat16_rn(0.5f * x[i]);
}

template <class T>
inline int signal(const float* xp, T* xq, int64_t n, const T** operand, cudaStream_t stream) {
  if constexpr (is_f32<T>()) {
    *operand = xp;
    return 0;
  } else {
    *operand = xq;
    if (n <= 0) return 0;
    halve_to_bf16<<<blocks(n, 256), 256, 0, stream>>>(xp, xq, n);
    return (int)cudaGetLastError();
  }
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
// Kernel A: xp is the signal operand (signal(): in f32 the padded signal, and
// the result twice the spectrum, the model's x/2 a factor 0.5 on the finished
// sum, which is exact; in bf16 the halved and rounded frames); kernel D's
// first product is the same code, so D's spectrum is A's bit for bit. Kernel E:
// xp is the padded output gradient, offset to the first frame that reaches
// the trimmed output, and wp the packed synthesis weights; a tile takes only
// the K steps (frame samples) that are live for one of its frames.
template <class T_>
struct Spectrum {
  using T = T_;
  static constexpr bool A_KFAST = true;
  static constexpr bool B_KFAST = false;
  const T* xp;
  const T* wp;
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
  __device__ const T* src_a(int row, const Step& st, int kk, int& n) const {
    n = row < 0 ? 0 : ft - st.k0 - kk;
    return xp + row + st.k0 + kk;
  }
  __device__ const T* src_b(int col, const Step& st, int kk, int& n) const {
    n = st.k0 + kk < ft ? ldc - col : 0;
    return wp + (int64_t)(st.k0 + kk) * ldc + col;
  }
  __device__ const T* base_a() const { return xp; }
  __device__ const T* base_b() const { return wp; }
};

// --------------------------------------------------------- the frame product
// out[z][r, j] = sum over the columns c of K slice z of spec[r, c] * wp[j, c],
// for r < rows: every sample of every frame, from an interleaved spectrum
// (rows, ldc) and packed weights (ft, ldc), both contiguous along c. Kernel
// D's frame gradients (its dspec and the analysis weights, one slice) and
// kernel B's frames (the spectrum and the synthesis weights) are this product.
// Row r is frame r / batch, whose sample j lies at position (r / batch) * hop
// + j; a tile with no live sample is skipped (its output is never read).
template <class T_>
struct Frames {
  using T = T_;
  static constexpr bool A_KFAST = true;
  static constexpr bool B_KFAST = true;
  const T* spec;
  const T* wp;
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
  __device__ const T* src_a(int row, const Step& st, int kk, int& n) const {
    n = row < 0 ? 0 : ldc - st.c0 - kk;
    return spec + row + st.c0 + kk;
  }
  __device__ const T* src_b(int col, const Step& st, int kk, int& n) const {
    n = col < 0 ? 0 : ldc - st.c0 - kk;
    return wp + col + st.c0 + kk;
  }
  __device__ const T* base_a() const { return spec; }
  __device__ const T* base_b() const { return wp; }
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
