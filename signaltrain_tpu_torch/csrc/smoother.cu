// Switched one-pole envelope smoother, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of signaltrain_tpu/ops/pallas_kernels.py:
//   C  st_smoother, st_smoother_chunked  <- _make_kernel / _smoother_kernel
//                      (l.84-116), driven by _smoother_local (l.132-193),
//                      public entry switched_one_pole_batched (l.281-295)
// The plain PyTorch version is switched_one_pole in
// signaltrain_tpu_torch/dsp/iir.py.
//
// Per row b, with per-row coefficients:
//   s[0] = 0;  s[n] = (1-a)*g[n] + a*s[n-1],  a = alpha_a if g[n] < s[n-1] else alpha_r
// The switch makes the recursion non-associative, so no parallel scan is
// exact. Each step is fma(alpha, s[n-1], (1-alpha)*g[n]): the rounding of the
// JAX package's compiled scan, and of the plain version.
//
// What bounds it on an H100: by the roofline it is bytes (each sample read
// once and written once, a handful of flops each), but a serial walk is bound
// by the latency of its dependent chain. The step (SwitchedStep) forms both
// candidates, sa = fma(alpha_a, s, (1-alpha_a)*g) and sr likewise, beside the
// compare, and selects one: at best two dependent operations, 8 cycles (an
// fma, fmul or fadd takes 4.1 on this card). How the select compiles decides
// the rest (cycles a step, one row alone, measured with clock64 on an H100):
//   * `g < s ? sa : sr`: nvcc and ptxas make it FFMA sa; FSETP P, g, s; @P
//     FFMA sr, a guarded fma overwriting sa, whose guard predicate costs ~14
//     cycles: 18.4 with the inputs in registers, ~30 in the parent kernel,
//     whose read-ahead loads the compiler also sank behind the steps;
//   * select_lt below: a set.lt mask and a lop3 blend, which ptxas makes
//     FSETP -> SEL -> LOP3, three 4-cycle operations and no guard: 13.2 in
//     registers (`slct` on the sign of g - s: 22.3);
//   * in the kernel the two products (1-alpha)*g also sit on the chain: ptxas
//     schedules each FMUL just before the fma that takes it, between the
//     FSETP and the fmas, and a warp issues in order: ~17 a step. Computed by
//     the row scan's producer warp into shared memory instead, they cost
//     more than they saved (18.1 at 2 rows a block, 24.8 at 8: the producer
//     could not keep ahead), so they stay in the step.
// Two schedules, both exact, chosen by shape in ops/cuda_kernels.py, both on
// the row scan of row_scan.cuh (which says how it keeps the chain from
// waiting on memory):
//
// * Rows (st_smoother): one thread owns one row and walks it in time, with
//   the carry in a register; a batch of rows spreads over the card, the rows
//   a block chosen by ops/cuda_kernels.rows_per_block.
// * Chunks (st_smoother_chunked), for a few long rows (the serving call
//   smooths a whole clip as ONE row, where one thread would walk millions of
//   steps while 131 of 132 SMs idle): speculate, then verify.
//   1. Each row is cut into chunks of L samples. Chunk k is a virtual row of
//      the row scan (smoother_chunks_kernel, whose rows are segments read
//      from a table): it starts from a guessed carry s[kL-W-1] = 0 at
//      max(0, kL-W), warms up to kL, writes only its own L outputs and
//      records its state at kL-1 in spec[b, k]. A chunk whose warm-up reaches
//      sample 0 starts at s[0] = 0 and is exact.
//      W = 24 / (1 - max alpha), at most 65,536, rounded up to a tile, per
//      row: the step is a contraction (piecewise linear, continuous at
//      s = g[n], slopes alpha_a, alpha_r < 1), so the guess's error shrinks
//      by e^-24 and the two float32 trajectories meet bit for bit.
//   2. One block per row verifies. The step is a fixed function of s[n-1]
//      and the inputs, so trajectories that are bit-equal at one step stay
//      so: chunk k is exact iff chunk k-1 is and spec[b, k] equals
//      out[b, kL-1] bit for bit. The comparisons run in parallel; from the
//      first mismatch, one thread walks on in order, its tiles staged by the
//      block's other warps, re-running a chunk from the exact carry until its
//      state at a tile's end equals the speculated one (the rest of the chunk
//      is then exact) or the chunk ends, and skipping the chunks that verify.
//      Input that never meets makes the walk serial: phase 1 plus the row
//      kernel's time, still exact. No spin-waits, no atomics; bit-equal run
//      to run.
//   Every schedule computes every step with the same code (SwitchedStep
//   through rs::run_tile), so their outputs are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_scan.cuh"

namespace {

using rs::Seg;
constexpr int SM_TT = rs::TT;    // time steps per staged tile
constexpr int SM_THREADS = 128;  // the verify walk: thread 0 walks, warps 1-3 stage tiles
constexpr int SM_STAGERS = SM_THREADS - 32;
constexpr int SM_BURST = 8;      // loads a stager keeps in flight
constexpr float WARMUP_DECAYS = 24.f;  // a chunk's warm-up: e^-24 of the guess's error left
constexpr int64_t WARMUP_MAX = 65536;  // steps; a multiple of SM_TT

__device__ __forceinline__ int64_t warmup_steps(float aa, float ar) {
  const float w = WARMUP_DECAYS / (1.f - fmaxf(aa, ar));
  const int64_t steps = w > 0.f && w < (float)WARMUP_MAX ? (int64_t)ceilf(w) : WARMUP_MAX;
  return (steps + SM_TT - 1) / SM_TT * SM_TT;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// sa if g < s else sr, bit for bit as the compare selects: a mask of all ones
// where g < s (set.lt gives 0 for g == s, so a tie takes sr; -0.0 == +0.0;
// subnormals compare as they are, the build flushes none) blends the two by
// lop3 (d = m ? sa : sr, table 0xCA). No guard predicate on the chain.
__device__ __forceinline__ float select_lt(float g, float s, float sa, float sr) {
  float r;
  asm("{\n\t.reg .b32 m;\n\tset.lt.u32.f32 m, %1, %2;\n\tlop3.b32 %0, m, %3, %4, 0xCA;\n\t}"
      : "=f"(r) : "f"(g), "f"(s), "f"(sa), "f"(sr));
  return r;
}

// One step of the smoother on one row, the carry s[n-1] in `carry`.
struct SwitchedStep {
  static constexpr bool kZeroFirst = true;  // s[0] = 0
  struct In {
    float g, ca, cr;  // g[n], (1-alpha_a)*g[n], (1-alpha_r)*g[n]: not on the chain
  };
  float aa, ar, one_aa, one_ar, carry;

  __device__ __forceinline__ static SwitchedStep make(float aa, float ar) {
    // 1 - alpha, rounded like the plain version; the carry entering a row is 0
    return SwitchedStep{aa, ar, __fsub_rn(1.f, aa), __fsub_rn(1.f, ar), 0.f};
  }
  __device__ __forceinline__ float zero() {
    carry = 0.f;
    return 0.f;
  }
  __device__ __forceinline__ In prep(float g) const {
    return In{g, __fmul_rn(one_aa, g), __fmul_rn(one_ar, g)};
  }
  __device__ __forceinline__ float operator()(const In& x) {
    const float sa = __fmaf_rn(aa, carry, x.ca);
    const float sr = __fmaf_rn(ar, carry, x.cr);
    carry = select_lt(x.g, carry, sa, sr);
    return carry;
  }
};

// Threads worker, worker + workers, ... move tile `store_tile` of the row
// `seg` from buf to out (its samples in [write, end)) and tile `load_tile`
// from g into buf (zeros past end); -1 skips either. Tile i of a segment is
// samples begin + i*SM_TT ... Up to SM_BURST loads in flight; the same thread
// writes an element back before it refills it. (The verify walk's staging.)
__device__ __forceinline__ void stage(float* buf, const Seg& s, int64_t store_tile,
                                      int64_t load_tile, const float* __restrict__ g, float* out,
                                      int worker, int workers) {
  for (int i0 = worker; i0 < SM_TT; i0 += workers * SM_BURST) {
    float v[SM_BURST];
#pragma unroll
    for (int u = 0; u < SM_BURST; ++u) {
      const int k = i0 + workers * u;
      v[u] = 0.f;
      if (k < SM_TT) {
        if (store_tile >= 0) {
          const int64_t t = s.begin + store_tile * SM_TT + k;
          if (t >= s.write && t < s.end) out[s.base + t] = buf[k];
        }
        if (load_tile >= 0) {
          const int64_t t = s.begin + load_tile * SM_TT + k;
          if (t < s.end) v[u] = g[s.base + t];
        }
      }
    }
    if (load_tile >= 0) {
#pragma unroll
      for (int u = 0; u < SM_BURST; ++u) {
        const int k = i0 + workers * u;
        if (k < SM_TT) buf[k] = v[u];
      }
    }
  }
}

// The row schedule: one thread a row, `per_block` rows a block.
__global__ void __launch_bounds__(rs::THREADS) smoother_kernel(
    const float* __restrict__ g, const float* __restrict__ alpha_a,
    const float* __restrict__ alpha_r, float* __restrict__ out, int batch, int64_t n,
    int per_block) {
  const int64_t row0 = (int64_t)blockIdx.x * per_block;
  const int64_t left = (int64_t)batch - row0;
  const int rows = left < per_block ? (int)left : per_block;
  SwitchedStep st{};
  if (threadIdx.x < rows)
    st = SwitchedStep::make(alpha_a[row0 + threadIdx.x], alpha_r[row0 + threadIdx.x]);
  rs::scan(g, out, rs::Rows{row0, n}, rows, st, [](int64_t) {});
}

// Phase 1 above: the row scan over `vrows` virtual rows, `per_block` a block,
// virtual row v being chunk v % nch of row v / nch; its state at kL-1 goes to
// spec[v].
__global__ void __launch_bounds__(rs::THREADS) smoother_chunks_kernel(
    const float* __restrict__ g, const float* __restrict__ alpha_a,
    const float* __restrict__ alpha_r, float* __restrict__ out, float* __restrict__ spec,
    int64_t vrows, int64_t n, int64_t chunk, int per_block) {
  __shared__ Seg table[rs::MAX_ROWS];

  const int tid = threadIdx.x;
  const int64_t v0 = (int64_t)blockIdx.x * per_block;
  const int64_t left = vrows - v0;
  const int rows = left < per_block ? (int)left : per_block;
  SwitchedStep st{};
  int64_t write = 0;
  if (tid < rows) {
    const int64_t nch = (n + chunk - 1) / chunk;
    const int64_t b = (v0 + tid) / nch, k = (v0 + tid) % nch;
    st = SwitchedStep::make(alpha_a[b], alpha_r[b]);  // the carry: the guess 0 at begin > 0
    write = k * chunk;
    const int64_t w = warmup_steps(st.aa, st.ar);
    table[tid] = Seg{b * n, write > w ? write - w : 0, write, write + chunk < n ? write + chunk : n};
  }
  __syncthreads();
  rs::scan(g, out, rs::Table{table}, rows, st, [&](int64_t t) {
    if (t == write) spec[v0 + tid] = st.carry;  // the state at kL-1
  });
}

// Phase 2 above: one block per row b, for the chunks that phase 1 wrote.
// stats[b] = {W, steps re-run}.
__global__ void __launch_bounds__(SM_THREADS) smoother_verify_kernel(
    const float* __restrict__ g, const float* __restrict__ alpha_a,
    const float* __restrict__ alpha_r, float* out, const float* __restrict__ spec,
    long long* __restrict__ stats, int64_t n, int64_t chunk) {
  __shared__ __align__(16) float tile[2][rs::STRIDE];
  __shared__ int64_t first_of_warp[SM_THREADS / 32];
  __shared__ int64_t next_tile[2];  // by the walk's step parity: read before it is rewritten
  __shared__ float ends[2][2];      // per tile buffer: see fetch_ends

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t nch = (n + chunk - 1) / chunk;
  const int64_t ntl = (n + SM_TT - 1) / SM_TT;
  const float* wb = spec + b * nch;
  const float* ob = out + b * n;
  const Seg row{b * n, 0, 0, n};  // tiles of the whole row, by absolute index
  // what the walk compares at the end of tile tt, staged beside its samples so
  // that no load waits on the chain: the speculated value at its last sample
  // and, where it ends a chunk k, chunk k+1's speculated carry
  auto fetch_ends = [&](int64_t tt, float* dst) {
    const int64_t e = (tt + 1) * SM_TT < n ? (tt + 1) * SM_TT : n;
    dst[0] = ob[e - 1];
    dst[1] = e % chunk == 0 && e < n ? wb[e / chunk] : 0.f;
  };

  // the first chunk whose speculated carry is not the exact one
  int64_t first = nch;
  for (int64_t k = 1 + tid; k < nch; k += SM_THREADS) {
    if (!same_bits(wb[k], ob[k * chunk - 1])) {
      first = k;
      break;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t other = __shfl_down_sync(0xffffffffu, (long long)first, off);
    first = other < first ? other : first;
  }
  if (tid % 32 == 0) first_of_warp[tid / 32] = first;
  __syncthreads();
  first = nch;
  for (int w = 0; w < SM_THREADS / 32; ++w) first = first_of_warp[w] < first ? first_of_warp[w] : first;

  const float aa = alpha_a[b], ar = alpha_r[b];
  long long steps = 0;
  SwitchedStep st = SwitchedStep::make(aa, ar);
  if (first < nch) {
    float carry = ob[first * chunk - 1];  // exact: every chunk before `first` is
    int64_t t = first * chunk / SM_TT, prev = -1;
    int cur = 0;
    stage(tile[0], row, -1, t, g, out, tid, SM_THREADS);
    if (tid == 0) fetch_ends(t, ends[0]);
    __syncthreads();
    for (int step = 0;; step ^= 1) {
      if (tid == 0) {
        const int64_t t0 = t * SM_TT;
        const int len = n - t0 < SM_TT ? (int)(n - t0) : SM_TT;
        const float spec_end = ends[cur][0];  // the speculated value there, untouched
        st.carry = carry;
        rs::run_tile(tile[cur], 0, len, st);
        carry = st.carry;
        steps += len;
        int64_t next = t + 1;
        const int64_t k = t0 / chunk;
        const int64_t chunk_end = (k + 1) * chunk < n ? (k + 1) * chunk : n;
        const bool ends_chunk = t0 + len == chunk_end;
        if (ends_chunk || same_bits(carry, spec_end)) {
          // chunk k is exact now; skip the chunks that verify against the carry
          float c = ends_chunk ? carry : ob[chunk_end - 1];
          int64_t kk = k + 1;
          float w_next = ends_chunk ? ends[cur][1] : kk < nch ? wb[kk] : 0.f;
          while (kk < nch && same_bits(w_next, c)) {
            c = ob[((kk + 1) * chunk < n ? (kk + 1) * chunk : n) - 1];
            if (++kk < nch) w_next = wb[kk];
          }
          next = kk < nch ? kk * chunk / SM_TT : -1;
          carry = c;
        }
        next_tile[step] = next;
      } else if (tid >= 32) {
        // the other buffer: write back the previous tile, fetch the following one
        if (tid == 32 && t + 1 < ntl) fetch_ends(t + 1, ends[cur ^ 1]);
        stage(tile[cur ^ 1], row, prev, t + 1 < ntl ? t + 1 : -1, g, out, tid - 32, SM_STAGERS);
      }
      __syncthreads();
      const int64_t next = next_tile[step];
      if (next == t + 1) {
        prev = t;
        t = next;
        cur ^= 1;
        continue;
      }
      // a jump or the end: write this tile back (the fetched one is not needed)
      stage(tile[cur], row, t, -1, g, out, tid, SM_THREADS);
      if (next < 0) break;
      stage(tile[cur ^ 1], row, -1, next, g, out, tid, SM_THREADS);
      if (tid == 0) fetch_ends(next, ends[cur ^ 1]);
      __syncthreads();
      prev = -1;
      t = next;
      cur ^= 1;
    }
  }
  if (tid == 0) {
    stats[2 * b] = (long long)warmup_steps(aa, ar);
    stats[2 * b + 1] = steps;
  }
}

unsigned blocks_for(int64_t rows, int per_block) {
  return (unsigned)((rows + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// g, out (batch, n) float32; alpha_a, alpha_r (batch,) float32. One thread a
// row, per_block (1-8) rows a block.
int st_smoother(const void* g, const void* alpha_a, const void* alpha_r, void* out,
                int batch, long long n, int per_block, void* stream) {
  if (per_block < 1 || per_block > rs::MAX_ROWS) return (int)cudaErrorInvalidValue;
  smoother_kernel<<<blocks_for(batch, per_block), rs::THREADS, rs::smem_bytes(per_block),
                    (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha_a, (const float*)alpha_r, (float*)out, batch,
      (int64_t)n, per_block);
  return (int)cudaGetLastError();
}

// The same function by chunks of `chunk` samples (a multiple of 256), phase 1
// per_block (1-8) chunks a block: spec (batch, ceil(n / chunk)) float32
// scratch; stats (batch, 2) int64 out, each row's warm-up W and the steps its
// verification re-ran.
int st_smoother_chunked(const void* g, const void* alpha_a, const void* alpha_r, void* out,
                        void* spec, void* stats, int batch, long long n, long long chunk,
                        int per_block, void* stream) {
  if (chunk <= 0 || chunk % SM_TT != 0 || per_block < 1 || per_block > rs::MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const int64_t vrows = (int64_t)batch * ((n + chunk - 1) / chunk);
  smoother_chunks_kernel<<<blocks_for(vrows, per_block), rs::THREADS,
                           rs::smem_bytes(per_block), (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha_a, (const float*)alpha_r, (float*)out, (float*)spec,
      vrows, (int64_t)n, (int64_t)chunk, per_block);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smoother_verify_kernel<<<(unsigned)batch, SM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha_a, (const float*)alpha_r, (float*)out,
      (const float*)spec, (long long*)stats, (int64_t)n, (int64_t)chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
