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
// by the latency of its dependent chain, one step per ~30 cycles on one
// thread. Two schedules, both exact, chosen by shape in ops/cuda_kernels.py:
//
// * Rows (st_smoother): one thread owns one row and walks it in time, with
//   the carry in a register; a batch of rows spreads over the card. Warp 0
//   owns up to 8 rows and only computes; warps 1-3 stage time-major tiles of
//   g through shared memory (so the loads of a warp's rows coalesce, even for
//   one row) and write the finished tiles back, double-buffered, so the loads
//   and stores of the next and previous tiles overlap the recursion on this
//   one. A row owner reads 8 steps ahead into registers, and forms both
//   candidate updates beside the compare, so each step is one fma and a
//   select on the chain.
// * Chunks (st_smoother_chunked), for a few long rows (the serving call
//   smooths a whole clip as ONE row, where one thread would walk millions of
//   steps while 131 of 132 SMs idle): speculate, then verify.
//   1. Each row is cut into chunks of L samples. Chunk k is a virtual row of
//      the row kernel's design (smoother_chunks_kernel, whose rows are
//      segments read from a table): it starts from a guessed carry
//      s[kL-W-1] = 0 at max(0, kL-W), warms up to kL, writes only its own L
//      outputs and records its state at kL-1 in spec[b, k]. A chunk whose
//      warm-up reaches sample 0 starts at s[0] = 0 and is exact.
//      W = 24 / (1 - max alpha), at most 65,536, rounded up to a tile, per
//      row: the step is a contraction (piecewise linear, continuous at
//      s = g[n], slopes alpha_a, alpha_r < 1), so the guess's error shrinks
//      by e^-24 and the two float32 trajectories meet bit for bit.
//   2. One block per row verifies. The step is a fixed function of s[n-1]
//      and the inputs, so trajectories that are bit-equal at one step stay
//      so: chunk k is exact iff chunk k-1 is and spec[b, k] equals
//      out[b, kL-1] bit for bit. The comparisons run in parallel; from the
//      first mismatch, one thread walks on in order, staged as in the row
//      kernel, re-running a chunk from the exact carry until its state at a
//      tile's end equals the speculated one (the rest of the chunk is then
//      exact) or the chunk ends, and skipping the chunks that verify. Input
//      that never meets makes the walk serial: phase 1 plus the row kernel's
//      time, still exact. No spin-waits, no atomics; bit-equal run to run.
//   Both schedules compute every step with the same code (run_tile), so
//   their outputs are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SM_ROWS = 8;       // rows per block: lanes 0-7 of warp 0 (few rows per
                                 // block, so a batch spreads over many SMs)
constexpr int SM_TT = 256;       // time steps per staged tile
constexpr int SM_THREADS = 128;  // warp 0 computes, warps 1-3 stage tiles
constexpr int SM_STAGERS = SM_THREADS - 32;
constexpr int SM_BURST = 8;      // loads a stager keeps in flight
constexpr int SM_AHEAD = 8;      // steps a row owner reads ahead
constexpr float WARMUP_DECAYS = 24.f;  // a chunk's warm-up: e^-24 of the guess's error left
constexpr int64_t WARMUP_MAX = 65536;  // steps; a multiple of SM_TT

// The part of a row one owner walks: samples [begin, end) of the row at
// base, the carry entering `begin` guessed as 0 (begin 0: s[0] = 0, exact),
// outputs from `write` on stored.
struct Seg {
  int64_t base, begin, write, end;
};

// Where a block's segments lie, for stage(): the walk's whole row b is
// Rows{b, n}; phase 1's chunks are read from the table the block built in
// shared memory.
struct Rows {
  int64_t v0, n;
  __device__ Seg operator[](int r) const { return Seg{(v0 + r) * n, 0, 0, n}; }
};
struct Chunks {
  const Seg* seg;
  __device__ const Seg& operator[](int r) const { return seg[r]; }
};

__device__ __forceinline__ int64_t warmup_steps(float aa, float ar) {
  const float w = WARMUP_DECAYS / (1.f - fmaxf(aa, ar));
  const int64_t steps = w > 0.f && w < (float)WARMUP_MAX ? (int64_t)ceilf(w) : WARMUP_MAX;
  return (steps + SM_TT - 1) / SM_TT * SM_TT;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Steps k..len-1 of one staged tile, in place (g in, s out), from carry s[k-1].
__device__ __forceinline__ float run_tile(float* row, int k, int len, float aa, float ar,
                                          float one_aa, float one_ar, float carry) {
  float v[SM_AHEAD];
  if (k + SM_AHEAD <= len) {
#pragma unroll
    for (int u = 0; u < SM_AHEAD; ++u) v[u] = row[k + u];
  }
  for (; k + SM_AHEAD <= len; k += SM_AHEAD) {
    float next[SM_AHEAD];  // the following steps' inputs, read before this chain
    const bool more = k + 2 * SM_AHEAD <= len;
    if (more) {
#pragma unroll
      for (int u = 0; u < SM_AHEAD; ++u) next[u] = row[k + SM_AHEAD + u];
    }
#pragma unroll
    for (int u = 0; u < SM_AHEAD; ++u) {
      const float sa = __fmaf_rn(aa, carry, __fmul_rn(one_aa, v[u]));
      const float sr = __fmaf_rn(ar, carry, __fmul_rn(one_ar, v[u]));
      carry = v[u] < carry ? sa : sr;
      row[k + u] = carry;
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < SM_AHEAD; ++u) v[u] = next[u];
    }
  }
  for (; k < len; ++k) {
    const float gn = row[k];
    const float sa = __fmaf_rn(aa, carry, __fmul_rn(one_aa, gn));
    const float sr = __fmaf_rn(ar, carry, __fmul_rn(one_ar, gn));
    carry = gn < carry ? sa : sr;
    row[k] = carry;
  }
  return carry;
}

// Threads worker, worker + workers, ... move tile `store_tile` of each of
// `rows` segments from buf to out (its samples in [write, end)) and tile
// `load_tile` from g into buf (zeros past end); -1 skips either. Tile i of a
// segment is samples begin + i*SM_TT ... Up to SM_BURST loads in flight; the
// same thread writes an element back before it refills it.
template <class Segs>
__device__ __forceinline__ void stage(float (*buf)[SM_TT + 1], Segs seg, int rows,
                                      int64_t store_tile, int64_t load_tile,
                                      const float* __restrict__ g, float* out,
                                      int worker, int workers) {
  const int total = rows * SM_TT;
  for (int i0 = worker; i0 < total; i0 += workers * SM_BURST) {
    float v[SM_BURST];
#pragma unroll
    for (int u = 0; u < SM_BURST; ++u) {
      const int idx = i0 + workers * u;
      v[u] = 0.f;
      if (idx < total) {
        const Seg s = seg[idx / SM_TT];
        const int k = idx % SM_TT;
        if (store_tile >= 0) {
          const int64_t t = s.begin + store_tile * SM_TT + k;
          if (t >= s.write && t < s.end) out[s.base + t] = buf[idx / SM_TT][k];
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
        const int idx = i0 + workers * u;
        if (idx < total) buf[idx / SM_TT][idx % SM_TT] = v[u];
      }
    }
  }
}

// The row schedule: one thread a row, 8 rows a block.
__global__ void __launch_bounds__(SM_THREADS) smoother_kernel(
    const float* __restrict__ g, const float* __restrict__ alpha_a,
    const float* __restrict__ alpha_r, float* __restrict__ out,
    int batch, int64_t n) {
  // two tiles, time-major per row; +1 so row owners read without bank conflicts
  __shared__ float tile[2][SM_ROWS][SM_TT + 1];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * SM_ROWS;
  const int64_t left = (int64_t)batch - row0;
  const int rows = left < SM_ROWS ? (int)left : SM_ROWS;
  const int64_t ntiles = (n + SM_TT - 1) / SM_TT;

  // stager: thread tid-32 of warps 1-3 moves elements i0 + 96*u of a tile,
  // SM_BURST loads in flight; the same thread writes an element back before
  // it refills it. (stage() below does the same for segments read from a
  // table; here each row's address is computed in place, because the table's
  // lookups slow this schedule down at calc_ct's (645, 8192) batch.)
  auto stage_rows = [&](int buf, int64_t store_tile, int64_t load_tile) {
    const int total = rows * SM_TT;
    for (int i0 = tid - 32; i0 < total; i0 += SM_STAGERS * SM_BURST) {
      float v[SM_BURST];
#pragma unroll
      for (int u = 0; u < SM_BURST; ++u) {
        const int idx = i0 + SM_STAGERS * u;
        v[u] = 0.f;
        if (idx < total) {
          const int r = idx / SM_TT;
          const int k = idx % SM_TT;
          const int64_t base = (row0 + r) * n;
          if (store_tile >= 0) out[base + store_tile * SM_TT + k] = tile[buf][r][k];
          if (load_tile >= 0 && load_tile * SM_TT + k < n) v[u] = g[base + load_tile * SM_TT + k];
        }
      }
      if (load_tile >= 0) {
#pragma unroll
        for (int u = 0; u < SM_BURST; ++u) {
          const int idx = i0 + SM_STAGERS * u;
          if (idx < total) tile[buf][idx / SM_TT][idx % SM_TT] = v[u];
        }
      }
    }
  };

  if (tid >= 32) stage_rows(0, -1, 0);
  __syncthreads();

  const bool owner = tid < rows;
  float aa = 0.f, ar = 0.f;
  if (owner) {
    aa = alpha_a[row0 + tid];
    ar = alpha_r[row0 + tid];
  }
  const float one_aa = __fsub_rn(1.f, aa);  // 1 - alpha, rounded like the plain version
  const float one_ar = __fsub_rn(1.f, ar);
  float carry = 0.f;

  for (int64_t i = 0; i < ntiles; ++i) {
    const int cur = (int)(i & 1);
    if (tid < 32) {
      if (owner) {
        float* row = tile[cur][tid];
        const int64_t t0 = i * SM_TT;
        const int len = n - t0 < SM_TT ? (int)(n - t0) : SM_TT;
        int k = 0;
        if (t0 == 0) {  // s[0] = 0 exactly
          row[0] = 0.f;
          k = 1;
        }
        carry = run_tile(row, k, len, aa, ar, one_aa, one_ar, carry);
      }
    } else {
      // the other buffer: write back tile i-1, then fetch tile i+1 into it
      stage_rows(cur ^ 1, i >= 1 ? i - 1 : -1, i + 1 < ntiles ? i + 1 : -1);
    }
    __syncthreads();
  }
  // the last tile, by every thread (all tiles before it are full-length)
  const int last = (int)((ntiles - 1) & 1);
  const int64_t tl = (ntiles - 1) * SM_TT;
  for (int idx = tid; idx < rows * SM_TT; idx += SM_THREADS) {
    const int r = idx / SM_TT;
    const int k = idx % SM_TT;
    if (tl + k < n) out[(row0 + r) * n + tl + k] = tile[last][r][k];
  }
}

// Phase 1 above: the row kernel over `vrows` virtual rows of 8 a block,
// virtual row v being chunk v % nch of row v / nch; its state at kL-1 goes to
// spec[v].
__global__ void __launch_bounds__(SM_THREADS) smoother_chunks_kernel(
    const float* __restrict__ g, const float* __restrict__ alpha_a,
    const float* __restrict__ alpha_r, float* __restrict__ out, float* __restrict__ spec,
    int64_t vrows, int64_t n, int64_t chunk) {
  __shared__ float tile[2][SM_ROWS][SM_TT + 1];
  __shared__ Seg table[SM_ROWS];

  const int tid = threadIdx.x;
  const int64_t v0 = (int64_t)blockIdx.x * SM_ROWS;
  const int64_t left = vrows - v0;
  const int rows = left < SM_ROWS ? (int)left : SM_ROWS;
  const bool owner = tid < rows;

  float aa = 0.f, ar = 0.f;
  if (owner) {
    const int64_t nch = (n + chunk - 1) / chunk;
    const int64_t b = (v0 + tid) / nch, k = (v0 + tid) % nch;
    aa = alpha_a[b];
    ar = alpha_r[b];
    const int64_t write = k * chunk, w = warmup_steps(aa, ar);
    table[tid] = Seg{b * n, write > w ? write - w : 0, write, write + chunk < n ? write + chunk : n};
  }
  __syncthreads();
  const Chunks seg{table};
  int64_t ntiles = 0;
  for (int r = 0; r < rows; ++r) {
    const int64_t t = (seg[r].end - seg[r].begin + SM_TT - 1) / SM_TT;
    ntiles = t > ntiles ? t : ntiles;
  }

  if (tid >= 32) stage(tile[0], seg, rows, -1, 0, g, out, tid - 32, SM_STAGERS);
  __syncthreads();

  const float one_aa = __fsub_rn(1.f, aa);
  const float one_ar = __fsub_rn(1.f, ar);
  float carry = 0.f;  // the guess at begin > 0
  Seg mine{0, 0, 0, 0};
  if (owner) mine = seg[tid];

  for (int64_t i = 0; i < ntiles; ++i) {
    const int cur = (int)(i & 1);
    if (tid < 32) {
      const int64_t t0 = mine.begin + i * SM_TT;
      const int64_t left_t = mine.end - t0;
      const int len = left_t < SM_TT ? (int)left_t : SM_TT;
      if (owner && len > 0) {
        float* row = tile[cur][tid];
        int k = 0;
        if (t0 == 0) {  // s[0] = 0 exactly
          row[0] = 0.f;
          k = 1;
        }
        carry = run_tile(row, k, len, aa, ar, one_aa, one_ar, carry);
        if (t0 + SM_TT == mine.write) spec[v0 + tid] = carry;  // the state at kL-1
      }
    } else {
      stage(tile[cur ^ 1], seg, rows, i >= 1 ? i - 1 : -1, i + 1 < ntiles ? i + 1 : -1, g, out,
            tid - 32, SM_STAGERS);
    }
    __syncthreads();
  }
  // the last tile, by every thread (a chunk's earlier tiles went back in the loop)
  stage(tile[(int)((ntiles - 1) & 1)], seg, rows, ntiles - 1, -1, g, out, tid, SM_THREADS);
}

// Phase 2 above: one block per row b, for the chunks that phase 1 wrote.
// stats[b] = {W, steps re-run}.
__global__ void __launch_bounds__(SM_THREADS) smoother_verify_kernel(
    const float* __restrict__ g, const float* __restrict__ alpha_a,
    const float* __restrict__ alpha_r, float* out, const float* __restrict__ spec,
    long long* __restrict__ stats, int64_t n, int64_t chunk) {
  __shared__ float tile[2][1][SM_TT + 1];
  __shared__ int64_t first_of_warp[SM_THREADS / 32];
  __shared__ int64_t next_tile[2];  // by the walk's step parity: read before it is rewritten
  __shared__ float ends[2][2];      // per tile buffer: see fetch_ends

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t nch = (n + chunk - 1) / chunk;
  const int64_t ntl = (n + SM_TT - 1) / SM_TT;
  const float* wb = spec + b * nch;
  const float* ob = out + b * n;
  const Rows row{b, n};  // tiles of the whole row, by absolute index
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
  if (first < nch) {
    const float one_aa = __fsub_rn(1.f, aa);
    const float one_ar = __fsub_rn(1.f, ar);
    float carry = ob[first * chunk - 1];  // exact: every chunk before `first` is
    int64_t t = first * chunk / SM_TT, prev = -1;
    int cur = 0;
    stage(tile[0], row, 1, -1, t, g, out, tid, SM_THREADS);
    if (tid == 0) fetch_ends(t, ends[0]);
    __syncthreads();
    for (int step = 0;; step ^= 1) {
      if (tid == 0) {
        const int64_t t0 = t * SM_TT;
        const int len = n - t0 < SM_TT ? (int)(n - t0) : SM_TT;
        const float spec_end = ends[cur][0];  // the speculated value there, untouched
        carry = run_tile(tile[cur][0], 0, len, aa, ar, one_aa, one_ar, carry);
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
        stage(tile[cur ^ 1], row, 1, prev, t + 1 < ntl ? t + 1 : -1, g, out, tid - 32,
              SM_STAGERS);
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
      stage(tile[cur], row, 1, t, -1, g, out, tid, SM_THREADS);
      if (next < 0) break;
      stage(tile[cur ^ 1], row, 1, -1, next, g, out, tid, SM_THREADS);
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

unsigned blocks_for(int64_t rows) { return (unsigned)((rows + SM_ROWS - 1) / SM_ROWS); }

}  // namespace

extern "C" {

const char* st_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// g, out (batch, n) float32; alpha_a, alpha_r (batch,) float32. One thread a row.
int st_smoother(const void* g, const void* alpha_a, const void* alpha_r, void* out,
                int batch, long long n, void* stream) {
  smoother_kernel<<<blocks_for(batch), SM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha_a, (const float*)alpha_r, (float*)out, batch,
      (int64_t)n);
  return (int)cudaGetLastError();
}

// The same function by chunks of `chunk` samples (a multiple of 256):
// spec (batch, ceil(n / chunk)) float32 scratch; stats (batch, 2) int64 out,
// each row's warm-up W and the steps its verification re-ran.
int st_smoother_chunked(const void* g, const void* alpha_a, const void* alpha_r, void* out,
                        void* spec, void* stats, int batch, long long n, long long chunk,
                        void* stream) {
  if (chunk <= 0 || chunk % SM_TT != 0) return (int)cudaErrorInvalidValue;
  const int64_t vrows = (int64_t)batch * ((n + chunk - 1) / chunk);
  smoother_chunks_kernel<<<blocks_for(vrows), SM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha_a, (const float*)alpha_r, (float*)out, (float*)spec,
      vrows, (int64_t)n, (int64_t)chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smoother_verify_kernel<<<(unsigned)batch, SM_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)alpha_a, (const float*)alpha_r, (float*)out,
      (const float*)spec, (long long*)stats, (int64_t)n, (int64_t)chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
