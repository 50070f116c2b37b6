// One row scan for Hopper (sm_90a): each row (or segment of a row) is walked
// in time by one thread, with its state in registers, one step at a time.
// Kernel C's row schedule and its chunked phase 1 (smoother.cu) and kernel L
// (iir.cu) run on it, each with its own step.
//
// What bounds a row scan on an H100. By the roofline it is bytes (each sample
// read and written once, a few flops each), but a row is one dependent chain,
// so a call takes N steps of the chain's latency however many rows it has,
// at ~4.1 cycles a dependent operation: at least 8 cycles a step for C (an
// fma and a select), 12 for L of order 1 (fma -> mul -> fma), 28 over 3
// steps for order 3. The chain must never wait on memory, and two things made
// it wait before this header:
//   * the shared-memory reads of a step's input: the next steps' inputs must
//     be in registers before the chain reaches them (run_tile reads a group
//     of 8 ahead, 16 bytes at a time);
//   * the staging of the tiles: three stager warps moved each 256-step tile
//     of 8 rows in and out with loads whose results they waited for, then a
//     block-wide __syncthreads() a tile held the chain until they were done;
//     with 8 rows a block the chain waited at every tile (L: 17 cycles a step
//     alone, 27-31 batched).
// The design here:
//   * the rows a block follow the batch (ops/cuda_kernels.rows_per_block): a
//     batch spreads over the card's SMs first, so a block stages as little as
//     the batch allows (1 or 2 rows of a training batch of 200, not 8);
//   * warp 0's lanes own the rows; warp 1 is a producer that fills a ring of
//     STAGES tiles ahead of them and writes the finished ones back, with
//     asynchronous copies, so neither side waits for a load's data;
//   * each stage has a "full" and an "empty" mbarrier: the owners wait only
//     for their own next tile and release it when done; the producer waits
//     only for a stage to come free. No block-wide barrier in the walk;
//   * the copies: where every row starts and ends on a 16-byte boundary (n a
//     multiple of 4 floats, 16-byte aligned input and output), one lane
//     copies a row's tile in and out with cp.async.bulk (the TMA's plain
//     copy, no tensor map), counted in bytes on the full barrier; otherwise
//     the producer's 32 lanes copy 4 bytes each with cp.async and report to
//     the full barrier with cp.async.mbarrier.arrive, and write the finished
//     tiles back with plain stores. Both copy paths move the same samples, so
//     the outputs are the same bits;
//   * a whole tile (every tile of a row but its last) is walked by code
//     whose bounds are known at compile time, which the compiler unrolls
//     into one block it schedules as a whole (L of order 3: 18.4 cycles a
//     step with run-time bounds, 11.9 unrolled).
//
// A step is a functor: `In prep(float x)` does the part of a step that does
// not depend on the state (In is whatever it hands on: the sample itself for
// L, the sample and C's products (1-alpha)*g[n] for C), `float
// operator()(const In&)` advances the state held in the functor by one input
// and returns the output; under kZeroFirst (C's s[0] = 0), `zero()` is the
// output at a row's sample 0, which takes no step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rs {
namespace {  // each library that includes this gets its own copy

constexpr int TT = 256;                 // steps a tile
constexpr int PAD = 4;                  // floats after a row's tile: rows 16-byte aligned,
constexpr int STRIDE = TT + PAD;        // and owner lane r starts at bank 4r (no conflicts)
constexpr int STAGES = 4;               // tiles in the ring
constexpr int MAX_ROWS = 8;             // rows a block: lanes 0-7 of warp 0
constexpr int THREADS = 64;             // warp 0 owns rows, warp 1 produces
constexpr int AHEAD = 8;                // steps an owner reads ahead

// bytes of dynamic shared memory for a block of `rows` rows (at most 33,280)
constexpr int smem_bytes(int rows) { return STAGES * rows * STRIDE * (int)sizeof(float); }

// The part of a row one owner walks: samples [begin, end) of the row at
// base, the state entering `begin` given by the caller (begin 0 under
// kZeroFirst: s[0] defined), outputs from `write` on stored. begin and write
// lie on tile boundaries from begin.
struct Seg {
  int64_t base, begin, write, end;
};

// Whole rows v0, v0 + 1, ... of length n.
struct Rows {
  int64_t v0, n;
  __device__ Seg operator[](int r) const { return Seg{(v0 + r) * n, 0, 0, n}; }
};

// Segments read from a table in shared memory (smoother.cu's chunks).
struct Table {
  const Seg* seg;
  __device__ const Seg& operator[](int r) const { return seg[r]; }
};

__device__ __forceinline__ uint32_t smem_at(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------- copies
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// bytes from shared src to global dst, as one bulk group's member
__device__ __forceinline__ void bulk_store(float* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until every committed bulk store has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// until every committed bulk store has completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// 4 bytes from global to shared, asynchronously
__device__ __forceinline__ void copy4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// an arrival on bar once this thread's cp.asyncs so far have landed (the
// barrier's count includes it)
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// this thread's shared-memory writes, before a bulk copy reads them
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ------------------------------------------------------------- the walk
// 8 floats of a row from shared memory (16-byte aligned), two 16-byte loads
__device__ __forceinline__ void load8(const float* p, float (&v)[AHEAD]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// Steps k..len-1 of one staged row tile, in place (x in, output out). After a
// scalar head up to a multiple of AHEAD (only a row that starts with
// zero()), each group of 8 inputs is in registers before the chain reaches
// it: the next group's two 16-byte loads are issued before this group's
// steps, unconditionally (the last group reads itself again), so that the
// compiler cannot sink them behind the steps.
template <class Step>
__device__ __forceinline__ void run_steps(float* row, int k, int len, Step& st) {
  for (; k < len && (k & (AHEAD - 1)); ++k) row[k] = st(st.prep(row[k]));
  if (k + AHEAD <= len) {
    float v[AHEAD];
    load8(row + k, v);
    for (; k + AHEAD <= len; k += AHEAD) {
      float next[AHEAD];
      load8(row + (k + 2 * AHEAD <= len ? k + AHEAD : k), next);
      float y[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) y[u] = st(st.prep(v[u]));
      *reinterpret_cast<float4*>(row + k) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(row + k + 4) = make_float4(y[4], y[5], y[6], y[7]);
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) v[u] = next[u];
    }
  }
  for (; k < len; ++k) row[k] = st(st.prep(row[k]));
}

// One staged tile: a whole one (every tile of a row but its last) through
// run_steps with its bounds known at compile time, unrolled into one block;
// any other with run-time bounds.
template <class Step>
__device__ __forceinline__ void run_tile(float* row, int k, int len, Step& st) {
  if (k == 0 && len == TT)
    run_steps(row, 0, TT, st);
  else
    run_steps(row, k, len, st);
}

// Whether the bulk copies can move every tile of a segment (of 16-byte
// aligned arrays) between device and shared memory: each tile starts on a
// multiple of 4 floats and the last one's length is one.
__device__ __forceinline__ bool bulk_ok(const Seg& q) {
  return (q.base + q.begin) % 4 == 0 && (q.end - q.begin) % 4 == 0;
}

// The walk of one block: `rows` segments (seg[0..rows)) of the rows of `in`
// into `out`, lane r of warp 0 walking segment r with step st (set up by the
// caller on that lane), warp 1 producing. After each tile a lane calls
// on_tile(t), t the segment's sample just past it. Every thread of the block
// calls this once, after whatever seg reads is in place (a table behind a
// __syncthreads()). Needs smem_bytes(rows) of dynamic shared memory.
template <class Step, class Segs, class OnTile>
__device__ __forceinline__ void scan(const float* __restrict__ in, float* __restrict__ out,
                                     Segs seg, int rows, Step& st, OnTile on_tile) {
  extern __shared__ __align__(16) float tiles[];  // [STAGES][rows][STRIDE]
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int tid = threadIdx.x;
  int64_t ntiles = 0;
  for (int r = 0; r < rows; ++r) {
    const int64_t t = (seg[r].end - seg[r].begin + TT - 1) / TT;
    ntiles = t > ntiles ? t : ntiles;
  }
  bool bulk = ((uintptr_t)in | (uintptr_t)out) % 16 == 0;
  for (int r = 0; r < rows; ++r) bulk = bulk && bulk_ok(seg[r]);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(smem_at(&full[s]), bulk ? 1 : 32);
      bar_init(smem_at(&empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto row_tile = [&](int s, int r) { return tiles + (s * rows + r) * STRIDE; };

  if (tid < 32) {  // the owners
    const bool owner = tid < rows;
    Seg mine{0, 0, 0, 0};
    if (owner) mine = seg[tid];
    for (int64_t i = 0; i < ntiles; ++i) {
      const int s = (int)(i % STAGES);
      bar_wait(smem_at(&full[s]), (int)((i / STAGES) & 1));
      const int64_t t0 = mine.begin + i * TT;
      if (owner && t0 < mine.end) {
        float* row = row_tile(s, tid);
        const int len = mine.end - t0 < TT ? (int)(mine.end - t0) : TT;
        int k = 0;
        if constexpr (Step::kZeroFirst) {
          if (t0 == 0) {
            row[0] = st.zero();
            k = 1;
          }
        }
        run_tile(row, k, len, st);
        on_tile(t0 + len);
      }
      if (bulk) fence_to_async();  // the outputs, to the bulk copy that stores them
      __syncwarp();
      if (tid == 0) bar_arrive(smem_at(&empty[s]));
    }
    return;
  }

  // the producer: lane 0 alone on the bulk path, all 32 lanes otherwise
  const int lane = tid - 32;
  if (bulk && lane != 0) return;
  auto load = [&](int64_t i) {
    const int s = (int)(i % STAGES);
    const uint32_t bar = smem_at(&full[s]);
    if (bulk) {
      int bytes = 0;
      for (int r = 0; r < rows; ++r) {
        const int64_t t0 = seg[r].begin + i * TT;
        if (t0 < seg[r].end) bytes += 4 * (seg[r].end - t0 < TT ? (int)(seg[r].end - t0) : TT);
      }
      bar_expect(bar, bytes);
      for (int r = 0; r < rows; ++r) {
        const Seg q = seg[r];
        const int64_t t0 = q.begin + i * TT;
        if (t0 < q.end)
          bulk_load(smem_at(row_tile(s, r)), in + q.base + t0,
                    4 * (q.end - t0 < TT ? (int)(q.end - t0) : TT), bar);
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        const Seg q = seg[r];
        const int64_t t0 = q.begin + i * TT;
        const int len = q.end - t0 < TT ? (int)(q.end - t0) : TT;
        const uint32_t dst = smem_at(row_tile(s, r));
        for (int k = lane; k < len; k += 32) copy4(dst + 4 * k, in + q.base + t0 + k);
      }
      copies_arrive(bar);
    }
  };
  // tile i's outputs from stage i % STAGES (its samples from `write` on)
  auto store = [&](int64_t i) {
    const int s = (int)(i % STAGES);
    for (int r = 0; r < rows; ++r) {
      const Seg q = seg[r];
      const int64_t t0 = q.begin + i * TT;
      const int64_t t1 = q.end - t0 < TT ? q.end : t0 + TT;
      const int64_t lo = q.write > t0 ? q.write : t0;
      if (lo >= t1) continue;
      const float* row = row_tile(s, r) + (lo - t0);
      if (bulk) {
        bulk_store(out + q.base + lo, smem_at(row), 4 * (int)(t1 - lo));
      } else {
        for (int64_t t = lo + lane; t < t1; t += 32) out[q.base + t] = row[t - lo];
      }
    }
    if (bulk) bulk_commit();
  };
  // tile i is loaded once tile i - STAGES has gone back
  for (int64_t i = 0; i < ntiles; ++i) {
    if (i >= STAGES) {
      bar_wait(smem_at(&empty[i % STAGES]), (int)(((i / STAGES) - 1) & 1));
      store(i - STAGES);
      if (bulk) bulk_wait_read();  // before the stage is filled again
    }
    load(i);
  }
  for (int64_t i = ntiles > STAGES ? ntiles - STAGES : 0; i < ntiles; ++i) {
    bar_wait(smem_at(&empty[i % STAGES]), (int)((i / STAGES) & 1));
    store(i);
  }
  if (bulk) bulk_wait();
}

}  // namespace
}  // namespace rs
