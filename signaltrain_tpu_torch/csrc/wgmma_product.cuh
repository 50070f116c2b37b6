// One matrix product for Hopper (sm_90a) with bf16 or split-TF32 float32
// operands and f32 sums, fed the Hopper way: a ring of shared-memory stages
// filled by the Tensor Memory Accelerator (TMA) against mbarriers, one
// producer warp, and two consumer warpgroups that multiply with
// wgmma.mma_async. The bf16 modes of kernels A and B (frontend.cu) and D and
// E (frontend_bwd.cu) run their products on it, and so do their float32
// modes (the split-TF32 instances at the end of this file); the mma.sync
// loop of tc_product.cuh remains every one of these kernels' second
// schedule, the one the rule takes where TMA cannot read the frames.
//
// What it replaces, and why. tc_product.cuh's bf16 loop issues one
// mma.sync.m16n8k16 a K chunk of 16 from registers that its threads load
// from shared memory, with cp.async copies issued by the same threads and
// one __syncthreads() a K step: it reached 79-81 TFLOP/s in bf16 D at batch
// 200 (PERF.md), a twelfth of the card's dense 989, and lost to cuBLAS on the
// same products. Where its output has too few tiles for the card's 132 SMs
// it cuts K into slices whose f32 partials a second pass adds (D's dW, E's
// dspec and dW: ~17 MB each written and read again). What bounds the
// products is the tensor cores (D: 21 GFLOP for its two products at batch
// 200, 0.021 ms at 989 TFLOP/s; E: 5.9 GFLOP over the live frames, below
// its own bytes bound), so the design is the one the card offers for that:
//   * wgmma: a warpgroup multiplies a 64-row tile by a B tile straight from
//     shared memory, asynchronously, with the sums in registers. Each of the
//     two consumer warpgroups takes 64 rows of the block's 128 and the whole
//     width of the tile, so the B tile is read by both;
//   * TMA: one lane asks for a whole box (8 or 64 rows of 128 bytes) and the
//     hardware writes it to shared memory in the 128-byte swizzle that wgmma
//     reads, zero-filling whatever lies outside the tensor (the ragged edges
//     need no code), and reports the bytes to the stage's "full" mbarrier;
//   * the ring: as many stages of one K step (64 bf16, one 128-byte swizzle
//     row) as fit beside the epilogue's staging buffers, up to 6; the
//     producer waits on a stage's "empty" mbarrier, the consumers on its
//     "full" one, and release it once the wgmmas that read it have
//     completed. The producer warpgroup gives registers back (setmaxnreg
//     40) and the consumers take them (232): the two add up to what the
//     block was given at launch, 384 x 168, which is all an .inc can draw on;
//   * full-width tiles (all but the last column tile) run a main loop whose
//     wgmma shapes are known at compile time; the last tile chooses its
//     pieces at run time;
//   * persistent blocks, one an SM: a block takes tile after tile and the
//     ring runs on across them, so the next tile's loads overlap this one's
//     epilogue;
//   * the epilogue through shared memory: a warpgroup writes its finished
//     rows from the wgmma fragments into a staging buffer and its threads
//     then walk them row by row, so that the device-memory reads and writes
//     of the epilogue (D's dmag / dphs and dspec, E's mag / phs, dmag, dphs
//     and spectrum, the dW rows) are contiguous across a warp (from the
//     fragments they are 16-byte pieces of rows). The producer also hints the
//     epilogue's reads into L2 when the tile starts;
//   * no K slices: a product's grid has enough tiles (64 or 128 columns wide)
//     to fill the card, so every sum is formed in one block's registers, in
//     one order for every run, and the epilogue writes the finished result
//     (D's dW, E's dmag / dphs / spec and dW) with no partials and no second
//     pass.
//
// Numerics. The tensor cores round the running sum of a wgmma toward zero,
// so a sum carried through the whole K in the accumulators is a chain of
// K / 16 truncations, each of up to an ulp of the running sum. Carried so,
// D's recomputed spectrum (K = 1,024) lay 6x as far from float64 as the
// mma.sync loop's (root mean square over its components), and the dspec it
// rounds on near-zero bins, where the phase adjoint is ill-conditioned,
// moved by up to 1,822 bf16 ulps: dW at batch 643 was 30.7 off float64
// against the mma.sync loop's 2.23 (PERF.md). So, as tc_product.cuh does with
// its K chunks of 16, each K step's four wgmmas start from zero and their
// sum is added to the tile's own sums in registers by a round-to-nearest
// add: at most 4 truncations a chain. That costs a wait for every step's
// products (one wgmma group in flight, not two): 2-3.5% of D's and E's time.
// Results are bit-equal from run to run (no atomics, a fixed order) but not
// to the mma.sync loop's.
//
// Operands. Every operand is read through a tensor map (cuTensorMapEncodeTiled,
// encoded on the host at each launch and passed by value as a
// __grid_constant__ parameter). A CUDA graph replays the parameters it
// captured, so the maps encoded at capture are the ones replayed: correct
// because a graph replays its kernels on the same pointers (its inputs and
// scratch live at fixed addresses in the graph's pool). Two kinds:
//   * a matrix (rows, cols), cols contiguous, boxes of 64 x 64;
//   * the frames of a signal, (k, b, t) -> signal[b * lp + t * hop + k]: the
//     frames overlap (hop < ft), which a tiled map takes since it only ever
//     reads. Boxes of 64 samples x 8 windows x 1 frame. A product's rows are
//     padded rows R = t * bpad + b (bpad = batch rounded up to 8), so 8 rows
//     are one box, one swizzle atom; the windows past batch fall outside the
//     map and read as zeros.
// A tile is K-major (an operand's K index contiguous, TA / TB = 0) or M/N-major
// (its M or N index contiguous, 1: wgmma's transpose bit, no transposed copy):
// 64 x 64 blocks of 8 KB, 8-row groups 1 KB apart, M/N blocks 8 KB apart.
//
// An instance P (a struct holding its maps) says:
//   A_MN, B_MN                     0 (K-major) or 1 (M/N-major) operands
//   m, n                           the output's rows and columns (Shape)
//   begin_tile(m0, n0, s0) -> K steps of the tile, s0 the first
//   load_a(dst, m0, step, bar, lane), load_b(dst, n0, blocks, step, bar, lane):
//       issue the step's TMA boxes of A (BM rows) and B (blocks x 64 columns)
//       into dst, lane by lane of the producer warp
//   TILE_N, ROW_FAST               the column tile's width (64 or 128); whether
//                                  the epilogue walks a tile down its rows
//                                  (for an output written transposed)
//   Aux, fetch(m, n) -> Aux        what the epilogue of elements (m, n),
//                                  (m, n + 1) reads besides them (NoAux:
//                                  nothing); fetched a few items ahead
//   prefetch(m0, n0, w, lane)      the producer warp's hint, at a tile's
//                                  start, of what its epilogue will fetch
//   pair(m, n, v0, v1, aux)        elements (m, n), (m, n + 1) of the
//                                  finished tile (n even); the instance
//                                  checks the bounds
//   SPLIT                          float32: A split in registers, B's hi and
//                                  lo planes (SplitB); load_b's third
//                                  argument is then whether the tile has a
//                                  tail piece
//   RESTAGE, transposed(stg, ld, m0, n0, w, th)
//                                  pair() returns the pair to stage again,
//                                  and transposed() writes the restaged rows
//                                  once more (D's float32 dspec)
// as tc_product.cuh's instances say how an operand element is addressed and
// what happens to a finished pair of columns.
//
// A tile's width w is cut into pieces that one wgmma each multiplies: a main
// piece of 128 columns if w >= 128, else 64 if w >= 64, then the rest rounded
// up to 8, 16, 32 or 64 (a piece always starts on a 64-column block, so a
// descriptor never starts inside a swizzle row; launch() gives a rest wider
// than 64 a column tile of its own). The flagship's 1,032 spectrum columns
// are 7 tiles of 128 and one of 136 (128 + 8), or 15 of 64 and one of 72: the
// 8-column tail rides on its neighbour, no columns wasted.
//
// What holds it back on the H100 (PERF.md, section 6; time_frontend's split by
// pass, and runs with one part switched off at a time): a step of the main
// loop moves 24-32 KB by TMA and takes 0.9-1.5 us a block, some 25 GB/s an
// SM; with the TMA loads or the wgmmas switched off the products ran within
// 10% of the whole, with the mbarrier waits switched off 20-30% faster, so
// the hand-over between producer and consumers costs as much as either
// side. D's spectrum product spends about half its time in the epilogue
// (the phase adjoint: 41 MB of dmag / dphs read and dspec written), which
// the consumers do between tiles instead of multiplying.
// The producer warpgroup's three idle warps cannot take the epilogue over:
// at the 56 registers a thread they could have, draining the staging
// buffers took D's spectrum product to 0.19 ms. Nor did two consumer
// schedules that take the epilogue out of the consumers' way help kernel A,
// whose product (A's spectrum, the instance of D's, with a magnitude and
// phase epilogue that writes 20.5 MB at batch 200) takes 0.0925 ms against
// D's 0.054 with its epilogue off (PERF.md, section 6): two consumer warpgroups
// on alternate 64-row tiles, each with its own B tile and "order" mbarriers
// so that the stages are consumed in the order they are filled (0.0902 at
// batch 200, 0.2190-0.2277 against 0.2150 at 643: each warpgroup now loads
// its own B tile, 1.5 times the bytes a step moves for the same products),
// and a tile's epilogue drained a share a K step between the next tile's
// wgmma issue and its wait (0.0927-0.0932). Neither is kept. What is left in
// A's way is the feed, not the epilogue's arithmetic: next, 2-block clusters
// sharing a B tile by TMA multicast, and fewer, larger frame boxes.
//
// Float32 (split TF32; the instances marked SPLIT). Every f32 product is
// three TF32 ones, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (tc_product.cuh's
// arithmetic: hi = x rounded to TF32 as cvt.rna rounds, lo = x - hi), on
// wgmma.m64nNk8.f32.tf32.tf32. TF32 wgmma takes its shared-memory operands
// K-major only (the transpose bit exists for 16-bit types), so:
//   * A comes from registers ("RS" wgmma): TMA brings the f32 tile (frames,
//     K-major or M-major, or dspec rows) into the ring as it lies, and each
//     consumer thread reads its fragment from shared memory and cuts it into
//     hi and lo (tc::split_tf32) there; no layout rule for A, so D's dW
//     multiplies the M-major frame tile with no transposed copy of frames;
//   * B comes pre-split, as two K-major planes (hi, lo) of f32 values that
//     are TF32 numbers, written by the pass before the product (the weight
//     repacks tc::pack_split / pack_split_transposed / pack_split_synthesis;
//     the transposed dspec of D's spectrum pass for its dW, the transposed
//     spectrum of E's dspec pass for its dW), each read by TMA.
// A K step is one 128-byte swizzle row of 32 floats: 4 k8 chunks x 3 terms,
// 12 wgmmas, the small terms first (all a_lo.b_hi, then a_hi.b_lo, then
// a_hi.b_hi), summed from zero in the tensor cores and joined to the tile's
// sums by one round-to-nearest add, as above (12 truncations a chain against
// the mma.sync loop's 3 a chunk of 8; the float64 rules of chip_smoke.py and
// tests/test_torch_port_cuda.py hold it). A stage is the A tile (128 rows,
// 16 KB) and both B planes (TILE_N + 8 rows each); a full-width column tile
// may carry an 8-column tail piece (the flagship's 1,028 columns are 7
// tiles of 128 and one of 132), which a narrow second pair of maps loads, so
// that no column tile is spent on 4 columns. What bounds it: three TF32
// products at the dense 495 TFLOP/s are 165 TFLOP/s of f32-accurate work; a
// K step is 1,536 tensor-core cycles of a block against 50 KB moved, a third
// of bf16's bytes a cycle. Measured on the H100 (PERF.md, section 6): A at
// batch 643 0.40 ms (84 TFLOP/s of f32-accurate work, half of the bound's
// rate), a K step ~1.6 us a block as in bf16; with its wgmmas switched off the
// product ran 5% faster, without A's frame boxes 15%, without B's lo plane or
// the register split not faster, with a fourth stage (a narrower staging
// buffer) -1% to +1%: the step's hand-over, not the math or the bytes, is what
// is left, as for bf16.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_product.cuh"

namespace wg {
namespace {  // each library that includes this gets its own copy

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                      // rows of a block's tile
constexpr int BK = 64;                       // K step: 64 bf16, one 128-byte row
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
constexpr int ROW = BK * 2;                  // bytes of a tile row
constexpr int BLOCK = 64 * ROW;              // 64 rows (or M/N columns) of a step: 8 KB
constexpr int A_BYTES = BM * ROW;            // 16 KB
constexpr int GROUP = 8;                     // rows of a frame box: one swizzle atom
constexpr int ENCODE_ERROR = 10000;          // + CUresult of a failed encode
constexpr int BK32 = ROW / 4;                // float32 K step: 32 floats, one 128-byte row
constexpr int TAIL = 8;                      // columns of a float32 full tile's tail piece

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

// a hint: the 128-byte line of p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma2(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma3(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// ----------------------------------------------------------------- wgmma
// A shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (K-major: SBO between 8-row groups, LBO unused;
// M/N-major: LBO between 64-wide M/N blocks, SBO between 8-row K groups).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulators across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, this warpgroup's f32 accumulators: 64 a thread) = a . b (+ d if scale)
template <int TA, int TB>
__device__ __forceinline__ void mma_n128(float* d, uint64_t a, uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale), "n"(TA), "n"(TB));
}

// d (64 x 64, this warpgroup's f32 accumulators: 32 a thread) = a . b (+ d if scale)
template <int TA, int TB>
__device__ __forceinline__ void mma_n64(float* d, uint64_t a, uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale), "n"(TA), "n"(TB));
}

// d (64 x 32, this warpgroup's f32 accumulators: 16 a thread) = a . b (+ d if scale)
template <int TA, int TB>
__device__ __forceinline__ void mma_n32(float* d, uint64_t a, uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale), "n"(TA), "n"(TB));
}

// d (64 x 16, this warpgroup's f32 accumulators: 8 a thread) = a . b (+ d if scale)
template <int TA, int TB>
__device__ __forceinline__ void mma_n16(float* d, uint64_t a, uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale), "n"(TA), "n"(TB));
}

// d (64 x 8, this warpgroup's f32 accumulators: 4 a thread) = a . b (+ d if scale)
template <int TA, int TB>
__device__ __forceinline__ void mma_n8(float* d, uint64_t a, uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale), "n"(TA), "n"(TB));
}

// The float32 (split-TF32) products: A a TF32 fragment in registers. The
// fragment of m64nNk8 (as mma.sync.m16n8k8's, one warp a 16-row slice):
// thread (warp w, lane 4 g + t) holds a0 (row 16 w + g, K t), a1 (row + 8,
// K t), a2 (row, K t + 4), a3 (row + 8, K t + 4).
// d (64 x 128: 64 a thread) = a . b (+ d if scale), b K-major
__device__ __forceinline__ void mma32_n128(float* d, const uint32_t (&a)[4], uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// d (64 x 64: 32 a thread) = a . b (+ d if scale), b K-major
__device__ __forceinline__ void mma32_n64(float* d, const uint32_t (&a)[4], uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// d (64 x 32: 16 a thread) = a . b (+ d if scale), b K-major
__device__ __forceinline__ void mma32_n32(float* d, const uint32_t (&a)[4], uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// d (64 x 16: 8 a thread) = a . b (+ d if scale), b K-major
__device__ __forceinline__ void mma32_n16(float* d, const uint32_t (&a)[4], uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// d (64 x 8: 4 a thread) = a . b (+ d if scale), b K-major
__device__ __forceinline__ void mma32_n8(float* d, const uint32_t (&a)[4], uint64_t b, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
}

// ------------------------------------------------------------- the product
// The pieces of a tile of width w (see the header's note): a main piece of
// 128 or 64 columns, then a tail of the rest rounded up to 8, 16, 32 or 64.
// launch() keeps every tile within 64 columns of a main piece, so that the
// tail is at most 64 wide.
struct Pieces {
  int main = 0, tail = 0;  // main 0, 64 or 128; tail 0, 8, 16, 32 or 64
  __host__ __device__ constexpr explicit Pieces(int w) {
    main = w >= 128 ? 128 : w >= 64 ? 64 : 0;
    const int rest = w - main;
    tail = rest <= 0 ? 0 : rest <= 8 ? 8 : rest <= 16 ? 16 : rest <= 32 ? 32 : 64;
  }
  __host__ __device__ constexpr int covered() const { return main + tail; }
  __host__ __device__ constexpr int blocks() const { return (covered() + 63) / 64; }
};

// What every instance carries besides its maps: the output's size, and (set
// by launch()) the column tile's width (the instance's TILE_N), the column
// tiles, the bytes and number of the ring's stages.
struct Shape {
  int m, n, tile_n, n_tiles, stage_bytes, stages, stage_ld;
  // the defaults of a bf16 instance: both operands from shared memory; pair()
  // returns nothing (a float32 instance says otherwise, at the end)
  static constexpr bool SPLIT = false, RESTAGE = false;
};

// What an epilogue reads besides the accumulators, when it reads nothing.
struct NoAux {};

// The tiles of the output, row tile fastest, column tiles from the last
// one down.
struct TileAt {
  int m0, n0, w;
  __device__ TileAt(const Shape& p, int tile) {
    const int tiles_m = (p.m + BM - 1) / BM;
    const int tn = p.n_tiles - 1 - tile / tiles_m;
    m0 = (tile % tiles_m) * BM;
    n0 = tn * p.tile_n;
    w = tn == p.n_tiles - 1 ? p.n - n0 : p.tile_n;
  }
};

// The barrier of one consumer warpgroup's 128 threads (ids 1, 2; 0 is the block's).
__device__ __forceinline__ void warpgroup_sync(int role) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + role) : "memory");
}

// A piece of the accumulators into the warpgroup's staging rows (ld floats
// apart): warp w holds rows 16 w + g and 16 w + g + 8 (lane = 4 g + q), each
// n8 block j columns 8 j + 2 q and + 1.
template <int J>
__device__ __forceinline__ void stage(float* stg, int ld, const float* acc, int col0, int width,
                                      int th) {
  const int g = (th % 32) / 4, q = th % 4, row = (th / 32) * 16 + g;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (8 * j < width) {
      float* at = stg + row * ld + col0 + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(at) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(at + 8 * ld) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
}

// The epilogue of a warpgroup's 64 staged rows of a tile w columns wide: its
// 128 threads walk the (row, column pair) items, consecutive threads on
// consecutive pairs of a row (or, for P::ROW_FAST, on consecutive rows of a
// pair), so that what pair() reads and writes in device memory is contiguous
// across a warp. Items go EPI at a time: their fetches first, then the pairs.
// For P::RESTAGE, pair() returns a new pair of values, which goes back into
// the staging buffer in place of the old (D's float32 dspec, which its
// epilogue then writes transposed).
template <class P>
__device__ __forceinline__ void drain(const P& p, float* stg, int ld, int m0, int n0, int w,
                                      int th) {
  constexpr int EPI = 4;
  const int pairs = w / 2, total = 64 * pairs;
  for (int i0 = th; i0 < total; i0 += 128 * EPI) {
    typename P::Aux aux[EPI];
    int rows[EPI], cols[EPI];
#pragma unroll
    for (int u = 0; u < EPI; ++u) {
      const int i = i0 + 128 * u;
      rows[u] = P::ROW_FAST ? i % 64 : i / pairs;
      cols[u] = 2 * (P::ROW_FAST ? i / 64 : i % pairs);
      if (i < total) aux[u] = p.fetch(m0 + rows[u], n0 + cols[u]);
    }
#pragma unroll
    for (int u = 0; u < EPI; ++u)
      if (i0 + 128 * u < total) {
        float2* at = reinterpret_cast<float2*>(stg + rows[u] * ld + cols[u]);
        const float2 v = *at;
        if constexpr (P::RESTAGE) {
          *at = p.pair(m0 + rows[u], n0 + cols[u], v.x, v.y, aux[u]);
        } else {
          p.pair(m0 + rows[u], n0 + cols[u], v.x, v.y, aux[u]);
        }
      }
  }
}

// The ring's mbarriers: full(s) and empty(s) of stage s.
struct Ring {
  uint32_t bars;
  int stages;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (stages + s); }
};

// One tile's main loop and epilogue in a consumer warpgroup. FIXED: the tile
// is TILE_N wide, one main piece known at compile time, so the wgmmas of a
// step are straight-line code; otherwise (the last column tile, of another
// width) its pieces are chosen at run time.
template <class P, bool FIXED>
__device__ __forceinline__ void consume(const P& p, const TileAt& t, int steps, int& it,
                                        uint32_t base, const Ring& ring, float* stg, int role) {
  constexpr int TA = P::A_MN, TB = P::B_MN;
  constexpr int MR = P::TILE_N / 2;   // the main piece's accumulators a thread (64 or 32)
  constexpr int TR = FIXED ? 1 : 32;  // the tail's (up to 64 columns)
  const Pieces pc = FIXED ? Pieces(P::TILE_N) : Pieces(t.w);
  const int stages = ring.stages, th = threadIdx.x % 128;
  float acc[MR], sum[MR], acct[TR], sumt[TR];
#pragma unroll
  for (int i = 0; i < MR; ++i) acc[i] = sum[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TR; ++i) acct[i] = sumt[i] = 0.f;
  const int ct = pc.main;  // the tail's first column
  for (int i = 0; i < steps; ++i, ++it) {
    const int s = it % stages;
    bar_wait(ring.full(s), (it / stages) & 1);
    const uint32_t a = base + s * p.stage_bytes + role * BLOCK;
    const uint32_t b = base + s * p.stage_bytes + A_BYTES;
    fence_regs(acc);  // the accumulators stay where the wgmmas left them
    fence_regs(acct);
    mma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const int scale = k > 0;  // a step's first product starts from 0
      // K-major: 16 K = 32 bytes along the row; M/N-major: two 8-row groups
      const uint32_t ka = TA ? k * 2 * 1024 : k * 32;
      const uint32_t kb = TB ? k * 2 * 1024 : k * 32;
      const uint64_t da = desc(a + ka, BLOCK, 1024);
      auto db = [&](int col) { return desc(b + col / 64 * BLOCK + kb, BLOCK, 1024); };
      if constexpr (FIXED) {
        if constexpr (MR == 64) mma_n128<TA, TB>(acc, da, db(0), scale);
        else mma_n64<TA, TB>(acc, da, db(0), scale);
      } else {
        if constexpr (MR == 64) {
          if (pc.main == 128) mma_n128<TA, TB>(acc, da, db(0), scale);
        }
        if (pc.main == 64) mma_n64<TA, TB>(acc, da, db(0), scale);
        switch (pc.tail) {
          case 8: mma_n8<TA, TB>(acct, da, db(ct), scale); break;
          case 16: mma_n16<TA, TB>(acct, da, db(ct), scale); break;
          case 32: mma_n32<TA, TB>(acct, da, db(ct), scale); break;
          case 64: mma_n64<TA, TB>(acct, da, db(ct), scale); break;
          default: break;
        }
      }
    }
    mma_commit();
    mma_wait<0>();  // the step's products are done: into the sums, and the stage goes back
    fence_regs(acc);
    fence_regs(acct);
#pragma unroll
    for (int r = 0; r < MR; ++r) sum[r] += acc[r];
#pragma unroll
    for (int r = 0; r < TR; ++r) sumt[r] += acct[r];
    if (th == 0) bar_arrive(ring.empty(s));
  }

  // the epilogue through shared memory: the warpgroup's rows into its
  // staging buffer (once its previous tile's epilogue has read it), then
  // drained in rows
  const int ld = p.stage_ld;
  warpgroup_sync(role);
  if constexpr (MR == 64) {
    if (pc.main == 128) stage<16>(stg, ld, sum, 0, 128, th);
  }
  if (pc.main == 64) stage<8>(stg, ld, sum, 0, 64, th);
  if constexpr (!FIXED) stage<8>(stg, ld, sumt, ct, pc.tail, th);
  warpgroup_sync(role);
  drain(p, stg, ld, t.m0 + role * 64, t.n0, t.w, th);
}

// ----------------------------------------------- the float32 consumer
// The pieces of a float32 tile of width w (launch() keeps w <= tn + TAIL):
// the full width tn, with a TAIL-wide tail when w > tn; a narrower tile (the
// last, when it could not ride on a full one) a main piece of 64 if w >= 64
// (tn 128) and a tail of the rest rounded up to 8, 16, 32 or 64.
struct Pieces32 {
  int main = 0, tail = 0;
  __host__ __device__ constexpr Pieces32(int w, int tn) {
    if (w >= tn) {
      main = tn;
      tail = w > tn ? TAIL : 0;
    } else {
      main = w >= 64 && tn > 64 ? 64 : 0;
      const int rest = w - main;
      tail = rest <= 0 ? 0 : rest <= 8 ? 8 : rest <= 16 ? 16 : rest <= 32 ? 32 : 64;
    }
  }
  __host__ __device__ constexpr int covered() const { return main + tail; }
};

// The bytes of one B plane of a float32 stage: TILE_N rows and the tail's.
template <class P>
__host__ __device__ constexpr int b_span() {
  return (P::TILE_N + TAIL) * ROW;
}

// This warpgroup's TF32 fragments of one K step's A tile (its 64 rows of the
// block's 128, 32 K), read from shared memory and split: ah[q] and al[q] for
// the k8 chunk q (the fragment layout above the mma32 wrappers). A_MN 0: the
// tile is K-major, row r at r * 128 bytes, its 16-byte chunks swizzled by
// r % 8 (TMA's 128-byte swizzle). A_MN 1 (D's dW, frames read M-major): four
// blocks of 32 rows (M), each 32 K rows of 128 bytes swizzled by the K row.
// With no K permutation both read conflict-free, or 2-way (M-major).
__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

template <int A_MN>
__device__ __forceinline__ void load_a32(uint32_t a, int role, int th, uint32_t (&ah)[4][4],
                                         uint32_t (&al)[4][4]) {
  const int w = th / 32, g = (th % 32) / 4, t = th % 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = role * 64 + 16 * w + g + 8 * (i & 1);  // the row of the block's tile
      const int k = 8 * q + t + 4 * (i >> 1);              // the K index of the step
      int at;
      if constexpr (A_MN == 0) {
        at = m * ROW + (((k >> 2) ^ (m & 7)) << 4) + ((k & 3) << 2);
      } else {
        const int mm = m & 31;
        at = (m >> 5) * (BK32 * ROW) + k * ROW + (((mm >> 2) ^ (k & 7)) << 4) + ((mm & 3) << 2);
      }
      tc::split_tf32(ld_shared(a + at), ah[q][i], al[q][i]);
    }
}

// keeps the A fragments in their registers until the wgmmas that read them
// are done
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[q][i])::"memory");
}

// The main piece of a float32 tile, TN = 128 or 64 columns wide.
template <int TN>
__device__ __forceinline__ void mma32_main(float* d, const uint32_t (&a)[4], uint64_t b, int scale) {
  if constexpr (TN == 128) {
    mma32_n128(d, a, b, scale);
  } else {
    mma32_n64(d, a, b, scale);
  }
}

// One float32 tile's main loop and epilogue in a consumer warpgroup. KIND 0:
// TILE_N wide; 1: TILE_N and the TAIL-wide tail; 2: run-time pieces of a
// narrower tile (main 0 or 64). The register budget sets the kinds apart: at
// TILE_N 128 the sums, the step's products and the A fragments are 64 + 64 +
// 32 registers, and a tail beside them only fits if it is 8 wide.
template <class P, int KIND>
__device__ __forceinline__ void consume32(const P& p, const TileAt& t, int steps, int& it,
                                          uint32_t base, const Ring& ring, float* stg, int role) {
  constexpr int TN = P::TILE_N;
  constexpr int MR = KIND == 2 ? 32 : TN / 2;         // the main piece's accumulators
  constexpr int TR = KIND == 0 ? 1 : KIND == 1 ? 4 : 32;  // the tail's
  const Pieces32 pc(KIND == 0 ? TN : KIND == 1 ? TN + TAIL : t.w, TN);
  const int stages = ring.stages, th = threadIdx.x % 128;
  float acc[MR], sum[MR], acct[TR], sumt[TR];
#pragma unroll
  for (int i = 0; i < MR; ++i) acc[i] = sum[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TR; ++i) acct[i] = sumt[i] = 0.f;
  const int ct = pc.main;  // the tail's first column
  for (int i = 0; i < steps; ++i, ++it) {
    const int s = it % stages;
    bar_wait(ring.full(s), (it / stages) & 1);
    uint32_t ah[4][4], al[4][4];
    load_a32<P::A_MN>(base + s * p.stage_bytes, role, th, ah, al);
    const uint32_t b_hi = base + s * p.stage_bytes + A_BYTES, b_lo = b_hi + b_span<P>();
    fence_regs(acc);  // the accumulators stay where the wgmmas left them
    fence_regs(acct);
    mma_fence();
    // a_lo.b_hi, a_hi.b_lo, a_hi.b_hi over the step's four k8 chunks, from 0
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t(&fa)[4] = term == 0 ? al[q] : ah[q];
        const uint32_t b = term == 1 ? b_lo : b_hi;
        const int scale = term > 0 || q > 0;
        // K-major B: column col at col * 128 bytes, the chunk 32 bytes along
        auto db = [&](int col) { return desc(b + col * ROW + q * 32, BLOCK, 1024); };
        if constexpr (KIND != 2) {
          mma32_main<TN>(acc, fa, db(0), scale);
          if constexpr (KIND == 1) mma32_n8(acct, fa, db(TN), scale);
        } else {
          if (pc.main == 64) mma32_n64(acc, fa, db(0), scale);
          switch (pc.tail) {
            case 8: mma32_n8(acct, fa, db(ct), scale); break;
            case 16: mma32_n16(acct, fa, db(ct), scale); break;
            case 32: mma32_n32(acct, fa, db(ct), scale); break;
            case 64: mma32_n64(acct, fa, db(ct), scale); break;
            default: break;
          }
        }
      }
    mma_commit();
    mma_wait<0>();  // the step's products are done: into the sums, and the stage goes back
    fence_regs(acc);
    fence_regs(acct);
    fence_frags(ah);
    fence_frags(al);
#pragma unroll
    for (int r = 0; r < MR; ++r) sum[r] += acc[r];
#pragma unroll
    for (int r = 0; r < TR; ++r) sumt[r] += acct[r];
    if (th == 0) bar_arrive(ring.empty(s));
  }

  // the epilogue, as consume's; a RESTAGE instance then writes the staged
  // tile again, transposed, once the warpgroup has restaged all of it
  const int ld = p.stage_ld;
  warpgroup_sync(role);
  if constexpr (KIND != 2) {
    stage<TN / 8>(stg, ld, sum, 0, TN, th);
    if constexpr (KIND == 1) stage<1>(stg, ld, sumt, TN, TAIL, th);
  } else {
    if (pc.main == 64) stage<8>(stg, ld, sum, 0, 64, th);
    stage<8>(stg, ld, sumt, ct, pc.tail, th);
  }
  warpgroup_sync(role);
  drain(p, stg, ld, t.m0 + role * 64, t.n0, t.w, th);
  if constexpr (P::RESTAGE) {
    warpgroup_sync(role);
    p.transposed(stg, ld, t.m0 + role * 64, t.n0, t.w, th);
  }
}

// A persistent block: it takes tiles blockIdx.x, + gridDim.x, ... of the
// m x n output, the ring running on from one tile to the next, so that the
// producer loads the next tile's first steps while the consumers finish the
// last one's epilogue.
template <class P>
__global__ void __launch_bounds__(THREADS, 1) product(const __grid_constant__ P p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_at(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1 KB atoms
  const int stages = p.stages;
  const uint32_t staging = base + stages * p.stage_bytes;  // 2 x 64 rows of stage_ld floats
  const Ring ring{staging + 2 * 64 * p.stage_ld * 4, stages};
  auto full = [&](int s) { return ring.full(s); };
  auto empty = [&](int s) { return ring.empty(s); };
  const int tiles = (p.m + BM - 1) / BM * p.n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int role = threadIdx.x / 128;
  if (role == CONSUMERS) {
    // ---- the producer warpgroup: one warp keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 < 32) {
      const int lane = threadIdx.x % 32;
      int it = 0;  // steps issued so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const TileAt t(p, tile);
        // bf16: B's 64-column blocks; float32: whether the tile has a tail
        // piece, whose rows a second box of each B plane brings
        int blocks, tx;
        if constexpr (P::SPLIT) {
          blocks = t.w > P::TILE_N;
          tx = A_BYTES + 2 * (P::TILE_N + (blocks ? TAIL : 0)) * ROW;
        } else {
          blocks = Pieces(t.w).blocks();
          tx = A_BYTES + blocks * BLOCK;
        }
        int s0 = 0;
        const int steps = p.begin_tile(t.m0, t.n0, s0);
        p.prefetch(t.m0, t.n0, t.w, lane);  // what the tile's epilogue reads, into L2
        for (int i = 0; i < steps; ++i, ++it) {
          const int s = it % stages;
          bar_wait(empty(s), ((it / stages) & 1) ^ 1);  // the first pass finds every stage empty
          if (lane == 0) bar_expect(full(s), tx);
          __syncwarp();
          const uint32_t a = base + s * p.stage_bytes;
          p.load_a(a, t.m0, s0 + i, full(s), lane);
          p.load_b(a + A_BYTES, t.n0, blocks, s0 + i, full(s), lane);
        }
      }
    }
  } else {
    // ---- a consumer warpgroup: rows role * 64 .. + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float* stg = reinterpret_cast<float*>(smem_raw + (staging - smem_at(smem_raw))) +
                 role * 64 * p.stage_ld;
    int it = 0;  // steps consumed so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const TileAt t(p, tile);
      int s0 = 0;
      const int steps = p.begin_tile(t.m0, t.n0, s0);
      if constexpr (P::SPLIT) {
        if (t.w == P::TILE_N) {
          consume32<P, 0>(p, t, steps, it, base, ring, stg, role);
        } else if (t.w > P::TILE_N) {  // the last column tile, with a tail piece
          consume32<P, 1>(p, t, steps, it, base, ring, stg, role);
        } else {  // the last column tile, narrower
          consume32<P, 2>(p, t, steps, it, base, ring, stg, role);
        }
      } else if (t.w == P::TILE_N) {
        consume<P, true>(p, t, steps, it, base, ring, stg, role);
      } else {  // the last column tile, of another width
        consume<P, false>(p, t, steps, it, base, ring, stg, role);
      }
    }
  }
}

constexpr int SMEM_BUDGET = 224 * 1024;  // of the ring, the staging buffers and the barriers
constexpr int MAX_STAGES = 6;

// Launch the product of instance p (an empty output launches nothing): one
// persistent block an SM, or one a tile where there are fewer tiles.
template <class P>
int launch(P p, cudaStream_t stream) {
  if (p.m <= 0 || p.n <= 0) return 0;
  p.tile_n = P::TILE_N;
  p.n_tiles = p.n / p.tile_n > 1 ? p.n / p.tile_n : 1;
  int last = p.n - (p.n_tiles - 1) * p.tile_n;
  int widest;  // the widest tile's pieces
  if constexpr (P::SPLIT) {
    if (last > p.tile_n + TAIL) {  // more than a tail piece: a column tile of its own
      ++p.n_tiles;
      last -= p.tile_n;
    }
    const Pieces32 lp(last, P::TILE_N);
    if (lp.covered() < last) return (int)cudaErrorInvalidValue;
    p.stage_bytes = A_BYTES + 2 * b_span<P>();
    widest = lp.covered() > P::TILE_N ? lp.covered() : P::TILE_N;
  } else {
    if (last > p.tile_n + 64) {  // a tail wider than 64: a column tile of its own
      ++p.n_tiles;
      last -= p.tile_n;
    }
    const Pieces lp(last), fp(p.tile_n);
    if (lp.covered() < last) return (int)cudaErrorInvalidValue;
    const int blocks = lp.blocks() > fp.blocks() ? lp.blocks() : fp.blocks();
    p.stage_bytes = A_BYTES + blocks * BLOCK;
    widest = lp.covered() > fp.covered() ? lp.covered() : fp.covered();
  }
  // floats a staged row: the widest tile's pieces, padded to 8 (mod 32) so that
  // the float2 writes of a half-warp's four rows fall on distinct banks
  p.stage_ld = widest + (40 - widest % 32) % 32;
  const int staging = 2 * 64 * p.stage_ld * 4;
  const int ring = SMEM_BUDGET - 1024 - staging - 2 * MAX_STAGES * 8;
  p.stages = ring / p.stage_bytes < MAX_STAGES ? ring / p.stage_bytes : MAX_STAGES;
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  const int bytes = p.stages * p.stage_bytes + staging + 2 * MAX_STAGES * 8 + 1024;  // + alignment
  // each device's SM count, and the shared memory limit set for this instance
  // on it, at the instance's first launch there
  constexpr int DEVICES = 64;
  static int sms[DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(product<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BUDGET);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = count;
  }
  const int tiles = (p.m + BM - 1) / BM * p.n_tiles;
  product<P><<<(unsigned)(tiles < sms[dev] ? tiles : sms[dev]), THREADS, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- tensor maps
// A map of bf16 (or, with type FLOAT32, f32) elements, 128-byte swizzle,
// elements outside the tensor read as 0. dims innermost first; strides in
// bytes of dims 1, 2, ...
inline int encode(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                  const uint64_t* strides, const uint32_t* box,
                  CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const uint32_t ones[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

// a (rows, cols) matrix, cols contiguous; boxes of 64 x 64
inline int matrix_map(CUtensorMap* map, const bf16* a, int64_t rows, int64_t cols) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, 64};
  return encode(map, a, 2, dims, strides, box);
}

// the frames of a signal: (k, b, t) -> signal[b * lp + t * hop + k], k < ft,
// b < batch, t < frames; boxes of 64 x GROUP x 1
inline int frames_map(CUtensorMap* map, const bf16* signal, int ft, int batch, int frames, int lp,
                      int hop) {
  const uint64_t dims[3] = {(uint64_t)ft, (uint64_t)batch, (uint64_t)frames};
  const uint64_t strides[2] = {(uint64_t)lp * 2, (uint64_t)hop * 2};
  const uint32_t box[3] = {64, GROUP, 1};
  return encode(map, signal, 3, dims, strides, box);
}

// float32: a (rows, cols) matrix, cols contiguous, boxes of 32 x box_rows
inline int matrix_map32(CUtensorMap* map, const float* a, int64_t rows, int64_t cols,
                        int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 4};
  const uint32_t box[2] = {BK32, (uint32_t)box_rows};
  return encode(map, a, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// float32: the frames of a signal, as frames_map; boxes of 32 x GROUP x 1
inline int frames_map32(CUtensorMap* map, const float* signal, int ft, int batch, int frames,
                        int lp, int hop) {
  const uint64_t dims[3] = {(uint64_t)ft, (uint64_t)batch, (uint64_t)frames};
  const uint64_t strides[2] = {(uint64_t)lp * 4, (uint64_t)hop * 4};
  const uint32_t box[3] = {BK32, GROUP, 1};
  return encode(map, signal, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// --------------------------------------------------------------- operands
// Padded rows R = t * bpad + b (the frames' rows, see the header's note).
__host__ __device__ inline int pad_rows(int batch) { return (batch + GROUP - 1) / GROUP * GROUP; }

// The frame box of padded-row group G: window b0 .. b0 + 7 of frame t.
__device__ __forceinline__ void frame_group(int G, int bpad, int& b0, int& t) {
  const int per = bpad / GROUP;
  t = G / per;
  b0 = (G - t * per) * GROUP;
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((b - 1 - a) / b); }

// C[R, c] = sum_k frame_R[k] * W[k, c]: the rows are frames (K-major, 16
// frame boxes a step), W (K, N) N-fast (M/N-major). Kernel D's spectrum
// product and kernel E's dspec. Only the samples [live_lo, live_hi) of a
// frame's row (counted from frame 0 of the map) can be non-zero: a tile takes
// the K steps that are live for one of its frames.
template <int TN>
struct FrameSpectrum : Shape {
  static constexpr int TILE_N = TN;  // 64 or 128
  static constexpr bool ROW_FAST = false;
  static constexpr int A_MN = 0, B_MN = 1;
  using Aux = NoAux;
  __device__ NoAux fetch(int, int) const { return {}; }
  __device__ void prefetch(int, int, int, int) const {}
  CUtensorMap frames;  // frames_map
  CUtensorMap w;       // matrix_map (K, N)
  int bpad, ft, hop, live_lo, live_hi;
  __device__ int begin_tile(int m0, int, int& s0) const {
    const int t_first = m0 / bpad, t_last = (min(m0 + BM, this->m) - 1) / bpad;
    const int lo = max(0, live_lo - t_last * hop), hi = min(ft, live_hi - t_first * hop);
    s0 = lo / BK;
    return hi > s0 * BK ? (hi - s0 * BK + BK - 1) / BK : 0;
  }
  __device__ void load_a(uint32_t dst, int m0, int step, uint32_t bar, int lane) const {
    if (lane < BM / GROUP) {
      int b0, t;
      frame_group(m0 / GROUP + lane, bpad, b0, t);
      tma3(dst + lane * GROUP * ROW, &frames, step * BK, b0, t, bar);
    }
  }
  __device__ void load_b(uint32_t dst, int n0, int blocks, int step, uint32_t bar, int lane) const {
    if (lane < blocks) tma2(dst + lane * BLOCK, &w, n0 + lane * 64, step * BK, bar);
  }
};

// C[R, j] = sum_c D[R, c] * W[j, c]: both K-major, rows of two matrices.
// Kernel D's frame gradients (for dxp).
template <int TN>
struct RowProduct : Shape {
  static constexpr int TILE_N = TN;  // 64 or 128
  static constexpr bool ROW_FAST = false;
  static constexpr int A_MN = 0, B_MN = 0;
  using Aux = NoAux;
  __device__ NoAux fetch(int, int) const { return {}; }
  __device__ void prefetch(int, int, int, int) const {}
  CUtensorMap d;  // matrix_map (M, K)
  CUtensorMap w;  // matrix_map (N, K)
  int k;
  __device__ int begin_tile(int, int, int& s0) const {
    s0 = 0;
    return (k + BK - 1) / BK;
  }
  __device__ void load_a(uint32_t dst, int m0, int step, uint32_t bar, int lane) const {
    if (lane < BM / 64) tma2(dst + lane * BLOCK, &d, step * BK, m0 + lane * 64, bar);
  }
  __device__ void load_b(uint32_t dst, int n0, int blocks, int step, uint32_t bar, int lane) const {
    if (lane < blocks) tma2(dst + lane * BLOCK, &w, step * BK, n0 + lane * 64, bar);
  }
};

// C[j, c] = sum over the padded rows R of frame_R[j] * S[R, c]: the frames
// M-major (A[j, R] is frame R's sample j), S (rows, N) N-fast. The dW of
// kernels D and E. A tile of samples j takes only the K steps of the frames
// with a live sample among them.
template <int TN>
struct FrameGrad : Shape {
  static constexpr int TILE_N = TN;  // 64 or 128
  static constexpr bool ROW_FAST = false;
  static constexpr int A_MN = 1, B_MN = 1;
  using Aux = NoAux;
  __device__ NoAux fetch(int, int) const { return {}; }
  __device__ void prefetch(int, int, int, int) const {}
  CUtensorMap frames;  // frames_map
  CUtensorMap s;       // matrix_map (rows, N)
  int bpad, hop, n_frames, live_lo, live_hi;
  __device__ int begin_tile(int j0, int, int& s0) const {
    const int t_lo = max(0, -floor_div(j0 + BM - 1 - live_lo, hop));
    const int t_hi = min(n_frames - 1, floor_div(live_hi - 1 - j0, hop));
    if (t_hi < t_lo) return 0;
    s0 = t_lo * bpad / BK;
    return ((t_hi + 1) * bpad + BK - 1) / BK - s0;
  }
  __device__ void load_a(uint32_t dst, int j0, int step, uint32_t bar, int lane) const {
    if (lane < 2 * (BK / GROUP)) {  // two 64-wide blocks of j, eight row groups each
      const int jb = lane / (BK / GROUP), gi = lane % (BK / GROUP);
      int b0, t;
      frame_group(step * (BK / GROUP) + gi, bpad, b0, t);
      tma3(dst + jb * BLOCK + gi * GROUP * ROW, &frames, j0 + jb * 64, b0, t, bar);
    }
  }
  __device__ void load_b(uint32_t dst, int n0, int blocks, int step, uint32_t bar, int lane) const {
    if (lane < blocks) tma2(dst + lane * BLOCK, &s, n0 + lane * 64, step * BK, bar);
  }
};

// ------------------------------------------------ float32 (split TF32)
// What every float32 instance carries besides Shape: B's two K-major planes
// (N, K) of TF32 values, hi and lo, each read through a map of TILE_N-row
// boxes and one of TAIL-row boxes (the tail piece of a full-width tile).
// load_b(dst, n0, tail, step, bar, lane) brings a step's B: the hi plane's
// rows at dst, the lo plane's b_span() further on.
template <int TN>
struct SplitB : Shape {
  static constexpr int TILE_N = TN;  // 64 or 128
  static constexpr bool SPLIT = true;
  CUtensorMap b_hi, b_lo, b_hi_tail, b_lo_tail;
  __device__ void load_b(uint32_t dst, int n0, int tail, int step, uint32_t bar, int lane) const {
    constexpr int SPAN = (TN + TAIL) * ROW;
    if (lane == 0) tma2(dst, &b_hi, step * BK32, n0, bar);
    if (lane == 1) tma2(dst + SPAN, &b_lo, step * BK32, n0, bar);
    if (tail && lane == 2) tma2(dst + TN * ROW, &b_hi_tail, step * BK32, n0 + TN, bar);
    if (tail && lane == 3) tma2(dst + SPAN + TN * ROW, &b_lo_tail, step * BK32, n0 + TN, bar);
  }
};

// The maps of B's planes hi, lo (n, k), k contiguous.
template <int TN>
inline int split_maps(SplitB<TN>* p, const float* hi, const float* lo, int n, int k) {
  int err;
  if ((err = matrix_map32(&p->b_hi, hi, n, k, TN)) || (err = matrix_map32(&p->b_lo, lo, n, k, TN)) ||
      (err = matrix_map32(&p->b_hi_tail, hi, n, k, TAIL)))
    return err;
  return matrix_map32(&p->b_lo_tail, lo, n, k, TAIL);
}

// FrameSpectrum in float32: C[R, c] = sum_k frame_R[k] * W^T[c, k], the
// frames K-major (16 frame boxes of 32 samples a step, split in registers),
// W^T's planes (N, ft). Kernel A's product, D's spectrum pass and E's dspec
// (the frames of the padded dout, the synthesis weights' planes (ldc, ft)).
template <int TN>
struct FrameSpectrum32 : SplitB<TN> {
  static constexpr bool ROW_FAST = false;
  static constexpr int A_MN = 0;
  using Aux = NoAux;
  __device__ NoAux fetch(int, int) const { return {}; }
  __device__ void prefetch(int, int, int, int) const {}
  CUtensorMap frames;  // frames_map32
  int bpad, ft, hop, live_lo, live_hi;
  __device__ int begin_tile(int m0, int, int& s0) const {
    const int t_first = m0 / bpad, t_last = (min(m0 + BM, this->m) - 1) / bpad;
    const int lo = max(0, live_lo - t_last * hop), hi = min(ft, live_hi - t_first * hop);
    s0 = lo / BK32;
    return hi > s0 * BK32 ? (hi - s0 * BK32 + BK32 - 1) / BK32 : 0;
  }
  __device__ void load_a(uint32_t dst, int m0, int step, uint32_t bar, int lane) const {
    if (lane < BM / GROUP) {
      int b0, t;
      frame_group(m0 / GROUP + lane, bpad, b0, t);
      tma3(dst + lane * GROUP * ROW, &frames, step * BK32, b0, t, bar);
    }
  }
};

// RowProduct in float32: C[R, j] = sum_c D[R, c] * W[j, c], D's rows (M, K)
// one box of 128 rows a step, split in registers; W's planes (N, K). Kernel
// D's frame gradients (for dxp) and kernel B's frames (the spectrum rows and
// the synthesis weights' planes (ft, ldc)).
template <int TN>
struct RowProduct32 : SplitB<TN> {
  static constexpr bool ROW_FAST = false;
  static constexpr int A_MN = 0;
  using Aux = NoAux;
  __device__ NoAux fetch(int, int) const { return {}; }
  __device__ void prefetch(int, int, int, int) const {}
  CUtensorMap d;  // matrix_map32 (M, K), boxes of 32 x BM
  int k;
  __device__ int begin_tile(int, int, int& s0) const {
    s0 = 0;
    return (k + BK32 - 1) / BK32;
  }
  __device__ void load_a(uint32_t dst, int m0, int step, uint32_t bar, int lane) const {
    if (lane == 0) tma2(dst, &d, step * BK32, m0, bar);
  }
};

// FrameGrad in float32: C[j, c] = sum over the padded rows R of frame_R[j] *
// S^T[c, R], the frames M-major (four blocks of 32 samples j by four groups
// of 8 rows a step: 16 boxes, read into registers as they lie), S^T's planes
// (N, rows). The dW of kernels D and E. A tile of samples j takes only the K
// steps of the frames with a live sample among them.
template <int TN>
struct FrameGrad32 : SplitB<TN> {
  static constexpr bool ROW_FAST = false;
  static constexpr int A_MN = 1;
  using Aux = NoAux;
  __device__ NoAux fetch(int, int) const { return {}; }
  __device__ void prefetch(int, int, int, int) const {}
  CUtensorMap frames;  // frames_map32
  int bpad, hop, n_frames, live_lo, live_hi;
  __device__ int begin_tile(int j0, int, int& s0) const {
    const int t_lo = max(0, -floor_div(j0 + BM - 1 - live_lo, hop));
    const int t_hi = min(n_frames - 1, floor_div(live_hi - 1 - j0, hop));
    if (t_hi < t_lo) return 0;
    s0 = t_lo * bpad / BK32;
    return ((t_hi + 1) * bpad + BK32 - 1) / BK32 - s0;
  }
  __device__ void load_a(uint32_t dst, int j0, int step, uint32_t bar, int lane) const {
    constexpr int GROUPS = BK32 / GROUP;  // row groups a step
    if (lane < (BM / BK32) * GROUPS) {    // four 32-wide blocks of j, four row groups each
      const int jb = lane / GROUPS, gi = lane % GROUPS;
      int b0, t;
      frame_group(step * GROUPS + gi, bpad, b0, t);
      tma3(dst + jb * BK32 * ROW + gi * GROUP * ROW, &frames, j0 + jb * BK32, b0, t, bar);
    }
  }
};

}  // namespace
}  // namespace wg
