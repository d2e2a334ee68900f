// Flash attention forward on Hopper's tensor cores (sm_90a), bf16, plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:31
// (_flash_kernel; wrapper flash_attention :112) for the inputs that
// repro_torch/kernels/flash_attention.py:_variant sends here: bf16, head dims
// multiples of 8 up to 256 (q/k and v), 16-byte-aligned base pointers, b/h/s
// strides that are positive multiples of 8 elements, with or without a local
// window.  The rest (f32, odd head dims, unaligned strides) keeps the
// CUDA-core kernel in flash_attention.cu.  It computes what _flash_kernel
// computes: causal or full GQA attention (q head h reads kv head
// h / (H / KH)) with an online softmax, f32 running max, denominator and
// accumulator, scores never written to device memory, output
// acc / max(l, 1e-20); and, as the reference's chunked_attention(window=),
// a local window: key k counts for query q only where q - k < window.
//
// What bounds it on the H100, at tinyllama-1.1b's shapes (H 32, KH 4, D 64,
// causal, bf16): the prefill (B 4, S 512) does 4.3e9 FLOPs for 19 MB of
// q/k/v/o, ~230 FLOP per byte, just under the card's bf16 ridge (~295), so
// its floor is the bytes (5.6 us) with the FLOPs close behind (4.3 us);
// training (B 2, S 4096) does 1.4e11 FLOPs for 75 MB, ~1800 FLOP per byte, so
// the tensor cores bound it (0.139 ms at 989 TFLOP/s).  Either way the
// products must run on the tensor cores; the CUDA-core kernel's 67 TFLOP/s
// ceiling kept it at 2% of the bound.  At D = 64 the softmax is the other
// limit: one exp2 per score on the SFU (16 per clock per SM) costs as much
// time as the two products on the tensor cores, so the design keeps the
// softmax lean and overlaps it with the products.  The design:
//   * one block of three warpgroups per SM, persistent: two consumers of 64
//     query rows each and one producer, walking work items of 128 query rows
//     of one (batch, q head), heaviest first, in a zig-zag over the blocks so
//     that their loads even out.  setmaxnreg moves registers from the
//     producer (40) to the consumers (232), which hold a 64 x kBlockN f32
//     score tile, the 64 x Dv f32 accumulator and P;
//   * one producer thread issues TMA loads: Q once per item (single
//     buffer, with full and empty barriers, the next item's Q prefetched into
//     L2), K and V tiles of kBlockN keys into a 3-stage ring in shared memory
//     with full barriers for K and V (mbarrier transaction counts) and an
//     empty barrier that the 8 consumer warps arrive on once P.V has read
//     the stage (a 2-stage ring frees K and V apart, below).  It runs ahead
//     into the next item while the consumers finish the current one.  The tensor maps are 4-D (D, S, heads, B) over the
//     caller's strides, so (B, S, H, D) tensors viewed as (B, H, S, D) load
//     without a copy; TMA zero-fills past S and past D, so D <= 64 runs as
//     one 64-column 128-byte-swizzled atom and 64 < D <= 128 (D = 80 too)
//     as two;
//   * S = Q.K^T: wgmma m64n128k16 (m64n64k16 for 64-key tiles), A (Q) and B
//     (K) both K-major from the swizzled shared memory, D / 16 steps, f32
//     accumulation;
//   * the softmax stays in registers, in the log2 domain: exp2 (the SFU's
//     ex2.approx) of s * log2(e)/sqrt(D) - m as one FMA; each row is spread
//     over 4 threads of a quad, whose max and sum meet through two
//     xor-shuffles; only tiles that cross the diagonal, S or the window's
//     lower edge carry masking code (a template parameter), two compares per
//     score; a row with no valid key yet subtracts 0 instead of -inf, so it
//     gives 0 and not NaN;
//   * O += P.V: P is rounded to bf16 in registers, where the score
//     accumulator's fragment layout is already wgmma's A-register layout; V
//     is B from shared memory, MN-major (D contiguous) through the transpose
//     bit; O stays f32;
//   * each iteration issues S_t = Q.K_t^T and then O += P_{t-1}.V_{t-1},
//     waits for S_t only and runs its softmax while the tensor cores do P.V;
//     the two consumer warpgroups issue freely and overlap each other (making
//     them take turns, as FA3 does, measured slower here);
//   * under `causal` the key loop stops at the item's diagonal tile; under a
//     window it starts at the tile of key q0 - window + 1, so an item visits
//     the band's tiles only.  The window is a template parameter too: a
//     launch without one runs code with no trace of it (timed against the
//     kernel before the window, tools/time_flash.py: equal within the
//     noise);
//   * the output is written as bf16 pairs straight from the accumulator
//     registers through the output strides, rows >= S and columns >= Dv
//     masked.
// ptxas (sm_90a): 168 registers at launch for every bucket, with
// and without the window (the consumers run under setmaxnreg 232), no
// spills; chip_smoke.py prints the build log's lines.
//
// Two head dims.  q and k have Dqk columns and v and the output Dv, as
// DeepSeek-V2's multi-head latent attention needs (Dqk 192 = 128 + 64 rope
// columns, Dv 128, one K per head).  The kernel is a template on both
// buckets: (64, 64) and (128, 128), the single head dim's instantiations
// unchanged, (192, 128), and (256, 256) for the rest up to 256 (RecurrentGemma's
// 256; q/k 256 with v 128 too).  At (192, 128) S = Q.K^T runs over twelve
// k-steps of 16 across three 64-column atoms, and P.V keeps the 128-column
// accumulator, so the consumers' registers are the (128, 128) bucket's.
// Shared memory, against the 227 KB (232,448 bytes) an SM offers a block:
//   (64, 64):   Q 16 KB + 3 stages x (K 16 KB + V 16 KB) = 112 KB;
//   (128, 128): Q 32 KB + 3 stages x (K 32 KB + V 32 KB) = 224 KB;
//   (192, 128): Q 48 KB + 3 stages x (K 48 KB + V 32 KB) = 288 KB does not
//               fit, so this bucket keeps 2 stages: 208 KB;
//   (256, 256): 64-key tiles, Q 64 KB + 2 stages x (K 32 KB + V 32 KB) =
//               192 KB (3 stages, 256 KB, do not fit);
// each plus 8 bytes per barrier (2 + 4 x stages) and 1 KB for the
// alignment; v is not padded to 192.  With one empty barrier per stage, a
// 2-stage ring would load K and V tile t + 1 only once P_{t-1}.V_{t-1} is
// done, half an iteration before K_{t+1} is read.  So a 2-stage ring has
// empty barriers for K and V apart: the consumers free K_t's stage once
// Q.K_t^T is done and V's once P.V is, and K tile t + 1 loads an iteration
// earlier (PERF.md §6 gives the (192, 128) bucket's train-shape time before
// and after).  The 3-stage buckets keep one empty barrier per stage: they
// already load a full iteration ahead.
//
// Head dim 256.  What bounds it at recurrentgemma-9b's shapes (16 q heads,
// one KV head, D = Dv = 256): the windowed training call (1 x 4096, window
// 2048) does 1.0e11 FLOPs for 71 MB, the tensor cores' work (0.104 ms); the
// serve prefill (4 x 512, causal) 8.6e9 FLOPs for 36 MB, just under the
// ridge, so its bytes (0.0106 ms).  Both products run on the tensor cores
// as in the other buckets; what sets the tiling is the register file.  The
// 64 x 256 f32 accumulator is 128 registers a consumer thread.  A 128-key
// score tile would add 64 and its bf16 P 32: 224 of the 232 setmaxnreg
// gives, before addresses and softmax state, so it would spill.  With
// 64-key tiles (block_n) the scores take 32 and P 16.  Q.K^T runs as
// m64n64k16 over sixteen k-steps across four atoms, P.V as m64n256k16 over
// four.  Each iteration does half the work of a 128-key tile's, so the
// ring's loads and barriers come twice as often; the 2-stage ring with K
// and V freed apart keeps K_{t+1} loading while P_{t-1}.V_{t-1} runs.  The
// atoms of K and V hold 64 rows (their TMA boxes too), Q's 128.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;                   // query rows per block
constexpr int kMaxStages = 3;                  // depth of the K/V ring where it fits
constexpr uint32_t kSmemLimit = 232448;        // an SM's shared memory for one block
constexpr int kConsumers = 2;                  // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kAtomCols = 64;                  // bf16 columns in one 128-byte row

// Keys per K/V tile of the (DQK, DV) bucket: 128, or 64 where v's 256
// columns take 128 accumulator registers a consumer thread (header note).
__host__ __device__ constexpr int block_n(int dv) { return dv > 128 ? 64 : 128; }

// One 128-byte-swizzled atom of a tile (one TMA box): `rows` rows of 64 bf16
// columns.  Q's atoms hold the item's 128 rows, K's and V's the tile's keys.
__host__ __device__ constexpr uint32_t atom_bytes(int rows) { return rows * 128u; }

// Shared memory, from a 1024-byte-aligned base: Q, the K ring, the V ring
// (Q and K tiles DQK / 64 atoms, V tiles DV / 64), then the barriers full_q,
// empty_q, full_k[kStages], full_v[kStages], empty_k[kStages] (used by a
// 2-stage ring only), empty_v[kStages] (the stage's, or its V's).  kStages
// is kMaxStages where that fits in kSmemLimit, else 2.
constexpr uint32_t smem_bytes(int dqk, int dv, int stages) {
  return dqk / kAtomCols * atom_bytes(kBlockM) +
         stages * ((dqk + dv) / kAtomCols) * atom_bytes(block_n(dv)) + 8 * (2 + 4 * stages) +
         1024;  // + alignment
}

template <int DQK, int DV>
struct Smem {
  static constexpr int kBlockN = block_n(DV);
  static constexpr int kAtomsQK = DQK / kAtomCols;
  static constexpr int kAtomsV = DV / kAtomCols;
  static constexpr uint32_t kAtomQ = atom_bytes(kBlockM);
  static constexpr uint32_t kAtomKV = atom_bytes(kBlockN);
  static constexpr uint32_t kTileQ = kAtomsQK * kAtomQ;
  static constexpr uint32_t kTileK = kAtomsQK * kAtomKV;
  static constexpr uint32_t kTileV = kAtomsV * kAtomKV;
  static constexpr int kStages =
      smem_bytes(DQK, DV, kMaxStages) <= kSmemLimit ? kMaxStages : 2;
  static constexpr bool kSplitEmpty = kStages == 2;  // K and V freed apart
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kTileQ;
  static constexpr uint32_t kV = kK + kStages * kTileK;
  static constexpr uint32_t kBar = kV + kStages * kTileV;
  static constexpr uint32_t kBytes = smem_bytes(DQK, DV, kStages);
  static_assert(kBytes <= kSmemLimit, "the Q tile and two K/V stages must fit");
  static_assert(kBytes == kBar + 8 * (2 + 4 * kStages) + 1024, "smem_bytes is the layout");
  // an atom is one TMA box (at most 256 rows) of whole 8-row swizzle groups,
  // and issue_qk has the wgmma shapes of 64- and 128-key tiles
  static_assert(kBlockM % 64 == 0 && kBlockM <= 256, "an atom holds Q's 128 rows");
  static_assert(kBlockN == 64 || kBlockN == 128, "an atom holds a K/V tile's keys");
};

struct Strides {  // in elements; the last (D) stride is 1
  long long b, h, s;
};

template <int kStages>
struct RingT {  // a position in the K/V ring: stage and the parity of its use
  int stage = 0, phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed.  A wait that
// lasts ~10 s (an arrival that never comes) traps, so the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

// One box of the 4-D tensor map at (d, s, head, batch) into L2 only.
__device__ __forceinline__ void tma_prefetch_l2(const CUtensorMap* map, int d, int s, int head,
                                                int batch) {
  asm volatile("cp.async.bulk.prefetch.tensor.4d.L2.global [%0, {%1, %2, %3, %4}];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(d), "r"(s), "r"(head), "r"(batch)
               : "memory");
}

// One box of the 4-D tensor map at (d, s, head, batch) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int s, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(head), "r"(batch)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte-swizzled layout:
// start address, leading and stride byte offsets (16-byte units), swizzle mode.
// The address is the low 14 bits, so adding (bytes >> 4) moves it within
// shared memory.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of wgmma's accumulator registers above
// the wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) = A . B (+ d if accumulate): A 64 x 16 and B 16 x 128 in
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = A . B (+ d if accumulate): A 64 x 16 and B 16 x 64 in
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A . B: A 64 x 16 bf16 in registers (the accumulator's
// fragment layout), B 16 x 64 in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A . B: A 64 x 16 bf16 in registers (the accumulator's
// fragment layout), B 16 x 128 in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A . B: A 64 x 16 bf16 in registers (the accumulator's
// fragment layout), B 16 x 256 in shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Accumulator fragment of wgmma m64nN (f32): in warp w of the warpgroup,
// register i of lane l holds row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.  Below, r = (i / 2) % 2 picks the row.

// S = Q . K^T for the warpgroup's 64 rows and a tile of N keys: DQK / 16
// k-steps; every 64 columns the next atom (Q's of 128 rows, K's of N).
template <int DQK, int N>
__device__ __forceinline__ void issue_qk(float (&sc)[N / 2], uint32_t q_addr, uint32_t k_addr) {
  const uint64_t dq = desc_sw128(q_addr, 16, 1024), dk = desc_sw128(k_addr, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {  // offsets in 16-byte units
    const uint32_t oq = ((kk / 4) * atom_bytes(kBlockM) + (kk % 4) * 32) >> 4;
    const uint32_t ok = ((kk / 4) * atom_bytes(N) + (kk % 4) * 32) >> 4;
    if constexpr (N == 64)
      wgmma_ss_m64n64(sc, dq + oq, dk + ok, kk > 0);
    else
      wgmma_ss_m64n128(sc, dq + oq, dk + ok, kk > 0);
  }
}

// O += P . V: V is N keys x Dv with Dv contiguous (MN-major); k-step j
// starts 16 rows (2048 bytes) further, each next 64-column atom
// atom_bytes(N) further.
template <int DV, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2], const uint32_t (&p)[N / 16][4],
                                         uint32_t v_addr) {
  const uint64_t dv = desc_sw128(v_addr, atom_bytes(N), 1024);
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    if constexpr (DV == 64)
      wgmma_rs_m64n64(acc, p[j], dv + j * 16 * 128 / 16);
    else if constexpr (DV == 128)
      wgmma_rs_m64n128(acc, p[j], dv + j * 16 * 128 / 16);
    else
      wgmma_rs_m64n256(acc, p[j], dv + j * 16 * 128 / 16);
  }
}

// The online softmax of one score tile of N keys, in place: sc becomes P
// (f32, not normalised) in the log2 domain, exp2(s * scale_log2 - m); m and
// this thread's share of l move on, and corr is what the accumulator's rows
// must be scaled by.  kMasked (a tile that crosses the diagonal, S or the
// window's lower edge) first sets the scores of keys < begin[r] and
// >= end[r] to -inf, both counted from this thread's first key; the other
// tiles carry no masking code at all.  A row with no valid key yet subtracts
// 0 instead of -inf, so it gives 0 and not NaN.
template <bool kMasked, int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int (&begin)[2],
                                             const int (&end)[2], float scale_log2) {
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i / 2) % 2, c = 8 * (i / 4) + i % 2;
    if (kMasked && (c < begin[r] || c >= end[r])) sc[i] = -INFINITY;
    mx[r][(i / 4) % 2] = fmaxf(mx[r][(i / 4) % 2], sc[i]);
  }
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(fmaxf(mx[r][0], mx[r][1])) * scale_log2);
    sub[r] = mn == -INFINITY ? 0.f : mn;
    corr[r] = ex2(m[r] - sub[r]);
    m[r] = mn;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = ex2(fmaf(sc[i], scale_log2, -sub[r]));
    sum[r][(i / 4) % 2] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r][0] + sum[r][1];
}

// The online softmax of a tile of N keys k0 ..: masked only where the tile
// crosses S or, under `causal`, the first row of the warpgroup, or, under a
// window (kWindow), lies window or more keys before the warpgroup's last row.
template <int N, bool kWindow>
__device__ __forceinline__ void softmax_at(float (&sc)[N / 2], float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int k0, int wg_row, int row0, int S,
                                           int causal, int window, float scale_log2, int lane) {
  if (k0 + N > S || (causal && k0 + N - 1 > wg_row) ||
      (kWindow && wg_row + 63 - k0 >= window)) {
    const int key0 = k0 + 2 * (lane % 4);  // this thread's first key in the tile
    const int end[2] = {(causal ? min(S, row0 + 1) : S) - key0,
                        (causal ? min(S, row0 + 9) : S) - key0};
    const int begin[2] = {kWindow ? row0 + 1 - window - key0 : 0,
                          kWindow ? row0 + 9 - window - key0 : 0};
    softmax_tile<true, N>(sc, m, l, corr, begin, end, scale_log2);
  } else {
    const int from[2] = {0, 0}, to[2] = {N, N};
    softmax_tile<false, N>(sc, m, l, corr, from, to, scale_log2);
  }
}

// P (f32, the score accumulator's layout) as wgmma's A fragments in bf16:
// k-step j covers keys 16 j .. 16 j + 15.
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N / 2], uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
}

// One work item: 128 query rows of one (batch, q head), visiting n_tiles K/V
// tiles of N keys from tile t0.  Items are numbered heaviest first, priced by
// the tiles they visit, q tiles outermost: under `causal` the last q tile
// first, else the first.  Under a window that order is still heaviest first, to one tile:
// an item visits the band from the tile of q0 - window + 1 to its diagonal
// (`causal`), so an earlier q tile visits no more tiles than a later one,
// but the last q tile, ragged at S, may visit one fewer than the one before
// it; or to S, so a later q tile, starting the band later, visits no more.
// Block c of G takes item c of each round of G items, walking the rounds
// back and forth (c, then G - 1 - c, ...), so the heavy and light items even
// out across the persistent blocks.
struct Item {
  int q0, h, b, t0, n_tiles;
};

__device__ __forceinline__ int item_index(int round) {
  return round * gridDim.x + (round % 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

template <int N, bool kWindow>
__device__ __forceinline__ Item item(int w, int H, int B, int S, int causal, int window) {
  const int n_q = (S + kBlockM - 1) / kBlockM;
  const int qt = w / (H * B), bh = w % (H * B);
  Item it;
  it.q0 = (causal ? n_q - 1 - qt : qt) * kBlockM;
  it.h = bh % H;
  it.b = bh / H;
  it.t0 = kWindow ? max(0, it.q0 - window + 1) / N : 0;
  it.n_tiles = ((causal ? min(it.q0 + kBlockM, S) : S) + N - 1) / N - it.t0;
  return it;
}

// kWindow: a local window (window > 0); without one the kernel carries no
// code for it.
template <int DQK, int DV, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int H,
                int B, int group, int S, int Dv, int causal, int window, float scale_log2,
                Strides so) {
  using L = Smem<DQK, DV>;
  constexpr int kStages = L::kStages, kBlockN = L::kBlockN;
  using Ring = RingT<kStages>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_q_empty = bar_q + 8;
  const uint32_t bar_k = bar_q + 16;                // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_empty_k = bar_v + 8 * kStages;
  const uint32_t bar_empty_v = bar_empty_k + 8 * kStages;
  const int n_items = H * B * ((S + kBlockM - 1) / kBlockM);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, kConsumers * 4);  // one arrival per consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty_k + 8 * s, kConsumers * 4);
      mbar_init(bar_empty_v + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps Q and the K/V ring full, running ahead into
    // the block's next item while the consumers finish the current one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      Ring ring;  // where the next K/V tile goes
      for (int n = 0, w; (w = item_index(n)) < n_items; ++n) {
        const Item it = item<kBlockN, kWindow>(w, H, B, S, causal, window);
        const int kvh = it.h / group;
        mbar_wait(bar_q_empty, (n & 1) ^ 1);
        mbar_expect_tx(bar_q, L::kTileQ);
        for (int a = 0; a < L::kAtomsQK; ++a)
          tma_load(base + L::kQ + a * L::kAtomQ, &tm_q, bar_q, a * kAtomCols, it.q0, it.h, it.b);
        if (item_index(n + 1) < n_items) {  // the next item's Q into L2, ahead of its load
          const Item next =
              item<kBlockN, kWindow>(item_index(n + 1), H, B, S, causal, window);
          for (int a = 0; a < L::kAtomsQK; ++a)
            tma_prefetch_l2(&tm_q, a * kAtomCols, next.q0, next.h, next.b);
        }
        for (int t = it.t0; t < it.t0 + it.n_tiles; ++t, ring.advance()) {
          const int s = ring.stage;
          mbar_wait((L::kSplitEmpty ? bar_empty_k : bar_empty_v) + 8 * s, ring.phase ^ 1);
          mbar_expect_tx(bar_k + 8 * s, L::kTileK);
          for (int a = 0; a < L::kAtomsQK; ++a)
            tma_load(base + L::kK + s * L::kTileK + a * L::kAtomKV, &tm_k, bar_k + 8 * s,
                     a * kAtomCols, t * kBlockN, kvh, it.b);
          if (L::kSplitEmpty) mbar_wait(bar_empty_v + 8 * s, ring.phase ^ 1);
          mbar_expect_tx(bar_v + 8 * s, L::kTileV);
          for (int a = 0; a < L::kAtomsV; ++a)
            tma_load(base + L::kV + s * L::kTileV + a * L::kAtomKV, &tm_v, bar_v + 8 * s,
                     a * kAtomCols, t * kBlockN, kvh, it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63 of
    // each item.  Iteration t issues S_t = Q K_t^T and then
    // O += P_{t-1} V_{t-1}, waits for S_t only (in a 2-stage ring frees
    // K_t) and runs its softmax while the tensor cores do P.V; then waits for
    // P.V, frees V_{t-1}'s stage and rescales O.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const uint32_t q_addr = base + L::kQ + 64 * wg * 128;
    const uint32_t k_ring = base + L::kK, v_ring = base + L::kV;

    Ring ring;  // the next K/V tile to read
    for (int n = 0, w; (w = item_index(n)) < n_items; ++n) {
      const Item it = item<kBlockN, kWindow>(w, H, B, S, causal, window);
      const int wg_row = it.q0 + 64 * wg;
      const int row0 = wg_row + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8

      float acc[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      float sc[kBlockN / 2];
      uint32_t p[kBlockN / 16][4];  // bf16 P of the tile whose P.V is pending

      mbar_wait(bar_q, n & 1);
      mbar_wait(bar_k + 8 * ring.stage, ring.phase);
      wgmma_fence();
      issue_qk<DQK, kBlockN>(sc, q_addr, k_ring + ring.stage * L::kTileK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (L::kSplitEmpty && lane == 0) mbar_arrive(bar_empty_k + 8 * ring.stage);
      softmax_at<kBlockN, kWindow>(sc, m, l, corr, it.t0 * kBlockN, wg_row, row0, S, causal,
                                   window, scale_log2, lane);
      pack_p<kBlockN>(sc, p);  // O is still 0: nothing to rescale
      Ring prev = ring;  // the tile whose P.V is pending
      ring.advance();

      for (int t = 1; t < it.n_tiles; ++t, prev = ring, ring.advance()) {
        const int s = ring.stage, sp = prev.stage;
        const int k0 = (it.t0 + t) * kBlockN;
        mbar_wait(bar_k + 8 * s, ring.phase);
        mbar_wait(bar_v + 8 * sp, prev.phase);
        wgmma_fence();
        issue_qk<DQK, kBlockN>(sc, q_addr, k_ring + s * L::kTileK);
        wgmma_commit();
        issue_pv<DV, kBlockN>(acc, p, v_ring + sp * L::kTileV);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        if (L::kSplitEmpty && lane == 0) mbar_arrive(bar_empty_k + 8 * s);
        softmax_at<kBlockN, kWindow>(sc, m, l, corr, k0, wg_row, row0, S, causal, window,
                                     scale_log2, lane);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(p);
        if (lane == 0) mbar_arrive(bar_empty_v + 8 * sp);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i / 2) % 2];
        pack_p<kBlockN>(sc, p);
      }
      // every product with Q is done: the producer may load the next item's
      if (lane == 0) mbar_arrive(bar_q_empty);
      const int sl = prev.stage;
      mbar_wait(bar_v + 8 * sl, prev.phase);
      wgmma_fence();
      issue_pv<DV, kBlockN>(acc, p, v_ring + sl * L::kTileV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bar_empty_v + 8 * sl);

      const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-20f);
      const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-20f);
      __nv_bfloat16* ob = o + it.b * so.b + it.h * so.h;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        if (col >= Dv) continue;
        if (row0 < S)
          *reinterpret_cast<uint32_t*>(ob + row0 * so.s + col) =
              pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (row0 + 8 < S)
          *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * so.s + col) =
              pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so that libcuda need not be linked.
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (D, S, heads, B) over bf16 at `ptr` with the given element
// strides; boxes of 64 columns x `rows` rows (one atom), 128-byte swizzle,
// zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B, Strides st,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kAtomCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                     strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (DQK, DV) bucket's launch: its tensor maps (Q's boxes of kBlockM rows,
// K's and V's of the bucket's tile), then one persistent block per SM.
template <int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KH,
                   int S, int D, int Dv, int causal, int window, float scale_log2, Strides sq,
                   Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  using L = Smem<DQK, DV>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, D, S, H, B, sq, kBlockM) ||
      !make_map(&mk, k, D, S, KH, B, sk, L::kBlockN) ||
      !make_map(&mv, v, Dv, S, KH, B, sv, L::kBlockN))
    return cudaErrorInvalidValue;
  constexpr int smem = L::kBytes;
  const auto kernel = window ? &flash_fwd_wgmma<DQK, DV, true> : &flash_fwd_wgmma<DQK, DV, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long items = (long long)H * B * ((S + kBlockM - 1) / kBlockM);
  const int grid = (int)(items < sms ? items : sms);  // persistent: one block per SM
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, B, H / KH, S, Dv, causal, window, scale_log2,
      so);
  return cudaGetLastError();
}

bool fits(const void* ptr, Strides st) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && st.b > 0 && st.h > 0 && st.s > 0 &&
         st.b % 8 == 0 && st.h % 8 == 0 && st.s % 8 == 0;
}

}  // namespace

extern "C" {

// The signature of repro_flash_attention_fwd (flash_attention.cu): q
// (B, H, S, D), k (B, KH, S, D), v (B, KH, S, Dv), o (B, H, S, Dv), addressed
// through the given strides (elements; the last dim contiguous).  dtype must
// be 1 (bfloat16), D and Dv multiples of 8 up to 256, q/k/v 16-byte aligned
// with b/h/s strides positive multiples of 8; window >= 0 (0: none).  The
// bucket: (64, 64) or (128, 128) where both head dims are at most 128,
// (192, 128) where q/k's is at most 192 and v's at most 128, else
// (256, 256).  scale_log2 is log2(e) / sqrt(D).  Returns cudaGetLastError()
// after the launch, or the error that kept it from launching.
int repro_flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int B, int H, int KH, int S, int D, int Dv,
                                    int causal, int window, float scale_log2, long long sqb,
                                    long long sqh, long long sqs, long long skb, long long skh,
                                    long long sks, long long svb, long long svh, long long svs,
                                    long long sob, long long soh, long long sos, void* stream) {
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  if (dtype != 1 || B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || D <= 0 || D > 256 ||
      D % 8 != 0 || Dv <= 0 || Dv > 256 || Dv % 8 != 0 || window < 0 ||
      (long long)H * B * ((S + kBlockM - 1) / kBlockM) > INT_MAX || !fits(q, sq) ||
      !fits(k, sk) || !fits(v, sv))
    return (int)cudaErrorInvalidValue;
  if (encode_fn() == nullptr) return (int)cudaErrorNotSupported;
  if (window >= S) window = 0;  // a band of S keys or more masks nothing
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the (DQK, DV) bucket
  const auto bucket = D > 192 || Dv > 128 ? &launch<256, 256>
                      : D > 128           ? &launch<192, 128>
                      : D > 64 || Dv > 64 ? &launch<128, 128>
                                          : &launch<64, 64>;
  return (int)bucket(q, k, v, o, B, H, KH, S, D, Dv, causal, window, scale_log2, sq, sk, sv, so,
                     st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
