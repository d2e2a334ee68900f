// Fused AdamW update for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_adam.py
// (_adam_kernel / fused_adam_2d, wrapper repro/kernels/ops.py:fused_adam,
// caller repro/optim/adamw.py:apply_fused): one pass over flat f32 vectors
//   m' = b1 m + (1 - b1) g,   v' = b2 v + (1 - b2) g^2,
//   p' = p - lr ((m' / c1) / (sqrt(v' / c2) + eps) + wd p),
// with lr, c1 and c2 read from device memory (they change every step and are
// computed on the device, so nothing syncs the host and nothing is rebuilt),
// and b1, 1 - b1, b2, 1 - b2, eps, wd as arguments (1 - b are computed by the
// caller in double and rounded once, as the reference's weak-typed constants
// are).  Outputs alias the inputs: the update is in place.
//
// What bounds it on the H100: bytes.  Each entry reads p, g, m, v and writes
// p, m, v (28 bytes) for ~15 f32 operations, ~0.5 operations per byte against
// the card's ~20 for f32 on the CUDA cores, and no entry is used twice.  At
// tinyllama-1.1b (N = 1.1e9) that is 30.8 GB, 9.194 ms at 3.35 TB/s.  The
// operations are not free all the same: three IEEE divisions and a square
// root an entry are ~45 instructions, a third of the memory time if they do
// not overlap it.
//
// What held the grid-stride loop this replaced (one float4 of each vector a
// thread an iteration, 8 x SMs blocks of 256 threads) below the bound:
// ptxas gave it 46 registers, so 5 of its 8 blocks an SM fitted and the
// grid ran in 1.6 waves, and a thread kept only 64 bytes in flight before
// its divisions.  The design keeps the copies off the threads: a
// persistent grid (as many blocks an SM as the occupancy API allows beside
// each block's shared memory: 2) in which each block walks tiles of kTile
// entries of the four vectors (tile b, b + grid, ...).  One thread issues
// each tile's four loads as 1-D bulk copies (cp.async.bulk, completing on an
// mbarrier) into a ring of kStages stages in shared memory, kStages - 1
// tiles ahead of the one the block computes; the block's threads update that
// tile in shared memory (two float4 of each vector a thread), and the same
// thread sends p, m and v back with bulk stores after a proxy fence and a
// block barrier.  A stage is refilled one tile after its stores were issued,
// once they have read it (cp.async.bulk.wait_group.read).  So 128 KB of
// loads are in flight an SM at almost no register cost, and the divisions of
// one tile overlap the copies of the next ones.  Every copy carries an L2
// evict-first policy: nothing is read twice (bulk stores without a cache
// hint ran slower).  Measured on the H100 (PERF.md, tools/time_fused_adam.py):
// faster than the loop it replaced and than a register-only design (a grid
// from the occupancy API, 4 float4 of each vector a thread loaded with
// __ldcs before any arithmetic, stored with __stcs), and still short of the
// bound by more than the arithmetic costs: in design probes the same ring
// with the arithmetic taken out ran barely faster, and tiles of 1024 to 4096
// entries, 3 to 8 stages, 512 threads a block or contiguous runs of tiles a
// block no faster.  A copy_ of one vector into another comes closer to the
// bound: what is left is the memory system's cost of four read and three
// write streams.
//
// Bulk copies need 16-byte-aligned addresses and sizes: where all four base
// pointers are 16-byte aligned, the first N - N % 4 entries (the body) go
// through the ring, the last tile cut to a multiple of four entries, and the
// last N % 4 through a plain loop in the same launch; otherwise the whole
// vector takes that loop.  The split is the wrapper's
// (kernels/fused_adam.py::_plan), checked here.  Indices are 64-bit (N * 4
// bytes passes 2^31 at this model).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;                     // entries of each vector in a tile
constexpr int kStages = 3;
constexpr int kTileBytes = kTile * 4;           // one vector's share of a stage
constexpr int kStageBytes = 4 * kTileBytes;     // p, g, m, v
constexpr int kSmemBytes = kStages * kStageBytes + kStages * 8;   // + the mbarriers
constexpr int kMaxDevices = 64;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

// Each operation rounded on its own, in the order of the per-leaf update
// (repro_torch/optim/adamw.py, AdamW.apply): no fused multiply-add, so the
// fused and the per-leaf update give the same bits.
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, float lr,
                                     float c1, float c2, const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float step = __fadd_rn(
      __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps)),
      __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, step));
}

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

__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// `bytes` from global `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// `bytes` from shared `src` to global `dst`, in this thread's open bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::
                   "l"(dst),
               "r"(src), "r"(bytes), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most N of this thread's bulk groups have not yet read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

struct Vecs {
  float* p;
  const float* g;
  float* m;
  float* v;
};

// The four loads of the block's k-th tile into `stage` (one thread).
__device__ __forceinline__ void load_tile(const Vecs& x, long long body, long long k,
                                          uint32_t stage, uint32_t bar, uint64_t policy) {
  const long long start = ((long long)blockIdx.x + k * gridDim.x) * kTile;
  const long long len = body - start < kTile ? body - start : kTile;
  const uint32_t bytes = (uint32_t)len * 4;
  mbar_expect_tx(bar, 4 * bytes);
  bulk_load(stage, x.p + start, bytes, bar, policy);
  bulk_load(stage + kTileBytes, x.g + start, bytes, bar, policy);
  bulk_load(stage + 2 * kTileBytes, x.m + start, bytes, bar, policy);
  bulk_load(stage + 3 * kTileBytes, x.v + start, bytes, bar, policy);
}

__global__ void __launch_bounds__(kThreads)
fused_adam(Vecs x, const float* __restrict__ lr_ptr, const float* __restrict__ c1_ptr,
           const float* __restrict__ c2_ptr, Hyper h, long long body, long long n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float lr = *lr_ptr, c1 = *c1_ptr, c2 = *c2_ptr;
  const long long tiles = (body + kTile - 1) / kTile;
  const long long mine =
      (long long)blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (mine > 0) {
    const uint32_t ring = smem_u32(smem);
    const uint32_t bars = ring + kStages * kStageBytes;
    const uint64_t policy = evict_first();
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int k = 0; k < kStages && k < mine; ++k)
        load_tile(x, body, k, ring + k * kStageBytes, bars + 8 * k, policy);
    }
    __syncthreads();
    for (long long k = 0; k < mine; ++k) {
      const int s = (int)(k % kStages);
      const long long start = ((long long)blockIdx.x + k * gridDim.x) * kTile;
      const int len4 = (int)((body - start < kTile ? body - start : kTile) / 4);
      mbar_wait(bars + 8 * s, (uint32_t)((k / kStages) & 1));
      float4* sp = reinterpret_cast<float4*>(smem + s * kStageBytes);
      const float4* sg = sp + kTile / 4;
      float4* sm = sp + kTile / 2;
      float4* sv = sp + 3 * kTile / 4;
      for (int i = threadIdx.x; i < len4; i += kThreads) {
        float4 pp = sp[i], mm = sm[i], vv = sv[i];
        const float4 gg = sg[i];
        adam(pp.x, gg.x, mm.x, vv.x, lr, c1, c2, h);
        adam(pp.y, gg.y, mm.y, vv.y, lr, c1, c2, h);
        adam(pp.z, gg.z, mm.z, vv.z, lr, c1, c2, h);
        adam(pp.w, gg.w, mm.w, vv.w, lr, c1, c2, h);
        sp[i] = pp;
        sm[i] = mm;
        sv[i] = vv;
      }
      // the threads' writes made visible to the bulk copies, then sent
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x == 0) {
        const uint32_t stage = ring + s * kStageBytes;
        const uint32_t bytes = (uint32_t)len4 * 16;
        bulk_store(x.p + start, stage, bytes, policy);
        bulk_store(x.m + start, stage + 2 * kTileBytes, bytes, policy);
        bulk_store(x.v + start, stage + 3 * kTileBytes, bytes, policy);
        bulk_commit();
        // the previous tile's stage, once its stores have read it, takes the
        // tile kStages - 1 ahead of this one
        if (k >= 1 && k - 1 + kStages < mine) {
          const int r = (int)((k - 1) % kStages);
          bulk_wait_read<1>();
          load_tile(x, body, k - 1 + kStages, ring + r * kStageBytes, bars + 8 * r, policy);
        }
      }
    }
    if (threadIdx.x == 0) bulk_wait_all();
  }
  // the entries past the body: the last N % 4, or all of them where a base
  // pointer is not 16-byte aligned
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = body + (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    float pp = x.p[i], mm = x.m[i], vv = x.v[i];
    adam(pp, x.g[i], mm, vv, lr, c1, c2, h);
    x.p[i] = pp;
    x.m[i] = mm;
    x.v[i] = vv;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The kernel's shared-memory limit raised and its blocks an SM found, once
// for each device.
cudaError_t blocks_per_sm(int* blocks, int* sms) {
  static int cached_blocks[kMaxDevices], cached_sms[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_blocks[device] == 0) {
    if ((err = cudaFuncSetAttribute(fused_adam, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmemBytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&cached_sms[device], cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached_blocks[device], fused_adam,
                                                             kThreads, kSmemBytes)) != cudaSuccess)
      return err;
    if (cached_blocks[device] < 1) return cudaErrorInvalidConfiguration;
  }
  *blocks = cached_blocks[device];
  *sms = cached_sms[device];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// p, g, m, v: flat f32 device vectors of n entries (p, m, v updated in
// place); lr, c1, c2: one f32 each in device memory; body: the entries that
// go through the ring of bulk copies (kernels/fused_adam.py::_plan), a
// multiple of 4, and 0 unless all four pointers are 16-byte aligned.
// Returns cudaGetLastError() after the launch.
int repro_fused_adam(void* p, const void* g, void* m, void* v, const void* lr,
                     const void* c1, const void* c2, float b1, float omb1, float b2,
                     float omb2, float eps, float wd, long long n, long long body,
                     void* stream) {
  if (n < 0 || body < 0 || body > n || body % 4 ||
      (body > 0 && !(aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int per_sm = 0, sms = 0;
  const cudaError_t err = blocks_per_sm(&per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (body + kTile - 1) / kTile;
  const long long rest = (n - body + kThreads - 1) / kThreads;
  const long long need = tiles > rest ? tiles : rest;
  const long long cap = (long long)per_sm * sms;
  const int blocks = (int)(need < cap ? need : cap);
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  fused_adam<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      Vecs{static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
           static_cast<float*>(v)},
      static_cast<const float*>(lr), static_cast<const float*>(c1),
      static_cast<const float*>(c2), h, body, n);
  return (int)cudaGetLastError();
}

// The blocks an SM the launch runs (the occupancy API's count for the
// kernel's shared memory), or minus a cudaError.
int repro_fused_adam_blocks_per_sm(void) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = blocks_per_sm(&per_sm, &sms);
  return err == cudaSuccess ? per_sm : -(int)err;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
