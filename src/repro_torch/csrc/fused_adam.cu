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
// are).
//
// What bounds it on the H100: bytes.  Each element reads p, g, m, v and writes
// p, m, v (28 bytes) for ~15 f32 operations, ~0.5 operations per byte against
// the card's ~20 for f32 on the CUDA cores, and no element is used twice.  At
// tinyllama-1.1b (N = 1.1e9) that is 30.8 GB, ~9.2 ms at 3.35 TB/s.  The
// design does nothing but stream: a grid-stride loop in which each thread
// moves 16 bytes per vector per access (float4), so a warp reads 512
// contiguous bytes per vector per iteration; the grid is a few blocks per SM
// and the loop covers any N.  Indices are 64-bit (N * 4 bytes passes 2^31 at
// this model, and N itself does for larger ones).  Where a pointer is not
// 16-byte aligned the whole vector goes through the scalar loop; the last
// N % 4 elements always do.  Outputs alias the inputs: the update is in place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
fused_adam(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
           float* __restrict__ v, const float* __restrict__ lr_ptr,
           const float* __restrict__ c1_ptr, const float* __restrict__ c2_ptr, Hyper h,
           long long n, int vec) {
  const float lr = *lr_ptr, c1 = *c1_ptr, c2 = *c2_ptr;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (long long i = tid; i < n4; i += stride) {
      float4 pp = p4[i], mm = m4[i], vv = v4[i];
      const float4 gg = g4[i];
      adam(pp.x, gg.x, mm.x, vv.x, lr, c1, c2, h);
      adam(pp.y, gg.y, mm.y, vv.y, lr, c1, c2, h);
      adam(pp.z, gg.z, mm.z, vv.z, lr, c1, c2, h);
      adam(pp.w, gg.w, mm.w, vv.w, lr, c1, c2, h);
      p4[i] = pp;
      m4[i] = mm;
      v4[i] = vv;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam(pp, g[i], mm, vv, lr, c1, c2, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// p, g, m, v: flat f32 device vectors of n elements (p, m, v updated in
// place); lr, c1, c2: one f32 each in device memory.  Returns
// cudaGetLastError() after the launch.
int repro_fused_adam(void* p, const void* g, void* m, void* v, const void* lr,
                     const void* c1, const void* c2, float b1, float omb1, float b2,
                     float omb2, float eps, float wd, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  const long long work = vec ? (n + 3) / 4 : n;
  const long long need = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  fused_adam<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<const float*>(lr), static_cast<const float*>(c1),
      static_cast<const float*>(c2), h, n, vec);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
