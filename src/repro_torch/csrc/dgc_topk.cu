// DGC threshold pass for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/dgc_topk.py
// (_dgc_kernel / dgc_threshold_2d, wrapper repro/kernels/ops.py:dgc_mask), the
// selection stage of Deep Gradient Compression: given a threshold (estimated
// outside the kernel), write g where |g| >= thr and 0 elsewhere, and count the
// entries kept.  g is f32 or bf16; the comparison is in f32 and the output is
// in g's type, which is what the reference computes after its cast to f32.
//
// What bounds it on the H100: bytes.  Each element is read once and written
// once (8 bytes in f32, 4 in bf16) for two operations, and no element is used
// twice.  The design streams: a grid-stride loop in which each thread moves 16
// bytes per access (4 f32 or 8 bf16 values), with a scalar loop for the tail
// and for pointers that are not 16-byte aligned.  Each thread counts its
// survivors; a warp sums its counts with shuffles, a block through shared
// memory, and each block adds its sum to one 64-bit counter with a single
// atomicAdd.  Integer adds give the same count in any order.  Indices are
// 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dgc_threshold(const T* __restrict__ g, T* __restrict__ out, const float* __restrict__ thr_ptr,
              long long n, int vec, unsigned long long* __restrict__ count) {
  constexpr int kVec = 16 / sizeof(T);
  const float thr = *thr_ptr;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned long long kept = 0;
  long long done = 0;
  if (vec) {
    const long long nv = n / kVec;
    const uint4* gv = reinterpret_cast<const uint4*>(g);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 in = gv[i];
      uint4 res;
      const T* x = reinterpret_cast<const T*>(&in);
      T* y = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool keep = fabsf(to_float(x[j])) >= thr;
        y[j] = keep ? x[j] : zero<T>();
        kept += keep;
      }
      ov[i] = res;
    }
    done = nv * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const T x = g[i];
    const bool keep = fabsf(to_float(x)) >= thr;
    out[i] = keep ? x : zero<T>();
    kept += keep;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, off);
  __shared__ unsigned long long warp_kept[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_kept[warp] = kept;
  __syncthreads();
  if (warp == 0) {
    kept = lane < kThreads / 32 ? warp_kept[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, off);
    if (lane == 0 && kept) atomicAdd(count, kept);
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* g, void* out, const void* thr, long long n,
                   unsigned long long* count, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  constexpr int kVec = 16 / sizeof(T);
  const int vec = aligned16(g) && aligned16(out);
  const long long work = vec ? (n + kVec - 1) / kVec : n;
  const long long need = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  dgc_threshold<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(out), static_cast<const float*>(thr), n, vec,
      count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, out: n elements in device memory, dtype 0 = float32, 1 = bfloat16;
// thr: one f32 in device memory; count: one zeroed uint64 in device memory,
// incremented by the number of entries kept.  Returns cudaGetLastError()
// after the launch.
int repro_dgc_threshold(const void* g, void* out, const void* thr, int dtype, long long n,
                        void* count, void* stream) {
  if (n < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  auto* cnt = static_cast<unsigned long long*>(count);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch<float>(g, out, thr, n, cnt, st)
                          : launch<__nv_bfloat16>(g, out, thr, n, cnt, st));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
