// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py (_rmsnorm_kernel /
// rmsnorm_2d, wrapper repro/kernels/ops.py:rmsnorm):
//   y = x * rsqrt(mean(x^2) + eps) * w   over the last dim,
// with the statistics in f32 and y in x's type (f32 or bf16; w f32 or bf16).
//
// What bounds it on the H100: bytes.  About 4 operations per element against
// one read of x and one write of y (4 bytes an element in bf16), so the floor
// is (2 * rows * D + D) * itemsize / 3.35e12 s, far above any operation bound.
// The design keeps enough bytes in flight and wastes no lane:
//   * a row belongs to a group of 1, 2, 4 or 8 warps (warps_per_row), and
//     each thread loads 16 bytes at a time (8 bf16 or 4 f32 values), at most
//     5 loads of x a row, all issued before the reduction together with the
//     matching loads of w (L1/L2 hits: w is a few KB that every warp reads).
//     The loads are sized to D: at 2560 bf16 columns a row is 320 loads, 5
//     for each of two warps' 64 lanes, and no lane is masked (the Triton
//     kernel this replaced ran a row as one block of next_power_of_2(D)
//     lanes, 37.5% of them masked at 2560 and 5120); at 2048, 2 loads for
//     each of four warps' lanes (the wrapper's _split);
//   * the sum of squares is reduced by __shfl_xor_sync within the warp; a
//     group of several warps adds its warps' partial sums through one word
//     of shared memory each behind a named barrier of the group alone (two
//     slots alternate, so one barrier a row suffices);
//   * the grid is capped at a few blocks per SM (the wrapper's _plan) and
//     each group walks rows with a stride of all the groups in the grid.
// Chosen by timing variants on the H100 (PERF.md): up to 10 loads a
// thread with one warp a row ran slower than 5 loads with two warps (at 2560
// columns it hit the 128-register cap and spilled); a thread of at most 3
// loads is capped at 64 registers, so four blocks fit an SM (faster at 1536
// columns; more loads under that cap spill); loading the next row into a
// second set of registers before reducing the current one, and holding w in
// registers across the rows a warp walks, gained nothing or lost (a warp
// walks one to four rows at the main path's shapes, and the registers they
// cost cut the warps resident); loading w with the row, not after the
// reduction, took a memory latency off rows of small tensors.
// Rows wider than 5 loads a thread at 8 warps a row (past 10240 bf16 or 5120
// f32 columns) take NV = 0, a loop over the row in chunks that reads x twice
// (the second time from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N elements moved as one load or store (two 16-byte ones for 8 f32 values)
template <typename E, int N>
struct alignas(sizeof(E) * N < 16 ? sizeof(E) * N : 16) Pack {
  E v[N];
};

template <typename E, int N>
__device__ __forceinline__ Pack<E, N> load(const E* p) {
  return *reinterpret_cast<const Pack<E, N>*>(p);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 1 / rms of a row from each thread's sum of squares: the warp by shuffles,
// a group of several warps through `part` behind the group's own barrier
__device__ __forceinline__ float inv_rms(float ss, int wpr, int group, int warp, int lane,
                                         float (*part)[kWarps], int& parity, int D,
                                         float eps) {
  ss = warp_sum(ss);
  if (wpr > 1) {
    if (lane == 0) part[parity][warp] = ss;
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(wpr * 32) : "memory");
    ss = 0.f;
    for (int j = 0; j < wpr; ++j) ss += part[parity][group * wpr + j];
    parity ^= 1;
  }
  return rsqrtf(ss / (float)D + eps);
}

template <typename T, typename W, int VEC>
__device__ __forceinline__ void store_scaled(T* y, const Pack<T, VEC>& xv,
                                             const Pack<W, VEC>& wv, float inv) {
  Pack<T, VEC> out;
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    out.v[i] = from_float<T>(to_float(xv.v[i]) * inv * to_float(wv.v[i]));
  *reinterpret_cast<Pack<T, VEC>*>(y) = out;
}

// x: rows of D elements `xs` apart; y: rows `ys` apart.  Each group of `wpr`
// warps owns rows group_id, group_id + groups in the grid, ...; thread t of a
// group owns the VEC-element vectors t, t + 32 wpr, ... of a row (NV of them,
// or as many as the row has when NV = 0).  Registers are capped so that two
// blocks fit an SM (128 a thread), four where a thread holds 3 loads or fewer.
template <typename T, typename W, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, NV <= 3 ? 4 : 2)
rmsnorm_rows(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
             long long rows, int D, long long xs, long long ys, float eps, int wpr) {
  __shared__ float part[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / wpr;
  const int gthreads = wpr * 32;
  const int t = (warp % wpr) * 32 + lane;
  const int nvec = D / VEC;
  const long long stride = (long long)gridDim.x * (kWarps / wpr);
  long long r = (long long)blockIdx.x * (kWarps / wpr) + group;
  int parity = 0;

  if constexpr (NV > 0) {
    for (; r < rows; r += stride) {
      const T* xr = x + r * xs;
      Pack<T, VEC> xv[NV];
      Pack<W, VEC> wv[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int vi = k * gthreads + t;
        if (vi < nvec) {
          xv[k] = load<T, VEC>(xr + (long long)vi * VEC);
          wv[k] = load<W, VEC>(w + vi * VEC);
        }
      }
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (k * gthreads + t < nvec) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const float f = to_float(xv[k].v[i]);
            ss = fmaf(f, f, ss);
          }
        }
      }
      const float inv = inv_rms(ss, wpr, group, warp, lane, part, parity, D, eps);
      T* yr = y + r * ys;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int vi = k * gthreads + t;
        if (vi < nvec) store_scaled<T, W, VEC>(yr + vi * VEC, xv[k], wv[k], inv);
      }
    }
  } else {
    for (; r < rows; r += stride) {
      const T* xr = x + r * xs;
      float ss = 0.f;
      for (int vi = t; vi < nvec; vi += gthreads) {
        const Pack<T, VEC> xv = load<T, VEC>(xr + (long long)vi * VEC);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float f = to_float(xv.v[i]);
          ss = fmaf(f, f, ss);
        }
      }
      const float inv = inv_rms(ss, wpr, group, warp, lane, part, parity, D, eps);
      T* yr = y + r * ys;
      for (int vi = t; vi < nvec; vi += gthreads)
        store_scaled<T, W, VEC>(yr + vi * VEC, load<T, VEC>(xr + (long long)vi * VEC),
                                load<W, VEC>(w + vi * VEC), inv);
    }
  }
}

struct Args {
  const void* x;
  const void* w;
  void* y;
  long long rows, xs, ys;
  int D, wpr, grid;
  float eps;
  cudaStream_t stream;
};

template <typename T, typename W, int VEC, int NV>
cudaError_t launch(const Args& a) {
  rmsnorm_rows<T, W, VEC, NV><<<a.grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const W*>(a.w), static_cast<T*>(a.y), a.rows,
      a.D, a.xs, a.ys, a.eps, a.wpr);
  return cudaGetLastError();
}

template <typename T, typename W, int VEC>
cudaError_t dispatch_nv(const Args& a, int nv) {
  switch (nv) {
    case 0: return launch<T, W, VEC, 0>(a);
    case 1: return launch<T, W, VEC, 1>(a);
    case 2: return launch<T, W, VEC, 2>(a);
    case 3: return launch<T, W, VEC, 3>(a);
    case 4: return launch<T, W, VEC, 4>(a);
    case 5: return launch<T, W, VEC, 5>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename W>
cudaError_t dispatch_vec(const Args& a, int vec, int nv) {
  if (vec == 1) return dispatch_nv<T, W, 1>(a, nv);
  constexpr int kVec = 16 / (int)sizeof(T);  // a 16-byte load
  if (vec == kVec) return dispatch_nv<T, W, kVec>(a, nv);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

}  // namespace

extern "C" {

// x: rows of D elements, x_stride elements apart (the last dim contiguous);
// y: rows of D elements y_stride apart; w: D elements.  x_dtype, w_dtype:
// 0 = float32, 1 = bfloat16 (y has x's).  vec: elements a load, 1 or 16
// bytes' worth; nv: loads a thread holds per row (1-5; 0 loops over the
// row in chunks); warps_per_row: 1, 2, 4 or 8; grid: blocks of 256
// threads.  The plan comes from the wrapper (rmsnorm.py::_plan); inputs it
// does not cover are refused here.  Returns cudaGetLastError() after the
// launch.
int repro_rmsnorm_fwd(const void* x, const void* w, void* y, int x_dtype, int w_dtype,
                      long long rows, int D, long long x_stride, long long y_stride, float eps,
                      int vec, int nv, int warps_per_row, int grid, void* stream) {
  const int xsize = x_dtype == 0 ? 4 : 2, wsize = w_dtype == 0 ? 4 : 2;
  const int wpr = warps_per_row;
  if (rows <= 0 || D <= 0 || grid <= 0 || x_stride < 0 || y_stride < D ||
      (x_dtype != 0 && x_dtype != 1) || (w_dtype != 0 && w_dtype != 1) ||
      (wpr != 1 && wpr != 2 && wpr != 4 && wpr != 8) || (vec != 1 && vec != 16 / xsize) ||
      (nv > 0 && (long long)nv * 32 * wpr * vec < D))
    return (int)cudaErrorInvalidValue;
  if (vec > 1) {
    const int wbytes = vec * wsize < 16 ? vec * wsize : 16;
    if (D % vec || x_stride % vec || y_stride % vec || !aligned(x, 16) || !aligned(y, 16) ||
        !aligned(w, wbytes))
      return (int)cudaErrorInvalidValue;
  }
  const Args a{x, w, y, rows, x_stride, y_stride, D, wpr, grid, eps,
               static_cast<cudaStream_t>(stream)};
  if (x_dtype == 0)
    return (int)(w_dtype == 0 ? dispatch_vec<float, float>(a, vec, nv)
                              : dispatch_vec<float, __nv_bfloat16>(a, vec, nv));
  return (int)(w_dtype == 0 ? dispatch_vec<__nv_bfloat16, float>(a, vec, nv)
                            : dispatch_vec<__nv_bfloat16, __nv_bfloat16>(a, vec, nv));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
