// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_flash_kernel / flash_attention, wrapper repro/kernels/ops.py:flash_attention):
// blockwise causal or non-causal GQA attention with an online softmax, f32
// running max / denominator / accumulator, scores never written to device
// memory, q head h reading kv head h / (H / KH).
//
// What bounds it on the H100: at the tinyllama prefill shape (B=4, S=512,
// H=32, KH=4, D=64, causal, bf16) the work is ~4.3e9 FLOPs against ~19 MB of
// q/k/v/o traffic, ~230 FLOPs per byte: below the card's ~295 FLOP/byte
// ridge for bf16 tensor cores, so the floor is the memory (~6 us), but this
// kernel does its products on the f32 CUDA cores (67 TFLOP/s), where the
// FLOPs bound it (~64 us at full rate).  The design keeps that work fed
// rather than reaching for the tensor cores:
//   * one block of 4 warps per (q tile of 32 rows, head, batch); each warp
//     owns 8 query rows, so every K/V element staged in shared memory is used
//     by 8 rows before the next load, and q rows are read as float4
//     broadcasts;
//   * K/V tiles of 32 keys are staged in shared memory as f32 (one key per
//     lane for the scores, 16-byte row padding on K so the lanes' float4 reads
//     are free of bank conflicts); P goes through shared memory so the P.V
//     product reads it as float4 broadcasts too;
//   * under `causal` the k-tile loop stops at the block's diagonal (a loop
//     bound, not skipped grid steps), which halves the work;
//   * a local `window` (RecurrentGemma's 2048; 0 = none) keeps key k for
//     query q only where q - k < window, as the reference's
//     chunked_attention(window=) masks it, with or without `causal`; the
//     k-tile loop starts at the tile of the block's first row's first key,
//     q0 - window + 1, so under `causal` a block visits at most
//     window / 32 + 2 tiles of keys and the work grows as S x window, not
//     S^2.  A row always keeps its own key, so none is wholly masked;
//   * scores are kept in the log2 domain (q pre-scaled by log2(e)/sqrt(D))
//     so the softmax uses exp2f.
// The ragged S edge and the columns past D are zero-filled in shared memory
// and masked; f32 and bf16 inputs share the code, the output is written in
// the input type.  Inputs are addressed through strides, so (B, S, H, D)
// tensors can be passed as (B, H, S, D) views without a copy; the last
// dimension must be contiguous.
//
// q and k have one head dim (Dqk) and v and the output another (Dv), as
// DeepSeek-V2's multi-head latent attention needs (Dqk 192 = 128 + 64 rope
// columns, Dv 128).  The kernel is instantiated for Dqk buckets of 64, 128,
// 192 and 256 columns and Dv buckets of 64, 128 and 256; Dqk = Dv takes the
// bucket pairs (64, 64), (128, 128) and (256, 256).  Head dim 256 is
// RecurrentGemma's (16 query heads, one KV head).  At (192, 128) the shared
// memory is 32 x 192 (Q) + 32 x 196 (K) + 32 x 128 (V) + 32 x 32 (P) floats,
// 70.1 KB; at (256, 256) 32 x 256 + 32 x 260 + 32 x 256 + 32 x 32 floats,
// 102,912 B, within the 227 KB a block may opt into.  At Dv 256 a lane
// accumulates 8 output columns for each of its 8 rows (64 floats), read from
// V as two float4s 128 columns apart, so the lanes' reads stay free of bank
// conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 32 query rows per block
constexpr int kBlockK = 32;                     // one key per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The output column of a lane's i-th accumulator: DPL adjacent columns for
// DPL <= 4; for DPL 8, four adjacent columns in each half of the 256, so a
// warp's float4 reads of a V row cover 512 contiguous bytes twice.
template <int DPL>
__device__ __forceinline__ int out_col(int lane, int i) {
  if constexpr (DPL == 8) return (i >> 2) * 128 + lane * 4 + (i & 3);
  return lane * DPL + i;
}

struct Strides {  // in elements; the last (D) stride is 1
  long long b, h, s;
};

template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * DQK             // Qs
                          + kBlockK * (DQK + 4)     // Ks, padded rows
                          + kBlockK * DV            // Vs
                          + kBlockQ * kBlockK);     // Ps
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int group, int S, int D, int Dv, int causal, int window,
          float scale_log2, Strides sq, Strides sk, Strides sv, Strides so) {
  constexpr int KPAD = DQK + 4;
  constexpr int DPL = DV / 32;  // output columns per lane
  static_assert(DPL == 2 || DPL == 4 || DPL == 8, "DV must be 64, 128 or 256");
  static_assert(DQK % 4 == 0, "DQK must be a multiple of 4");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [kBlockQ][DQK], pre-scaled
  float* Ks = Qs + kBlockQ * DQK;      // [kBlockK][KPAD]
  float* Vs = Ks + kBlockK * KPAD;     // [kBlockK][DV]
  float* Ps = Vs + kBlockK * DV;       // [kBlockQ][kBlockK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBlockQ * DQK; i += kThreads) {
    const int r = i / DQK, d = i % DQK;
    Qs[i] = (q0 + r < S && d < D) ? to_float(qb[(q0 + r) * sq.s + d]) * scale_log2 : 0.f;
  }

  const int q_end = min(q0 + kBlockQ, S);
  const int n_tiles = causal ? (q_end - 1) / kBlockK + 1 : (S + kBlockK - 1) / kBlockK;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / kBlockK : 0;
  const int row0 = warp * kRowsPerWarp;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int t = t_first; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < kBlockK * DQK; i += kThreads) {
      const int j = i / DQK, d = i % DQK;
      Ks[j * KPAD + d] = k0 + j < S && d < D ? to_float(kb[(k0 + j) * sk.s + d]) : 0.f;
    }
    for (int i = tid; i < kBlockK * DV; i += kThreads) {
      const int j = i / DV, d = i % DV;
      Vs[j * DV + d] = k0 + j < S && d < Dv ? to_float(vb[(k0 + j) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KPAD;
#pragma unroll 4
    for (int d = 0; d < DQK; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row0 + r) * DQK + d);
        s[r] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[r]))));
      }
    }

    // online softmax, one row at a time across the warp
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + row0 + r;
      const bool valid = kpos < S && (!causal || kpos <= qpos) &&
                         (window <= 0 || qpos - kpos < window);
      const float sc = valid ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      float corr = 1.f, p = 0.f;
      if (m_new != -INFINITY) {  // else: no valid key for this row yet
        corr = exp2f(m[r] - m_new);
        p = valid ? exp2f(sc - m_new) : 0.f;
      }
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
      Ps[(row0 + r) * kBlockK + lane] = p;
    }
    __syncwarp();

    // acc += P . V; lane owns the columns out_col<DPL>(lane, 0 .. DPL - 1)
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * DV + out_col<DPL>(lane, 0);
        if constexpr (DPL == 8) {
          const float4 x = *reinterpret_cast<const float4*>(vrow);
          const float4 y = *reinterpret_cast<const float4*>(vrow + 128);
          vv[jj][0] = x.x; vv[jj][1] = x.y; vv[jj][2] = x.z; vv[jj][3] = x.w;
          vv[jj][4] = y.x; vv[jj][5] = y.y; vv[jj][6] = y.z; vv[jj][7] = y.w;
        } else if constexpr (DPL == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow);
          vv[jj][0] = x.x; vv[jj][1] = x.y; vv[jj][2] = x.z; vv[jj][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow);
          vv[jj][0] = x.x; vv[jj][1] = x.y;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + (row0 + r) * kBlockK + j);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[r][i] = fmaf(pv.x, vv[0][i], fmaf(pv.y, vv[1][i],
                      fmaf(pv.z, vv[2][i], fmaf(pv.w, vv[3][i], acc[r][i]))));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = out_col<DPL>(lane, i);
      if (d < Dv) ob[qpos * so.s + d] = from_float<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KH, int S, int D, int Dv, int causal, int window, float scale_log2,
                   Strides sq, Strides sk, Strides sv, Strides so, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H / KH, S, D, Dv, causal, window, scale_log2, sq, sk, sv, so);
  return cudaGetLastError();
}

// The instantiation for a head-dim pair: Dqk in buckets of 64, 128, 192, 256
// and Dv in buckets of 64, 128, 256.
template <typename T, int DQK>
cudaError_t dispatch_dv(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int KH, int S, int D, int Dv, int causal, int window,
                        float scale_log2, Strides sq, Strides sk, Strides sv, Strides so,
                        cudaStream_t st) {
#define REPRO_FLASH_LAUNCH(DV)                                                              \
  launch<T, DQK, DV>(q, k, v, o, B, H, KH, S, D, Dv, causal, window, scale_log2, sq, sk, sv, \
                     so, st)
  if (Dv <= 64) return REPRO_FLASH_LAUNCH(64);
  if (Dv <= 128) return REPRO_FLASH_LAUNCH(128);
  return REPRO_FLASH_LAUNCH(256);
#undef REPRO_FLASH_LAUNCH
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int KH, int S, int D, int Dv, int causal, int window, float scale_log2,
                     Strides sq, Strides sk, Strides sv, Strides so, cudaStream_t st) {
#define REPRO_FLASH_DISPATCH(DQK)                                                          \
  dispatch_dv<T, DQK>(q, k, v, o, B, H, KH, S, D, Dv, causal, window, scale_log2, sq, sk, sv, \
                      so, st)
  if (D <= 64) return REPRO_FLASH_DISPATCH(64);
  if (D <= 128) return REPRO_FLASH_DISPATCH(128);
  if (D <= 192) return REPRO_FLASH_DISPATCH(192);
  return REPRO_FLASH_DISPATCH(256);
#undef REPRO_FLASH_DISPATCH
}

}  // namespace

extern "C" {

// q: (B, H, S, D); k: (B, KH, S, D); v: (B, KH, S, Dv); o: (B, H, S, Dv),
// addressed through the given strides (elements; the last dim contiguous).
// D <= 256, Dv <= 256.  dtype: 0 = float32, 1 = bfloat16.  window > 0 keeps
// key k for query q only where q - k < window (0 = every key).  scale_log2 is
// log2(e) / sqrt(D).  Returns cudaGetLastError() after the launch.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                              int dtype, int B, int H, int KH, int S, int D, int Dv,
                              int causal, int window, float scale_log2, long long sqb,
                              long long sqh, long long sqs, long long skb, long long skh,
                              long long sks,
                              long long svb, long long svh, long long svs, long long sob,
                              long long soh, long long sos, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || S <= 0 || D <= 0 || D > 256 ||
      Dv <= 0 || Dv > 256 || H > 65535 || B > 65535 || window < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, H, KH, S, D, Dv, causal, window, scale_log2,
                                sq, sk, sv, so, st);
  return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, H, KH, S, D, Dv, causal, window,
                                      scale_log2, sq, sk, sv, so, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
