// Token-row building blocks shared by K2 (fused_cross_attention.cu), K4
// (fused_swap_fusion.cu) and K6 (fused_swap_fusion_streaming.cu): a block
// owns kRows token rows (K6: 16, its tiles are twice as wide) held as
// f32 tiles in shared memory, and runs LayerNorms and products with weights
// over them.
//
// Numerics follow the TPU bodies: a tile holds f32 values, and wherever the
// TPU body casts to the compute dtype T the kernel rounds with rnd<T>, so a
// tile that feeds a product holds values exact in T.  Products accumulate in
// f32.  With T = bf16 the product runs on the tensor cores (mma.sync
// m16n8k16, the A fragments packed from the f32 tile, which is exact);
// with T = f32 it runs scalar FMAs, the sharp check against the plain
// version.  Weights are read from device memory (they are small and stay in
// L2), transposed as (N, K), which is nn.Linear's own layout.  Rows move
// between device memory and the tiles in 8-value (16-byte in bf16)
// vectors, so every width is a multiple of 8 and every row 16-byte
// aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

#include <math.h>
#include <stdint.h>

namespace rowops {

constexpr int kRows = 64;       // token rows per block
constexpr int kThreads = 256;   // 8 warps; in the tensor-core product warp
                                // w owns rows 16(w%4).. and column half w/4
constexpr int kSmemLimit = 232448;  // an H100 block's shared-memory maximum

// row stride (floats) of a tile of width n: the float2 fragment loads of
// the tensor-core product hit distinct banks
__host__ __device__ constexpr int pad(int n) { return n + 8; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round to T and back: the TPU body's astype(compute_dtype)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// 8 consecutive values at p (16-byte aligned) as f32, and back
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void zero8(float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// LayerNorm in f32 (eps 1e-5) of the Rows rows of tile s (row stride ld,
// width n), in place: (t - mu) * rsqrt(var + eps) * gamma + beta, as
// cobevt_tpu/ops/fused_cross_attention.py:_ln_f32.  The result is rounded
// to T when round_out.  One warp per row; callers sync before and after.
template <typename T, int Rows = kRows>
__device__ void layer_norm_rows(float* s, int ld, int n, const T* gamma,
                                const T* beta, bool round_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < Rows; r += kThreads / 32) {
    float* row = s + r * ld;
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) sum += row[c];
    const float mu = warp_sum(sum) / n;
    float sq = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float d = row[c] - mu;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / n + 1e-5f);
    for (int c = lane; c < n; c += 32) {
      const float y = (row[c] - mu) * inv * to_f(gamma[c]) + to_f(beta[c]);
      row[c] = round_out ? rnd<T>(y) : y;
    }
  }
}

// out[r][c] = sum_k A[r][k] * Wt[c][k] for the Rows rows and c < N.
// A: f32 tile (row stride lda) whose values are exact in T; Wt: (N, K)
// row-major in T.  f32 accumulation.  Rows is 16, 32 or 64: the 8 warps of
// the tensor-core product form Rows / 16 row groups of 16 rows, and the
// warps of a row group split the N columns evenly in 8-column tiles, so it
// needs K % 16 == 0 and N % (8 * 8 / (Rows / 16)) == 0 (N % 16 at the
// default 64 rows, N % 32 at 32 rows).  Callers sync before (A complete)
// and after (out complete).
template <typename T, int Rows = kRows>
struct Gemm;

template <int Rows>
struct Gemm<float, Rows> {
  static __device__ void run(const float* A, int lda, const float* Wt, int K,
                             int N, float* out, int ldo) {
    for (int c = threadIdx.x; c < N; c += kThreads) {
      const float* w = Wt + (size_t)c * K;
      for (int r0 = 0; r0 < Rows; r0 += 16) {
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.f;
        for (int k = 0; k < K; k += 4) {
          const float4 wk = *reinterpret_cast<const float4*>(w + k);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            // every thread of the warp reads the same A word: a broadcast
            const float4 a =
                *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
            acc[i] = fmaf(a.x, wk.x, acc[i]);
            acc[i] = fmaf(a.y, wk.y, acc[i]);
            acc[i] = fmaf(a.z, wk.z, acc[i]);
            acc[i] = fmaf(a.w, wk.w, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) out[(r0 + i) * ldo + c] = acc[i];
      }
    }
  }
};

template <int Rows>
struct Gemm<__nv_bfloat16, Rows> {
  static_assert(Rows == 16 || Rows == 32 || Rows == 64,
                "8 warps in row groups of 16 rows");
  static __device__ void run(const float* A, int lda,
                             const __nv_bfloat16* Wt, int K, int N,
                             float* out, int ldo) {
    constexpr int kRowGroups = Rows / 16;
    constexpr int kColGroups = (kThreads / 32) / kRowGroups;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = (warp % kRowGroups) * 16;
    const int n_lo = (warp / kRowGroups) * (N / kColGroups);
    const int n_hi = n_lo + N / kColGroups;
    const float* a0p = A + (r0 + g) * lda + 2 * t;
    const float* a1p = a0p + 8 * lda;
    for (int n0 = n_lo; n0 < n_hi; n0 += 64) {
      const int nt = min(8, (n_hi - n0) / 8);
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int k0 = 0; k0 < K; k0 += 16) {
        const float2 x0 = *reinterpret_cast<const float2*>(a0p + k0);
        const float2 x1 = *reinterpret_cast<const float2*>(a1p + k0);
        const float2 x2 = *reinterpret_cast<const float2*>(a0p + k0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(a1p + k0 + 8);
        const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                               pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            const __nv_bfloat16* w =
                Wt + (size_t)(n0 + j * 8 + g) * K + k0 + 2 * t;
            const uint32_t b[2] = {ld32(w), ld32(w + 8)};
            mma_bf16_16816(acc[j], a, b);
          }
        }
      }
      float* o0 = out + (r0 + g) * ldo + n0 + 2 * t;
      float* o1 = o0 + 8 * ldo;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          o0[j * 8] = acc[j][0];
          o0[j * 8 + 1] = acc[j][1];
          o1[j * 8] = acc[j][2];
          o1[j * 8 + 1] = acc[j][3];
        }
      }
    }
  }
};

// Raise a kernel's dynamic shared-memory ceiling, then check the launch.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace rowops
