// Flash-style window attention shared by K2, K4 and K6.
//
// The design of K1 (window_attention.cu): one block per (query tile, head,
// window), key tiles streamed through shared memory, an online softmax with
// an f32 running max, sum and accumulator, so no Tq x Tk tile exists
// anywhere.  What K2 and K4 add to K1's contract:
//
//  * operands at any row stride, so q/k/v are read straight from a packed
//    (rows, 3D) QKV scratch (K4) or separate (rows, C) scratches (K2);
//  * segments (K2's cameras): query rows s*Tq + r for s < nseg attend over
//    the same keys and the block returns the mean over s of the normalised
//    outputs, the camera mean taken in f32 before the output projection;
//  * an additive bias in the compute dtype T (K4 keeps its 3-D rel-pos bias
//    in T, cobevt_tpu/ops/fused_swap_fusion.py:254-257) and K4's key mask
//    read from the (B, L, H, W) mask through the window map (window or grid
//    cells), added as mask_add (-1e9 rounded to T) after the bias;
//  * the probabilities rounded to T before both the numerator and the sum,
//    as the TPU bodies round their exp (fused_cross_attention.py:78-89);
//  * for K6 the bias in f32 whatever T is (template parameter TB), as the
//    streaming TPU body keeps it (fused_swap_fusion.py:400-401); its
//    mask_add is then -1e9 itself, which is exact in f32.
//
// The bf16 kernel runs both products on the tensor cores (mma.sync
// m16n8k16) for head dims 16 and 32; the scalar kernel (f32, and bf16 at
// head dim 8) runs f32 FMAs.
#pragma once

#include "rowops.cuh"

#include <type_traits>

namespace flash {

using rowops::from_f;
using rowops::ld32;
using rowops::pack_bf16;
using rowops::rnd;
using rowops::to_f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  long long q_win;   // elements between windows of q
  long long kv_win;  // elements between windows of k and v
  int ldq, ldkv;     // row strides in elements
  void* out;
  long long o_win;
  int ldo;
  int Tq;    // query rows per segment (output rows per window)
  int nseg;  // segments averaged; segment s holds query rows s*Tq + r
  int Tk;
  int heads;
  const void* bias;   // (Tq, heads*Tk) in TB (T, or f32 for K6), shared by
                      // every window; or null
  const float* mask;  // (B, L, Hs, Ws) key mask (keys with mask <= 0 get
                      // mask_add); or null
  int L, wsz, X, Y, Hs, Ws, grid;  // window map of the mask
  float mask_add;
};

// offset in the (B, L, Hs, Ws) mask of key j of window g: key j is token
// (l, p, s) of window (wx, wy); a grid window takes every X-th row and
// every Y-th column
__device__ __forceinline__ long long mask_offset(const Args& a, int g, int j) {
  const int nwin = a.X * a.Y;
  const int b = g / nwin;
  const int wi = g - b * nwin;
  const int wx = wi / a.Y;
  const int wy = wi - wx * a.Y;
  const int w2 = a.wsz * a.wsz;
  const int l = j / w2;
  const int rem = j - l * w2;
  const int p = rem / a.wsz;
  const int s = rem - p * a.wsz;
  const int y = a.grid ? p * a.X + wx : wx * a.wsz + p;
  const int x = a.grid ? s * a.Y + wy : wy * a.wsz + s;
  return ((long long)(b * a.L + l) * a.Hs + y) * a.Ws + x;
}

// two consecutive bias values as f32
__device__ __forceinline__ float2 bias2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 bias2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

constexpr int kScalarQ = 64;  // query rows per block, one per thread
constexpr int kScalarK = 32;  // keys per shared-memory tile

// grid: (ceil(Tq / kScalarQ), heads, G); block: kScalarQ threads.
template <typename T, int D, typename TB = T>
__global__ void __launch_bounds__(kScalarQ) scalar_kernel(Args a) {
  __shared__ __align__(16) float ks[kScalarK][D];
  __shared__ __align__(16) float vs[kScalarK][D];
  __shared__ float bs[kScalarQ][kScalarK + 1];
  __shared__ float ms[kScalarK];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int q0 = blockIdx.x * kScalarQ;
  const int row = q0 + tid;
  const bool live = row < a.Tq;
  const T* q = static_cast<const T*>(a.q) + g * a.q_win;
  const T* k = static_cast<const T*>(a.k) + g * a.kv_win;
  const T* v = static_cast<const T*>(a.v) + g * a.kv_win;
  const TB* bias = static_cast<const TB*>(a.bias);
  const size_t HTk = (size_t)a.heads * a.Tk;

  float mean[D];
#pragma unroll
  for (int d = 0; d < D; ++d) mean[d] = 0.f;

  for (int seg = 0; seg < a.nseg; ++seg) {
    float qr[D], acc[D];
    {
      const T* qp =
          q + (size_t)(seg * a.Tq + (live ? row : 0)) * a.ldq + h * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[d] = to_f(qp[d]);
        acc[d] = 0.f;
      }
    }
    float m_run = -INFINITY;
    float l_run = 0.f;
    for (int k0 = 0; k0 < a.Tk; k0 += kScalarK) {
      const int nk = min(kScalarK, a.Tk - k0);
      for (int i = tid; i < kScalarK * D; i += kScalarQ) {
        const int j = i / D;
        const int d = i - j * D;
        float kv = 0.f, vv = 0.f;
        if (j < nk) {
          const size_t off = (size_t)(k0 + j) * a.ldkv + h * D + d;
          kv = to_f(k[off]);
          vv = to_f(v[off]);
        }
        ks[j][d] = kv;
        vs[j][d] = vv;
      }
      if (bias != nullptr) {
        for (int i = tid; i < kScalarQ * kScalarK; i += kScalarQ) {
          const int r = i / kScalarK;
          const int c = i - r * kScalarK;
          float b = 0.f;
          if (q0 + r < a.Tq && c < nk)
            b = to_f(bias[(size_t)(q0 + r) * HTk + (size_t)h * a.Tk + k0 + c]);
          bs[r][c] = b;
        }
      }
      if (a.mask != nullptr && tid < kScalarK) {
        float add = 0.f;
        if (tid < nk && !(a.mask[mask_offset(a, g, k0 + tid)] > 0.f))
          add = a.mask_add;
        ms[tid] = add;
      }
      __syncthreads();

      float s[kScalarK];
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kScalarK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        // the TPU order: (q.k + bias) + mask
        if (bias != nullptr) dot += bs[tid][j];
        if (a.mask != nullptr) dot += ms[j];
        s[j] = (j < nk) ? dot : -INFINITY;
        tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m_run, tile_max);  // every tile holds a key
      const float alpha = expf(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kScalarK; ++j) {
        const float p = rnd<T>(expf(s[j] - m_new));
        l_run += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
      }
      m_run = m_new;
      __syncthreads();
    }
    const float inv = 1.f / l_run;
#pragma unroll
    for (int d = 0; d < D; ++d) mean[d] += acc[d] * inv;
  }
  if (live) {
    T* op = static_cast<T*>(a.out) + g * a.o_win + (size_t)row * a.ldo +
            h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f<T>(mean[d] / a.nseg);
  }
}

constexpr int kTcWarps = 4;
constexpr int kTcQ = 16 * kTcWarps;  // query rows per block
constexpr int kTcK = 64;             // keys per shared-memory tile

// bf16 on the tensor cores.  grid: (ceil(Tq / kTcQ), heads, G); block:
// 32 * kTcWarps threads.  Four warps each own 16 query rows; the S
// accumulator fragments are repacked in registers as the A operand of P v.
// Needs Tk % 8 == 0 and 16-byte aligned k/v rows.
template <int D, typename TB = __nv_bfloat16>
__global__ void __launch_bounds__(32 * kTcWarps) tc_kernel(Args a) {
  constexpr int kPadK = D + 8;     // Ks row, halves
  constexpr int kPadV = kTcK + 8;  // Vt row, halves
  __shared__ __align__(16) __nv_bfloat16 Ks[kTcK][kPadK];
  __shared__ __align__(16) __nv_bfloat16 Vt[D][kPadV];
  __shared__ float ms[kTcK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const int Tq = a.Tq;
  const int Tk = a.Tk;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) +
                           win * a.q_win;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) +
                           win * a.kv_win;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) +
                           win * a.kv_win;
  const TB* bias = static_cast<const TB*>(a.bias);
  const size_t HTk = (size_t)a.heads * Tk;

  const int r0 = blockIdx.x * kTcQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const int rc0 = min(r0, Tq - 1);  // clamped for loads of dead rows
  const int rc1 = min(r1, Tq - 1);

  float mean[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) mean[nd][e] = 0.f;

  for (int seg = 0; seg < a.nseg; ++seg) {
    uint32_t qa[D / 16][4];
    {
      const __nv_bfloat16* q0p =
          q + (size_t)(seg * Tq + rc0) * a.ldq + h * D;
      const __nv_bfloat16* q1p =
          q + (size_t)(seg * Tq + rc1) * a.ldq + h * D;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        qa[kd][0] = ld32(q0p + kd * 16 + 2 * t);
        qa[kd][1] = ld32(q1p + kd * 16 + 2 * t);
        qa[kd][2] = ld32(q0p + kd * 16 + 2 * t + 8);
        qa[kd][3] = ld32(q1p + kd * 16 + 2 * t + 8);
      }
    }
    float o[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    for (int k0 = 0; k0 < Tk; k0 += kTcK) {
      // stage K (key-major) and V (transposed, d-major), 8 halves a chunk
      for (int c = tid; c < kTcK * D / 8; c += 32 * kTcWarps) {
        const int j = c / (D / 8);
        const int d = (c - j * (D / 8)) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (k0 + j < Tk) {
          const size_t off = (size_t)(k0 + j) * a.ldkv + h * D + d;
          kv = *reinterpret_cast<const uint4*>(k + off);
          vv = *reinterpret_cast<const uint4*>(v + off);
        }
        *reinterpret_cast<uint4*>(&Ks[j][d]) = kv;
        const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) Vt[d + i][j] = vh[i];
      }
      if (a.mask != nullptr && tid < kTcK) {
        float add = 0.f;
        if (k0 + tid < Tk && !(a.mask[mask_offset(a, win, k0 + tid)] > 0.f))
          add = a.mask_add;
        ms[tid] = add;
      }
      __syncthreads();

      // S = q k^T: 8 n-tiles of 8 keys, f32 accumulators
      float s[kTcK / 8][4];
#pragma unroll
      for (int j = 0; j < kTcK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const uint32_t b[2] = {ld32(&Ks[j * 8 + g][kd * 16 + 2 * t]),
                                 ld32(&Ks[j * 8 + g][kd * 16 + 2 * t + 8])};
          mma_bf16_16816(s[j], qa[kd], b);
        }
      }

      // (q.k + bias) + mask, then the online softmax over this tile
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kTcK / 8; ++j) {
        const int key = k0 + j * 8 + 2 * t;  // columns key, key + 1
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = hr ? rc1 : rc0;
          float x0 = s[j][2 * hr], x1 = s[j][2 * hr + 1];
          if (key < Tk) {
            if (bias != nullptr) {
              const float2 b =
                  bias2(bias + (size_t)row * HTk + (size_t)h * Tk + key);
              x0 += b.x;
              x1 += b.y;
            }
            if (a.mask != nullptr) {
              x0 += ms[key - k0];
              x1 += ms[key - k0 + 1];
            }
          } else {
            x0 = x1 = -INFINITY;  // Tk % 8 == 0: both columns are past Tk
          }
          s[j][2 * hr] = x0;
          s[j][2 * hr + 1] = x1;
          tile_max[hr] = fmaxf(tile_max[hr], fmaxf(x0, x1));
        }
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // the four threads of a group share the row
        tile_max[hr] = fmaxf(tile_max[hr],
                             __shfl_xor_sync(0xffffffffu, tile_max[hr], 1));
        tile_max[hr] = fmaxf(tile_max[hr],
                             __shfl_xor_sync(0xffffffffu, tile_max[hr], 2));
        const float m_new = fmaxf(m_run[hr], tile_max[hr]);  // finite
        alpha[hr] = __expf(m_run[hr] - m_new);
        m_run[hr] = m_new;
        l_run[hr] *= alpha[hr];
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][0] *= alpha[0];
        o[nd][1] *= alpha[0];
        o[nd][2] *= alpha[1];
        o[nd][3] *= alpha[1];
      }

      // P rounded to bf16: the same values feed the numerator and the sum
      uint32_t pa[kTcK / 16][4];
#pragma unroll
      for (int j = 0; j < kTcK / 8; ++j) {
        const uint32_t lo = pack_bf16(__expf(s[j][0] - m_run[0]),
                                      __expf(s[j][1] - m_run[0]));
        const uint32_t hi = pack_bf16(__expf(s[j][2] - m_run[1]),
                                      __expf(s[j][3] - m_run[1]));
        const float2 plo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&lo));
        const float2 phi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&hi));
        l_run[0] += plo.x + plo.y;
        l_run[1] += phi.x + phi.y;
        pa[j >> 1][(j & 1) * 2] = lo;
        pa[j >> 1][(j & 1) * 2 + 1] = hi;
      }

      // O += P v
#pragma unroll
      for (int kk = 0; kk < kTcK / 16; ++kk) {
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const uint32_t b[2] = {ld32(&Vt[nd * 8 + g][kk * 16 + 2 * t]),
                                 ld32(&Vt[nd * 8 + g][kk * 16 + 2 * t + 8])};
          mma_bf16_16816(o[nd], pa[kk], b);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
      l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
    }
    const float inv0 = 1.f / l_run[0];
    const float inv1 = 1.f / l_run[1];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      mean[nd][0] += o[nd][0] * inv0;
      mean[nd][1] += o[nd][1] * inv0;
      mean[nd][2] += o[nd][2] * inv1;
      mean[nd][3] += o[nd][3] * inv1;
    }
  }

  const float inv_seg = 1.f / a.nseg;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr ? r1 : r0;
    if (row >= Tq) continue;
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.out) + win * a.o_win +
                        (size_t)row * a.ldo + h * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(op + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(mean[nd][2 * hr] * inv_seg,
                                mean[nd][2 * hr + 1] * inv_seg);
  }
}

template <typename T, int D, typename TB>
inline void launch_scalar(const Args& a, int G, cudaStream_t s) {
  const dim3 grid((a.Tq + kScalarQ - 1) / kScalarQ, a.heads, G);
  scalar_kernel<T, D, TB><<<grid, kScalarQ, 0, s>>>(a);
}

template <int D, typename TB>
inline void launch_tc(const Args& a, int G, cudaStream_t s) {
  const dim3 grid((a.Tq + kTcQ - 1) / kTcQ, a.heads, G);
  tc_kernel<D, TB><<<grid, 32 * kTcWarps, 0, s>>>(a);
}

// Head dim D in {8, 16, 32}: bf16 at 16 and 32 on the tensor cores,
// everything else scalar.  BiasF32: the bias is f32 whatever the compute
// dtype (K6); otherwise it is in the compute dtype.  Returns the launch's
// cudaError_t.
template <bool BiasF32 = false>
inline cudaError_t launch(const Args& a, int G, int D, bool is_bf16,
                          cudaStream_t s) {
  using TBh = typename std::conditional<BiasF32, float, __nv_bfloat16>::type;
  if (G <= 0 || G > 65535 || a.heads <= 0 || a.heads > 65535 || a.Tq <= 0 ||
      a.Tk <= 0 || a.nseg <= 0 || a.Tk % 8)
    return cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 32)
      launch_tc<32, TBh>(a, G, s);
    else if (D == 16)
      launch_tc<16, TBh>(a, G, s);
    else if (D == 8)
      launch_scalar<__nv_bfloat16, 8, TBh>(a, G, s);
    else
      return cudaErrorInvalidValue;
  } else {
    if (D == 32)
      launch_scalar<float, 32, float>(a, G, s);
    else if (D == 16)
      launch_scalar<float, 16, float>(a, G, s);
    else if (D == 8)
      launch_scalar<float, 8, float>(a, G, s);
    else
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace flash
