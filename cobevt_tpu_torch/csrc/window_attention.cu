// K1: packed window attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel cobevt_tpu/ops/window_attention.py:
// fused_window_attention_packed (-> _packed_forward_core -> _packed_kernel /
// _packed_body).  Contract, as there:
//   q (G, Tq, H*D) pre-scaled, k/v (G, Tk, H*D), heads interleaved in the
//   channel axis; optional f32 bias (Tq, H*Tk) shared by all windows
//   (column block h holds head h); optional f32 key mask (G, Tk) added as
//   -1e9 where mask <= 0 (not -inf: a fully masked row stays finite and
//   comes out as uniform weights, as in JAX); optional post-softmax weight
//   (G, Tq, H*Tk) in q's dtype that scales the numerator only.  Output
//   (G, Tq, H*D) in q's dtype.  f32 or bf16, D in {16, 32}, Tq and Tk
//   multiples of 8.
//
// What bounds it on the H100: two (Tq x Tk x D) products per (window, head)
// against q/k/v in and the output out: Tq Tk / (Tq + Tk) operations per
// byte in bf16, 128 to 512 at the CorpBEVT shapes, around the card's ~295.
// So the bytes bind for the 256-key windows (0.063 ms at the largest shape,
// G 320, 1024 x 256, with the arithmetic at 0.043 ms) and the arithmetic for
// the 1024 x 1024 ones.
// Both kernels are flash style: one block per (window, head, query tile),
// key tiles streamed through shared memory, an online softmax with f32
// running max, sum and accumulator, so the similarity matrix never leaves
// registers.  The bias and weight are read tile by tile: the 16 MB
// self-attention bias is never resident.
//
//  * window_attention_tc_kernel (bf16): tensor cores through mma.sync
//    m16n8k16.  Four warps each own 16 query rows; S = q k^T and O += P v
//    run on the tensor cores with f32 accumulators, and the S accumulator
//    fragments are repacked in registers as the A operand of P v (no
//    shared-memory round trip).  v is staged transposed so both B
//    operands load as 32-bit words; rows are padded so the fragment loads
//    hit distinct banks.
//  * window_attention_kernel (f32): scalar f32 FMAs; one thread owns one
//    query row; k/v tiles are read from shared memory as warp-wide
//    broadcasts.
//
// K8, the head-major twin (cobevt_tpu/ops/window_attention.py:
// fused_window_attention -> _forward_core -> _attn_body), runs the same two
// kernels through another Layout: q (G, H, Tq, D), k/v (G, H, Tk, D), bias
// (H, Tq, Tk), no weight.  _attn_body sums the exp in f32 before it rounds
// it for the e v product, which is what these kernels do, so K8 needs no
// numeric switch: only the strides differ (entry point
// cobevt_window_attention_hm).  The same bound holds: arithmetic.
//
// Numerics differ from the TPU body of K1 in one documented place: there the
// exp is rounded to bf16 once and that value feeds both the sum and the AV
// product.  The bf16 kernel rounds the probabilities to bf16 for the P v
// product (as the TPU does) but sums them in f32; the f32 kernel keeps
// them f32 throughout.  The bf16 tolerance of the comparisons covers it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 32;  // keys per shared-memory tile
constexpr float kMaskAdd = -1e9f;

// Where element (window, head, row, d) of q/out and of k/v lives, and where
// bias (head, row, key) lives: packed (K1) or head-major (K8).
struct Layout {
  long long q_win, kv_win;    // elements between windows
  long long q_head, kv_head;  // elements between heads
  int ldq, ldkv;              // elements between rows
  long long b_head;           // bias: elements between heads
  long long ldb;              // bias: elements between query rows
};

inline Layout packed_layout(int Tq, int Tk, int H, int D) {
  const long long C = (long long)H * D;
  return {Tq * C, Tk * C, D, D, (int)C, (int)C, Tk, (long long)H * Tk};
}

inline Layout head_major_layout(int Tq, int Tk, int H, int D) {
  return {(long long)H * Tq * D, (long long)H * Tk * D, (long long)Tq * D,
          (long long)Tk * D, D, D, (long long)Tq * Tk, Tk};
}

// f32 path.  grid: (ceil(Tq / kBlockQ), H, G); block: kBlockQ threads.
template <int D>
__global__ void __launch_bounds__(kBlockQ)
    window_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const float* __restrict__ weight,
                            float* __restrict__ out, int Tq, int Tk, int H,
                            Layout L) {
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];
  __shared__ float bs[kBlockQ][kBlockK + 1];  // +1: conflict-free row reads
  __shared__ float ws[kBlockQ][kBlockK + 1];
  __shared__ float ms[kBlockK];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const size_t HTk = (size_t)H * Tk;
  const int row = q0 + tid;
  const bool live = row < Tq;

  float qr[D];
  float acc[D];
  {
    const float* qp = q + g * L.q_win + (size_t)(live ? row : 0) * L.ldq +
                      h * L.q_head;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = live ? qp[d] : 0.f;
      acc[d] = 0.f;
    }
  }
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    const int nk = min(kBlockK, Tk - k0);
    for (int i = tid; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D;
      const int d = i - j * D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off =
            g * L.kv_win + (size_t)(k0 + j) * L.ldkv + h * L.kv_head + d;
        kv = k[off];
        vv = v[off];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (bias != nullptr) {
      for (int i = tid; i < kBlockQ * kBlockK; i += kBlockQ) {
        const int r = i / kBlockK;
        const int c = i - r * kBlockK;
        float b = 0.f;
        if (q0 + r < Tq && c < nk)
          b = bias[h * L.b_head + (q0 + r) * L.ldb + k0 + c];
        bs[r][c] = b;
      }
    }
    if (weight != nullptr) {
      for (int i = tid; i < kBlockQ * kBlockK; i += kBlockQ) {
        const int r = i / kBlockK;
        const int c = i - r * kBlockK;
        float w = 0.f;
        if (q0 + r < Tq && c < nk)
          w = weight[((size_t)g * Tq + q0 + r) * HTk + (size_t)h * Tk + k0 +
                     c];
        ws[r][c] = w;
      }
    }
    if (mask != nullptr && tid < kBlockK) {
      float add = 0.f;
      if (tid < nk && !(mask[(size_t)g * Tk + k0 + tid] > 0.f)) add = kMaskAdd;
      ms[tid] = add;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      // same order as the reference: (q.k + bias) + mask
      if (bias != nullptr) dot += bs[tid][j];
      if (mask != nullptr) dot += ms[j];
      s[j] = (j < nk) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // every tile holds at least one key, so m_new is finite
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = __expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float p = __expf(s[j] - m_new);
      l_run += p;  // the denominator stays unweighted
      if (weight != nullptr) p *= ws[tid][j];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m_run = m_new;
    __syncthreads();
  }

  if (live) {
    const float inv = 1.f / l_run;
    float* op = out + g * L.q_win + (size_t)row * L.ldq + h * L.q_head;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* bias,
            const void* mask, const void* weight, void* out, int G, int Tq,
            int Tk, int H, const Layout& L, cudaStream_t stream) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, H, G);
  window_attention_kernel<D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(weight),
      static_cast<float*>(out), Tq, Tk, H, L);
}

// ---------------------------------------------------------------------------
// tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcQ = 16 * kTcWarps;  // query rows per block
constexpr int kTcK = 64;             // keys per shared-memory tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid: (ceil(Tq / kTcQ), H, G); block: 32 * kTcWarps threads.
template <int D>
__global__ void __launch_bounds__(32 * kTcWarps)
    window_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const float* __restrict__ bias,
                               const float* __restrict__ mask,
                               const __nv_bfloat16* __restrict__ weight,
                               __nv_bfloat16* __restrict__ out, int Tq,
                               int Tk, int H, Layout L) {
  constexpr int kPadK = D + 8;       // Ks row, halves
  constexpr int kPadV = kTcK + 8;    // Vt row, halves
  __shared__ __align__(16) __nv_bfloat16 Ks[kTcK][kPadK];
  __shared__ __align__(16) __nv_bfloat16 Vt[D][kPadV];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const size_t HTk = (size_t)H * Tk;

  // this thread's two query rows (fragment rows g and g + 8)
  const int r0 = blockIdx.x * kTcQ + warp * 16 + g;
  const int r1 = r0 + 8;
  const int rc0 = min(r0, Tq - 1);   // clamped for loads of dead rows
  const int rc1 = min(r1, Tq - 1);

  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qw = q + win * L.q_win + h * L.q_head;
    const __nv_bfloat16* q0p = qw + (size_t)rc0 * L.ldq;
    const __nv_bfloat16* q1p = qw + (size_t)rc1 * L.ldq;
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
        const size_t off = win * L.kv_win + (size_t)(k0 + j) * L.ldkv +
                           h * L.kv_head + d;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[j][d]) = kv;
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[d + i][j] = vh[i];
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
      const int key = k0 + j * 8 + 2 * t;   // columns key, key + 1
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = hr ? rc1 : rc0;
        float x0 = s[j][2 * hr], x1 = s[j][2 * hr + 1];
        if (key < Tk) {
          if (bias != nullptr) {
            const float2 b = *reinterpret_cast<const float2*>(
                bias + h * L.b_head + row * L.ldb + key);
            x0 += b.x;
            x1 += b.y;
          }
          if (mask != nullptr) {
            const float* mp = mask + (size_t)win * Tk + key;
            if (!(mp[0] > 0.f)) x0 += kMaskAdd;
            if (!(mp[1] > 0.f)) x1 += kMaskAdd;
          }
        } else {
          x0 = x1 = -INFINITY;   // Tk % 8 == 0: both columns are past Tk
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

    // P (numerator weights) in bf16 A fragments; the sum stays f32 and
    // unweighted
    uint32_t pa[kTcK / 16][4];
#pragma unroll
    for (int j = 0; j < kTcK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __expf(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += p[e];
      }
      if (weight != nullptr) {
        const int key = min(k0 + j * 8 + 2 * t, Tk - 2);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = hr ? rc1 : rc0;
          const float2 w = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  weight + ((size_t)win * Tq + row) * HTk + (size_t)h * Tk +
                  key));
          p[2 * hr] *= w.x;
          p[2 * hr + 1] *= w.y;
        }
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
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
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr ? r1 : r0;
    if (row >= Tq) continue;
    const float inv = 1.f / l_run[hr];
    __nv_bfloat16* op =
        out + win * L.q_win + (size_t)row * L.ldq + h * L.q_head;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(op + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(o[nd][2 * hr] * inv,
                                o[nd][2 * hr + 1] * inv);
  }
}

template <int D>
void launch_tc(const void* q, const void* k, const void* v, const void* bias,
               const void* mask, const void* weight, void* out, int G, int Tq,
               int Tk, int H, const Layout& L, cudaStream_t stream) {
  const dim3 grid((Tq + kTcQ - 1) / kTcQ, H, G);
  window_attention_tc_kernel<D><<<grid, 32 * kTcWarps, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask),
      static_cast<const __nv_bfloat16*>(weight),
      static_cast<__nv_bfloat16*>(out), Tq, Tk, H, L);
}

// Picks the kernel for (D, dtype).  Returns the launch's cudaError_t.
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, const void* mask, const void* weight,
                     void* out, int G, int Tq, int Tk, int H, int D,
                     int is_bf16, const Layout& L, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (G <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || G > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32 && is_bf16)
    launch_tc<32>(q, k, v, bias, mask, weight, out, G, Tq, Tk, H, L, s);
  else if (D == 32)
    launch<32>(q, k, v, bias, mask, weight, out, G, Tq, Tk, H, L, s);
  else if (D == 16 && is_bf16)
    launch_tc<16>(q, k, v, bias, mask, weight, out, G, Tq, Tk, H, L, s);
  else if (D == 16)
    launch<16>(q, k, v, bias, mask, weight, out, G, Tq, Tk, H, L, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  bias, mask and weight may be
// null.  Each returns the cudaError_t of the launch (0 on success).

// K1: packed layout, q (G, Tq, H*D), bias (Tq, H*Tk).
extern "C" int cobevt_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* mask, const void* weight,
                                       void* out, int G, int Tq, int Tk,
                                       int H, int D, int is_bf16, int device,
                                       void* stream) {
  return (int)dispatch(q, k, v, bias, mask, weight, out, G, Tq, Tk, H, D,
                       is_bf16, packed_layout(Tq, Tk, H, D), device, stream);
}

// K8: head-major layout, q (G, H, Tq, D), bias (H, Tq, Tk), no weight.
extern "C" int cobevt_window_attention_hm(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* mask, void* out, int G,
                                          int Tq, int Tk, int H, int D,
                                          int is_bf16, int device,
                                          void* stream) {
  return (int)dispatch(q, k, v, bias, mask, nullptr, out, G, Tq, Tk, H, D,
                       is_bf16, head_major_layout(Tq, Tk, H, D), device,
                       stream);
}
