// K11 and K12: the fused PreNorm feed-forward sublayer and its recompute
// backward, for Hopper (sm_90a).
//
// Replace the Pallas pair of cobevt_tpu/tools/micro_ffd_fused.py: _pallas_fwd
// (-> pallas_call :117, body _fwd_kernel :54) and _pallas_bwd (-> pallas_call
// :138, body _bwd_kernel :69), which jax.custom_vjp binds together (fused_ffd
// :161).  Over an (N, D) token matrix x with weights w1 (D, M), w2 (M, D):
//
//   forward   xhat = LN(x) in f32 (eps 1e-5, biased variance)
//             t = cast(xhat * gamma + beta)       h = t @ w1 + b1   (f32 acc)
//             a = cast(gelu(h))                   y = a @ w2 + b2   (f32 acc)
//             out = cast(x + y)
//   backward  recomputes xhat, r, t, h, a from x; with g = dy:
//             da = g @ w2^T      dh = cast(da * gelu'(h))      dt = dh @ w1^T
//             dx = cast(g + r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))),
//             dxhat = dt * gamma;   dgamma = sum dt * xhat,  dbeta = sum dt,
//             dw1 = t^T dh,  db1 = sum dh,  dw2 = a^T g,  db2 = sum g   (f32)
//
// cast() rounds to the compute dtype T (x's); gelu is the TPU body's own
// 5-term erf polynomial (_erf_f32 :28), not erff.  The casts of t, a and dh
// are the TPU body's own roundings (it casts them before the weight
// gradients' products), so a kernel may keep them in T.
//
// What the TPU kernels are shaped by, and what is done here instead.  The TPU
// grid walks 960-row blocks in order with both weights resident in VMEM, and
// the backward adds its parameter gradients into output blocks that every
// grid step revisits.  Blocks of a GPU grid run together, and dw1 / dw2 (512
// KB of f32 each at D 256, M 512) pass one SM's shared memory and registers.
// No kernel here uses atomics: every sum across blocks goes through per-block
// partials added in a fixed order (partials.cuh), so two runs give the same
// bits.  Two routes, chosen by shape before the launch
// (ops/ffd_fused.py:kernel_path):
//
//   * "wgmma" (bf16, D 128 or 256, M a multiple of 128; the LiDAR shape),
//     namespace wg: persistent blocks of two warpgroups, each on a 64-row
//     tile, weights streamed by TMA through a ring of 16 KB boxes that both
//     warpgroups read, every product a wgmma from 128B-swizzled shared
//     memory.  K11 is one launch: LN in registers, t as the A tile, per 64
//     hidden columns h = t w1, a = bf16(gelu(h + b1)) into a 64 x 64 atom and
//     y += a w2 in f32 registers (64 x D), so the hidden activation never
//     leaves the SM.  K12 is four launches behind one C entry: (1) the rows
//     launch recomputes t and, per 64 hidden columns, h and da = g w2^T,
//     forms a and dh, stores t, a and dh in bf16 (N (D + 2M) x 2 bytes, 216
//     MB at the LiDAR shape) for launch 2, and keeps dt = dh w1^T in
//     registers for the LN backward and dx; (2) the weights launch computes
//     dW1 = t^T dh and dW2 = a^T g as split-K products over the token rows,
//     128 x 128 output tiles times S row splits, both operands read in place
//     as MN-major (wgmma trans-a, trans-b); (3, 4) the ordered additions of
//     the S weight partials and the per-warp vector partials.  Five products
//     of 2 N D M in all, where the row kernels below take seven.
//   * "rows" (f32, and bf16 at other widths): 16-row blocks of f32 tiles
//     (rowops.cuh) whose products run on mma.sync m16n8k16 from weights read
//     from L2 (T = f32 as scalar FMAs, the sharp check against the plain
//     version).  K11 is one launch of 16-row blocks.  K12 is four launches:
//       1. bwd_rows: a persistent grid of 16-row blocks recomputes t and h,
//          forms da, dh, dt and dx, and carries the four vector gradients
//          (dgamma, dbeta, db2, db1) in shared memory over its share of row
//          blocks, one partial row per block;
//       2. bwd_weights: block (j, s) owns the 32 hidden columns j of dw1 and
//          the 32 rows j of dw2 as register accumulators and walks the 32-row
//          blocks s, s + S, ...: it recomputes t, the slice of h and da, a
//          and dh, and adds t^T dh and a^T g with the transposed fragments
//          read straight from the f32 tiles, keeping t, a and dh out of
//          device memory at the cost of the LayerNorm and two products again
//          (seven products in all);
//       3. and 4. the ordered additions of the weight and vector partials.
//     N need not divide a tile: the tail rows are masked (TMA reads them as
//     zeros and does not store them on the wgmma route).
//
// Bound on the H100: operations.  At N 84480, D 256, M 512 in bf16 K11 is
// 44.3 GFLOP on 86.5 MB (0.045 ms at the bf16 peak against 0.026 ms of
// bytes); K12's bound as a function is its five products (h, da, dt, dW1,
// dW2: 110.7 GFLOP, 0.112 ms) on 130 MB of operands; the wgmma route moves
// ~0.6 GB, t, a and dh written once and read again (0.18 ms at 3.35 TB/s).
#include "hopper.cuh"
#include "partials.cuh"
#include "rowops.cuh"

namespace {

using rowops::Gemm;
using rowops::kThreads;
using rowops::ld8;
using rowops::pad;
using rowops::rnd;
using rowops::st8;
using rowops::warp_sum;
using rowops::zero8;

constexpr int kRowsFwd = 16;   // token rows of a K11 / bwd_rows block
constexpr int kRowsW = 32;     // token rows of a bwd_weights step
constexpr int kSlice = 32;     // hidden columns a bwd_weights block owns
constexpr int kMaxD = 256;     // bwd_weights: one thread or 1/8 warp per column
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// erf by the Abramowitz-Stegun polynomial of the TPU body (|error| <= 1.5e-7)
__device__ __forceinline__ float erf_poly(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float r = 1.f - poly * expf(-ax * ax);
  return x > 0.f ? r : (x < 0.f ? -r : 0.f);
}
__device__ __forceinline__ float gelu_poly(float h) {
  return 0.5f * h * (1.f + erf_poly(h * kInvSqrt2));
}
__device__ __forceinline__ float dgelu_poly(float h) {
  const float phi = expf(-0.5f * h * h) * kInvSqrt2Pi;
  return 0.5f * (1.f + erf_poly(h * kInvSqrt2)) + h * phi;
}
// gelu_poly(h) and dgelu_poly(h) from one erf: the same operations, so the
// same bits
__device__ __forceinline__ void gelu_and_grad(float h, float& gelu,
                                              float& grad) {
  const float e = 1.f + erf_poly(h * kInvSqrt2);
  gelu = 0.5f * h * e;
  grad = 0.5f * e + h * (expf(-0.5f * h * h) * kInvSqrt2Pi);
}

// Rows rows of src (N, D) from row0 into an f32 tile; rows past N are zeros.
template <typename T, int Rows>
__device__ void load_rows(const T* __restrict__ src, long long row0,
                          long long N, int D, float* tile, int ld) {
  const int D8 = D / 8;
  for (int i = threadIdx.x; i < Rows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    float v[8];
    if (row0 + r < N)
      ld8(src + (row0 + r) * D + c, v);
    else
      zero8(v);
    st8(tile + r * ld + c, v);
  }
}

// LayerNorm parts of the Rows rows of tile X (row stride ld, width D), one
// warp per row: Tt gets cast(xhat * gamma + beta); XH, where given, xhat and
// rstd the row's rsqrt(var + eps).  X may be XH or Tt (each element is read,
// then written, by one thread).  Callers sync before and after.
template <typename T, int Rows>
__device__ void ln_rows(const float* X, float* XH, float* Tt, int ld, int D,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* rstd) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < Rows; r += kThreads / 32) {
    const float* row = X + r * ld;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum += row[c];
    const float mu = warp_sum(sum) / D;
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = row[c] - mu;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / D + 1e-5f);
    for (int c = lane; c < D; c += 32) {
      const float xh = (row[c] - mu) * inv;
      if (XH) XH[r * ld + c] = xh;
      Tt[r * ld + c] = rnd<T>(xh * gamma[c] + beta[c]);
    }
    if (rstd && lane == 0) rstd[r] = inv;
  }
}

// ---------------------------------------------------------------------------
// K11
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const T* __restrict__ w1t,
                   const float* __restrict__ b1, const T* __restrict__ w2t,
                   const float* __restrict__ b2, T* __restrict__ out,
                   long long N, int D, int M) {
  constexpr int R = kRowsFwd;
  extern __shared__ __align__(16) float smem[];
  const int ld = pad(D), ldh = pad(M);
  const int D8 = D / 8, M8 = M / 8;
  float* A = smem;            // x, then t, then y
  float* Hb = A + R * ld;     // hidden
  const long long row0 = (long long)blockIdx.x * R;
  load_rows<T, R>(x, row0, N, D, A, ld);
  __syncthreads();
  ln_rows<T, R>(A, nullptr, A, ld, D, gamma, beta, nullptr);
  __syncthreads();
  Gemm<T, R>::run(A, ld, w1t, D, M, Hb, ldh);
  __syncthreads();
  for (int i = threadIdx.x; i < R * M8; i += kThreads) {
    const int r = i / M8, c = (i - r * M8) * 8;
    float v[8];
    ld8(Hb + r * ldh + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = rnd<T>(gelu_poly(v[e] + b1[c + e]));
    st8(Hb + r * ldh + c, v);
  }
  __syncthreads();
  Gemm<T, R>::run(Hb, ldh, w2t, M, D, A, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < R * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    if (row0 + r >= N) continue;
    float xv[8], y[8];
    ld8(x + (row0 + r) * D + c, xv);
    ld8(A + r * ld + c, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) xv[e] = xv[e] + (y[e] + b2[c + e]);
    st8(out + (row0 + r) * D + c, xv);
  }
}

// ---------------------------------------------------------------------------
// K12, launch 1: everything that is local to a token row, and the four
// vector gradients.  part (gridDim.x, 3D + M): [dgamma | dbeta | db2 | db1].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffd_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const T* __restrict__ w1t, const T* __restrict__ w1,
                        const T* __restrict__ w2, const float* __restrict__ b1,
                        T* __restrict__ dx, float* __restrict__ part,
                        long long N, int D, int M) {
  constexpr int R = kRowsFwd;
  extern __shared__ __align__(16) float smem[];
  __shared__ float rstd[R];
  const int ld = pad(D), ldh = pad(M);
  const int D8 = D / 8, M8 = M / 8;
  float* XH = smem;             // x, then xhat
  float* S2 = XH + R * ld;      // t, then g, then dt, then dx's LN part
  float* Hb = S2 + R * ld;      // h, then dh
  float* DA = Hb + R * ldh;     // da
  float* acc = DA + R * ldh;    // 3D + M column sums, thread-owned entries
  const int V = 3 * D + M;
  for (int i = threadIdx.x; i < V; i += kThreads) acc[i] = 0.f;
  const long long nrb = (N + R - 1) / R;
  for (long long rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
    const long long row0 = rb * R;
    load_rows<T, R>(x, row0, N, D, XH, ld);
    __syncthreads();
    ln_rows<T, R>(XH, XH, S2, ld, D, gamma, beta, rstd);
    __syncthreads();
    Gemm<T, R>::run(S2, ld, w1t, D, M, Hb, ldh);   // h - b1
    __syncthreads();
    load_rows<T, R>(dy, row0, N, D, S2, ld);       // g; zero past N
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) s += S2[r * ld + c];
      acc[2 * D + c] += s;                         // db2
    }
    Gemm<T, R>::run(S2, ld, w2, D, M, DA, ldh);    // da = g @ w2^T
    __syncthreads();
    for (int i = threadIdx.x; i < R * M8; i += kThreads) {
      const int r = i / M8, c = (i - r * M8) * 8;
      float h[8], da[8];
      ld8(Hb + r * ldh + c, h);
      ld8(DA + r * ldh + c, da);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = rnd<T>(da[e] * dgelu_poly(h[e] + b1[c + e]));
      st8(Hb + r * ldh + c, h);                    // dh
    }
    __syncthreads();
    for (int c = threadIdx.x; c < M; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) s += Hb[r * ldh + c];
      acc[3 * D + c] += s;                         // db1
    }
    Gemm<T, R>::run(Hb, ldh, w1, M, D, S2, ld);    // dt = dh @ w1^T
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float sg = 0.f, sb = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dt = S2[r * ld + c];
        sg += dt * XH[r * ld + c];
        sb += dt;
      }
      acc[c] += sg;                                // dgamma
      acc[D + c] += sb;                            // dbeta
    }
    __syncthreads();
    {  // LayerNorm backward, one warp per row: S2 <- r * (dxhat - m1 - xhat m2)
      const int lane = threadIdx.x & 31;
      const int warp = threadIdx.x >> 5;
      for (int r = warp; r < R; r += kThreads / 32) {
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < D; c += 32) {
          const float dxh = S2[r * ld + c] * gamma[c];
          s1 += dxh;
          s2 += dxh * XH[r * ld + c];
        }
        const float m1 = warp_sum(s1) / D;
        const float m2 = warp_sum(s2) / D;
        const float inv = rstd[r];
        for (int c = lane; c < D; c += 32) {
          const float dxh = S2[r * ld + c] * gamma[c];
          S2[r * ld + c] = inv * (dxh - m1 - XH[r * ld + c] * m2);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * D8; i += kThreads) {
      const int r = i / D8, c = (i - r * D8) * 8;
      if (row0 + r >= N) continue;
      float g[8], l[8];
      ld8(dy + (row0 + r) * D + c, g);
      ld8(S2 + r * ld + c, l);
#pragma unroll
      for (int e = 0; e < 8; ++e) g[e] = g[e] + l[e];
      st8(dx + (row0 + r) * D + c, g);
    }
    __syncthreads();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < V; i += kThreads)
    part[(size_t)blockIdx.x * V + i] = acc[i];
}

// ---------------------------------------------------------------------------
// K12, launch 2: dw1[:, slice] += t^T dh and dw2[slice, :] += a^T g over the
// kRowsW rows of the tiles.  Tt, G: (kRowsW, ld) f32 tiles of t and g; Hs, Ds:
// (kRowsW, lds) tiles of a and dh; every value exact in T.
// ---------------------------------------------------------------------------
constexpr int kLds = kSlice + 8;

template <typename T>
struct WeightAcc;

// one thread per column d of x: 32 entries of dw1's row d and of dw2's column d
template <>
struct WeightAcc<float> {
  float a1[kSlice], a2[kSlice];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kSlice; ++i) a1[i] = a2[i] = 0.f;
  }
  __device__ void add(const float* Tt, const float* G, int ld, const float* Hs,
                      const float* Ds, int D) {
    const int d = threadIdx.x;
    if (d >= D) return;
    for (int r = 0; r < kRowsW; ++r) {
      const float tv = Tt[r * ld + d], gv = G[r * ld + d];
#pragma unroll
      for (int c = 0; c < kSlice; ++c) {
        a1[c] = fmaf(tv, Ds[r * kLds + c], a1[c]);
        a2[c] = fmaf(Hs[r * kLds + c], gv, a2[c]);
      }
    }
  }
  // p1: dw1 partial (D, M) at column m0; p2: dw2 partial (M, D) at row m0
  __device__ void store(float* p1, float* p2, int D, int M, int m0) const {
    const int d = threadIdx.x;
    if (d >= D) return;
#pragma unroll
    for (int c = 0; c < kSlice; ++c) {
      p1[(size_t)d * M + m0 + c] = a1[c];
      p2[(size_t)(m0 + c) * D + d] = a2[c];
    }
  }
};

// warp w owns columns 32w .. 32w + 31 of x: a 32 x 32 block of dw1 (rows d)
// and of dw2 (columns d), each as 2 x 4 mma tiles.  The A operands are the
// transposes t^T and a^T, so a fragment register packs two values of
// consecutive token rows.
template <>
struct WeightAcc<__nv_bfloat16> {
  float a1[2][4][4], a2[2][4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[i][j][e] = a2[i][j][e] = 0.f;
  }
  // fragment of the transposed A operand: rows m0 + g (+8) are columns of the
  // tile S, the k axis its token rows k0 ..
  static __device__ __forceinline__ void frag_at(const float* S, int ld, int k0,
                                                 int m0, int g, int t,
                                                 uint32_t (&a)[4]) {
    const float* p = S + (k0 + 2 * t) * ld + m0 + g;
    a[0] = rowops::pack_bf16(p[0], p[ld]);
    a[1] = rowops::pack_bf16(p[8], p[ld + 8]);
    a[2] = rowops::pack_bf16(p[8 * ld], p[9 * ld]);
    a[3] = rowops::pack_bf16(p[8 * ld + 8], p[9 * ld + 8]);
  }
  // fragment of the B operand: token rows k0 .. of tile S, column n0 + g
  static __device__ __forceinline__ void frag_b(const float* S, int ld, int k0,
                                                int n0, int g, int t,
                                                uint32_t (&b)[2]) {
    const float* p = S + (k0 + 2 * t) * ld + n0 + g;
    b[0] = rowops::pack_bf16(p[0], p[ld]);
    b[1] = rowops::pack_bf16(p[8 * ld], p[9 * ld]);
  }
  __device__ void add(const float* Tt, const float* G, int ld, const float* Hs,
                      const float* Ds, int D) {
    const int lane = threadIdx.x & 31;
    const int d0 = (threadIdx.x >> 5) * 32;
    if (d0 >= D) return;
    const int g = lane >> 2, t = lane & 3;
    for (int k0 = 0; k0 < kRowsW; k0 += 16) {
      uint32_t fa[2][4], fb[4][2];
      // dw1 block: A = t^T (rows d0 ..), B = dh (32 columns)
#pragma unroll
      for (int i = 0; i < 2; ++i) frag_at(Tt, ld, k0, d0 + 16 * i, g, t, fa[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) frag_b(Ds, kLds, k0, 8 * j, g, t, fb[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(a1[i][j], fa[i], fb[j]);
      // dw2 block: A = a^T (32 rows), B = g (columns d0 ..)
#pragma unroll
      for (int i = 0; i < 2; ++i) frag_at(Hs, kLds, k0, 16 * i, g, t, fa[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) frag_b(G, ld, k0, d0 + 8 * j, g, t, fb[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(a2[i][j], fa[i], fb[j]);
    }
  }
  __device__ void store(float* p1, float* p2, int D, int M, int m0) const {
    const int lane = threadIdx.x & 31;
    const int d0 = (threadIdx.x >> 5) * 32;
    if (d0 >= D) return;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // dw1: rows d0 + 16 i + g (+8), columns m0 + 8 j + 2t (+1)
        float* q1 = p1 + (size_t)(d0 + 16 * i + g) * M + m0 + 8 * j + 2 * t;
        q1[0] = a1[i][j][0];
        q1[1] = a1[i][j][1];
        q1[(size_t)8 * M] = a1[i][j][2];
        q1[(size_t)8 * M + 1] = a1[i][j][3];
        // dw2: rows m0 + 16 i + g (+8), columns d0 + 8 j + 2t (+1)
        float* q2 = p2 + (size_t)(m0 + 16 * i + g) * D + d0 + 8 * j + 2 * t;
        q2[0] = a2[i][j][0];
        q2[1] = a2[i][j][1];
        q2[(size_t)8 * D] = a2[i][j][2];
        q2[(size_t)8 * D + 1] = a2[i][j][3];
      }
  }
};

// grid (M / kSlice, S).  part (S, 2 D M): [dw1 (D, M) | dw2 (M, D)].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffd_bwd_weights_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const T* __restrict__ w1t, const T* __restrict__ w2,
                           const float* __restrict__ b1,
                           float* __restrict__ part, long long N, int D,
                           int M) {
  constexpr int R = kRowsW;
  extern __shared__ __align__(16) float smem[];
  const int ld = pad(D);
  float* Tt = smem;             // x, then t
  float* G = Tt + R * ld;       // g
  float* Hs = G + R * ld;       // h slice, then a
  float* Ds = Hs + R * kLds;    // da slice, then dh
  const int m0 = blockIdx.x * kSlice;
  const T* w1s = w1t + (size_t)m0 * D;   // rows m0 .. of w1^T (M, D)
  const T* w2s = w2 + (size_t)m0 * D;    // rows m0 .. of w2 (M, D)
  WeightAcc<T> acc;
  acc.zero();
  const long long nrb = (N + R - 1) / R;
  for (long long rb = blockIdx.y; rb < nrb; rb += gridDim.y) {
    const long long row0 = rb * R;
    load_rows<T, R>(x, row0, N, D, Tt, ld);
    load_rows<T, R>(dy, row0, N, D, G, ld);
    __syncthreads();
    ln_rows<T, R>(Tt, nullptr, Tt, ld, D, gamma, beta, nullptr);
    __syncthreads();
    Gemm<T, R>::run(Tt, ld, w1s, D, kSlice, Hs, kLds);
    Gemm<T, R>::run(G, ld, w2s, D, kSlice, Ds, kLds);
    __syncthreads();
    for (int i = threadIdx.x; i < R * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i - r * kSlice;
      const float h = Hs[r * kLds + c] + b1[m0 + c];
      Hs[r * kLds + c] = rnd<T>(gelu_poly(h));
      Ds[r * kLds + c] = rnd<T>(Ds[r * kLds + c] * dgelu_poly(h));
    }
    __syncthreads();
    acc.add(Tt, G, ld, Hs, Ds, D);
    __syncthreads();
  }
  float* p = part + (size_t)blockIdx.y * 2 * D * M;
  acc.store(p, p + (size_t)D * M, D, M, m0);
}

int smem_fwd(int D, int M) {
  return kRowsFwd * (pad(D) + pad(M)) * (int)sizeof(float);
}
int smem_rows(int D, int M) {
  return (kRowsFwd * 2 * (pad(D) + pad(M)) + 3 * D + M) * (int)sizeof(float);
}
int smem_weights(int D) {
  return kRowsW * 2 * (pad(D) + kLds) * (int)sizeof(float);
}
bool widths_ok(long long N, int D, int M) {
  return N > 0 && D > 0 && M > 0 && D % 64 == 0 && M % 64 == 0 && D <= kMaxD;
}

template <typename T>
cudaError_t fwd_launch(const void* x, const float* gamma, const float* beta,
                       const void* w1t, const float* b1, const void* w2t,
                       const float* b2, void* out, long long N, int D, int M,
                       cudaStream_t s) {
  const int smem = smem_fwd(D, M);
  cudaError_t err = rowops::allow_smem(ffd_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (N + kRowsFwd - 1) / kRowsFwd;
  ffd_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, s>>>(
      (const T*)x, gamma, beta, (const T*)w1t, b1, (const T*)w2t, b2, (T*)out,
      N, D, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_launch(const void* x, const void* dy, const float* gamma,
                       const float* beta, const void* w1t, const void* w1,
                       const void* w2, const float* b1, void* dx, float* dvec,
                       float* dw, float* pvec, float* pw, int PA, int S,
                       long long N, int D, int M, cudaStream_t s) {
  const int smem_a = smem_rows(D, M), smem_b = smem_weights(D);
  cudaError_t err = rowops::allow_smem(ffd_bwd_rows_kernel<T>, smem_a);
  if (err != cudaSuccess) return err;
  err = rowops::allow_smem(ffd_bwd_weights_kernel<T>, smem_b);
  if (err != cudaSuccess) return err;
  ffd_bwd_rows_kernel<T><<<PA, kThreads, smem_a, s>>>(
      (const T*)x, (const T*)dy, gamma, beta, (const T*)w1t, (const T*)w1,
      (const T*)w2, b1, (T*)dx, pvec, N, D, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffd_bwd_weights_kernel<T><<<dim3(M / kSlice, S), kThreads, smem_b, s>>>(
      (const T*)x, (const T*)dy, gamma, beta, (const T*)w1t, (const T*)w2, b1,
      pw, N, D, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = partials::add(pw, S, 2LL * D * M, dw, s);
  if (err != cudaSuccess) return err;
  return partials::add(pvec, PA, 3LL * D + M, dvec, s);
}


// ---------------------------------------------------------------------------
// bf16 on wgmma + TMA (ops/ffd_fused.py:ffd_plan, route "wgmma"): D 128 or
// 256, M a multiple of 128.  Grids, ring depths and the split-K row ranges
// come from the plan.
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;              // token rows of a warpgroup's tile
constexpr int kGroups = 2;             // consumer warpgroups a block
constexpr int kBlock = 128 * kGroups;  // threads a block
constexpr int kAtom = 64 * 128;        // 64 rows of 64 bf16 (128 bytes)
constexpr int kBox = 2 * kAtom;        // a weight box of the row launches
constexpr int kSlice = 64;             // hidden columns a step
constexpr int kMaxStages = 8;

// Byte offset of element (r, c) in a 64-row tile of 64-column atoms in the
// 128B-swizzled layout TMA writes and wgmma reads (SBO 1024).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 6) * kAtom + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float2 ld2(const uint8_t* tile, uint32_t off) {
  return unpack2(*reinterpret_cast<const uint32_t*>(tile + off));
}
__device__ __forceinline__ void st2(uint8_t* tile, uint32_t off, float lo,
                                    float hi) {
  *reinterpret_cast<uint32_t*>(tile + off) = pack2(lo, hi);
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}
__device__ __forceinline__ uint64_t desc128(const uint8_t* p) {
  return make_desc(p, 1024, kSwizzle128);
}

// A ring of `stages` boxes of `bytes` in shared memory, filled in a fixed
// sequence of `total` items by thread 0 of the block and read by both
// warpgroups: item i goes to stage i % stages once both have released item
// i - stages (the stage's empty barrier: one arrival a warp, after its
// products on the item completed); a warpgroup takes item i when the
// stage's full barrier completes.  Thread 0 issues the next item as its own
// warpgroup releases one (as K6's output launch does).  Both warpgroups
// read every item: the row launches' two tiles take the same weights, the
// weight launch's two halves the same k-steps.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, bytes, total;
  int tx;       // the bytes an item's loads bring (<= bytes)
  int issued;   // thread 0: items issued
  int used;     // this warpgroup: items taken and released

  __device__ void init() const {   // thread 0, before __syncthreads
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kGroups);
    }
  }
  template <typename Load>
  __device__ void issue(const Load& load) {
    const int i = issued++;
    const int s = i % stages, r = i / stages;
    if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
    mbar_arrive_expect_tx(&full[s], tx);
    load(i, base + s * bytes, &full[s]);
  }
  template <typename Load>
  __device__ void prime(const Load& load) {   // thread 0
    while (issued < total && issued < stages) issue(load);
  }
  // item used + ahead (ahead < stages), once it has landed
  __device__ const uint8_t* take(int ahead = 0) const {
    const int i = used + ahead;
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    return base + s * bytes;
  }
  // after the products that read the item have completed
  template <typename Load>
  __device__ void release(const Load& load) {
    const int s = used % stages;
    ++used;
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && issued < total) issue(load);
    __syncwarp();
  }
};

// The LayerNorm of rows r0 and r0 + 8 of a 64-row tile holding bf16 x (D
// columns): f32, eps 1e-5, biased variance; t = bf16(xhat * gamma + beta)
// written back in place, the tile becoming wgmma's A operand.  A row's D
// values sit with the four threads t of its group (columns 8j + 2t, + 1),
// so its sums take two shuffles.  mu and rsqrt(var + eps) of each row out.
template <int D>
__device__ __forceinline__ void ln_tile(uint8_t* tile,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        int r0, int t, float (&mu)[2],
                                        float (&inv)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v = ld2(tile, sw128(r, 8 * j + 2 * t));
      sum += v.x + v.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    mu[hr] = sum / D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v = ld2(tile, sw128(r, 8 * j + 2 * t));
      const float d0 = v.x - mu[hr], d1 = v.y - mu[hr];
      sq += d0 * d0 + d1 * d1;
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    inv[hr] = rsqrtf(sq / D + 1e-5f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 v = ld2(tile, sw128(r, c));
      const float2 gg = *reinterpret_cast<const float2*>(gamma + c);
      const float2 bb = *reinterpret_cast<const float2*>(beta + c);
      st2(tile, sw128(r, c), (v.x - mu[hr]) * inv[hr] * gg.x + bb.x,
          (v.y - mu[hr]) * inv[hr] * gg.y + bb.y);
    }
  }
}

// acc (64 x 64) += A[:, 128 kb .. 128 kb + 127] B^T: A a tile of D columns,
// B a row box (64 rows x 128 columns as two atoms), both K-major.  One wait
// a box: on the H100, holding a second box (or a second commit group) in
// flight was slower for both row launches (more registers, a shallower
// ring for the other warpgroup).
__device__ __forceinline__ void mma_rowbox(float (&acc)[32],
                                           const uint8_t* a_s, int kb,
                                           const uint8_t* box) {
  wgmma_fence();
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n64k16_ss(acc, desc128(a_s + (2 * kb + a) * kAtom + k * 32),
                         desc128(box + a * kAtom + k * 32), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc (64 x 128) += H B^T: H a 64 x 64 atom (the hidden slice), B a column
// box (128 rows x 64 columns), both K-major.
__device__ __forceinline__ void mma_colbox(float (&acc)[64],
                                           const uint8_t* h_s,
                                           const uint8_t* box) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n128k16_ss(acc, desc128(h_s + k * 32), desc128(box + k * 32), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc (64 x 64) += A[:, 128 nb .. 128 nb + 127] B: A a tile of D columns
// (K-major), B a column box of w1 (128 rows of D x 64 hidden columns) read
// as MN-major (trans-b): K = its 128 rows, 16 a step (2 KB).
__device__ __forceinline__ void mma_colbox_mn(float (&acc)[32],
                                              const uint8_t* a_s, int nb,
                                              const uint8_t* box) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k)
    wgmma_m64n64k16_ss_tb(
        acc, desc128(a_s + (2 * nb + (k >> 2)) * kAtom + (k & 3) * 32),
        desc_add(desc128(box), 2048 * k), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc (64 x 128) += H B: H a 64 x 64 atom (the hidden slice, K-major), B a
// row box of w2 (64 hidden rows x 128 columns of D as two atoms) read as
// MN-major (trans-b, the second span kAtom on).
__device__ __forceinline__ void mma_rowbox_mn(float (&acc)[64],
                                              const uint8_t* h_s,
                                              const uint8_t* box) {
  wgmma_fence();
  const uint64_t db = make_desc_lbo(box, kAtom, 1024, kSwizzle128);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n128k16_ss_tb(acc, desc128(h_s + k * 32), desc_add(db, 2048 * k),
                           1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// K11.  A persistent block of two warpgroups walks pairs of 64-row tiles,
// one a warpgroup.  TMA loads the x tile; the LN writes t over it (wgmma's
// A layout); per 64 hidden columns h = t w1 (m64n64k16 over D), a =
// bf16(gelu(h + b1)) into the hidden atom, and y += a w2 (m64n128k16 over
// the 64 columns) in f32 registers; once the last h products are done, TMA
// loads x into the tile again, and x + (y + b2), cast, is staged over it
// and stored by TMA (rows past N are not written).  The hidden
// activation never leaves the SM.  Both warpgroups read the weights, in
// their own layouts, from one ring; items, per slice s: the column boxes
// of w1 (D x M: rows 128 nb.., columns 64 s..) for h, then the row boxes of
// w2 (M x D: rows 64 s.., columns 128 kb..) for y, 16 KB each, both read as
// MN-major B operands.
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
    fwd_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap omap,
              const __grid_constant__ CUtensorMap w1map,
              const __grid_constant__ CUtensorMap w2map,
              const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ b1,
              const float* __restrict__ b2, int N, int M, int stages) {
  constexpr int KB = D / 128;
  constexpr int kT = kTile * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring_s = align1024(smem_raw);   // the ring, then the tiles
  const int grp = threadIdx.x >> 7;
  uint8_t* tiles_s = ring_s + stages * kBox;
  uint8_t* t_s = tiles_s + grp * (kT + kAtom);
  uint8_t* a_s = t_s + kT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(tiles_s +
                                               kGroups * (kT + kAtom));
  uint64_t* tbar = bars + 2 * kMaxStages + grp;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;   // this thread's rows r0, r0 + 8 of a tile
  const int slices = M / kSlice;
  const int per_pass = slices * 2 * KB;
  const int pairs = ((N + kTile - 1) / kTile + kGroups - 1) / kGroups;
  const int my_pairs =
      blockIdx.x < pairs ? (pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  Ring ring{ring_s, bars, bars + kMaxStages, stages, kBox,
            my_pairs * per_pass, kBox, 0, 0};
  auto load = [&](int i, uint8_t* dst, uint64_t* bar) {
    const int j = i % per_pass, s = j / (2 * KB), e = j % (2 * KB);
    if (e < KB) {
      tma_load_2d(dst, &w1map, bar, s * kSlice, e * 128);
    } else {
      tma_load_2d(dst, &w2map, bar, (e - KB) * 128, s * kSlice);
      tma_load_2d(dst + kAtom, &w2map, bar, (e - KB) * 128 + 64, s * kSlice);
    }
  };
  if (threadIdx.x == 0) {
    ring.init();
    for (int q = 0; q < kGroups; ++q) mbar_init(bars + 2 * kMaxStages + q, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(load);
  auto group_sync = [&]() { named_barrier_sync(1 + grp, 128); };
  uint32_t tphase = 0;

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int row0 = (pair * kGroups + grp) * kTile;   // past N: zeros
    if (tid == 0) {
      tma_store_wait_read();   // the last tile's output has left t_s
      mbar_arrive_expect_tx(tbar, kT);
      for (int a = 0; a < D / 64; ++a)
        tma_load_2d(t_s + a * kAtom, &xmap, tbar, a * 64, row0);
    }
    mbar_wait(tbar, tphase);
    tphase ^= 1;
    float mu[2], inv[2];
    ln_tile<D>(t_s, gamma, beta, r0, t, mu, inv);
    fence_async_shared();
    group_sync();
    float y[KB][64];
#pragma unroll
    for (int nb = 0; nb < KB; ++nb)
#pragma unroll
      for (int i = 0; i < 64; ++i) y[nb][i] = 0.f;
    for (int s = 0; s < slices; ++s) {
      float h[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0.f;
#pragma unroll
      for (int nb = 0; nb < KB; ++nb) {
        mma_colbox_mn(h, t_s, nb, ring.take());
        ring.release(load);
      }
      if (s > 0) group_sync();   // every warp's products have read a_s
      if (s == slices - 1 && tid == 0) {   // and t_s: x again, for the end
        mbar_arrive_expect_tx(tbar, kT);
        for (int a = 0; a < D / 64; ++a)
          tma_load_2d(t_s + a * kAtom, &xmap, tbar, a * 64, row0);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 bb =
            *reinterpret_cast<const float2*>(b1 + s * kSlice + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          st2(a_s, sw128(r0 + 8 * hr, c),
              gelu_poly(h[4 * j + 2 * hr] + bb.x),
              gelu_poly(h[4 * j + 2 * hr + 1] + bb.y));
      }
      fence_async_shared();
      group_sync();
#pragma unroll
      for (int nb = 0; nb < KB; ++nb) {
        mma_rowbox_mn(y[nb], a_s, ring.take());
        ring.release(load);
      }
    }
    mbar_wait(tbar, tphase);   // x, reloaded into t_s
    tphase ^= 1;
#pragma unroll
    for (int nb = 0; nb < KB; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = nb * 128 + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t off = sw128(r0 + 8 * hr, c);
          const float2 xv = ld2(t_s, off);
          st2(t_s, off, xv.x + (y[nb][4 * j + 2 * hr] + bb.x),
              xv.y + (y[nb][4 * j + 2 * hr + 1] + bb.y));
        }
      }
    fence_async_shared();
    group_sync();
    if (tid == 0) {
      for (int a = 0; a < D / 64; ++a)
        tma_store_2d(&omap, t_s + a * kAtom, a * 64, row0);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_all();
}

// K12, launch 1: everything local to a token row, on the same walk as K11.
// A warpgroup's tile: TMA loads x and g (= dy); the LN writes t over x,
// and t goes to device memory (TMA store) for launch 2.  Per 64 hidden
// columns: da = g w2^T and h = t w1 (m64n64k16 over D), then a = bf16(gelu(h
// + b1)) and dh = bf16(da gelu'(h + b1)) into two atoms that TMA stores for
// launch 2, and dt += dh w1^T (m64n128k16) in f32 registers.
// At the tile's end: dgamma and dbeta, and the LN backward's two row means;
// dx = bf16(g + rsqrt * (dxhat - m1 - xhat m2)) is staged over x and stored
// by TMA.  xhat is recomputed from x, which TMA loads into t_s again once the
// last h products are done with t (and t's store has left it).  dgamma and
// dbeta: each warp sums its 16 rows by shuffles, the four warps' sums meet
// in the free a/dh atoms, and thread i of the warpgroup adds columns i,
// i + 128, ... of them, in warp order, to its registers, which the kernel
// writes at its end as the warpgroup's partial row [dgamma | dbeta] of
// `part` (launch 4 adds the rows in order).  No read-modify-write of device
// memory, so no warp waits on one.  db1 and db2 are launch 2's.  Weight
// ring items, per slice s: the row boxes of w2 (M x D: rows 64 s..,
// columns 128 kb..) for da, then the column boxes of w1 (D x M: rows 128
// nb.., columns 64 s..), each read twice: as the MN-major B of h and, kept
// in the ring through the epilogue, as the K-major B of dt (four boxes a
// slice where separate w1^T boxes for h would make six).
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
    bwd_rows_wgmma(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap tmap,
                   const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap hmap,
                   const __grid_constant__ CUtensorMap dxmap,
                   const __grid_constant__ CUtensorMap w2map,
                   const __grid_constant__ CUtensorMap w1map,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float* __restrict__ b1, float* __restrict__ part,
                   int N, int M, int stages) {
  constexpr int KB = D / 128;
  constexpr int kT = kTile * D * 2;
  constexpr int kG = 2 * kT + 2 * kAtom;   // t, g, a, dh
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring_s = align1024(smem_raw);   // the ring, then the tiles
  const int grp = threadIdx.x >> 7;
  uint8_t* tiles_s = ring_s + stages * kBox;
  uint8_t* t_s = tiles_s + grp * kG;
  uint8_t* g_s = t_s + kT;
  uint8_t* a_s = g_s + kT;
  uint8_t* h_s = a_s + kAtom;
  uint64_t* bars = reinterpret_cast<uint64_t*>(tiles_s + kGroups * kG);
  uint64_t* tbar = bars + 2 * kMaxStages + grp;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  const int slices = M / kSlice;
  const int per_pass = slices * 2 * KB;
  const int pairs = ((N + kTile - 1) / kTile + kGroups - 1) / kGroups;
  const int my_pairs =
      blockIdx.x < pairs ? (pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // columns tid, tid + 128, ... of [dgamma | dbeta], over this warpgroup's
  // tiles
  float vsum[2 * D / 128];
#pragma unroll
  for (int i = 0; i < 2 * D / 128; ++i) vsum[i] = 0.f;
  Ring ring{ring_s, bars, bars + kMaxStages, stages, kBox,
            my_pairs * per_pass, kBox, 0, 0};
  auto load = [&](int i, uint8_t* dst, uint64_t* bar) {
    const int j = i % per_pass, s = j / (2 * KB), e = j % (2 * KB);
    if (e < KB) {
      tma_load_2d(dst, &w2map, bar, e * 128, s * kSlice);
      tma_load_2d(dst + kAtom, &w2map, bar, e * 128 + 64, s * kSlice);
    } else {
      tma_load_2d(dst, &w1map, bar, s * kSlice, (e - KB) * 128);
    }
  };
  if (threadIdx.x == 0) {
    ring.init();
    for (int q = 0; q < kGroups; ++q) mbar_init(bars + 2 * kMaxStages + q, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(load);
  auto group_sync = [&]() { named_barrier_sync(1 + grp, 128); };
  // the sum over the warp's 16 rows of a value of this thread's two rows
  auto warp_rows = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    return v + __shfl_xor_sync(0xffffffffu, v, 16);
  };
  uint32_t tphase = 0;

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int row0 = (pair * kGroups + grp) * kTile;
    if (tid == 0) {
      tma_store_wait_read();   // the last tile's stores have left the tiles
      mbar_arrive_expect_tx(tbar, 2 * kT);
      for (int a = 0; a < D / 64; ++a) {
        tma_load_2d(t_s + a * kAtom, &xmap, tbar, a * 64, row0);
        tma_load_2d(g_s + a * kAtom, &gmap, tbar, a * 64, row0);
      }
    }
    mbar_wait(tbar, tphase);
    tphase ^= 1;
    float mu[2], inv[2];
    ln_tile<D>(t_s, gamma, beta, r0, t, mu, inv);
    fence_async_shared();
    group_sync();
    if (tid == 0) {
      for (int a = 0; a < D / 64; ++a)
        tma_store_2d(&tmap, t_s + a * kAtom, a * 64, row0);
      tma_store_commit();
    }
    float dt[KB][64];
#pragma unroll
    for (int nb = 0; nb < KB; ++nb)
#pragma unroll
      for (int i = 0; i < 64; ++i) dt[nb][i] = 0.f;
    for (int s = 0; s < slices; ++s) {
      float h[32], da[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = da[i] = 0.f;
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        mma_rowbox(da, g_s, kb, ring.take());
        ring.release(load);
      }
      // the w1 boxes stay in the ring for dt
#pragma unroll
      for (int nb = 0; nb < KB; ++nb) mma_colbox_mn(h, t_s, nb, ring.take(nb));
      if (s > 0) {   // the last slice's stores and products are done with
        if (tid == 0) tma_store_wait_read();   // a_s and h_s (and t_s)
        group_sync();
      }
      if (s == slices - 1 && tid == 0) {   // t_s: x again, for the end
        mbar_arrive_expect_tx(tbar, kT);
        for (int a = 0; a < D / 64; ++a)
          tma_load_2d(t_s + a * kAtom, &xmap, tbar, a * 64, row0);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 bb =
            *reinterpret_cast<const float2*>(b1 + s * kSlice + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float u0 = h[4 * j + 2 * hr] + bb.x;
          const float u1 = h[4 * j + 2 * hr + 1] + bb.y;
          const uint32_t off = sw128(r0 + 8 * hr, c);
          float g0, g1, d0, d1;
          gelu_and_grad(u0, g0, d0);
          gelu_and_grad(u1, g1, d1);
          st2(a_s, off, g0, g1);
          st2(h_s, off, da[4 * j + 2 * hr] * d0, da[4 * j + 2 * hr + 1] * d1);
        }
      }
      fence_async_shared();
      group_sync();
      if (tid == 0) {
        tma_store_2d(&amap, a_s, s * kSlice, row0);
        tma_store_2d(&hmap, h_s, s * kSlice, row0);
        tma_store_commit();
      }
#pragma unroll
      for (int nb = 0; nb < KB; ++nb) {
        mma_colbox(dt[nb], h_s, ring.take());
        ring.release(load);
      }
    }
    // dgamma and dbeta of the tile, and the LN backward's row sums; the
    // warps' column sums meet in the a and dh atoms once the stores of the
    // tile have read them
    if (tid == 0) tma_store_wait_read();
    group_sync();
    mbar_wait(tbar, tphase);   // x, reloaded into t_s
    tphase ^= 1;
    float* stage = reinterpret_cast<float*>(a_s);   // (4 warps, 2D) f32
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < KB; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = nb * 128 + 8 * j + 2 * t;
        const float2 gam = *reinterpret_cast<const float2*>(gamma + c);
        float vg[2] = {0.f, 0.f}, vb[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 xv = ld2(t_s, sw128(r0 + 8 * hr, c));
          const float xh0 = (xv.x - mu[hr]) * inv[hr];
          const float xh1 = (xv.y - mu[hr]) * inv[hr];
          const float d0 = dt[nb][4 * j + 2 * hr];
          const float d1 = dt[nb][4 * j + 2 * hr + 1];
          vg[0] += d0 * xh0;
          vg[1] += d1 * xh1;
          vb[0] += d0;
          vb[1] += d1;
          const float e0 = d0 * gam.x, e1 = d1 * gam.y;
          s1[hr] += e0 + e1;
          s2[hr] += e0 * xh0 + e1 * xh1;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          vg[e] = warp_rows(vg[e]);
          vb[e] = warp_rows(vb[e]);
        }
        if (g == 0) {
          *reinterpret_cast<float2*>(stage + warp * 2 * D + c) =
              make_float2(vg[0], vg[1]);
          *reinterpret_cast<float2*>(stage + warp * 2 * D + D + c) =
              make_float2(vb[0], vb[1]);
        }
      }
    group_sync();
#pragma unroll
    for (int i = 0; i < 2 * D / 128; ++i) {
      const int col = tid + 128 * i;
      vsum[i] += ((stage[col] + stage[2 * D + col]) + stage[4 * D + col]) +
                 stage[6 * D + col];
    }
    float m1[2], m2[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      s1[hr] += __shfl_xor_sync(0xffffffffu, s1[hr], 1);
      s1[hr] += __shfl_xor_sync(0xffffffffu, s1[hr], 2);
      s2[hr] += __shfl_xor_sync(0xffffffffu, s2[hr], 1);
      s2[hr] += __shfl_xor_sync(0xffffffffu, s2[hr], 2);
      m1[hr] = s1[hr] / D;
      m2[hr] = s2[hr] / D;
    }
#pragma unroll
    for (int nb = 0; nb < KB; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = nb * 128 + 8 * j + 2 * t;
        const float2 gam = *reinterpret_cast<const float2*>(gamma + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t off = sw128(r0 + 8 * hr, c);
          const float2 xv = ld2(t_s, off);
          const float xh0 = (xv.x - mu[hr]) * inv[hr];
          const float xh1 = (xv.y - mu[hr]) * inv[hr];
          const float2 gv = ld2(g_s, off);
          const float e0 = dt[nb][4 * j + 2 * hr] * gam.x;
          const float e1 = dt[nb][4 * j + 2 * hr + 1] * gam.y;
          st2(t_s, off,
              gv.x + inv[hr] * (e0 - m1[hr] - xh0 * m2[hr]),
              gv.y + inv[hr] * (e1 - m1[hr] - xh1 * m2[hr]));
        }
      }
    fence_async_shared();
    group_sync();
    if (tid == 0) {
      for (int a = 0; a < D / 64; ++a)
        tma_store_2d(&dxmap, t_s + a * kAtom, a * 64, row0);
      tma_store_commit();
    }
  }
  float* row = part + ((size_t)blockIdx.x * kGroups + grp) * 2 * D;
#pragma unroll
  for (int i = 0; i < 2 * D / 128; ++i) row[tid + 128 * i] = vsum[i];
  if (tid == 0) tma_store_wait_all();
}

// K12, launch 2: the weight gradients as two split-K products over the
// token rows, dW1 = t^T dh (D x M) and dW2 = a^T g (M x D), from what launch
// 1 stored.  Block (tile, split) owns one output tile of 128 rows and TW =
// 256 columns (128 where the matrix is 128 wide: dW2 at D 128), dW1's tiles
// first, row-major over their grid, then dW2's, and walks its split's 64-row
// k-steps in order; warpgroup w owns the tile's rows 64 w .. 64 w + 63 as
// TW / 128 accumulators of 64 x 128.  A ring stage is a k-step's 64 x 64
// boxes: the A operand's two 64-column halves (one a warpgroup) and the B
// operand's TW / 64, all read in place as MN-major operands (token rows as
// K, wgmma trans-a and trans-b).  One k-step's products stay in flight
// while the next one's are issued.  The launch is bound by what it reads
// through L2 (each k-step's operands once a tile): 128 x 256 tiles read a
// quarter less than 128 x 128 ones.  The blocks of the first tile row also
// sum their B columns over the token rows while the products run: db1 =
// sum dh (dW1's tiles) and db2 = sum g (dW2's), warpgroup w the k-step's
// rows 32 w .. 32 w + 31, the two added in that order at the end.  The
// split's partial is [dW1 | dW2 | db1 | db2]; launch 3 adds the partials in
// split order.
constexpr int kWeightRows = 128;   // an output tile's rows
constexpr int kStageMax = 6 * kAtom;

// an output matrix's tile width: 256 columns where they divide it, else 128
__host__ __device__ inline int tile_width(int ncols) {
  return ncols % 256 == 0 ? 256 : 128;
}
__host__ __device__ inline int weight_tiles(int D, int M) {
  return (D / kWeightRows) * (M / tile_width(M)) +
         (M / kWeightRows) * (D / tile_width(D));
}

template <int D>
__global__ void __launch_bounds__(kBlock, 1)
    bwd_weights_wgmma(const __grid_constant__ CUtensorMap tmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap gmap,
                      float* __restrict__ part, int N, int M,
                      int steps_per_split, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring_s = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_s + stages * kStageMax);
  const int grp = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tw1 = tile_width(M);
  const int tiles1 = (D / kWeightRows) * (M / tw1);
  const bool second = blockIdx.x >= tiles1;   // dW2
  const int tt = second ? blockIdx.x - tiles1 : blockIdx.x;
  const int ncols = second ? D : M;
  const int tw = tile_width(ncols);
  const int row_t = tt / (ncols / tw), col_t = tt % (ncols / tw);
  const CUtensorMap* am = second ? &amap : &tmap;
  const CUtensorMap* bm = second ? &gmap : &hmap;
  const bool colsum = row_t == 0;
  const int ksteps = (N + kTile - 1) / kTile;
  const int k0 = blockIdx.y * steps_per_split;
  const int k1 = min(k0 + steps_per_split, ksteps);
  Ring ring{ring_s, bars, bars + kMaxStages, stages, kStageMax,
            max(k1 - k0, 0), (2 + tw / 64) * kAtom, 0, 0};
  auto load = [&](int i, uint8_t* dst, uint64_t* bar) {
    const int row = (k0 + i) * kTile;
    tma_load_2d(dst, am, bar, row_t * kWeightRows, row);
    tma_load_2d(dst + kAtom, am, bar, row_t * kWeightRows + 64, row);
    for (int b = 0; b < tw / 64; ++b)
      tma_load_2d(dst + (2 + b) * kAtom, bm, bar, col_t * tw + 64 * b, row);
  };
  if (threadIdx.x == 0) {
    ring.init();
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) ring.prime(load);
  float acc[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
  // columns tid and tid + 128 (TW 256) of the B operand, rows 32 grp .. + 31
  float csum[2] = {0.f, 0.f};
  const int chunk = (tid & 63) >> 3;
  wgmma_fence();
  for (int i = 0; i < ring.total; ++i) {
    const uint8_t* st = ring.take(i > 0);   // item i; item i - 1 in flight
    const uint64_t da = desc128(st + grp * kAtom);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      if (nb * 128 >= tw) break;
      const uint64_t db = make_desc_lbo(st + (2 + 2 * nb) * kAtom, kAtom,
                                        1024, kSwizzle128);
#pragma unroll
      for (int k = 0; k < 4; ++k)   // 16 token rows (2 KB) a step
        wgmma_m64n128k16_ss_tt(acc[nb], desc_add(da, 2048 * k),
                               desc_add(db, 2048 * k), 1);
    }
    wgmma_commit();
    if (colsum) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        if (nb * 128 >= tw) break;
        const uint8_t* col = st + (2 + 2 * nb + (tid >> 6)) * kAtom +
                             ((tid & 7) << 1);
#pragma unroll 8
        for (int r = 32 * grp; r < 32 * grp + 32; ++r)
          csum[nb] += __bfloat162float(*reinterpret_cast<const bf16*>(
              col + r * 128 + ((chunk ^ (r & 7)) << 4)));
      }
    }
    if (i > 0) {   // item i - 1's products are done: back to the ring
      wgmma_wait<1>();
      ring.release(load);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  if (ring.total > 0) ring.release(load);
  const size_t W = 2 * (size_t)D * M + M + D;   // a split's partial
  if (colsum) {
    float* other = reinterpret_cast<float*>(ring_s);
    __syncthreads();   // every product is done with the ring
    if (grp == 1) {
      other[tid] = csum[0];
      other[128 + tid] = csum[1];
    }
    __syncthreads();
    if (grp == 0)
      for (int nb = 0; nb < tw / 128; ++nb)
        part[blockIdx.y * W + 2 * (size_t)D * M + (second ? M : 0) +
             col_t * tw + nb * 128 + tid] = csum[nb] + other[nb * 128 + tid];
  }
  float* out = part + (size_t)blockIdx.y * W +
               (second ? (size_t)D * M : 0) +
               (size_t)(row_t * kWeightRows + grp * 64) * ncols + col_t * tw;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    if (nb * 128 >= tw) break;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(out + (size_t)(warp * 16 + g + 8 * hr) *
                                             ncols + nb * 128 + 8 * j + 2 * t) =
            make_float2(acc[nb][4 * j + 2 * hr], acc[nb][4 * j + 2 * hr + 1]);
  }
}

// Shared memory of each launch with `stages` ring stages.  ops/ffd_fused.py:
// ffd_plan computes the same bytes (its CPU tests hold them) and passes
// them in; the entries refuse bytes that differ from these.
inline int fwd_smem(int D, int stages) {
  return 1024 + stages * kBox + kGroups * (kTile * D * 2 + kAtom) +
         (2 * kMaxStages + kGroups) * 8;
}
inline int rows_smem(int D, int stages) {
  return 1024 + stages * kBox + kGroups * (2 * kTile * D * 2 + 2 * kAtom) +
         (2 * kMaxStages + kGroups) * 8;
}
inline int weights_smem(int stages) {
  return 1024 + stages * kStageMax + 2 * kMaxStages * 8;
}

// a (rows, cols) bf16 row-major matrix in boxes of 64 columns x box_rows
// rows, 128B-swizzled; rows past the end read as zeros, and a store does
// not write them
cudaError_t map_bf16(CUtensorMap* map, const void* base, long long rows,
                     int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                               base, dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t fwd(const void* x, const float* gamma, const float* beta,
                const void* w1, const float* b1, const void* w2,
                const float* b2, void* out, int N, int M, int blocks,
                int stages, int smem, cudaStream_t s) {
  if (smem != fwd_smem(D, stages)) return cudaErrorInvalidValue;
  CUtensorMap xmap, omap, w1map, w2map;
  cudaError_t err = map_bf16(&xmap, x, N, D, kTile);
  if (err == cudaSuccess) err = map_bf16(&omap, out, N, D, kTile);
  if (err == cudaSuccess) err = map_bf16(&w1map, w1, D, M, 128);
  if (err == cudaSuccess) err = map_bf16(&w2map, w2, M, D, kSlice);
  if (err == cudaSuccess) err = rowops::allow_smem(fwd_wgmma<D>, smem);
  if (err != cudaSuccess) return err;
  fwd_wgmma<D><<<blocks, kBlock, smem, s>>>(
      xmap, omap, w1map, w2map, gamma, beta, b1, b2, N, M, stages);
  return cudaGetLastError();
}

// plan: {row-launch blocks, row-launch stages, splits, k-steps a split,
// weight-launch stages, row-launch and weight-launch shared memory}
template <int D>
cudaError_t bwd(const void* x, const void* dy, const float* gamma,
                const float* beta, const void* w1, const void* w2,
                const float* b1, void* dx, float* dvec, float* dw,
                float* pvec, float* pw, void* tb, void* ab, void* hb, int N,
                int M, const int* plan, cudaStream_t s) {
  const int smem_r = plan[5], smem_w = plan[6];
  if (smem_r != rows_smem(D, plan[1]) || smem_w != weights_smem(plan[4]))
    return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap, tmap, amap, hmap, dxmap, w2map, w1map;
  cudaError_t err = map_bf16(&xmap, x, N, D, kTile);
  if (err == cudaSuccess) err = map_bf16(&gmap, dy, N, D, kTile);
  if (err == cudaSuccess) err = map_bf16(&tmap, tb, N, D, kTile);
  if (err == cudaSuccess) err = map_bf16(&amap, ab, N, M, kTile);
  if (err == cudaSuccess) err = map_bf16(&hmap, hb, N, M, kTile);
  if (err == cudaSuccess) err = map_bf16(&dxmap, dx, N, D, kTile);
  if (err == cudaSuccess) err = map_bf16(&w2map, w2, M, D, kSlice);
  if (err == cudaSuccess) err = map_bf16(&w1map, w1, D, M, 128);
  if (err == cudaSuccess)
    err = rowops::allow_smem(bwd_rows_wgmma<D>, smem_r);
  if (err == cudaSuccess)
    err = rowops::allow_smem(bwd_weights_wgmma<D>, smem_w);
  if (err != cudaSuccess) return err;
  bwd_rows_wgmma<D><<<plan[0], kBlock, smem_r, s>>>(
      xmap, gmap, tmap, amap, hmap, dxmap, w2map, w1map, gamma, beta, b1,
      pvec, N, M, plan[1]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_weights_wgmma<D><<<dim3(weight_tiles(D, M), plan[2]), kBlock, smem_w,
                         s>>>(
      tmap, hmap, amap, gmap, pw, N, M, plan[3], plan[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = partials::add(pw, plan[2], 2LL * D * M + M + D, dw, s);
  if (err != cudaSuccess) return err;
  return partials::add(pvec, plan[0] * kGroups, 2LL * D, dvec, s);
}

bool shape_ok(long long N, int D, int M) {
  return N > 0 && N < (1LL << 31) && (D == 128 || D == 256) && M > 0 &&
         M % 128 == 0;
}

}  // namespace wg

}  // namespace

// Plain C entry points, loaded with ctypes.  x, dy, out, dx: (N, D) in the
// compute dtype (f32, or bf16 when is_bf16); w1t (M, D) = w1^T, w1 (D, M),
// w2 (M, D), w2t (D, M) = w2^T in the same dtype; gamma, beta, b2 (D) and b1
// (M) f32.  D and M are multiples of 64, D <= 256; N is free.  Each returns
// the first cudaError_t of its launches (0 on success).

extern "C" int cobevt_ffd_fwd(const void* x, const float* gamma,
                              const float* beta, const void* w1t,
                              const float* b1, const void* w2t,
                              const float* b2, void* out, long long N, int D,
                              int M, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!widths_ok(N, D, M)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? fwd_launch<__nv_bfloat16>(x, gamma, beta, w1t, b1, w2t, b2,
                                            out, N, D, M, s)
                : fwd_launch<float>(x, gamma, beta, w1t, b1, w2t, b2, out, N,
                                    D, M, s);
  return (int)err;
}

// dvec (3D + M) f32: [dgamma | dbeta | db2 | db1]; dw (2 D M) f32: [dw1 (D, M)
// | dw2 (M, D)]; pvec (PA, 3D + M) and pw (S, 2 D M): the caller's scratch
// for the PA row blocks' and the S weight blocks' partial sums.
extern "C" int cobevt_ffd_bwd(const void* x, const void* dy,
                              const float* gamma, const float* beta,
                              const void* w1t, const void* w1, const void* w2,
                              const float* b1, void* dx, float* dvec,
                              float* dw, float* pvec, float* pw, long long N,
                              int D, int M, int PA, int S, int is_bf16,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!widths_ok(N, D, M) || PA < 1 || S < 1 || S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16
            ? bwd_launch<__nv_bfloat16>(x, dy, gamma, beta, w1t, w1, w2, b1, dx,
                                        dvec, dw, pvec, pw, PA, S, N, D, M, s)
            : bwd_launch<float>(x, dy, gamma, beta, w1t, w1, w2, b1, dx, dvec,
                                dw, pvec, pw, PA, S, N, D, M, s);
  return (int)err;
}

// The wgmma route (ops/ffd_fused.py:ffd_plan): bf16 only, D 128 or 256, M a
// multiple of 128, every operand 16-byte aligned; the weights in their own
// layouts, w1 (D, M) and w2 (M, D).  K11: blocks, ring stages and shared
// memory from the plan.
extern "C" int cobevt_ffd_fwd_wgmma(const void* x, const float* gamma,
                                    const float* beta, const void* w1,
                                    const float* b1, const void* w2,
                                    const float* b2, void* out, long long N,
                                    int D, int M, int blocks, int stages,
                                    int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wg::shape_ok(N, D, M) || blocks < 1 || stages < 2 ||
      stages > wg::kMaxStages)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 256 ? wg::fwd<256>(x, gamma, beta, w1, b1, w2, b2, out,
                                       (int)N, M, blocks, stages, smem, s)
                        : wg::fwd<128>(x, gamma, beta, w1, b1, w2, b2, out,
                                       (int)N, M, blocks, stages, smem, s));
}

// K12 on the wgmma route: four launches (rows, weights, and the ordered
// additions of the weight and vector partials).  dvec (2D) f32: [dgamma |
// dbeta]; dw (2 D M + M + D) f32: [dw1 (D, M) | dw2 (M, D) | db1 | db2];
// pvec (plan[0] * 2, 2D) and pw (plan[2], 2 D M + M + D) f32 scratch for
// the warpgroups' and the splits' partials; tb (N, D), ab and hb (N, M)
// bf16 scratch for t, a and dh; plan the 7 ints of
// ops/ffd_fused.py:WgmmaPlan.bwd_ints.
extern "C" int cobevt_ffd_bwd_wgmma(
    const void* x, const void* dy, const float* gamma, const float* beta,
    const void* w1, const void* w2, const float* b1,
    void* dx, float* dvec, float* dw, float* pvec, float* pw, void* tb,
    void* ab, void* hb, long long N, int D, int M, const int* plan,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wg::shape_ok(N, D, M) || plan == nullptr || plan[0] < 1 ||
      plan[1] < 2 || plan[1] > wg::kMaxStages || plan[2] < 1 ||
      plan[2] > 65535 || plan[3] < 1 ||
      (long long)plan[2] * plan[3] * wg::kTile < N || plan[4] < 2 ||
      plan[4] > wg::kMaxStages)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(D == 256
                   ? wg::bwd<256>(x, dy, gamma, beta, w1, w2, b1, dx, dvec,
                                  dw, pvec, pw, tb, ab, hb, (int)N, M, plan,
                                  s)
                   : wg::bwd<128>(x, dy, gamma, beta, w1, w2, b1, dx, dvec,
                                  dw, pvec, pw, tb, ab, hb, (int)N, M, plan,
                                  s));
}
