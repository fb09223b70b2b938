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
// 5-term erf polynomial (_erf_f32 :28), not erff.  Products of T = bf16 run on
// the tensor cores (mma.sync m16n8k16, f32 accumulation), T = f32 as scalar
// FMAs, the sharp check against the plain version.
//
// What the TPU kernels are shaped by, and what is done here instead.  The TPU
// grid walks 960-row blocks in order with both weights resident in VMEM, and
// the backward adds its parameter gradients into output blocks that every
// grid step revisits.  Blocks of a GPU grid run together, and dw1 / dw2 (512
// KB of f32 each at D 256, M 512) pass one SM's shared memory and registers.
// So:
//
//   * K11 is one launch: a block owns 16 token rows as f32 tiles (rowops.cuh,
//     50 KB at the LiDAR width, four blocks to an SM, which hides the weight
//     loads from L2) and runs LN, both products and the residual on them.
//     N need not divide 16: the tail rows are masked.
//   * K12 is four launches behind one C entry, and saves nothing between
//     forward and backward:
//       1. bwd_rows: a persistent grid of 16-row blocks recomputes t and h,
//          forms da, dh, dt and dx, and carries the four vector gradients
//          (dgamma, dbeta, db2, db1) in shared memory over its share of row
//          blocks, one partial row per block;
//       2. bwd_weights: block (j, s) owns the 32 hidden columns j of dw1 and
//          the 32 rows j of dw2 as register accumulators and walks the 32-row
//          blocks s, s + S, ...: it recomputes t, the slice of h and da, a
//          and dh, and adds t^T dh and a^T g with the transposed fragments
//          read straight from the f32 tiles.  Over the slices this repeats
//          the LayerNorm and two of the six products (seven in all), and
//          keeps t, a and dh out of device memory.  32 rows a step keep the
//          tiles at 78 KB, two blocks to an SM: K12 takes 4.37 ms at the
//          LiDAR width where 64-row steps, one block to an SM, took 5.76 ms
//          (NVIDIA H100 80GB HBM3, 700 W, bf16);
//       3. and 4. add_partials: the S weight partials and the per-block
//          vector partials are added in a fixed order.
//     No atomics: two runs give the same bits.
//
// Bound on the H100: operations.  At N 84480, D 256, M 512 in bf16 K11 is
// 44.3 GFLOP on 86.5 MB (0.045 ms at the bf16 peak against 0.026 ms of
// bytes); K12's six products are 132.9 GFLOP on 130 MB (0.134 ms).
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

// K12, launches 3 and 4: out[i] = part[0][i] + part[1][i] + ... in order.
__global__ void add_partials_kernel(const float* __restrict__ part, int P,
                                    long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
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
  const long long nw = 2LL * D * M, nv = 3LL * D + M;
  add_partials_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, s>>>(pw, S, nw,
                                                                  dw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  add_partials_kernel<<<(unsigned)((nv + 255) / 256), 256, 0, s>>>(pvec, PA,
                                                                  nv, dvec);
  return cudaGetLastError();
}

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
