// K5: flash backward of packed window attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel cobevt_tpu/ops/window_attention.py:
// _packed_bwd_pallas (body _packed_bwd_kernel), the backward of K1
// (window_attention.cu).  Contract, as there:
//   in:  q, g (= dO), out (G, Tq, H*D); k, v (G, Tk, H*D), heads interleaved
//        in the channel axis; optional f32 bias (Tq, H*Tk) shared by all
//        windows; optional f32 key mask (G, Tk), -1e9 added where mask <= 0.
//   out: dq (G, Tq, H*D), dk, dv (G, Tk, H*D) in the input dtype, and
//        dbias (Tq, H*Tk) f32 summed over the windows.
//   f32 or bf16, D in {16, 32}, Tq and Tk multiples of 8.  No post-softmax
//   weight: that case takes the plain composite backward, as in JAX.
//
// Roundings follow the TPU body: sim = q k^T in f32, + bias, + mask;
// e = exp(sim - max) rounded to the value dtype, the per-head sum taken from
// the rounded e in f32; p32 = f32(e) * (1 / sum), the forward's weights;
// the flash rowsum s = sum_d f32(g * out), the product rounded to the input
// dtype first; da = g v^T in f32; ds32 = p32 (da - s); dq = ds k and
// dk = ds^T q with ds32 rounded to the input dtype, dv = p^T g with p32
// rounded; all three summed in f32 and rounded once; dbias = sum over
// windows of ds32.  One deliberate difference: the TPU body takes the row
// maximum over all heads of a row at once (its block-diagonal product puts
// them side by side); here it is per head, which is the same softmax and
// cannot underflow a whole head.
//
// What shaped the TPU kernel and does not carry over: it builds
// block-diagonal K/V of (H*Tk, C) to fill a 128-wide matrix unit and holds
// five (Tq, H*Tk) f32 tensors on chip per window.  Here the work is split
// per (window, head) with D = 16 or 32, in tiles of 64 queries by 64 keys,
// and every tile of sim/p/da/ds is recomputed in registers: nothing of size
// Tq x Tk touches device memory.
//
// What bounds it on the H100: five (Tq x Tk x D) products per (window,
// head) against q/k/v/g/out in and dq/dk/dv out.  At the largest CorpBEVT
// shape (G 320, 1024 x 256, bf16) that is 107 GFLOP over 419 MB, 256
// operations per byte, just under the card's ~295: the bytes bind (0.125
// ms) with the arithmetic close behind (0.109 ms); the self-attention case
// (G 5) is bound by its f32 bias and dbias bytes.  The kernel is ~17x
// above that bound: mma.sync with unpipelined shared-memory staging, and
// nine tile products where five are needed.
//
// Design: dq sums over key tiles and dk/dv sum over query tiles, so one
// block cannot own both.  Three launches, no atomics on dq/dk/dv:
//   1. stats: per (window, head, query row) the max, the sum of the rounded
//      exp (two sweeps over the keys, as the TPU body's two reductions) and
//      the flash rowsum, into a small f32 scratch (3, G, H, Tq);
//   2. dq: a block owns 64 query rows and loops over key tiles;
//   3. dk/dv: a block owns 64 keys and loops over query tiles, computing
//      the transposed tiles k q^T and v g^T directly so the keys are the
//      rows of its accumulators.
// Two passes recompute q k^T and g v^T twice; the alternative, one pass with
// f32 atomics into dq scratch, would make dq depend on the block order and
// need a zeroed f32 buffer and a cast pass.  dbias is the sum over windows,
// which on the TPU is carried from one grid step to the next; blocks here
// run in no order, so the dq kernel adds its ds32 tile into the zeroed
// dbias with f32 atomicAdd.  Each element receives G addends (16 or 5 at
// CorpBEVT) in an order that changes from run to run: dbias is reproducible
// to f32 rounding of a G-term sum (~1e-6 relative), not bit for bit.
//
//  * *_tc_kernel (bf16): tensor cores through mma.sync m16n8k16, four warps
//    of 16 rows each; accumulator fragments are repacked in registers as
//    the A operand of the next product; tiles are staged row-major for the
//    x^T products and transposed for the products that contract over the
//    tile's rows.
//  * scalar kernels (f32): one thread per row, f32 FMAs, tiles of 32 rows
//    broadcast from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskAdd = -1e9f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const void* o;
  const float* bias;  // (Tq, H*Tk) or null
  const float* mask;  // (G, Tk) or null
  float* m;           // (G, H, Tq) row max
  float* l;           // (G, H, Tq) sum of the rounded exp
  float* s;           // (G, H, Tq) flash rowsum
  void* dq;
  void* dk;
  void* dv;
  float* dbias;  // (Tq, H*Tk), zeroed by the caller; or null
  int Tq, Tk, H;
};

// ---------------------------------------------------------------------------
// f32: scalar kernels, one thread per row
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // rows a block owns, one per thread
constexpr int kStep = 32;  // rows of a streamed shared-memory tile

// stage rows [r0, r0 + kStep) of head h of x (row stride C) as f32, zeros
// past `limit`
template <int D>
__device__ __forceinline__ void stage_f32(float (*dst)[D], const float* x,
                                          size_t win_row0, int r0, int limit,
                                          int C, int h, int tid) {
  for (int i = tid; i < kStep * D; i += kRows) {
    const int j = i / D;
    const int d = i - j * D;
    dst[j][d] = (r0 + j < limit)
                    ? x[(win_row0 + r0 + j) * C + h * D + d]
                    : 0.f;
  }
}

// grid: (ceil(Tq / kRows), H, G); block: kRows threads.
template <int D>
__global__ void __launch_bounds__(kRows) stats_kernel(Args a) {
  __shared__ __align__(16) float ks[kStep][D];
  __shared__ float madd[kStep];
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const int C = a.H * D;
  const size_t HTk = (size_t)a.H * a.Tk;
  const int row = blockIdx.x * kRows + tid;
  const bool live = row < a.Tq;
  const int rc = live ? row : a.Tq - 1;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const size_t roff = ((size_t)win * a.Tq + rc) * C + h * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = q[roff + d];
  float m = -INFINITY, l = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < a.Tk; k0 += kStep) {
      __syncthreads();
      stage_f32<D>(ks, k, (size_t)win * a.Tk, k0, a.Tk, C, h, tid);
      if (tid < kStep) {
        float add = 0.f;
        if (k0 + tid >= a.Tk)
          add = -INFINITY;
        else if (a.mask != nullptr &&
                 !(a.mask[(size_t)win * a.Tk + k0 + tid] > 0.f))
          add = kMaskAdd;
        madd[tid] = add;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kStep; ++j) {
        float x = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) x = fmaf(qr[d], ks[j][d], x);
        // the TPU order: (q.k + bias) + mask
        if (a.bias != nullptr)
          x += a.bias[(size_t)rc * HTk + (size_t)h * a.Tk +
                      min(k0 + j, a.Tk - 1)];
        x += madd[j];
        if (pass == 0)
          m = fmaxf(m, x);
        else
          l += expf(x - m);
      }
    }
  }
  if (live) {
    const float* g = static_cast<const float*>(a.g);
    const float* o = static_cast<const float*>(a.o);
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(g[roff + d], o[roff + d], s);
    const size_t si = ((size_t)win * a.H + h) * a.Tq + row;
    a.m[si] = m;
    a.l[si] = l;
    a.s[si] = s;
  }
}

// grid: (ceil(Tq / kRows), H, G); block: kRows threads, one query row each.
template <int D>
__global__ void __launch_bounds__(kRows) dq_kernel(Args a) {
  __shared__ __align__(16) float ks[kStep][D];
  __shared__ __align__(16) float vs[kStep][D];
  __shared__ float madd[kStep];
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const int C = a.H * D;
  const size_t HTk = (size_t)a.H * a.Tk;
  const int row = blockIdx.x * kRows + tid;
  const bool live = row < a.Tq;
  const int rc = live ? row : a.Tq - 1;
  const size_t roff = ((size_t)win * a.Tq + rc) * C + h * D;
  const float* q = static_cast<const float*>(a.q);
  const float* g = static_cast<const float*>(a.g);

  float qr[D], gr[D], dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q[roff + d];
    gr[d] = g[roff + d];
    dq[d] = 0.f;
  }
  const size_t si = ((size_t)win * a.H + h) * a.Tq + rc;
  const float m = a.m[si];
  const float il = 1.f / a.l[si];
  const float s = a.s[si];

  for (int k0 = 0; k0 < a.Tk; k0 += kStep) {
    __syncthreads();
    stage_f32<D>(ks, static_cast<const float*>(a.k), (size_t)win * a.Tk, k0,
                 a.Tk, C, h, tid);
    stage_f32<D>(vs, static_cast<const float*>(a.v), (size_t)win * a.Tk, k0,
                 a.Tk, C, h, tid);
    if (tid < kStep) {
      float add = 0.f;
      if (k0 + tid >= a.Tk)
        add = -INFINITY;
      else if (a.mask != nullptr &&
               !(a.mask[(size_t)win * a.Tk + k0 + tid] > 0.f))
        add = kMaskAdd;
      madd[tid] = add;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kStep; ++j) {
      float x = 0.f, da = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        x = fmaf(qr[d], ks[j][d], x);
        da = fmaf(gr[d], vs[j][d], da);
      }
      const size_t bi =
          (size_t)rc * HTk + (size_t)h * a.Tk + min(k0 + j, a.Tk - 1);
      if (a.bias != nullptr) x += a.bias[bi];
      x += madd[j];
      const float p = expf(x - m) * il;  // 0 for a key past Tk
      const float ds = p * (da - s);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, ks[j][d], dq[d]);
      if (a.dbias != nullptr && live && k0 + j < a.Tk)
        atomicAdd(a.dbias + bi, ds);
    }
  }
  if (live) {
    float* out = static_cast<float*>(a.dq) + roff;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = dq[d];
  }
}

// grid: (ceil(Tk / kRows), H, G); block: kRows threads, one key each.
template <int D>
__global__ void __launch_bounds__(kRows) dkdv_kernel(Args a) {
  __shared__ __align__(16) float qs[kStep][D];
  __shared__ __align__(16) float gs[kStep][D];
  __shared__ float ms[kStep], ils[kStep], ss[kStep];
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const int C = a.H * D;
  const size_t HTk = (size_t)a.H * a.Tk;
  const int key = blockIdx.x * kRows + tid;
  const bool live = key < a.Tk;
  const int kc = live ? key : a.Tk - 1;
  const size_t koff = ((size_t)win * a.Tk + kc) * C + h * D;
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  float kr[D], vr[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = k[koff + d];
    vr[d] = v[koff + d];
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  float madd = 0.f;
  if (!live)
    madd = -INFINITY;
  else if (a.mask != nullptr && !(a.mask[(size_t)win * a.Tk + key] > 0.f))
    madd = kMaskAdd;

  for (int q0 = 0; q0 < a.Tq; q0 += kStep) {
    __syncthreads();
    stage_f32<D>(qs, static_cast<const float*>(a.q), (size_t)win * a.Tq, q0,
                 a.Tq, C, h, tid);
    stage_f32<D>(gs, static_cast<const float*>(a.g), (size_t)win * a.Tq, q0,
                 a.Tq, C, h, tid);
    if (tid < kStep) {
      const bool ql = q0 + tid < a.Tq;
      const size_t si =
          ((size_t)win * a.H + h) * a.Tq + (ql ? q0 + tid : a.Tq - 1);
      // a query past Tq adds nothing: exp(x - inf) = 0, times 0
      ms[tid] = ql ? a.m[si] : INFINITY;
      ils[tid] = ql ? 1.f / a.l[si] : 0.f;
      ss[tid] = a.s[si];
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kStep; ++i) {
      float x = 0.f, da = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        x = fmaf(kr[d], qs[i][d], x);
        da = fmaf(vr[d], gs[i][d], da);
      }
      if (a.bias != nullptr)
        x += a.bias[(size_t)min(q0 + i, a.Tq - 1) * HTk + (size_t)h * a.Tk +
                    kc];
      x += madd;
      const float p = expf(x - ms[i]) * ils[i];
      const float ds = p * (da - ss[i]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(p, gs[i][d], dv[d]);
        dk[d] = fmaf(ds, qs[i][d], dk[d]);
      }
    }
  }
  if (live) {
    float* okp = static_cast<float*>(a.dk) + koff;
    float* ovp = static_cast<float*>(a.dv) + koff;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      okp[d] = dk[d];
      ovp[d] = dv[d];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // rows a block owns = rows of a tile
constexpr int kPadT = kTile + 8;    // row of a transposed tile, halves

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage rows [0, kTile) of a tile whose row 0 starts at src (row stride ld)
// into shared memory: row-major rm[kTile][D + 8] and/or transposed
// tr[D][kPadT]; rows past `live` are zeros.
template <int D, bool kRowMajor, bool kTransposed>
__device__ __forceinline__ void stage(const bf16* src, int ld, int live,
                                      bf16* rm, bf16* tr, int tid) {
  for (int c = tid; c < kTile * D / 8; c += kThreads) {
    const int j = c / (D / 8);
    const int d = (c - j * (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (j < live) val = *reinterpret_cast<const uint4*>(src + (size_t)j * ld + d);
    if (kRowMajor) *reinterpret_cast<uint4*>(rm + j * (D + 8) + d) = val;
    if (kTransposed) {
      const bf16* h8 = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) tr[(d + i) * kPadT + j] = h8[i];
    }
  }
}

// A fragments of this thread's two rows (p0: fragment row g, p1: row g + 8);
// a dead row loads as zeros
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const bf16* p0, const bf16* p1,
                                       bool live0, bool live1, int t) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    a[kd][0] = live0 ? ld32(p0 + kd * 16 + 2 * t) : 0u;
    a[kd][1] = live1 ? ld32(p1 + kd * 16 + 2 * t) : 0u;
    a[kd][2] = live0 ? ld32(p0 + kd * 16 + 2 * t + 8) : 0u;
    a[kd][3] = live1 ? ld32(p1 + kd * 16 + 2 * t + 8) : 0u;
  }
}

// s = a x^T for the warp's 16 rows against the kTile rows of a row-major
// tile xs[kTile][D + 8]
template <int D>
__device__ __forceinline__ void product_xt(float (&s)[kTile / 8][4],
                                           const uint32_t (&a)[D / 16][4],
                                           const bf16* xs, int g, int t) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const bf16* row = xs + (j * 8 + g) * (D + 8) + kd * 16 + 2 * t;
      const uint32_t b[2] = {ld32(row), ld32(row + 8)};
      mma_bf16_16816(s[j], a[kd], b);
    }
  }
}

// acc += w x for the warp's 16 rows: w (16 x kTile) in accumulator layout,
// rounded to bf16 as A fragments; x the tile staged transposed xt[D][kPadT]
template <int D>
__device__ __forceinline__ void product_acc(float (&acc)[D / 8][4],
                                            const float (&w)[kTile / 8][4],
                                            const bf16* xt, int g, int t) {
  uint32_t pa[kTile / 16][4];
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack_bf16(w[j][0], w[j][1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(w[j][2], w[j][3]);
  }
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const bf16* row = xt + (nd * 8 + g) * kPadT + kk * 16 + 2 * t;
      const uint32_t b[2] = {ld32(row), ld32(row + 8)};
      mma_bf16_16816(acc[nd], pa[kk], b);
    }
  }
}

// (q.k + bias) + mask on a query-major tile: rows r0/r1 (clamped rc0/rc1),
// columns k0 + j*8 + 2t (+1); a key past Tk becomes -inf
__device__ __forceinline__ void add_bias_mask(float (&s)[kTile / 8][4],
                                              const Args& a, int win, int h,
                                              int rc0, int rc1, int k0,
                                              int t) {
  const size_t HTk = (size_t)a.H * a.Tk;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int key = k0 + j * 8 + 2 * t;
    if (key >= a.Tk) {  // Tk % 8 == 0: both columns are past Tk
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = -INFINITY;
      continue;
    }
    if (a.bias != nullptr) {
      const float2 b0 = *reinterpret_cast<const float2*>(
          a.bias + (size_t)rc0 * HTk + (size_t)h * a.Tk + key);
      const float2 b1 = *reinterpret_cast<const float2*>(
          a.bias + (size_t)rc1 * HTk + (size_t)h * a.Tk + key);
      s[j][0] += b0.x;
      s[j][1] += b0.y;
      s[j][2] += b1.x;
      s[j][3] += b1.y;
    }
    if (a.mask != nullptr) {
      const float* mp = a.mask + (size_t)win * a.Tk + key;
      const float a0 = (mp[0] > 0.f) ? 0.f : kMaskAdd;
      const float a1 = (mp[1] > 0.f) ? 0.f : kMaskAdd;
      s[j][0] += a0;
      s[j][1] += a1;
      s[j][2] += a0;
      s[j][3] += a1;
    }
  }
}

// write the warp's 16 accumulator rows (D wide) as bf16
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* p0, bf16* p1, bool live0,
                                           bool live1, int t) {
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    if (live0)
      *reinterpret_cast<__nv_bfloat162*>(p0 + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][0], acc[nd][1]);
    if (live1)
      *reinterpret_cast<__nv_bfloat162*>(p1 + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nd][2], acc[nd][3]);
  }
}

// grid: (ceil(Tq / kTile), H, G); block: kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads) stats_tc_kernel(Args a) {
  __shared__ __align__(16) bf16 Ks[kTile * (D + 8)];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const int C = a.H * D;
  const int r0 = blockIdx.x * kTile + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool live0 = r0 < a.Tq, live1 = r1 < a.Tq;
  const int rc0 = min(r0, a.Tq - 1), rc1 = min(r1, a.Tq - 1);
  const size_t off0 = ((size_t)win * a.Tq + rc0) * C + h * D;
  const size_t off1 = ((size_t)win * a.Tq + rc1) * C + h * D;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);

  uint32_t qa[D / 16][4];
  load_a<D>(qa, q + off0, q + off1, live0, live1, t);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < a.Tk; k0 += kTile) {
      __syncthreads();
      stage<D, true, false>(k + ((size_t)win * a.Tk + k0) * C + h * D, C,
                            a.Tk - k0, Ks, nullptr, tid);
      __syncthreads();
      float s[kTile / 8][4];
      product_xt<D>(s, qa, Ks, g, t);
      add_bias_mask(s, a, win, h, rc0, rc1, k0, t);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (pass == 0)
            m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
          else
            l[e >> 1] += rnd_bf16(__expf(s[j][e] - m[e >> 1]));
        }
      }
    }
    if (pass == 0) {
      // the four threads of a group share a row
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
        m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
      }
    }
  }
  // flash rowsum: g * out rounded to bf16 (the product of two bf16 values is
  // exact in f32, so one rounding), summed in f32 over the head's channels
  const bf16* gp = static_cast<const bf16*>(a.g);
  const bf16* op = static_cast<const bf16*>(a.o);
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const size_t off = hr ? off1 : off0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 gg = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(gp + off + i * 8 + 2 * t));
      const float2 oo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(op + off + i * 8 + 2 * t));
      s[hr] += rnd_bf16(gg.x * oo.x) + rnd_bf16(gg.y * oo.y);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 1);
    s[hr] += __shfl_xor_sync(0xffffffffu, s[hr], 2);
  }
  if (t == 0) {
    const size_t base = ((size_t)win * a.H + h) * a.Tq;
    if (live0) {
      a.m[base + r0] = m[0];
      a.l[base + r0] = l[0];
      a.s[base + r0] = s[0];
    }
    if (live1) {
      a.m[base + r1] = m[1];
      a.l[base + r1] = l[1];
      a.s[base + r1] = s[1];
    }
  }
}

// grid: (ceil(Tq / kTile), H, G); block: kThreads.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_tc_kernel(Args a) {
  __shared__ __align__(16) bf16 Ks[kTile * (D + 8)];
  __shared__ __align__(16) bf16 Vs[kTile * (D + 8)];
  __shared__ __align__(16) bf16 Kt[D * kPadT];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const int C = a.H * D;
  const size_t HTk = (size_t)a.H * a.Tk;
  const int r0 = blockIdx.x * kTile + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool live0 = r0 < a.Tq, live1 = r1 < a.Tq;
  const int rc0 = min(r0, a.Tq - 1), rc1 = min(r1, a.Tq - 1);
  const size_t off0 = ((size_t)win * a.Tq + rc0) * C + h * D;
  const size_t off1 = ((size_t)win * a.Tq + rc1) * C + h * D;
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a<D>(qa, static_cast<const bf16*>(a.q) + off0,
            static_cast<const bf16*>(a.q) + off1, live0, live1, t);
  load_a<D>(ga, static_cast<const bf16*>(a.g) + off0,
            static_cast<const bf16*>(a.g) + off1, live0, live1, t);
  const size_t sbase = ((size_t)win * a.H + h) * a.Tq;
  const float m[2] = {a.m[sbase + rc0], a.m[sbase + rc1]};
  const float il[2] = {1.f / a.l[sbase + rc0], 1.f / a.l[sbase + rc1]};
  const float rs[2] = {a.s[sbase + rc0], a.s[sbase + rc1]};

  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;

  for (int k0 = 0; k0 < a.Tk; k0 += kTile) {
    __syncthreads();
    const size_t koff = ((size_t)win * a.Tk + k0) * C + h * D;
    stage<D, true, true>(k + koff, C, a.Tk - k0, Ks, Kt, tid);
    stage<D, true, false>(v + koff, C, a.Tk - k0, Vs, nullptr, tid);
    __syncthreads();
    float s[kTile / 8][4], da[kTile / 8][4];
    product_xt<D>(s, qa, Ks, g, t);
    add_bias_mask(s, a, win, h, rc0, rc1, k0, t);
    product_xt<D>(da, ga, Vs, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = rnd_bf16(__expf(s[j][e] - m[hr])) * il[hr];
        s[j][e] = p * (da[j][e] - rs[hr]);  // ds32; 0 for a key past Tk
      }
      if (a.dbias != nullptr) {
        const int key = k0 + j * 8 + 2 * t;
        if (key < a.Tk) {
          if (live0) {
            float* d0 = a.dbias + (size_t)r0 * HTk + (size_t)h * a.Tk + key;
            atomicAdd(d0, s[j][0]);
            atomicAdd(d0 + 1, s[j][1]);
          }
          if (live1) {
            float* d1 = a.dbias + (size_t)r1 * HTk + (size_t)h * a.Tk + key;
            atomicAdd(d1, s[j][2]);
            atomicAdd(d1 + 1, s[j][3]);
          }
        }
      }
    }
    product_acc<D>(dq, s, Kt, g, t);  // dq += bf16(ds32) k
  }
  store_rows<D>(dq, static_cast<bf16*>(a.dq) + off0,
                static_cast<bf16*>(a.dq) + off1, live0, live1, t);
}

// grid: (ceil(Tk / kTile), H, G); block: kThreads.  The warp's 16 rows are
// keys; the streamed tiles are queries.
template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_tc_kernel(Args a) {
  __shared__ __align__(16) bf16 Qs[kTile * (D + 8)];
  __shared__ __align__(16) bf16 Gs[kTile * (D + 8)];
  __shared__ __align__(16) bf16 Qt[D * kPadT];
  __shared__ __align__(16) bf16 Gt[D * kPadT];
  __shared__ float ms[kTile], ils[kTile], ss[kTile];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int win = blockIdx.z;
  const int C = a.H * D;
  const size_t HTk = (size_t)a.H * a.Tk;
  const int c0 = blockIdx.x * kTile + warp * 16 + g;
  const int c1 = c0 + 8;
  const bool live0 = c0 < a.Tk, live1 = c1 < a.Tk;
  const int cc0 = min(c0, a.Tk - 1), cc1 = min(c1, a.Tk - 1);
  const size_t off0 = ((size_t)win * a.Tk + cc0) * C + h * D;
  const size_t off1 = ((size_t)win * a.Tk + cc1) * C + h * D;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* gp = static_cast<const bf16*>(a.g);

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, static_cast<const bf16*>(a.k) + off0,
            static_cast<const bf16*>(a.k) + off1, live0, live1, t);
  load_a<D>(va, static_cast<const bf16*>(a.v) + off0,
            static_cast<const bf16*>(a.v) + off1, live0, live1, t);
  // additive key mask of this thread's two keys; a key past Tk gets -inf
  float madd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bool live = hr ? live1 : live0;
    const int key = hr ? cc1 : cc0;
    madd[hr] = 0.f;
    if (!live)
      madd[hr] = -INFINITY;
    else if (a.mask != nullptr && !(a.mask[(size_t)win * a.Tk + key] > 0.f))
      madd[hr] = kMaskAdd;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  const size_t sbase = ((size_t)win * a.H + h) * a.Tq;
  for (int q0 = 0; q0 < a.Tq; q0 += kTile) {
    __syncthreads();
    const size_t qoff = ((size_t)win * a.Tq + q0) * C + h * D;
    stage<D, true, true>(q + qoff, C, a.Tq - q0, Qs, Qt, tid);
    stage<D, true, true>(gp + qoff, C, a.Tq - q0, Gs, Gt, tid);
    if (tid < kTile) {
      const bool ql = q0 + tid < a.Tq;
      const size_t si = sbase + (ql ? q0 + tid : a.Tq - 1);
      // a query past Tq adds nothing: exp(x - inf) = 0, times 0
      ms[tid] = ql ? a.m[si] : INFINITY;
      ils[tid] = ql ? 1.f / a.l[si] : 0.f;
      ss[tid] = a.s[si];
    }
    __syncthreads();
    float st[kTile / 8][4], dat[kTile / 8][4];
    product_xt<D>(st, ka, Qs, g, t);    // (k q^T): rows keys, columns queries
    product_xt<D>(dat, va, Gs, g, t);   // (v g^T)
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int qi = j * 8 + 2 * t + (e & 1);
        float x = st[j][e];
        if (a.bias != nullptr)
          x += a.bias[(size_t)min(q0 + qi, a.Tq - 1) * HTk +
                      (size_t)h * a.Tk + (hr ? cc1 : cc0)];
        x += madd[hr];
        const float p = rnd_bf16(__expf(x - ms[qi])) * ils[qi];
        st[j][e] = p;                            // p32
        dat[j][e] = p * (dat[j][e] - ss[qi]);    // ds32
      }
    }
    product_acc<D>(dv, st, Gt, g, t);   // dv += bf16(p32)^T g
    product_acc<D>(dk, dat, Qt, g, t);  // dk += bf16(ds32)^T q
  }
  store_rows<D>(dk, static_cast<bf16*>(a.dk) + off0,
                static_cast<bf16*>(a.dk) + off1, live0, live1, t);
  store_rows<D>(dv, static_cast<bf16*>(a.dv) + off0,
                static_cast<bf16*>(a.dv) + off1, live0, live1, t);
}

template <int D>
cudaError_t launch_all(const Args& a, int G, bool is_bf16, cudaStream_t s) {
  const int rows = is_bf16 ? kTile : kRows;
  const dim3 grid_q((a.Tq + rows - 1) / rows, a.H, G);
  const dim3 grid_k((a.Tk + rows - 1) / rows, a.H, G);
  if (is_bf16) {
    stats_tc_kernel<D><<<grid_q, kThreads, 0, s>>>(a);
    dq_tc_kernel<D><<<grid_q, kThreads, 0, s>>>(a);
    dkdv_tc_kernel<D><<<grid_k, kThreads, 0, s>>>(a);
  } else {
    stats_kernel<D><<<grid_q, kRows, 0, s>>>(a);
    dq_kernel<D><<<grid_q, kRows, 0, s>>>(a);
    dkdv_kernel<D><<<grid_k, kRows, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  bias, mask and dbias may be null
// (dbias exactly when bias is); dbias must be zeroed; stats is an f32
// scratch of 3 * G * H * Tq values.  Returns the cudaError_t of the launches
// (0 on success).
extern "C" int cobevt_window_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* o,
    const void* bias, const void* mask, void* stats, void* dq, void* dk,
    void* dv, void* dbias, int G, int Tq, int Tk, int H, int D, int is_bf16,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || G > 65535 || H > 65535 ||
      Tq % 8 || Tk % 8 || (bias == nullptr) != (dbias == nullptr))
    return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(stats);
  const size_t n = (size_t)G * H * Tq;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.o = o;
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.m = st;
  a.l = st + n;
  a.s = st + 2 * n;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias = static_cast<float*>(dbias);
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32)
    err = launch_all<32>(a, G, is_bf16 != 0, s);
  else if (D == 16)
    err = launch_all<16>(a, G, is_bf16 != 0, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
