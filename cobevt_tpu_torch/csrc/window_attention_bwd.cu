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
//   f32 or bf16, D in {16, 32}, any Tq >= 1 (the nuScenes windows of 100
//   and 625 queries included), Tk a multiple of 8.  No post-softmax weight:
//   that case takes the plain composite backward, as in JAX.  The row
//   statistics scratch is (3, G, H, ldst) f32, the pitch ldst >= Tq a
//   multiple of 4 given by the caller (ops/window_attention.py:stats_pitch),
//   so every (window, head) row starts on 16 bytes, as TMA's strides must;
//   K1 writes it at the same pitch.
//
// Rows past Tq: the q, g and out maps are 4D (D, H, T, G), so TMA
// zero-fills a tile's rows past Tq and never reads the next window's; their
// statistics read 0 (K1 and launch 1 never write them, the statistics map
// is cut at Tq and zero-fills), so p = bf16(exp2(0 - 0)) * 0 = 0 exactly,
// and ds = 0 * (0 - 0): they add nothing to dk, dv or dbias, and their dq
// is never stored.
//
// Roundings follow the TPU body: sim = q k^T in f32, + bias, + mask;
// e = exp(sim - max) rounded to the value dtype, the per-head sum taken from
// the rounded e in f32; p32 = f32(e) * (1 / sum), the forward's weights;
// the flash rowsum s = sum_d f32(g * out), the product rounded to the input
// dtype first; da = g v^T in f32; ds32 = p32 (da - s); dq = ds k and
// dk = ds^T q with ds32 rounded to the input dtype, dv = p^T g with p32
// rounded; all three summed in f32 and rounded once; dbias = sum over
// windows of ds32.  Two deliberate differences: the TPU body takes the row
// maximum over all heads of a row at once (its block-diagonal product puts
// them side by side), here it is per head, which is the same softmax and
// cannot underflow a whole head; and the bf16 kernels take the sum of the
// rounded e in one sweep with an online maximum, so a term met before the
// row's maximum was known is rounded at the running maximum and rescaled:
// each term of the sum may differ from the TPU body's by one bf16 ulp of
// itself (the plain version and the f32 kernels round at the final max).
//
// What shaped the TPU kernel and does not carry over: it builds
// block-diagonal K/V of (H*Tk, C) to fill a 128-wide matrix unit and holds
// five (Tq, H*Tk) f32 tensors on chip per window.  Here the work is split
// per (window, head) with D = 16 or 32, in tiles of 64 queries by 64 keys,
// and every tile of sim/p/da/ds is recomputed in registers: nothing of size
// Tq x Tk touches device memory.
//
// What bounds it on the H100: five (Tq x Tk x D) products per (window,
// head) against q/k/v/g/out in and dq/dk/dv out (plus the f32 bias, dbias
// and mask).  By path shape (bf16, D 32): fax_local_stage0 (G 320,
// 1024 x 256, 4 heads) 419 MB / 107 GFLOP, the bytes bind at 0.125 ms;
// fax_grid_stage0 (320, 256^2) 0.050 ms, fax_stage1 (80, 256^2) 0.013 ms
// and fusion (16, 320^2, bias, mask) 0.004 ms, bytes; fax_stage2 (5,
// 1024^2) 6.7 GFLOP, the operations bind at 0.007 ms; lidar_fusion (264,
// 320^2, 8 heads, bias, mask) 352 MB, bytes, 0.105 ms; the nuScenes train
// step at B 8 (bias- and mask-free): stage 0 local (G 800, 600 x 432, 1
// head) 66 GFLOP / 211 MB, operations at 0.067 ms; stage 0 grid (800, 100
// x 432) 0.033 ms and stage 1 (200, 100 x 432, 2 heads) 0.016, bytes; stage
// 2 (8, 625 x 2,520, 4 heads) 16 GFLOP, operations at 0.016.  With D 32 each
// score costs 64 operations of a product but one exp and some ten f32
// operations of the softmax, so, as in K1, the exp and the f32 arithmetic,
// not the tensor cores, set the pace once the loads are hidden: the design
// counts exps and f32 operations per score as much as products.
//
// Design (bf16): dq sums over key tiles and dk/dv sum over query tiles, so
// one block cannot own both.  Two launches, no atomics on dq/dk/dv; both in
// the idiom of K1's window_attention_wgmma_kernel: one warpgroup a block,
// operands staged by TMA with mbarrier completion, thread 0 refilling a
// ring stage once the warpgroup is past it, every product a wgmma
// (m64n64k16 from shared memory for the score-shaped tiles, m64n{32,16}k16
// with the probabilities as register A fragments for the D-wide sums):
//   1. bwd_dq_kernel: a block owns 64 query rows of one (window, head),
//      keeps q and g in shared memory and sweeps the key tiles.  The stats
//      sweep forms S = q k^T and keeps the row maximum and the sum of the
//      rounded exp online (one product); the dq sweep forms S and
//      dA = g v^T, then ds and dq += bf16(ds) k (three products).  It writes
//      the row statistics (max * log2(e), 1 / sum, the flash rowsum) to a
//      small f32 scratch (3, G, H, Tq) for launch 2.  On the training path
//      K1's forward has already written the first two planes
//      (window_attention.cu, the same arithmetic in the same order), and the
//      kernel skips its stats sweep (stats_ready).
//   2. bwd_dkdv_kernel: a block owns 64 keys of one (window, head), keeps
//      k and v in shared memory and streams q, g, the statistics and the
//      bias tile of every query tile: S^T = k q^T and dA^T = v g^T, then
//      dv += bf16(p)^T g and dk += bf16(ds)^T q (four products).  The keys
//      are the rows of its accumulators, so P^T and dS^T are register A
//      fragments as K1's P is.
// Products per (query tile, key tile): seven on the training path, where
// K1 wrote the statistics, and eight for a backward called alone (the TPU
// body's: nine; five are the least: S, dA, dq, dk, dv); exps per score: two,
// and three alone.  dbias is the sum over windows of ds32, which on the TPU
// is carried from one grid step to the next; blocks here run in no order,
// and G blocks adding into one dbias entry would make its bits depend on
// their order.  So, with a bias, a third launch owns dbias:
//   3. bwd_dbias_kernel: a block owns a 64 x 64 tile of dbias (query tile,
//      head, key tile) in registers and walks a chunk of `wpc` consecutive
//      windows in order, forming S and dA again (two more products a tile
//      and window, nine in all) and ds32 from launch 1's statistics by
//      launch 1's arithmetic; each chunk's tile goes to its slot of an f32
//      partial buffer (P, Tq, H*Tk), and partials::add sums the P slots in
//      order.  No entry has two writers and every sum has a fixed order, so
//      dbias, like dq, dk and dv, repeats bit for bit.  P fills one wave of
//      four blocks an SM (ops/window_attention.py:dbias_plan): 2 chunks of
//      132 windows at the LiDAR shape, 4 of 4 at the camera fusion shape,
//      6.6 MB of partials each; with P 1 the tile goes to dbias directly.
//
// f32: scalar kernels, one thread per row, three launches (statistics in
// two sweeps, dq, dk/dv); the sharp check against the plain version.  Its
// dq blocks walk chunks of windows and add ds32 into the chunk's slot, each
// entry by the one thread that owns it in every window (one thread's
// operations on one address apply in program order), then partials::add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "partials.cuh"

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
  float* m;           // (G, H, ldst) row max
  float* l;           // (G, H, ldst) sum of the rounded exp
  float* s;           // (G, H, ldst) flash rowsum
  void* dq;
  void* dk;
  void* dv;
  float* dbias;  // the (P, Tq, H*Tk) partials (chunk p's slot); or null
  int Tq, Tk, H;
  int ldst;      // the statistics' row pitch, Tq rounded up to 4
  int wpc;       // windows a chunk
};

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
    const size_t si = ((size_t)win * a.H + h) * a.ldst + row;
    a.m[si] = m;
    a.l[si] = l;
    a.s[si] = s;
  }
}

// grid: (ceil(Tq / kRows), H, P chunks); block: kRows threads, one query
// row each, walking the windows of its chunk in order; ds goes into the
// chunk's dbias slot (stored by the first window, added by the later ones
// through the owning thread's own reductions, in window order).
template <int D>
__global__ void __launch_bounds__(kRows) dq_kernel(Args a, int G) {
  __shared__ __align__(16) float ks[kStep][D];
  __shared__ __align__(16) float vs[kStep][D];
  __shared__ float madd[kStep];
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int C = a.H * D;
  const size_t HTk = (size_t)a.H * a.Tk;
  const int row = blockIdx.x * kRows + tid;
  const bool live = row < a.Tq;
  const int rc = live ? row : a.Tq - 1;
  const int win0 = blockIdx.z * a.wpc;
  const int win1 = min(win0 + a.wpc, G);
  float* slot = a.dbias != nullptr
                    ? a.dbias + (size_t)blockIdx.z * a.Tq * HTk
                    : nullptr;
  for (int win = win0; win < win1; ++win) {
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
    const size_t si = ((size_t)win * a.H + h) * a.ldst + rc;
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
        if (slot != nullptr && live && k0 + j < a.Tk) {
          if (win == win0)
            slot[bi] = ds;
          else
            atomicAdd(slot + bi, ds);   // this thread's entry, window order
        }
      }
    }
    if (live) {
      float* out = static_cast<float*>(a.dq) + roff;
#pragma unroll
      for (int d = 0; d < D; ++d) out[d] = dq[d];
    }
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
          ((size_t)win * a.H + h) * a.ldst + (ql ? q0 + tid : a.Tq - 1);
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
// bf16: wgmma + TMA kernels
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kWgRows = 64;      // rows a block owns, and rows of a tile
constexpr int kMaxStages = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqBlocksPerSm = 4;   // kFed (K1 wrote the row statistics)
                                    // compiles the statistics sweep out
constexpr int kDkvBlocksPerSm = 3;
constexpr int kDbiasBlocksPerSm = 4;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__host__ __device__ inline int round1024(int b) { return (b + 1023) & ~1023; }

// Shared-memory plan of a block, the same on host and device: the block's
// own two tiles (q, g or k, v), then `stages` ring stages of [x | y | stats
// | bias | mask] (x, y: the streamed tiles), every part aligned to 1024
// bytes (the largest swizzle repeat), then the barriers.
struct BwdPlan {
  int tile_bytes, stats_bytes, bias_bytes, mask_bytes, stage_bytes;
  int stages, bar_off, smem_bytes;
};

__host__ __device__ inline BwdPlan bwd_plan(int D, bool stats, bool bias,
                                            bool mask, int stages) {
  BwdPlan p;
  p.tile_bytes = round1024(kWgRows * D * 2);
  p.stats_bytes = stats ? 1024 : 0;            // 3 x 64 f32
  p.bias_bytes = bias ? 2 * kWgRows * 128 : 0;  // two 32-key f32 boxes
  p.mask_bytes = mask ? 1024 : 0;               // 64 f32
  p.stage_bytes = 2 * p.tile_bytes + p.stats_bytes + p.bias_bytes +
                  p.mask_bytes;
  p.stages = stages;
  p.bar_off = 2 * p.tile_bytes + stages * p.stage_bytes;
  p.smem_bytes = 1024 + p.bar_off + (1 + kMaxStages) * 8;
  return p;
}

// ring depth: as many stages, 2 .. 4, as keep `per_sm` blocks on an SM
// (each block also holds 1 KB of the SM's 228 KB for the system)
inline int bwd_stages(int D, bool stats, bool bias, bool mask, int per_sm) {
  const int budget = 228 * 1024 / per_sm - 1024;
  const BwdPlan one = bwd_plan(D, stats, bias, mask, 1);
  const int stages = (budget - (one.smem_bytes - one.stage_bytes)) /
                     one.stage_bytes;
  return stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
}

struct BwdArgs {
  const bf16* g;      // (G, Tq, C): the flash rowsum's operands
  const bf16* o;
  float* stats;       // (3, G, H, ldst): max * log2(e), 1 / sum, rowsum
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dbias;       // the (P, Tq, H*Tk) partials; or null
  float* dbias_out;   // (Tq, H*Tk): the partials' ordered sum (may be dbias)
  const float* mask;  // (G, Tk) or null
  int G, Tq, Tk, H, stages, has_bias, has_mask;
  int ldst;           // the statistics' row pitch, Tq rounded up to 4
  int wpc;            // windows a chunk (a dbias block walks them in order)
  int stats_ready;    // the first two planes of stats came from K1
};

// Element (row r, key column cc < 32) of a 64-row x 32-key f32 bias box in
// the 128B-swizzled layout TMA writes.
__device__ __forceinline__ const float* bias_at(const uint8_t* box, int r,
                                                int cc) {
  return reinterpret_cast<const float*>(
      box + r * 128 + ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2)));
}

// Launch 1.  grid: G * H * ceil(Tq / 64) blocks of one warpgroup, query
// tiles fastest, windows slowest.  Maps (boxes of dispatch_wgmma): q, g,
// k, v as 4D (D, H, T, G), boxes of 64 rows x D, 64B (D 32) or 32B (D 16)
// swizzle; bias as 3D (Tk, H, Tq), boxes of 32 keys x 64 rows, f32, 128B
// swizzle; mask as (Tk, G), boxes of 64 keys.
template <int D, bool kFed>
__global__ void __launch_bounds__(128, kDqBlocksPerSm)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap bmap,
                  const __grid_constant__ CUtensorMap mmap, BwdArgs a) {
  using namespace hopper;
  constexpr Swizzle kSw = D == 32 ? kSwizzle64 : kSwizzle32;
  constexpr uint32_t kRowBytes = D * 2;   // one row: the swizzle span
  const BwdPlan plan = bwd_plan(D, false, a.has_bias, a.has_mask, a.stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* g_s = smem + plan.tile_bytes;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + plan.bar_off);
  uint64_t* full = own + 1;
  auto stage_ptr = [&](int s) {
    return smem + 2 * plan.tile_bytes + s * plan.stage_bytes;
  };

  const int QT = (a.Tq + kWgRows - 1) / kWgRows;
  const int KT = (a.Tk + kWgRows - 1) / kWgRows;
  int b = blockIdx.x;
  const int qt = b % QT;
  b /= QT;
  const int h = b % a.H;
  const int win = b / a.H;
  const int q0 = qt * kWgRows;
  // the stats sweep (unless K1 wrote the statistics), then the dq sweep
  const int first = kFed ? KT : 0;
  const int steps = 2 * KT - first;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // step n: key tile (first + n) % KT of sweep (first + n) / KT (k alone,
  // then k and v)
  auto load_step = [&](int n) {
    const int s = n % a.stages;
    const int k0 = ((first + n) % KT) * kWgRows;
    const bool with_v = first + n >= KT;
    uint8_t* st = stage_ptr(s);
    mbar_arrive_expect_tx(&full[s], (with_v ? 2 : 1) * kWgRows * D * 2 +
                                        plan.bias_bytes +
                                        (a.has_mask ? kWgRows * 4 : 0));
    tma_load_4d(st, &kmap, &full[s], 0, h, k0, win);
    if (with_v) tma_load_4d(st + plan.tile_bytes, &vmap, &full[s], 0, h, k0,
                            win);
    uint8_t* part = st + 2 * plan.tile_bytes;
    if (a.has_bias) {
      for (int sb = 0; sb < 2; ++sb)
        tma_load_3d(part + sb * kWgRows * 128, &bmap, &full[s], k0 + 32 * sb,
                    h, q0);
      part += plan.bias_bytes;
    }
    if (a.has_mask) tma_load_2d(part, &mmap, &full[s], k0, win);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(own, 2 * kWgRows * D * 2);
    tma_load_4d(q_s, &qmap, own, 0, h, q0, win);
    tma_load_4d(g_s, &gmap, own, 0, h, q0, win);
    for (int n = 0; n < a.stages && n < steps; ++n) load_step(n);
  }

  // this thread's rows rl[0], rl[1] (accumulator rows gq, gq + 8 of its
  // warp), key columns 8j + 2t and 8j + 2t + 1 of each 64-key tile
  const int gq = lane >> 2, t = lane & 3;
  const int rl[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  const int C = a.H * D;

  // flash rowsum: g * out rounded to bf16 (the product of two bf16 values
  // is exact in f32, so one rounding), summed in f32 over the head
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + rl[hr];
    if (row >= a.Tq) continue;
    const size_t off = ((size_t)win * a.Tq + row) * C + h * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 gg = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.g + off + i * 8 + 2 * t));
      const float2 oo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.o + off + i * 8 + 2 * t));
      rs[hr] += rnd_bf16(gg.x * oo.x) + rnd_bf16(gg.y * oo.y);
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
  }

  mbar_wait(own, 0);
  const uint64_t desc_q = make_desc(q_s, 8 * kRowBytes, kSw);
  const uint64_t desc_g = make_desc(g_s, 8 * kRowBytes, kSw);

  // running maximum, and it times log2(e) as the exps subtract it: the
  // rescale takes the difference of the rounded products, so a fully masked
  // row (scores near -1e9) rescales by exactly what its exps moved
  float m_run[2] = {-INFINITY, -INFINITY};
  float ml_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f};
  const size_t per = (size_t)a.G * a.H * a.ldst;
  const size_t row0_i = ((size_t)win * a.H + h) * a.ldst + q0;
  if (kFed) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (q0 + rl[hr] < a.Tq) {   // a row past Tq keeps 0: it adds nothing
        ml_run[hr] = a.stats[row0_i + rl[hr]];
        il[hr] = a.stats[per + row0_i + rl[hr]];
      } else {
        ml_run[hr] = 0.f;
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (q0 + rl[hr] < a.Tq) a.stats[2 * per + row0_i + rl[hr]] = rs[hr];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int n = 0; n < steps; ++n) {
    const int s = n % a.stages;
    mbar_wait(&full[s], (n / a.stages) & 1);
    uint8_t* st = stage_ptr(s);
    const uint8_t* bias_s = st + 2 * plan.tile_bytes;
    const float* mask_s =
        reinterpret_cast<const float*>(bias_s + plan.bias_bytes);
    const int k0 = ((first + n) % KT) * kWgRows;
    const bool dq_sweep = kFed || first + n >= KT;

    // S = q k^T; in the dq sweep also dA = g v^T
    float sc[32], da[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = da[i] = 0.f;
    const uint64_t desc_k = make_desc(st, 8 * kRowBytes, kSw);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_m64n64k16_ss(sc, desc_add(desc_q, 32 * kd),
                         desc_add(desc_k, 32 * kd), 1);
    if (dq_sweep) {
      const uint64_t desc_v =
          make_desc(st + plan.tile_bytes, 8 * kRowBytes, kSw);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        wgmma_m64n64k16_ss(da, desc_add(desc_g, 32 * kd),
                           desc_add(desc_v, 32 * kd), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(da);

    // (q.k + bias) + mask; keys past Tk get -inf
#pragma unroll
    for (int j = 0; j < kWgRows / 8; ++j) {
      const int c = 8 * j + 2 * t;    // columns c, c + 1 of the tile
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x0 = sc[4 * j + 2 * hr], x1 = sc[4 * j + 2 * hr + 1];
        if (k0 + c < a.Tk) {
          if (a.has_bias) {
            const float2 bb = *reinterpret_cast<const float2*>(
                bias_at(bias_s + (c >> 5) * kWgRows * 128, rl[hr], c & 31));
            x0 += bb.x;
            x1 += bb.y;
          }
          if (a.has_mask) {
            const float2 mm = *reinterpret_cast<const float2*>(mask_s + c);
            if (!(mm.x > 0.f)) x0 += kMaskAdd;
            if (!(mm.y > 0.f)) x1 += kMaskAdd;
          }
        } else {
          x0 = x1 = -INFINITY;   // Tk % 8 == 0: both columns are past Tk
        }
        sc[4 * j + 2 * hr] = x0;
        sc[4 * j + 2 * hr + 1] = x1;
      }
    }

    if (!dq_sweep) {
      // online maximum; the sum of the exp rounded to bf16 at it
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // the four threads of a group share the row
        tile_max[hr] = fmaxf(tile_max[hr],
                             __shfl_xor_sync(0xffffffffu, tile_max[hr], 1));
        tile_max[hr] = fmaxf(tile_max[hr],
                             __shfl_xor_sync(0xffffffffu, tile_max[hr], 2));
        const float m_new = fmaxf(m_run[hr], tile_max[hr]);  // finite
        const float ml_new = m_new * kLog2e;
        l_run[hr] *= exp2f(ml_run[hr] - ml_new);   // 0 at the first tile
        m_run[hr] = m_new;
        ml_run[hr] = ml_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hr = (i >> 1) & 1;
        l_run[hr] += rnd_bf16(exp2f(fmaf(sc[i], kLog2e, -ml_run[hr])));
      }
      if (n == KT - 1) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
          l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
          il[hr] = 1.f / l_run[hr];
          if (t == 0 && q0 + rl[hr] < a.Tq) {
            a.stats[row0_i + rl[hr]] = ml_run[hr];
            a.stats[per + row0_i + rl[hr]] = il[hr];
          }
        }
      }
    } else {
      // ds32 = p32 (dA - s) with p32 = bf16(exp) / sum; bf16(ds32) as the
      // A fragments of dq += ds k (launch 3 forms ds32 again for dbias)
      uint32_t pa[kWgRows / 16][4];
#pragma unroll
      for (int j = 0; j < kWgRows / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          const float p =
              rnd_bf16(exp2f(fmaf(sc[4 * j + e], kLog2e, -ml_run[hr]))) *
              il[hr];
          ds[e] = p * (da[4 * j + e] - rs[hr]);   // 0 for a key past Tk
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // k read in place as the MN-major B operand
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk) {
        if constexpr (D == 32)
          wgmma_m64n32k16_rs_mn(acc, pa[kk],
                                desc_add(desc_k, 16 * kRowBytes * kk), 1);
        else
          wgmma_m64n16k16_rs_mn(acc, pa[kk],
                                desc_add(desc_k, 16 * kRowBytes * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // every warp is past stage s: refill it with the step `stages` ahead
    if (n + a.stages < steps) {
      __syncthreads();
      if (tid == 0) load_step(n + a.stages);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + rl[hr];
    if (row >= a.Tq) continue;
    bf16* op = a.dq + ((size_t)win * a.Tq + row) * C + h * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(op + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * nd + 2 * hr],
                                acc[4 * nd + 2 * hr + 1]);
  }
}

// Launch 2.  grid: G * H * ceil(Tk / 64) blocks of one warpgroup, key
// tiles fastest, windows slowest.  Maps as launch 1, and the statistics as
// 3D (Tq, G*H, 3) f32 with rows ldst floats apart, boxes of 64 queries x
// 1 x 3, zero-filled past Tq.  The accumulator rows
// are this block's keys, the columns a tile's queries.
template <int D>
__global__ void __launch_bounds__(128, kDkvBlocksPerSm)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap smap, BwdArgs a) {
  using namespace hopper;
  constexpr Swizzle kSw = D == 32 ? kSwizzle64 : kSwizzle32;
  constexpr uint32_t kRowBytes = D * 2;
  const BwdPlan plan = bwd_plan(D, true, a.has_bias, false, a.stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + plan.tile_bytes;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + plan.bar_off);
  uint64_t* full = own + 1;
  auto stage_ptr = [&](int s) {
    return smem + 2 * plan.tile_bytes + s * plan.stage_bytes;
  };

  const int KT = (a.Tk + kWgRows - 1) / kWgRows;
  const int QT = (a.Tq + kWgRows - 1) / kWgRows;
  int b = blockIdx.x;
  const int kt = b % KT;
  b /= KT;
  const int h = b % a.H;
  const int win = b / a.H;
  const int k0 = kt * kWgRows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto load_step = [&](int n) {
    const int s = n % a.stages;
    const int q0 = n * kWgRows;
    uint8_t* st = stage_ptr(s);
    mbar_arrive_expect_tx(&full[s], 2 * kWgRows * D * 2 + 3 * kWgRows * 4 +
                                        plan.bias_bytes);
    tma_load_4d(st, &qmap, &full[s], 0, h, q0, win);
    tma_load_4d(st + plan.tile_bytes, &gmap, &full[s], 0, h, q0, win);
    tma_load_3d(st + 2 * plan.tile_bytes, &smap, &full[s], q0, win * a.H + h,
                0);
    if (a.has_bias) {
      uint8_t* part = st + 2 * plan.tile_bytes + plan.stats_bytes;
      for (int sb = 0; sb < 2; ++sb)
        tma_load_3d(part + sb * kWgRows * 128, &bmap, &full[s], k0 + 32 * sb,
                    h, q0);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(own, 2 * kWgRows * D * 2);
    tma_load_4d(k_s, &kmap, own, 0, h, k0, win);
    tma_load_4d(v_s, &vmap, own, 0, h, k0, win);
    for (int n = 0; n < a.stages && n < QT; ++n) load_step(n);
  }

  // this thread's keys rl[0], rl[1] of the block, query columns 8j + 2t
  // and 8j + 2t + 1 of each 64-query tile
  const int gq = lane >> 2, t = lane & 3;
  const int rl[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  float madd[2] = {0.f, 0.f};
  if (a.has_mask) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = k0 + rl[hr];
      if (key < a.Tk && !(a.mask[(size_t)win * a.Tk + key] > 0.f))
        madd[hr] = kMaskAdd;
    }
  }

  mbar_wait(own, 0);
  const uint64_t desc_kk = make_desc(k_s, 8 * kRowBytes, kSw);
  const uint64_t desc_vv = make_desc(v_s, 8 * kRowBytes, kSw);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int n = 0; n < QT; ++n) {
    const int s = n % a.stages;
    mbar_wait(&full[s], (n / a.stages) & 1);
    uint8_t* st = stage_ptr(s);
    const float* stats_s =
        reinterpret_cast<const float*>(st + 2 * plan.tile_bytes);
    const uint8_t* bias_s = st + 2 * plan.tile_bytes + plan.stats_bytes;
    const uint64_t desc_q = make_desc(st, 8 * kRowBytes, kSw);
    const uint64_t desc_g = make_desc(st + plan.tile_bytes, 8 * kRowBytes,
                                      kSw);

    // S^T = k q^T and dA^T = v g^T: rows keys, columns queries
    float sc[32], da[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = da[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_m64n64k16_ss(sc, desc_add(desc_kk, 32 * kd),
                         desc_add(desc_q, 32 * kd), 1);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_m64n64k16_ss(da, desc_add(desc_vv, 32 * kd),
                         desc_add(desc_g, 32 * kd), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(da);

    // p32 = bf16(exp(x - max)) / sum, ds32 = p32 (dA - s); a query past Tq
    // has 1 / sum = 0 from TMA's zero fill, so it adds nothing
    uint32_t pa[kWgRows / 16][4], sa[kWgRows / 16][4];
#pragma unroll
    for (int j = 0; j < kWgRows / 8; ++j) {
      const int c = 8 * j + 2 * t;   // query columns c, c + 1
      const float2 ml = *reinterpret_cast<const float2*>(stats_s + c);
      const float2 li = *reinterpret_cast<const float2*>(stats_s + 64 + c);
      const float2 rr = *reinterpret_cast<const float2*>(stats_s + 128 + c);
      float p[4], ds[4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x0 = sc[4 * j + 2 * hr], x1 = sc[4 * j + 2 * hr + 1];
        if (a.has_bias) {
          const int r = rl[hr];
          const uint8_t* box = bias_s + (r >> 5) * kWgRows * 128;
          x0 += *bias_at(box, c, r & 31);
          x1 += *bias_at(box, c + 1, r & 31);
        }
        x0 += madd[hr];
        x1 += madd[hr];
        p[2 * hr] = rnd_bf16(exp2f(fmaf(x0, kLog2e, -ml.x))) * li.x;
        p[2 * hr + 1] = rnd_bf16(exp2f(fmaf(x1, kLog2e, -ml.y))) * li.y;
        ds[2 * hr] = p[2 * hr] * (da[4 * j + 2 * hr] - rr.x);
        ds[2 * hr + 1] = p[2 * hr + 1] * (da[4 * j + 2 * hr + 1] - rr.y);
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      sa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      sa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dv += P^T g and dk += dS^T q, g and q read in place as MN-major B
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) {
      if constexpr (D == 32) {
        wgmma_m64n32k16_rs_mn(dv, pa[kk],
                              desc_add(desc_g, 16 * kRowBytes * kk), 1);
        wgmma_m64n32k16_rs_mn(dk, sa[kk],
                              desc_add(desc_q, 16 * kRowBytes * kk), 1);
      } else {
        wgmma_m64n16k16_rs_mn(dv, pa[kk],
                              desc_add(desc_g, 16 * kRowBytes * kk), 1);
        wgmma_m64n16k16_rs_mn(dk, sa[kk],
                              desc_add(desc_q, 16 * kRowBytes * kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (n + a.stages < QT) {
      __syncthreads();
      if (tid == 0) load_step(n + a.stages);
    }
  }

  const int C = a.H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = k0 + rl[hr];
    if (key >= a.Tk) continue;
    const size_t off = ((size_t)win * a.Tk + key) * C + h * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[4 * nd + 2 * hr], dk[4 * nd + 2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[4 * nd + 2 * hr], dv[4 * nd + 2 * hr + 1]);
    }
  }
}

// Launch 3, with a bias: dbias.  grid: P * H * QT * KT blocks of one
// warpgroup, key tiles fastest, then query tiles, heads, and the P chunks
// of `wpc` windows slowest (ops/window_attention.py:dbias_plan).  The
// block owns the 64 x 64 dbias tile (query tile, head, key tile) in
// registers and walks its chunk's windows in order: per window S = q k^T
// and dA = g v^T again (two products), ds32 = p32 (dA - rowsum) from the
// statistics launch 1 used, by launch 1's arithmetic, and tile += ds32.
// Then it stores the tile into its chunk's slot of the (P, Tq, H*Tk)
// partials (into dbias itself when P is 1).  Shared memory: the two bias
// boxes of the tile, loaded once, then `stages` ring stages of [q | g | k |
// v | statistics | mask], each part aligned to 1024 bytes.
struct DbiasPlan {
  int tile_bytes, stage_bytes, stages, bar_off, smem_bytes;
};

__host__ __device__ inline DbiasPlan dbias_smem_plan(int D, bool mask,
                                                     int stages) {
  DbiasPlan p;
  p.tile_bytes = round1024(kWgRows * D * 2);
  p.stage_bytes = 4 * p.tile_bytes + 1024 + (mask ? 1024 : 0);
  p.stages = stages;
  p.bar_off = 2 * kWgRows * 128 + stages * p.stage_bytes;
  p.smem_bytes = 1024 + p.bar_off + (1 + kMaxStages) * 8;
  return p;
}

inline int dbias_stages(int D, bool mask) {
  const int budget = 228 * 1024 / kDbiasBlocksPerSm - 1024;
  const DbiasPlan one = dbias_smem_plan(D, mask, 1);
  const int stages = (budget - (one.smem_bytes - one.stage_bytes)) /
                     one.stage_bytes;
  return stages < 2 ? 2 : (stages > kMaxStages ? kMaxStages : stages);
}

template <int D>
__global__ void __launch_bounds__(128, kDbiasBlocksPerSm)
    bwd_dbias_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap mmap,
                     const __grid_constant__ CUtensorMap smap, BwdArgs a) {
  using namespace hopper;
  constexpr Swizzle kSw = D == 32 ? kSwizzle64 : kSwizzle32;
  constexpr uint32_t kRowBytes = D * 2;
  const DbiasPlan plan = dbias_smem_plan(D, a.has_mask, a.stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint8_t* bias_s = smem;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + plan.bar_off);
  uint64_t* full = own + 1;
  auto stage_ptr = [&](int s) {
    return smem + 2 * kWgRows * 128 + s * plan.stage_bytes;
  };

  const int KT = (a.Tk + kWgRows - 1) / kWgRows;
  const int QT = (a.Tq + kWgRows - 1) / kWgRows;
  int b = blockIdx.x;
  const int kt = b % KT;
  b /= KT;
  const int qt = b % QT;
  b /= QT;
  const int h = b % a.H;
  const int chunk = b / a.H;
  const int win0 = chunk * a.wpc;
  const int nwin = min(a.wpc, a.G - win0);
  const int q0 = qt * kWgRows, k0 = kt * kWgRows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // step n: window win0 + n
  auto load_step = [&](int n) {
    const int s = n % a.stages;
    const int win = win0 + n;
    uint8_t* st = stage_ptr(s);
    mbar_arrive_expect_tx(&full[s], 4 * kWgRows * D * 2 + 3 * kWgRows * 4 +
                                        (a.has_mask ? kWgRows * 4 : 0));
    tma_load_4d(st, &qmap, &full[s], 0, h, q0, win);
    tma_load_4d(st + plan.tile_bytes, &gmap, &full[s], 0, h, q0, win);
    tma_load_4d(st + 2 * plan.tile_bytes, &kmap, &full[s], 0, h, k0, win);
    tma_load_4d(st + 3 * plan.tile_bytes, &vmap, &full[s], 0, h, k0, win);
    tma_load_3d(st + 4 * plan.tile_bytes, &smap, &full[s], q0, win * a.H + h,
                0);
    if (a.has_mask)
      tma_load_2d(st + 4 * plan.tile_bytes + 1024, &mmap, &full[s], k0, win);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(own, 2 * kWgRows * 128);
    for (int sb = 0; sb < 2; ++sb)
      tma_load_3d(smem + sb * kWgRows * 128, &bmap, own, k0 + 32 * sb, h, q0);
    for (int n = 0; n < a.stages && n < nwin; ++n) load_step(n);
  }

  // this thread's rows rl[0], rl[1] and key columns 8j + 2t, 8j + 2t + 1,
  // as in launch 1
  const int gq = lane >> 2, t = lane & 3;
  const int rl[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  float db[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) db[i] = 0.f;
  mbar_wait(own, 0);

  for (int n = 0; n < nwin; ++n) {
    const int s = n % a.stages;
    mbar_wait(&full[s], (n / a.stages) & 1);
    uint8_t* st = stage_ptr(s);
    const float* stats_s =
        reinterpret_cast<const float*>(st + 4 * plan.tile_bytes);
    const float* mask_s = stats_s + 256;
    const uint64_t desc_q = make_desc(st, 8 * kRowBytes, kSw);
    const uint64_t desc_g = make_desc(st + plan.tile_bytes, 8 * kRowBytes,
                                      kSw);
    const uint64_t desc_k = make_desc(st + 2 * plan.tile_bytes,
                                      8 * kRowBytes, kSw);
    const uint64_t desc_v = make_desc(st + 3 * plan.tile_bytes,
                                      8 * kRowBytes, kSw);
    float sc[32], da[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = da[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_m64n64k16_ss(sc, desc_add(desc_q, 32 * kd),
                         desc_add(desc_k, 32 * kd), 1);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_m64n64k16_ss(da, desc_add(desc_g, 32 * kd),
                         desc_add(desc_v, 32 * kd), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(da);

    // a row past Tq has 1 / sum = 0 from TMA's zero fill: it adds nothing
    float ml[2], il[2], rs[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      ml[hr] = stats_s[rl[hr]];
      il[hr] = stats_s[64 + rl[hr]];
      rs[hr] = stats_s[128 + rl[hr]];
    }
#pragma unroll
    for (int j = 0; j < kWgRows / 8; ++j) {
      const int c = 8 * j + 2 * t;    // columns c, c + 1 of the tile
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x0 = sc[4 * j + 2 * hr], x1 = sc[4 * j + 2 * hr + 1];
        if (k0 + c < a.Tk) {
          const float2 bb = *reinterpret_cast<const float2*>(
              bias_at(bias_s + (c >> 5) * kWgRows * 128, rl[hr], c & 31));
          x0 += bb.x;
          x1 += bb.y;
          if (a.has_mask) {
            const float2 mm = *reinterpret_cast<const float2*>(mask_s + c);
            if (!(mm.x > 0.f)) x0 += kMaskAdd;
            if (!(mm.y > 0.f)) x1 += kMaskAdd;
          }
        } else {
          x0 = x1 = -INFINITY;   // Tk % 8 == 0: both columns are past Tk
        }
        const float p0 =
            rnd_bf16(exp2f(fmaf(x0, kLog2e, -ml[hr]))) * il[hr];
        const float p1 =
            rnd_bf16(exp2f(fmaf(x1, kLog2e, -ml[hr]))) * il[hr];
        db[4 * j + 2 * hr] += p0 * (da[4 * j + 2 * hr] - rs[hr]);
        db[4 * j + 2 * hr + 1] += p1 * (da[4 * j + 2 * hr + 1] - rs[hr]);
      }
    }
    // every warp is past stage s: refill it with the window `stages` ahead
    if (n + a.stages < nwin) {
      __syncthreads();
      if (tid == 0) load_step(n + a.stages);
    }
  }

  float* slot = a.dbias + (size_t)chunk * a.Tq * a.H * a.Tk;
#pragma unroll
  for (int j = 0; j < kWgRows / 8; ++j) {
    const int key = k0 + 8 * j + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + rl[hr];
      if (row < a.Tq && key < a.Tk)
        *reinterpret_cast<float2*>(slot + (size_t)row * a.H * a.Tk +
                                   (size_t)h * a.Tk + key) =
            make_float2(db[4 * j + 2 * hr], db[4 * j + 2 * hr + 1]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int device, bool (&configured)[64]) {
  if (device < 64 && configured[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err == cudaSuccess && device < 64) configured[device] = true;
  return err;
}

template <int D>
cudaError_t launch_wgmma(const CUtensorMap* maps, BwdArgs a, int device,
                         cudaStream_t stream) {
  static bool dq_ready[2][64] = {}, dkdv_ready[64] = {};
  static bool dbias_ready[64] = {};
  const bool fed = a.stats_ready != 0;
  auto* dq_kernel = fed ? bwd_dq_kernel<D, true> : bwd_dq_kernel<D, false>;
  cudaError_t err = allow_smem(dq_kernel, device, dq_ready[fed]);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dkdv_kernel<D>, device, dkdv_ready);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dbias_kernel<D>, device, dbias_ready);
  if (err != cudaSuccess) return err;
  const bool bias = a.has_bias != 0, mask = a.has_mask != 0;
  const long long gh = (long long)a.G * a.H;
  const int QT = (a.Tq + kWgRows - 1) / kWgRows;
  const int KT = (a.Tk + kWgRows - 1) / kWgRows;
  a.stages = bwd_stages(D, false, bias, mask, kDqBlocksPerSm);
  dq_kernel<<<(unsigned)(gh * QT), 128,
              bwd_plan(D, false, bias, mask, a.stages).smem_bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bias) {
    // dbias from the statistics launch 1 left, then the chunks' partials
    // added in order
    const int P = (a.G + a.wpc - 1) / a.wpc;
    a.stages = dbias_stages(D, mask);
    bwd_dbias_kernel<D><<<(unsigned)((long long)P * a.H * QT * KT), 128,
                          dbias_smem_plan(D, mask, a.stages).smem_bytes,
                          stream>>>(maps[0], maps[1], maps[2], maps[3],
                                    maps[4], maps[5], maps[6], a);
    err = cudaGetLastError();
    if (err == cudaSuccess && a.dbias_out != a.dbias)
      err = partials::add(a.dbias, P, (long long)a.Tq * a.H * a.Tk,
                          a.dbias_out, stream);
    if (err != cudaSuccess) return err;
  }
  a.stages = bwd_stages(D, true, bias, false, kDkvBlocksPerSm);
  bwd_dkdv_kernel<D><<<(unsigned)(gh * ((a.Tk + kWgRows - 1) / kWgRows)),
                       128, bwd_plan(D, true, bias, false, a.stages).smem_bytes,
                       stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                 maps[6], a);
  return cudaGetLastError();
}

// The tensor maps of one call (the boxes of the kernels' comments), then
// the two launches.  Maps of absent operands repeat q's and are never read.
cudaError_t dispatch_wgmma(const Args& x, float* dbias_out, float* stats,
                           bool stats_ready, int G, int D, int device,
                           cudaStream_t stream) {
  using hopper_host::make_map;
  const int Tq = x.Tq, Tk = x.Tk, H = x.H;
  const CUtensorMapSwizzle sw =
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const uint64_t row = (uint64_t)D * 2, C = (uint64_t)H * D;
  CUtensorMap maps[7];
  cudaError_t err;
  const void* bases[4] = {x.q, x.g, x.k, x.v};
  for (int i = 0; i < 4; ++i) {   // (G, T, H, D)
    const uint64_t T = i < 2 ? Tq : Tk;
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, T, (uint64_t)G};
    const uint64_t strides[3] = {row, C * 2, T * C * 2};
    const uint32_t box[4] = {(uint32_t)D, 1, kWgRows, 1};
    err = make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, bases[i],
                   dims, strides, box, sw);
    if (err != cudaSuccess) return err;
  }
  maps[4] = maps[5] = maps[0];
  if (x.bias != nullptr) {   // (Tq, H, Tk)
    const uint64_t tk4 = (uint64_t)Tk * 4;
    const uint64_t dims[3] = {(uint64_t)Tk, (uint64_t)H, (uint64_t)Tq};
    const uint64_t strides[2] = {tk4, (uint64_t)H * tk4};
    const uint32_t box[3] = {32, 1, kWgRows};
    err = make_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x.bias, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  if (x.mask != nullptr) {   // (G, Tk)
    const uint64_t dims[2] = {(uint64_t)Tk, (uint64_t)G};
    const uint64_t strides[1] = {(uint64_t)Tk * 4};
    const uint32_t box[2] = {kWgRows, 1};
    err = make_map(&maps[5], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x.mask, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  {   // statistics (3, G*H, ldst), cut at Tq
    const uint64_t ld4 = (uint64_t)x.ldst * 4;   // a multiple of 16 bytes
    const uint64_t dims[3] = {(uint64_t)Tq, (uint64_t)G * H, 3};
    const uint64_t strides[2] = {ld4, (uint64_t)G * H * ld4};
    const uint32_t box[3] = {kWgRows, 1, 3};
    err = make_map(&maps[6], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, stats, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  BwdArgs a;
  a.g = static_cast<const bf16*>(x.g);
  a.o = static_cast<const bf16*>(x.o);
  a.stats = stats;
  a.dq = static_cast<bf16*>(x.dq);
  a.dk = static_cast<bf16*>(x.dk);
  a.dv = static_cast<bf16*>(x.dv);
  a.dbias = x.dbias;
  a.dbias_out = dbias_out;
  a.mask = x.mask;
  a.wpc = x.wpc;
  a.G = G;
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.ldst = x.ldst;
  a.stages = 2;
  a.has_bias = x.bias != nullptr;
  a.has_mask = x.mask != nullptr;
  a.stats_ready = stats_ready;
  if (D == 32) return launch_wgmma<32>(maps, a, device, stream);
  return launch_wgmma<16>(maps, a, device, stream);
}

template <int D>
cudaError_t launch_f32(const Args& a, int G, cudaStream_t s) {
  const dim3 grid_q((a.Tq + kRows - 1) / kRows, a.H, G);
  const dim3 grid_c((a.Tq + kRows - 1) / kRows, a.H,
                    (G + a.wpc - 1) / a.wpc);
  const dim3 grid_k((a.Tk + kRows - 1) / kRows, a.H, G);
  stats_kernel<D><<<grid_q, kRows, 0, s>>>(a);
  dq_kernel<D><<<grid_c, kRows, 0, s>>>(a, G);
  dkdv_kernel<D><<<grid_k, kRows, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  bias, mask and dbias may be null
// (dbias exactly when bias is); dbias_part is the (P, Tq, H*Tk) f32 scratch
// of the P = ceil(G / wpc) chunks (ops/window_attention.py:dbias_plan),
// which the dbias launch (bf16) or the dq launch (f32) fills and one more
// launch adds in order into dbias; with P 1 it may be dbias itself (no
// addition); stats is an f32
// scratch (3, G, H, ldst), ldst >= Tq a multiple of 4, whose first two
// planes K1 filled for
// these operands when stats_ready (bf16 only); every pointer is 16-byte
// aligned (the bf16 kernels read through TMA).  Returns the cudaError_t of
// the set-up and launches (0 on success).
extern "C" int cobevt_window_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* o,
    const void* bias, const void* mask, void* stats, void* dq, void* dk,
    void* dv, void* dbias, void* dbias_part, int G, int Tq, int Tk, int H,
    int D, int ldst, int wpc, int is_bf16, int stats_ready, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || G > 65535 || H > 65535 ||
      Tk % 8 || ldst < Tq || ldst % 4 ||
      (bias == nullptr) != (dbias == nullptr) ||
      (dbias == nullptr) != (dbias_part == nullptr) || wpc < 1 ||
      (bias == nullptr && wpc != 1) ||
      (D != 16 && D != 32))
    return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(stats);
  const size_t n = (size_t)G * H * ldst;
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
  a.dbias = static_cast<float*>(dbias_part);
  a.Tq = Tq;
  a.Tk = Tk;
  a.H = H;
  a.ldst = ldst;
  a.wpc = wpc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)   // adds the dbias partials itself, between its launches
    return (int)dispatch_wgmma(a, static_cast<float*>(dbias), st,
                               stats_ready != 0, G, D, device, s);
  if (stats_ready) return (int)cudaErrorInvalidValue;   // bf16 only
  err = D == 32 ? launch_f32<32>(a, G, s) : launch_f32<16>(a, G, s);
  if (err != cudaSuccess || dbias == nullptr || dbias_part == dbias)
    return (int)err;
  const int P = (G + wpc - 1) / wpc;
  return (int)partials::add(static_cast<const float*>(dbias_part), P,
                            (long long)Tq * H * Tk, static_cast<float*>(dbias),
                            s);
}
