// K1's bf16 kernel on wgmma + TMA (window_attention_wgmma_kernel) and its
// host side, shared by window_attention.cu (K1 and K8) and
// fused_swap_fusion_streaming.cu (K6's attention launch), so that K6 runs
// this very kernel and not a second one.  Contract and design: the header of
// window_attention.cu.  Entry for another kernel's C function:
// wattn::dispatch_wgmma (packed or head-major layout, f32 bias and key mask,
// optional bf16 weight, optional K5 statistics; with K4's numerics the bias
// is bf16, the mask adds -1e9 rounded to bf16 and the softmax sum runs over
// the exp rounded to bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

// Internal linkage, as each including source's own kernels have: an inline
// function's static (launch_wgmma's "attribute set" flag) would otherwise be
// one object across every library of the process that includes this header,
// so the first library to set its copy of the kernel's shared-memory limit
// would leave the others' copies unset.
namespace {
namespace wattn {

constexpr float kMaskAdd = -1e9f;
constexpr float kMaskAddBf16 = -998244352.f;   // -1e9 rounded to bf16 (K4)


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


// ---------------------------------------------------------------------------
// wgmma path (bf16)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;       // query rows per block: one warpgroup
constexpr int kWgKeys = 64;       // keys per ring stage
constexpr int kWgMaxStages = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWgBlocksPerSm = 6;   // 8 (64 registers) spills

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory plan of one block, the same on host and device: the
// block's q rows, then `stages` ring stages of [k | v | bias | weight |
// mask], every part aligned to 1024 bytes (the largest swizzle repeat),
// then the barriers.
struct WgPlan {
  int q_bytes, k_bytes, bias_bytes, weight_bytes, mask_bytes, stage_bytes;
  int stages, bar_off, smem_bytes;
  uint32_t tx_bytes;   // what TMA delivers into one stage
};

__host__ __device__ inline int round1024(int b) { return (b + 1023) & ~1023; }

__host__ __device__ inline WgPlan wg_plan(int D, bool bias, bool weight,
                                          bool mask, int stages,
                                          bool bias16 = false) {
  WgPlan p;
  p.q_bytes = round1024(kWgRows * D * 2);
  p.k_bytes = round1024(kWgKeys * D * 2);
  // two 32-key f32 boxes, or one 64-key bf16 box
  p.bias_bytes = bias ? (bias16 ? 1 : 2) * kWgRows * 128 : 0;
  p.weight_bytes = weight ? kWgRows * 128 : 0;  // one 64-key bf16 box
  p.mask_bytes = mask ? 1024 : 0;
  p.stage_bytes = 2 * p.k_bytes + p.bias_bytes + p.weight_bytes +
                  p.mask_bytes;
  p.stages = stages;
  p.bar_off = p.q_bytes + stages * p.stage_bytes;
  p.smem_bytes = 1024 + p.bar_off + (1 + kWgMaxStages) * 8;
  p.tx_bytes = 2 * kWgKeys * D * 2 + p.bias_bytes + p.weight_bytes +
               (mask ? kWgKeys * 4 : 0);
  return p;
}

// grid: G * H * ceil(Tq / 64) blocks of one warpgroup (128 threads); six
// fit an SM (the kernel is bound by latency: the softmax of one warpgroup
// hides the products and loads of the others).  Thread 0 keeps `stages`
// 64-key tiles in flight, refilling a stage once the whole warpgroup is
// past it.  Maps (the boxes of dispatch_wgmma): q and k/v as 4D (D, H, T,
// G) packed or (D, T, H, G) head-major, boxes of 64 rows x D with the 64B
// (D 32) or 32B (D 16) swizzle; bias as 3D (Tk, H, Tq) packed or (Tk, Tq,
// H) head-major, boxes of 32 keys x 64 rows, f32, 128B swizzle (kK4: bf16,
// boxes of 64 keys x 64 rows, packed only); weight as
// (Tk, H, Tq, G), boxes of 64 keys x 64 rows, 128B swizzle; mask as (Tk, G),
// boxes of 64 keys.
template <int D, bool kK4>
__global__ void __launch_bounds__(128, kWgBlocksPerSm)
    window_attention_wgmma_kernel(
        const __grid_constant__ CUtensorMap qmap,
        const __grid_constant__ CUtensorMap kmap,
        const __grid_constant__ CUtensorMap vmap,
        const __grid_constant__ CUtensorMap bmap,
        const __grid_constant__ CUtensorMap mmap,
        const __grid_constant__ CUtensorMap wmap,
        __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int ldst,
        int G, int Tq, int Tk, int H, Layout L, int head_major, int has_bias,
        int has_mask, int has_weight, int stages) {
  using namespace hopper;
  constexpr Swizzle kSw = D == 32 ? kSwizzle64 : kSwizzle32;
  constexpr uint32_t kRowBytes = D * 2;   // one q/k/v row: the swizzle span
  const WgPlan plan = wg_plan(D, has_bias, has_weight, has_mask, stages, kK4);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + plan.bar_off);
  uint64_t* full = qbar + 1;
  auto stage_ptr = [&](int s) {
    return smem + plan.q_bytes + s * plan.stage_bytes;
  };

  // the windows of one (head, query tile) run side by side when there is a
  // bias, so its tile is read from device memory once for all of them; the
  // query tiles of one (window, head) otherwise, so they share k and v in L2
  const int QT = (Tq + kWgRows - 1) / kWgRows;
  int b = blockIdx.x, win, h, qt;
  if (has_bias) {
    win = b % G;
    b /= G;
    qt = b % QT;
    h = b / QT;
  } else {
    qt = b % QT;
    b /= QT;
    h = b % H;
    win = b / H;
  }
  const int q0 = qt * kWgRows;
  const int KT = (Tk + kWgKeys - 1) / kWgKeys;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if constexpr (kK4) {   // launched with hopper_host::launch_pdl
    pdl_launch_dependents();
    pdl_wait();
  }

  // key tile kt into its stage, completing on the stage's barrier
  auto load_tile = [&](int kt) {
    const int s = kt % stages;
    uint8_t* st = stage_ptr(s);
    const int k0 = kt * kWgKeys;
    mbar_arrive_expect_tx(&full[s], plan.tx_bytes);
    if (head_major) {
      tma_load_4d(st, &kmap, &full[s], 0, k0, h, win);
      tma_load_4d(st + plan.k_bytes, &vmap, &full[s], 0, k0, h, win);
    } else {
      tma_load_4d(st, &kmap, &full[s], 0, h, k0, win);
      tma_load_4d(st + plan.k_bytes, &vmap, &full[s], 0, h, k0, win);
    }
    uint8_t* part = st + 2 * plan.k_bytes;
    if (has_bias && kK4) {
      tma_load_3d(part, &bmap, &full[s], k0, h, q0);
      part += plan.bias_bytes;
    } else if (has_bias) {
      for (int sb = 0; sb < 2; ++sb) {
        if (head_major)
          tma_load_3d(part + sb * kWgRows * 128, &bmap, &full[s],
                      k0 + 32 * sb, q0, h);
        else
          tma_load_3d(part + sb * kWgRows * 128, &bmap, &full[s],
                      k0 + 32 * sb, h, q0);
      }
      part += plan.bias_bytes;
    }
    if (has_weight) {
      tma_load_4d(part, &wmap, &full[s], k0, h, q0, win);
      part += plan.weight_bytes;
    }
    if (has_mask) tma_load_2d(part, &mmap, &full[s], k0, win);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(qbar, kWgRows * D * 2);
    if (head_major)
      tma_load_4d(q_s, &qmap, qbar, 0, q0, h, win);
    else
      tma_load_4d(q_s, &qmap, qbar, 0, h, q0, win);
    for (int kt = 0; kt < stages && kt < KT; ++kt) load_tile(kt);
  }

  // this thread's rows rl[0] and rl[1] (accumulator rows g, g + 8 of its
  // warp), key columns 8j + 2t and 8j + 2t + 1 of each 64-key tile
  const int g = lane >> 2, t = lane & 3;
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};
  mbar_wait(qbar, 0);
  const uint64_t dq = make_desc(q_s, 8 * kRowBytes, kSw);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  // for K5 (stats non-null, no weight): the sum of the exp rounded to bf16
  // at the running maximum, rescaled as it moves -- the same arithmetic, in
  // the same order, as the statistics sweep of K5's dq kernel
  float l_bf[2] = {0.f, 0.f};
  float ml_prev[2] = {-INFINITY, -INFINITY};

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % stages;
    mbar_wait(&full[s], (kt / stages) & 1);
    uint8_t* st = stage_ptr(s);
    const uint8_t* bias_s = st + 2 * plan.k_bytes;
    const uint8_t* weight_s = bias_s + plan.bias_bytes;
    const float* mask_s =
        reinterpret_cast<const float*>(weight_s + plan.weight_bytes);
    const int k0 = kt * kWgKeys;

    // S = q k^T over this tile's 64 keys, f32
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    const uint64_t dk = make_desc(st, 8 * kRowBytes, kSw);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      wgmma_m64n64k16_ss(sc, desc_add(dq, 32 * kd), desc_add(dk, 32 * kd), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // (q.k + bias) + mask, then the online softmax over this tile
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kWgKeys / 8; ++j) {
      const int c = 8 * j + 2 * t;    // columns c, c + 1 of the tile
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x0 = sc[4 * j + 2 * hr], x1 = sc[4 * j + 2 * hr + 1];
        if (k0 + c < Tk) {
          if (has_bias && kK4) {
            const int r = rl[hr];
            const float2 bb = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    bias_s + r * 128 +
                    ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1))));
            x0 += bb.x;
            x1 += bb.y;
          } else if (has_bias) {
            const int r = rl[hr], cc = c & 31;
            const float2 bb = *reinterpret_cast<const float2*>(
                bias_s + (c >> 5) * kWgRows * 128 + r * 128 +
                ((((cc >> 2) ^ (r & 7)) << 4) | ((cc & 3) << 2)));
            x0 += bb.x;
            x1 += bb.y;
          }
          if (has_mask) {
            const float2 mm = *reinterpret_cast<const float2*>(mask_s + c);
            constexpr float kAdd = kK4 ? kMaskAddBf16 : kMaskAdd;
            if (!(mm.x > 0.f)) x0 += kAdd;
            if (!(mm.y > 0.f)) x1 += kAdd;
          }
        } else {
          x0 = x1 = -INFINITY;   // Tk % 8 == 0: both columns are past Tk
        }
        sc[4 * j + 2 * hr] = x0;
        sc[4 * j + 2 * hr + 1] = x1;
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
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // P (numerator weights) as the bf16 A fragments of P v; the sum stays
    // f32 and unweighted.  The accumulator columns 16kk .. 16kk + 15 are
    // exactly the A fragment of k-step kk.
    // exp(s - m) as exp2(s log2(e) - m log2(e)): one FMA before the MUFU op
    uint32_t pa[kWgKeys / 16][4];
    const float m_log2e[2] = {m_run[0] * kLog2e, m_run[1] * kLog2e};
    if (stats != nullptr) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l_bf[hr] *= exp2f(ml_prev[hr] - m_log2e[hr]);   // 0 at the first tile
        ml_prev[hr] = m_log2e[hr];
      }
    }
#pragma unroll
    for (int j = 0; j < kWgKeys / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(sc[4 * j + e], kLog2e, -m_log2e[e >> 1]));
        // K4 (no weight): the sum of the exp as P v reads it, in bf16
        if constexpr (kK4)
          p[e] = __bfloat162float(__float2bfloat16_rn(p[e]));
        l_run[e >> 1] += p[e];
      }
      if (has_weight) {
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rl[hr];
          const float2 w = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  weight_s + r * 128 +
                  ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1))));
          p[2 * hr] *= w.x;
          p[2 * hr + 1] *= w.y;
        }
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      if (stats != nullptr) {   // no weight: P holds the rounded exp itself
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float2 e = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  &pa[j >> 1][(j & 1) * 2 + hr]));
          l_bf[hr] += e.x;
          l_bf[hr] += e.y;
        }
      }
    }

    // O += P v, v read in place as the MN-major B operand
    const uint64_t dv = make_desc(st + plan.k_bytes, 8 * kRowBytes, kSw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk) {
      if constexpr (D == 32)
        wgmma_m64n32k16_rs_mn(o, pa[kk], desc_add(dv, 16 * kRowBytes * kk),
                              1);
      else
        wgmma_m64n16k16_rs_mn(o, pa[kk], desc_add(dv, 16 * kRowBytes * kk),
                              1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    // every warp is past stage s: refill it with the tile `stages` ahead
    if (kt + stages < KT) {
      __syncthreads();
      if (tid == 0) load_tile(kt + stages);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
  }
  if (stats != nullptr) {
    // K5's row statistics (3, G, H, ldst): max * log2(e), 1 / rounded sum;
    // rows ldst floats apart (the caller's pitch, as K5's TMA reads them)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l_bf[hr] += __shfl_xor_sync(0xffffffffu, l_bf[hr], 1);
      l_bf[hr] += __shfl_xor_sync(0xffffffffu, l_bf[hr], 2);
      const int row = q0 + rl[hr];
      if (t == 0 && row < Tq) {
        const size_t per = (size_t)G * H * ldst;
        const size_t i0 = ((size_t)win * H + h) * ldst + row;
        stats[i0] = ml_prev[hr];
        stats[per + i0] = 1.f / l_bf[hr];
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + rl[hr];
    if (row >= Tq) continue;
    const float inv = 1.f / l_run[hr];
    __nv_bfloat16* op =
        out + win * L.q_win + (size_t)row * L.ldq + h * L.q_head;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(op + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * nd + 2 * hr] * inv,
                                o[4 * nd + 2 * hr + 1] * inv);
  }
}

// ring depth: as many stages, 2 .. 4, as keep `per_sm` blocks on an SM
// (each block also holds 1 KB of the SM's 228 KB for the system)
inline int wg_stages(int D, bool bias, bool weight, bool mask,
                     bool bias16 = false, int per_sm = kWgBlocksPerSm) {
  const int budget = 228 * 1024 / per_sm - 1024;
  const WgPlan one = wg_plan(D, bias, weight, mask, 1, bias16);
  const int fixed = one.smem_bytes - one.stage_bytes;
  const int stages = (budget - fixed) / one.stage_bytes;
  return stages < 2 ? 2 : (stages > kWgMaxStages ? kWgMaxStages : stages);
}

template <int D, bool kK4>
inline cudaError_t launch_wgmma(const CUtensorMap* maps, void* out,
                                float* stats, int ldst, int G, int Tq, int Tk,
                                int H,
                                const Layout& L, int head_major, bool bias,
                                bool mask, bool weight, int device,
                                cudaStream_t stream, bool pdl) {
  auto kernel = window_attention_wgmma_kernel<D, kK4>;
  static bool configured[64] = {};
  if (device >= 64 || !configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    if (device < 64) configured[device] = true;
  }
  // K4's launches (320 blocks at CorpBEVT) fill the card at three blocks an
  // SM, so their ring is as deep as three allow
  const int stages =
      wg_stages(D, bias, weight, mask, kK4, kK4 ? 3 : kWgBlocksPerSm);
  const WgPlan plan = wg_plan(D, bias, weight, mask, stages, kK4);
  const long long blocks =
      (long long)G * H * ((Tq + kWgRows - 1) / kWgRows);
  if constexpr (kK4)   // K4's launches may overlap each other's set-up
    return hopper_host::launch_pdl(
        pdl, kernel, dim3((unsigned)blocks), dim3(128), plan.smem_bytes,
        stream,
        maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
        static_cast<__nv_bfloat16*>(out), stats, ldst, G, Tq, Tk, H, L,
        head_major,
        (int)bias, (int)mask, (int)weight, stages);
  kernel<<<(unsigned)blocks, 128, plan.smem_bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<__nv_bfloat16*>(out), stats, ldst, G, Tq, Tk, H, L,
      head_major,
      (int)bias, (int)mask, (int)weight, stages);
  return cudaGetLastError();
}

// The tensor maps of one call (the boxes of the kernel's comment), then the
// launch.  Maps of absent operands repeat q's and are never read.
// k4_numerics (packed, no weight): the bias is bf16 (Tq, H * Tk), masked
// keys add -1e9 rounded to bf16 and the softmax sum runs over the exp
// rounded to bf16, as K4's TPU body; with pdl the launch may start before
// the kernel ahead of it has finished (hopper_host::launch_pdl).
inline cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v,
                           const void* bias, const void* mask,
                           const void* weight, void* out, float* stats,
                           int ldst, int G, int Tq, int Tk, int H, int D,
                           int head_major,
                           const Layout& L, int device, cudaStream_t stream,
                           bool k4_numerics = false, bool pdl = false) {
  using hopper_host::make_map;
  if (head_major && weight != nullptr) return cudaErrorInvalidValue;
  if (k4_numerics && weight != nullptr) return cudaErrorInvalidValue;
  if (stats != nullptr && (weight != nullptr || head_major || ldst < Tq ||
                           ldst % 4))
    return cudaErrorInvalidValue;
  const CUtensorMapSwizzle sw =
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const uint64_t row = (uint64_t)D * 2;
  const uint64_t C = (uint64_t)H * D;
  CUtensorMap maps[6];
  cudaError_t err;
  for (int i = 0; i < 3; ++i) {
    const void* base = i == 0 ? q : (i == 1 ? k : v);
    const uint64_t T = i == 0 ? Tq : Tk;
    const uint32_t box_rows = i == 0 ? kWgRows : kWgKeys;
    uint64_t dims[4], strides[3];
    uint32_t box[4];
    if (head_major) {   // (G, H, T, D)
      const uint64_t d[4] = {(uint64_t)D, T, (uint64_t)H, (uint64_t)G};
      const uint64_t st[3] = {row, T * row, (uint64_t)H * T * row};
      const uint32_t bx[4] = {(uint32_t)D, box_rows, 1, 1};
      for (int j = 0; j < 4; ++j) dims[j] = d[j], box[j] = bx[j];
      for (int j = 0; j < 3; ++j) strides[j] = st[j];
    } else {            // (G, T, H, D)
      const uint64_t d[4] = {(uint64_t)D, (uint64_t)H, T, (uint64_t)G};
      const uint64_t st[3] = {row, C * 2, T * C * 2};
      const uint32_t bx[4] = {(uint32_t)D, 1, box_rows, 1};
      for (int j = 0; j < 4; ++j) dims[j] = d[j], box[j] = bx[j];
      for (int j = 0; j < 3; ++j) strides[j] = st[j];
    }
    err = make_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                   strides, box, sw);
    if (err != cudaSuccess) return err;
  }
  maps[3] = maps[4] = maps[5] = maps[0];
  if (bias != nullptr && k4_numerics) {   // (Tq, H, Tk) bf16
    if (head_major) return cudaErrorInvalidValue;
    const uint64_t tk2 = (uint64_t)Tk * 2;
    const uint64_t dims[3] = {(uint64_t)Tk, (uint64_t)H, (uint64_t)Tq};
    const uint64_t strides[2] = {tk2, (uint64_t)H * tk2};
    const uint32_t box[3] = {kWgKeys, 1, kWgRows};
    err = make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, bias, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  } else if (bias != nullptr) {
    const uint64_t tk4 = (uint64_t)Tk * 4;
    if (head_major) {   // (H, Tq, Tk)
      const uint64_t dims[3] = {(uint64_t)Tk, (uint64_t)Tq, (uint64_t)H};
      const uint64_t strides[2] = {tk4, (uint64_t)Tq * tk4};
      const uint32_t box[3] = {32, kWgRows, 1};
      err = make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, bias, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    } else {            // (Tq, H, Tk)
      const uint64_t dims[3] = {(uint64_t)Tk, (uint64_t)H, (uint64_t)Tq};
      const uint64_t strides[2] = {tk4, (uint64_t)H * tk4};
      const uint32_t box[3] = {32, 1, kWgRows};
      err = make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, bias, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (err != cudaSuccess) return err;
  }
  if (mask != nullptr) {   // (G, Tk)
    const uint64_t dims[2] = {(uint64_t)Tk, (uint64_t)G};
    const uint64_t strides[1] = {(uint64_t)Tk * 4};
    const uint32_t box[2] = {kWgKeys, 1};
    err = make_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, mask, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  if (weight != nullptr) {   // (G, Tq, H, Tk)
    const uint64_t tk2 = (uint64_t)Tk * 2;
    const uint64_t dims[4] = {(uint64_t)Tk, (uint64_t)H, (uint64_t)Tq,
                              (uint64_t)G};
    const uint64_t strides[3] = {tk2, (uint64_t)H * tk2,
                                 (uint64_t)Tq * H * tk2};
    const uint32_t box[4] = {kWgKeys, 1, kWgRows, 1};
    err = make_map(&maps[5], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, weight,
                   dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  const bool b = bias != nullptr, m = mask != nullptr, w = weight != nullptr;
#define WG_LAUNCH(HD, K4)                                                     \
  launch_wgmma<HD, K4>(maps, out, stats, ldst, G, Tq, Tk, H, L, head_major, \
                       b, m, w, device, stream, pdl)
  if (D == 32) return k4_numerics ? WG_LAUNCH(32, true) : WG_LAUNCH(32, false);
  return k4_numerics ? WG_LAUNCH(16, true) : WG_LAUNCH(16, false);
#undef WG_LAUNCH
}

}  // namespace wattn
}  // namespace
