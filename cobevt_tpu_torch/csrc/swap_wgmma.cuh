// The FuseBEVT sublayer's QKV launch on wgmma + TMA (bf16), shared by K6
// (fused_swap_fusion_streaming.cu, two warpgroups a block) and K4
// (fused_swap_fusion.cu, its first QKV launch, one warpgroup a block): the
// QKV launch, the swizzled tile layout and the index maps between the state
// and the window-major token rows.  The attention between them is K1's
// window_attention_wgmma_kernel (window_attention.cuh).  Shapes: D 128 or
// 256, mlp a multiple of 128; the launches' grids and the weight ring's
// depth come from ops/fused_swap_fusion.py (stream_plan, k4_plan).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "rowops.cuh"
#include "swap_state.cuh"

// Internal linkage, as window_attention.cuh: each library that includes
// this header has its own copy of the kernels.
namespace {
namespace swapwg {

using namespace hopper;
using swap_state::Dims;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;      // token rows a tile: one warpgroup
constexpr int kAtomRow = 128;  // bytes of a swizzled row: 64 values
constexpr int kSmemMax = 232448;

// Byte offset of element (r, c) in a K-major 128B-swizzled tile of 64 rows:
// 64-column atoms of 64 x 128 bytes, as TMA writes a (64, 64) box and wgmma
// reads it (SBO 1024).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 6) * kTile * kAtomRow + r * kAtomRow +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// state_offset in 32-bit arithmetic (the route takes states of fewer than
// 2^31 elements)
__device__ __forceinline__ int state_offset32(const Dims& d, int rr) {
  const int X = d.H / d.w, Y = d.W / d.w;
  const int w2 = d.w * d.w;
  const int T = d.L * w2;
  const int g = rr / T;
  const int j = rr - g * T;
  const int b = g / (X * Y);
  const int wi = g - b * X * Y;
  const int wx = wi / Y, wy = wi - wx * Y;
  const int l = j / w2;
  const int p = (j - l * w2) / d.w;
  const int s = j - l * w2 - p * d.w;
  const int y = d.grid ? p * X + wx : wx * d.w + p;
  const int x = d.grid ? s * Y + wy : wy * d.w + s;
  return (((b * d.L + l) * d.H + y) * d.W + x) * d.D;
}

// The inverse: the window-major row, in the partition of d.grid, of the
// token at state offset `off` (window cells: wx = y / w, p = y % w; grid
// cells: p = y / X, wx = y % X; the same for x with wy, s and Y)
__device__ __forceinline__ int row_of(const Dims& d, int off) {
  const int X = d.H / d.w, Y = d.W / d.w;
  const int pix = off / d.D;
  const int x = pix % d.W;
  const int yl = pix / d.W;
  const int y = yl % d.H;
  const int bl = yl / d.H;
  const int l = bl % d.L, b = bl / d.L;
  const int wx = d.grid ? y % X : y / d.w, p = d.grid ? y / X : y % d.w;
  const int wy = d.grid ? x % Y : x / d.w, s = d.grid ? x / Y : x % d.w;
  return ((b * X + wx) * Y + wy) * (d.L * d.w * d.w) + (l * d.w + p) * d.w +
         s;
}

// acc (64 x 128) += A[:, 0 .. 16 KS) B[n0 .. n0 + 127, same columns]^T: A a
// 64-row tile, B a box of `brows` rows, both K-major 128B-swizzled.  The
// caller fences before and commits and waits after.  Unrolled whole: a
// loop left around wgmma makes ptxas serialize the products.
template <int KS>
__device__ __forceinline__ void mma_n128(float (&acc)[64], const uint8_t* a_s,
                                         const uint8_t* b_s, int brows,
                                         int n0) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint64_t da = make_desc(
        a_s + (k >> 2) * kTile * kAtomRow + (k & 3) * 32, 1024, kSwizzle128);
    const uint64_t db = make_desc(
        b_s + (k >> 2) * brows * kAtomRow + n0 * kAtomRow + (k & 3) * 32,
        1024, kSwizzle128);
    wgmma_m64n128k16_ss(acc, da, db, 1);
  }
}

// The QKV launch.  grid: (blocks, 3); blockIdx.y picks q, k or v, whose D x
// D slice of Wqkv a block TMA-loads once.  Its G warpgroups walk alternate
// 64-row tiles of the window-major token rows: gather through state_offset
// (D / 16 lanes a row, 16 values a lane, every load issued first), LN in
// f32 into the bf16 A tile, the product on wgmma, the cast (and q's scale
// after it) into the A tile, and a TMA store of the tile into the (3, rows,
// D) scratch, which is the packed (G, T, heads * hd) layout K1 reads.
template <int D, int G>
__global__ void __launch_bounds__(128 * G, 1)
    stream_qkv_wgmma(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap qkvmap,
                     const bf16* __restrict__ S,
                     const bf16* __restrict__ ln_a, float scale, Dims d) {
  constexpr int LPR = D / 16;     // lanes a row
  constexpr int RPS = 32 / LPR;   // rows a warp step
  constexpr int STEPS = 16 / RPS;
  constexpr int kW = D * D * 2;
  constexpr int kA = kTile * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w_s = align1024(smem_raw);
  const int grp = threadIdx.x >> 7;
  uint8_t* a_s = w_s + kW + grp * kA;
  float* gb = reinterpret_cast<float*>(w_s + kW + G * kA);
  uint64_t* bar = reinterpret_cast<uint64_t*>(gb + 2 * D);
  const int slice = blockIdx.y;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar, kW);
    for (int a = 0; a < D / 64; ++a)
      tma_load_2d(w_s + a * D * kAtomRow, &wmap, bar, a * 64, slice * D);
  }
  // gamma, beta: value e of lane cl's columns at [e * LPR + cl]
  for (int i = threadIdx.x; i < D; i += 128 * G) {
    const int cl = i >> 4, e = i & 15;
    gb[e * LPR + cl] = __bfloat162float(ln_a[i]);
    gb[D + e * LPR + cl] = __bfloat162float(ln_a[D + i]);
  }
  __syncthreads();
  // the state is read from here on (a no-op unless launched with
  // hopper_host::launch_pdl)
  pdl_launch_dependents();
  pdl_wait();
  auto group_sync = [&]() { named_barrier_sync(1 + grp, 128); };
  const int rs = lane / LPR, cl = lane % LPR;
  const int rows = d.B * d.L * d.H * d.W;
  const int tiles = (rows + kTile - 1) / kTile;
  mbar_wait(bar, 0);
  for (int tile = blockIdx.x * G + grp; tile < tiles; tile += gridDim.x * G) {
    const int row0 = tile * kTile;
    // warp w gathers rows 16 w .. 16 w + 15, RPS at a time, all loads first
    // (a row past the end reads the last row; TMA does not store it)
    uint4 raw[STEPS][2];
#pragma unroll
    for (int it = 0; it < STEPS; ++it) {
      const int rr = min(row0 + warp * 16 + it * RPS + rs, rows - 1);
      const uint4* src = reinterpret_cast<const uint4*>(
          S + state_offset32(d, rr) + 16 * cl);
      raw[it][0] = src[0];
      raw[it][1] = src[1];
    }
    group_sync();   // the last tile's store has read the A tile
#pragma unroll
    for (int it = 0; it < STEPS; ++it) {
      float x[16];
      const uint32_t* u = reinterpret_cast<const uint32_t*>(raw[it]);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 v = unpack2(u[i]);
        x[2 * i] = v.x;
        x[2 * i + 1] = v.y;
        sum += v.x + v.y;
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum / D;
      float sq = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) sq += (x[e] - mu) * (x[e] - mu);
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float inv = rsqrtf(sq / D + 1e-5f);
      uint32_t wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = 2 * i;
        wv[i] = pack2(
            (x[e] - mu) * inv * gb[e * LPR + cl] + gb[D + e * LPR + cl],
            (x[e + 1] - mu) * inv * gb[(e + 1) * LPR + cl] +
                gb[D + (e + 1) * LPR + cl]);
      }
      const int r = warp * 16 + it * RPS + rs;
      *reinterpret_cast<uint4*>(a_s + sw128(r, 16 * cl)) =
          make_uint4(wv[0], wv[1], wv[2], wv[3]);
      *reinterpret_cast<uint4*>(a_s + sw128(r, 16 * cl + 8)) =
          make_uint4(wv[4], wv[5], wv[6], wv[7]);
    }
    fence_async_shared();
    group_sync();
    float acc[D / 128][64];
#pragma unroll
    for (int nh = 0; nh < D / 128; ++nh)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[nh][i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int nh = 0; nh < D / 128; ++nh)
      mma_n128<D / 16>(acc[nh], a_s, w_s, D, nh * 128);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nh = 0; nh < D / 128; ++nh) fence_regs(acc[nh]);
    group_sync();   // every warp's products are done with the A tile
    // the cast, and q's scale after it, into the A tile
#pragma unroll
    for (int nh = 0; nh < D / 128; ++nh)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float v0 = rnd(acc[nh][4 * j + 2 * hr]);
          float v1 = rnd(acc[nh][4 * j + 2 * hr + 1]);
          if (slice == 0) {
            v0 *= scale;
            v1 *= scale;
          }
          *reinterpret_cast<uint32_t*>(
              a_s + sw128(warp * 16 + g + 8 * hr, nh * 128 + 8 * j + 2 * t)) =
              pack2(v0, v1);
        }
    fence_async_shared();
    group_sync();
    if (tid == 0) {
      for (int a = 0; a < D / 64; ++a)
        tma_store_3d(&qkvmap, a_s + a * kTile * kAtomRow, a * 64, row0,
                     slice);
      tma_store_wait();
    }
  }
}

// Shared memory of the QKV launch with G warpgroups a block;
// ops/fused_swap_fusion.py:stream_plan and k4_plan compute the same.
inline int qkv_smem(int D, int G) {
  return 1024 + D * D * 2 + G * kTile * D * 2 + 2 * D * 4 + 16;
}

inline cudaError_t map2d(CUtensorMap* map, const void* base, uint64_t inner,
                         uint64_t outer, uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint64_t strides[1] = {inner * 2};
  const uint32_t box[2] = {64, box_outer};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the (3, rows, D) q, k, v scratch as a 3-D map with (64 columns, 64 rows)
// boxes: the QKV launch's TMA stores
inline cudaError_t qkv_map(CUtensorMap* map, void* qkv, int rows, int D) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)rows, 3};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)rows * D * 2};
  const uint32_t box[3] = {64, kTile, 1};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qkv,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename K>
inline cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace swapwg
}  // namespace
