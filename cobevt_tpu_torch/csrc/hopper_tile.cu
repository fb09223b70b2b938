// One bare TMA + wgmma tile product, the check of csrc/hopper.cuh.
//
// Descriptor or swizzle bits that are wrong give silently wrong numbers, so
// each product form that K1, K3 and K8 use is run here once, alone, on one
// tile loaded by TMA, and held against torch.matmul in f32 (bf16 inputs,
// exact products, f32 sums): ops/hopper_tile.py, tests/test_torch_kernels_gpu
// .py and chip_smoke.py phase 3.  One warpgroup, one block.
//
//   variant 0 (K3's form): C (64 x 128) = A (64 x 64) B^T, B stored
//     (128 x 64): both K-major, 128-byte rows, SWIZZLE_128B, four k16 steps
//     of m64n128k16 from shared memory.
//   variant 1 (K1's S = q k^T): C (64 x 64) = A (64 x 32) B^T, B stored
//     (64 x 32): both K-major, 64-byte rows, SWIZZLE_64B, two steps of
//     m64n64k16.
//   variant 2 (K1's O += P v): C (64 x 32) = A (64 x 64) B, B stored
//     (64 x 32) row-major, i.e. MN-major, SWIZZLE_64B, read in place with
//     trans-b; A from registers in the m16n8k16 A-fragment layout, four
//     steps of m64n32k16.
//   variant 3 (8-bit, SS): C (64 x 128, s32) = A (64 x 128) B^T, s8, B
//     stored (128 x 128): both K-major, 128-byte rows, SWIZZLE_128B, four
//     k32 steps of m64n128k32.s8 from shared memory.
//   variant 4 (K7's form, 8-bit, RS): the same product with A from
//     registers, loaded by ldmatrix_x4 from a plain copy of A in shared
//     memory whose rows are 144 bytes apart (K7's halo tile pads a pixel's
//     channels by 16 bytes the same way).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#include <stdint.h>

namespace {

using namespace hopper;

// rows 16 * warp + g (+ 8) of the 64 x N tile C, columns 8j + 2t (+ 1)
template <int R>
__device__ __forceinline__ void store_tile(const float (&d)[R], float* c,
                                           int warp, int g, int t) {
  constexpr int N = 2 * R;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(warp * 16 + g + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] =
          d[4 * j + e];
}

// rows 16 * warp + g (+ 8) of the 64 x 128 s32 tile C, columns 8j + 2t (+ 1)
__device__ __forceinline__ void store_tile_s32(const int (&d)[64], int* c,
                                               int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(warp * 16 + g + 8 * (e >> 1)) * 128 + 8 * j + 2 * t + (e & 1)] =
          d[4 * j + e];
}

constexpr int kRowS8 = 144;   // variant 4: bytes between A's rows

__global__ void __launch_bounds__(128)
    tile_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap,
                const __nv_bfloat16* __restrict__ a, float* __restrict__ c,
                int variant) {
  __shared__ __align__(1024) uint8_t sa[64 * 64 * 2];
  __shared__ __align__(1024) uint8_t sb[128 * 64 * 2];
  __shared__ __align__(16) uint8_t sr[64 * kRowS8];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    const bool a_regs = variant == 2 || variant == 4;
    const uint32_t a_bytes =
        a_regs ? 0 : (variant == 0 || variant == 3 ? 8192 : 4096);
    const uint32_t b_bytes = variant == 0 || variant >= 3 ? 16384 : 4096;
    mbar_arrive_expect_tx(&bar, a_bytes + b_bytes);
    if (!a_regs) tma_load_2d(sa, &amap, &bar, 0, 0);
    tma_load_2d(sb, &bmap, &bar, 0, 0);
  }
  if (variant == 4) {   // A (64 x 128 s8) into 144-byte rows, 16 bytes a go
    const uint8_t* as = reinterpret_cast<const uint8_t*>(a);
    for (int i = tid; i < 64 * 8; i += 128)
      *reinterpret_cast<uint4*>(sr + (i >> 3) * kRowS8 + (i & 7) * 16) =
          *reinterpret_cast<const uint4*>(as + i * 16);
    __syncthreads();
  }
  mbar_wait(&bar, 0);

  if (variant >= 3) {
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    const uint64_t db = make_desc(sb, 1024, kSwizzle128);
    if (variant == 3) {
      const uint64_t da = make_desc(sa, 1024, kSwizzle128);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n128k32_s8_ss(d, desc_add(da, 32 * k), desc_add(db, 32 * k),
                               1);
    } else {
      uint32_t frag[4][4];
      const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ldmatrix_x4(frag[k], sr + row * kRowS8 + 32 * k + (lane >> 4) * 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n128k32_s8_rs(d, frag[k], desc_add(db, 32 * k), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    store_tile_s32(d, reinterpret_cast<int*>(c), warp, g, t);
    return;
  }

  if (variant == 0) {
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    const uint64_t da = make_desc(sa, 1024, kSwizzle128);
    const uint64_t db = make_desc(sb, 1024, kSwizzle128);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n128k16_ss(d, desc_add(da, 32 * k), desc_add(db, 32 * k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    store_tile(d, c, warp, g, t);
  } else if (variant == 1) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    const uint64_t da = make_desc(sa, 512, kSwizzle64);
    const uint64_t db = make_desc(sb, 512, kSwizzle64);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 2; ++k)
      wgmma_m64n64k16_ss(d, desc_add(da, 32 * k), desc_add(db, 32 * k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    store_tile(d, c, warp, g, t);
  } else {
    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = 0.f;
    const uint64_t db = make_desc(sb, 512, kSwizzle64);
    const int r0 = warp * 16 + g;
    uint32_t frag[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 16 * k + 2 * t;
      frag[k][0] = *reinterpret_cast<const uint32_t*>(a + r0 * 64 + col);
      frag[k][1] = *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * 64 + col);
      frag[k][2] = *reinterpret_cast<const uint32_t*>(a + r0 * 64 + col + 8);
      frag[k][3] =
          *reinterpret_cast<const uint32_t*>(a + (r0 + 8) * 64 + col + 8);
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)  // 16 rows of B (64 bytes each) a step
      wgmma_m64n32k16_rs_mn(d, frag[k], desc_add(db, 1024 * k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    store_tile(d, c, warp, g, t);
  }
}

cudaError_t map_2d(CUtensorMap* map, const void* base, int rows, int cols,
                   CUtensorMapSwizzle swizzle, int elt = 2) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * elt};
  const uint32_t box[2] = {(uint32_t)cols, (uint32_t)rows};
  return hopper_host::make_map(
      map, elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, base, dims, strides, box, swizzle);
}

}  // namespace

// a, b row-major, bf16 (variants 0-2, c f32) or s8 (3, 4, c s32), c
// (64 x N), with the shapes of the variant (header comment).  Returns the
// cudaError_t of the set-up and launch.
extern "C" int cobevt_hopper_tile(const void* a, const void* b, void* c,
                                  int variant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (variant < 0 || variant > 4) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (variant >= 3) {
    err = map_2d(&bmap, b, 128, 128, CU_TENSOR_MAP_SWIZZLE_128B, 1);
    amap = bmap;   // variant 4 does not read it
    if (err == cudaSuccess && variant == 3)
      err = map_2d(&amap, a, 64, 128, CU_TENSOR_MAP_SWIZZLE_128B, 1);
  } else if (variant == 0) {
    err = map_2d(&amap, a, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
      err = map_2d(&bmap, b, 128, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  } else if (variant == 1) {
    err = map_2d(&amap, a, 64, 32, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err == cudaSuccess)
      err = map_2d(&bmap, b, 64, 32, CU_TENSOR_MAP_SWIZZLE_64B);
  } else {
    err = map_2d(&bmap, b, 64, 32, CU_TENSOR_MAP_SWIZZLE_64B);
    amap = bmap;  // not read
  }
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      amap, bmap, static_cast<const __nv_bfloat16*>(a),
      static_cast<float*>(c), variant);
  return (int)cudaGetLastError();
}
