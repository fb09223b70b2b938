// K3: fused stride-1 SAME 3x3 convolution for Hopper (sm_90a), inference.
//
// Replaces the Pallas kernel cobevt_tpu/ops/conv2d.py:fused_conv3x3
// (body _conv_kernel).  Contract, as there: x (N, H, W, C) NHWC, w
// (3, 3, C, O) with the BatchNorm scale already folded in and cast to x's
// dtype, shift (O,) f32 (the folded BN bias), optional residual
// (N, H, W, O) added before the ReLU, optional ReLU.  Accumulates in f32;
// output (N, H, W, O) in x's dtype.  f32 or bf16; C % 16 == 0, O % 4 == 0.
//
// What bounds it on the H100: at the ResNet-34 trunk shapes (64^2 x 128,
// 32^2 x 256, 16^2 x 512, N = 4 cameras x 5 agents) each conv is ~24 GFLOP
// against ~20 MB of activations, so it is bound by arithmetic: the tensor
// cores, not memory, set its floor (0.024 ms a conv at 989 TFLOP/s).  Both
// kernels below are implicit GEMMs -- M = N*H*W output pixels, N = O
// channels, K = 9*C taps x channels -- that walk K one tap at a time, and
// the folded-BN shift, the residual and the ReLU run on the f32
// accumulators before the single store, so the conv output never makes a
// round trip through device memory.
//
//  * conv3x3_wgmma_kernel (bf16, C % 32 == 0, O % 8 == 0 -- every trunk
//    block): a tile is 128 output pixels of one image, a bh x bw spatial box
//    (2 x 64 at W 64, 4 x 32 at W 32, 8 x 16 at W 16: ops/conv2d.py:
//    conv_tile_plan), by 128 output channels.  A K step is 64 channels of one
//    tap: one TMA 4D box of x at (c0, x0 + dx - 1, y0 + dy - 1, n) -- TMA's
//    zero fill of out-of-range coordinates is the SAME halo, so no thread
//    computes an address or a halo predicate -- and one TMA 2D box of the
//    packed weight (O, 9C), both 128-byte rows in the 128B-swizzled layout
//    that wgmma reads in place.  Where C % 64 == 32 the last step of a tap has
//    its channels past C zero-filled the same way, so the 32 weight columns it
//    reads beyond its tap are multiplied by zeros.  A ring of kStages such
//    pairs is fed by one producer warp and drained by two consumer warpgroups,
//    each owning 64 pixel rows and issuing m64n128k16 products from shared
//    memory with f32 accumulators in registers; a stage's "empty" barrier
//    frees it for the next load as soon as the products that read it have
//    completed.  The residual tile arrives by TMA while the last steps run and
//    the output leaves by TMA store, both through the ring slot after the last
//    step, so the epilogue makes no scattered 4-byte accesses.  Two blocks
//    share an SM, so one block's epilogue overlaps the other's products.  Each
//    input box is fetched nine times, once per tap (L2 traffic: PERF.md).
//  * conv3x3_kernel (f32, and bf16 shapes the wgmma kernel does not take):
//    scalar f32 FMAs; a block owns a 64 x 64 tile, each thread a 4 x 4
//    register tile, so one shared load feeds four FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // output pixels per block
constexpr int kBlockN = 64;   // output channels per block
constexpr int kBlockK = 16;   // input channels of one tap per step
constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(o[0], o[1]);
  p2[1] = __floats2bfloat162_rn(o[2], o[3]);
}

// grid: (ceil(N*H*W / kBlockM), ceil(O / kBlockN)); block: kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ shift,
                   const T* __restrict__ residual, T* __restrict__ out, int N,
                   int H, int W, int C, int O, int relu) {
  // A tile stored k-major so a thread reads its 4 pixels as one float4;
  // +4 keeps the rows 16-byte aligned and spreads the transposed stores.
  __shared__ __align__(16) float As[kBlockK][kBlockM + 4];
  __shared__ __align__(16) float Bs[kBlockK][kBlockN];

  const int tid = threadIdx.x;
  const int M = N * H * W;
  const int m0 = blockIdx.x * kBlockM;
  const int o0 = blockIdx.y * kBlockN;

  // loader roles: A -> one pixel, 4 consecutive channels; B -> one K row,
  // 4 consecutive output channels
  const int a_p = tid >> 2;
  const int a_c = (tid & 3) * 4;
  const int a_m = m0 + a_p;
  const bool a_live = a_m < M;
  int a_n = 0, a_y = 0, a_x = 0;
  if (a_live) {
    a_n = a_m / (H * W);
    const int rem = a_m - a_n * H * W;
    a_y = rem / W;
    a_x = rem - a_y * W;
  }
  const int b_k = tid >> 4;
  const int b_o = o0 + (tid & 15) * 4;

  // compute roles: pixels ty*4 .. ty*4+3, channels tx*4 .. tx*4+3
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int K = 9 * C;
  for (int kb = 0; kb < K; kb += kBlockK) {
    const int tap = kb / C;
    const int c0 = kb - tap * C;
    const int iy = a_y + tap / 3 - 1;
    const int ix = a_x + tap % 3 - 1;
    float a4[4] = {0.f, 0.f, 0.f, 0.f};
    if (a_live && iy >= 0 && iy < H && ix >= 0 && ix < W)
      load4(x + (((size_t)a_n * H + iy) * W + ix) * C + c0 + a_c, a4);
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_c + i][a_p] = a4[i];

    float b4[4] = {0.f, 0.f, 0.f, 0.f};
    if (b_o < O) load4(w + (size_t)(kb + b_k) * O + b_o, b4);
    *reinterpret_cast<float4*>(&Bs[b_k][(tid & 15) * 4]) =
        make_float4(b4[0], b4[1], b4[2], b4[3]);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int o = o0 + tx * 4;
  if (o >= O) return;
  float sh[4];
  load4(shift + o, sh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = acc[i][j] + sh[j];
    if (residual != nullptr) {
      float rr[4];
      load4(residual + (size_t)m * O + o, rr);
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] += rr[j];
    }
    if (relu) {
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = fmaxf(r[j], 0.f);
    }
    store4(out + (size_t)m * O + o, r);
  }
}

// ---------------------------------------------------------------------------
// wgmma path (bf16, C % 32 == 0)
// ---------------------------------------------------------------------------

constexpr int kWgM = 128;              // output pixels per tile
constexpr int kWgN = 128;              // output channels per tile
constexpr int kWgK = 64;               // channels of one tap per K step
constexpr int kWgStages = 3;           // ring depth (two blocks an SM)
constexpr int kWgConsumers = 2;        // warpgroups of 64 pixel rows
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // + the producer warp
constexpr int kWgStageA = kWgM * kWgK * 2;   // 16 KB
constexpr int kWgStageB = kWgN * kWgK * 2;   // 16 KB
constexpr int kWgSmem = kWgStages * (kWgStageA + kWgStageB) + 1024 + 64;

// grid: (N * tiles_y * tiles_x, ceil(O / kWgN)); block: kWgThreads.
// xmap: x as (C, W, H, N), box (64, bw, bh, 1); wmap: the packed weight as
// (9C, O), box (64, 128); rmap / omap: the residual and the output as
// (O, W, H, N), boxes (64, bw, bh, 1); all SWIZZLE_128B.
//
// Epilogue: ring slot KT % kWgStages (the one after the last K step, free
// once both warpgroups' products of step KT - kWgStages completed, which
// its empty barrier records) holds the block's 128 x 128 output tile as two
// 64-channel boxes in the same layout.  Each warpgroup writes the weight
// half of the slot that the other still reads until then, so every
// consumer waits for that release first: on the empty barrier, or with a
// residual on the full barrier of the residual tile, which the producer
// loads there by TMA only after the release.  The consumers add shift and
// residual, apply the ReLU and round in place, and one thread writes the
// boxes back by TMA store, which drops the pixels and channels outside the
// tensor.
__global__ void __launch_bounds__(kWgThreads, 2)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap rmap,
                         const __grid_constant__ CUtensorMap omap,
                         const float* __restrict__ shift, int H, int W,
                         int C, int O, int relu, int has_residual, int bh,
                         int bw_log2) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128B swizzle repeats every 8 rows of 128 B
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* tiles_a = smem;
  uint8_t* tiles_b = smem + kWgStages * kWgStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kWgStages * (kWgStageA + kWgStageB));
  uint64_t* empty = full + kWgStages;

  const int bw = 1 << bw_log2;
  const int tiles_x = (W + bw - 1) >> bw_log2;
  const int tiles_y = (H + bh - 1) / bh;
  int tile = blockIdx.x;
  const int n = tile / (tiles_y * tiles_x);
  tile -= n * tiles_y * tiles_x;
  const int y0 = (tile / tiles_x) * bh;
  const int x0 = (tile % tiles_x) << bw_log2;
  const int o0 = blockIdx.y * kWgN;
  const int chunks = (C + kWgK - 1) / kWgK;   // K steps per tap
  const int KT = 9 * chunks;          // >= 9 > kWgStages
  const int s_out = KT % kWgStages;   // the epilogue's ring slot
  uint8_t* out_lo = tiles_a + s_out * kWgStageA;   // channels o0 .. o0+63
  uint8_t* out_hi = tiles_b + s_out * kWgStageB;   // o0+64 .. o0+127

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgConsumers);  // one arrival a warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kWgConsumers) {
    // producer: one thread keeps the ring full
    if ((tid & 31) == 0) {
      prefetch_tensor_map(&xmap);
      prefetch_tensor_map(&wmap);
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kWgStages;
        if (kt >= kWgStages) mbar_wait(&empty[s], ((kt / kWgStages) - 1) & 1);
        const int tap = kt / chunks;
        const int c0 = (kt - tap * chunks) * kWgK;
        mbar_arrive_expect_tx(&full[s], kWgStageA + kWgStageB);
        tma_load_4d(tiles_a + s * kWgStageA, &xmap, &full[s], c0,
                    x0 + tap % 3 - 1, y0 + tap / 3 - 1, n);
        tma_load_2d(tiles_b + s * kWgStageB, &wmap, &full[s], tap * C + c0,
                    o0);
      }
      if (has_residual) {
        mbar_wait(&empty[s_out], ((KT / kWgStages) - 1) & 1);
        mbar_arrive_expect_tx(&full[s_out], kWgStageA + kWgStageB);
        tma_load_4d(out_lo, &rmap, &full[s_out], o0, x0, y0, n);
        tma_load_4d(out_hi, &rmap, &full[s_out], o0 + 64, x0, y0, n);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns pixel rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  const int lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kWgStages;
    mbar_wait(&full[s], (kt / kWgStages) & 1);
    const uint64_t da =
        make_desc(tiles_a + s * kWgStageA + wg * 64 * 128, 1024, kSwizzle128);
    const uint64_t db = make_desc(tiles_b + s * kWgStageB, 1024, kSwizzle128);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWgK / 16; ++k)
      wgmma_m64n128k16_ss(acc, desc_add(da, 32 * k), desc_add(db, 32 * k), 1);
    wgmma_commit();
    // free the stage as soon as its products have completed: the ring then
    // keeps two stages in flight ahead of the products (releasing a step
    // later, to keep one group of products queued, ran slower on the H100)
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (has_residual)
    mbar_wait(&full[s_out], (KT / kWgStages) & 1);
  else
    mbar_wait(&empty[s_out], ((KT / kWgStages) - 1) & 1);

  // acc[4j + e] is pixel row r = 64 wg + 16 (warp % 4) + g + 8 (e / 2),
  // channel o0 + 8j + 2t + e % 2: element (r, c) of a 64-channel box sits at
  // r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + (warp & 3) * 16 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j) {
      const int o = o0 + 8 * j + 2 * t;
      uint8_t* box = j < 8 ? out_lo : out_hi;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
          box + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * t);
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (o < O) {
        v0 += shift[o];
        v1 += shift[o + 1];
      }
      if (has_residual) {
        const float2 rr = __bfloat1622float2(*p);
        v0 += rr.x;
        v1 += rr.y;
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      *p = __floats2bfloat162_rn(v0, v1);
    }
  }
  fence_async_shared();
  named_barrier_sync(1, 128 * kWgConsumers);
  if (tid == 0) {
    tma_store_4d(&omap, out_lo, o0, x0, y0, n);
    if (o0 + 64 < O) tma_store_4d(&omap, out_hi, o0 + 64, x0, y0, n);
    tma_store_wait();
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* shift,
            const void* residual, void* out, int N, int H, int W, int C, int O,
            int relu, cudaStream_t stream) {
  const long long M = (long long)N * H * W;
  const dim3 grid((unsigned)((M + kBlockM - 1) / kBlockM),
                  (O + kBlockN - 1) / kBlockN);
  conv3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(shift), static_cast<const T*>(residual),
      static_cast<T*>(out), N, H, W, C, O, relu);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  residual may be null.  They
// return the cudaError_t of the launch (0 on success).

// w: (3, 3, C, O); scalar FMA path, f32 or bf16.
extern "C" int cobevt_conv3x3(const void* x, const void* w, const void* shift,
                              const void* residual, void* out, int N, int H,
                              int W, int C, int O, int relu, int is_bf16,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % kBlockK != 0 ||
      O % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, w, shift, residual, out, N, H, W, C, O, relu, s);
  else
    launch<float>(x, w, shift, residual, out, N, H, W, C, O, relu, s);
  return (int)cudaGetLastError();
}

// wt: (O, 9*C), the folded weight with K contiguous, tap-major and
// channel-minor; wgmma path, bf16 only, C % 32 == 0, O % 8 == 0,
// every pointer 16-byte aligned.  (bh, bw) is the tile's spatial box,
// bh * bw == 128 and bw a power of two (ops/conv2d.py:conv_tile_plan).
extern "C" int cobevt_conv3x3_wgmma(const void* x, const void* wt,
                                    const void* shift, const void* residual,
                                    void* out, int N, int H, int W, int C,
                                    int O, int relu, int bh, int bw,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int bw_log2 = 0;
  while ((1 << bw_log2) < bw) ++bw_log2;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 32 != 0 ||
      O % 8 != 0 || (1 << bw_log2) != bw || bh * bw != kWgM)
    return (int)cudaErrorInvalidValue;
  // an NHWC activation of `ch` channels as (ch, W, H, N), 64-channel boxes
  auto nhwc_map = [&](CUtensorMap* map, const void* base, int ch) {
    const uint64_t dims[4] = {(uint64_t)ch, (uint64_t)W, (uint64_t)H,
                              (uint64_t)N};
    const uint64_t strides[3] = {(uint64_t)ch * 2, (uint64_t)W * ch * 2,
                                 (uint64_t)H * W * ch * 2};
    const uint32_t box[4] = {kWgK, (uint32_t)bw, (uint32_t)bh, 1};
    return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                                 base, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
  };
  CUtensorMap xmap, wmap, rmap, omap;
  err = nhwc_map(&xmap, x, C);
  if (err == cudaSuccess) err = nhwc_map(&omap, out, O);
  // without a residual the kernel never reads rmap
  if (err == cudaSuccess)
    err = nhwc_map(&rmap, residual != nullptr ? residual : out, O);
  if (err != cudaSuccess) return (int)err;
  {
    const uint64_t dims[2] = {(uint64_t)9 * C, (uint64_t)O};
    const uint64_t strides[1] = {(uint64_t)9 * C * 2};
    const uint32_t box[2] = {kWgK, kWgN};
    err = hopper_host::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                wt, dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return (int)err;
  }
  static bool configured[64] = {};
  if (device >= 64 || !configured[device]) {
    err = cudaFuncSetAttribute(conv3x3_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWgSmem);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) configured[device] = true;
  }
  const long long tiles =
      (long long)N * ((H + bh - 1) / bh) * ((W + bw - 1) / bw);
  const dim3 grid((unsigned)tiles, (O + kWgN - 1) / kWgN);
  conv3x3_wgmma_kernel<<<grid, kWgThreads, kWgSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, rmap, omap, static_cast<const float*>(shift), H, W, C, O,
      relu, residual != nullptr, bh, bw_log2);
  return (int)cudaGetLastError();
}
