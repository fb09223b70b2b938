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
// 32^2 x 256, 16^2 x 512, N = 4 cameras per agent) each conv is ~24 GFLOP
// against ~20 MB of activations, so it is bound by arithmetic: the tensor
// cores, not memory, set its floor.  Both kernels below are implicit GEMMs
// -- M = N*H*W output pixels, N = O channels, K = 9*C taps x channels --
// that walk K one tap at a time: the shifted input rows (with the zero
// halo at the image edge) and the matching weight rows are staged in
// shared memory, and the folded-BN shift, the residual and the ReLU run on
// the f32 accumulators before the single store, so the conv output never
// makes a round trip through device memory.
//
//  * conv3x3_tc_kernel (bf16, C % 32 == 0, O % 8 == 0 -- every trunk
//    block): tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulate).  A block owns a 128-pixel x 128-channel tile; 8 warps
//    each hold 32 x 64 accumulators in registers.  32-channel K slices are
//    double-buffered in shared memory with cp.async (zero-filled for the
//    halo), so the next slice loads while the tensor cores run.  Rows are
//    padded to 40 halves so the fragment loads hit 32 distinct banks.
//    wgmma/TMA would be the next step.
//  * conv3x3_kernel (f32, and bf16 shapes the tensor-core path does not
//    take): scalar f32 FMAs; a block owns a 64 x 64 tile, each thread a
//    4 x 4 register tile, so one shared load feeds four FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

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
// tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcM = 128;      // output pixels per block
constexpr int kTcN = 128;      // output channels per block
constexpr int kTcK = 32;       // input channels of one tap per stage
constexpr int kTcPad = 40;     // smem row length in halves (80 B)
constexpr int kTcThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid: (ceil(N*H*W / kTcM), ceil(O / kTcN)); block: kTcThreads.
// wt is the folded weight transposed to (O, 9*C): K contiguous per channel.
__global__ void __launch_bounds__(kTcThreads)
    conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wt,
                      const float* __restrict__ shift,
                      const __nv_bfloat16* __restrict__ residual,
                      __nv_bfloat16* __restrict__ out, int N, int H, int W,
                      int C, int O, int relu) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kTcM][kTcPad];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kTcN][kTcPad];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int M = N * H * W;
  const int m0 = blockIdx.x * kTcM;
  const int o0 = blockIdx.y * kTcN;
  const int K = 9 * C;

  // loader roles: 2 x 16-byte chunks of A and of B per thread; chunk q
  // covers row q / 4, halves (q % 4) * 8 .. +7 of the 32-wide K slice
  int a_n[2], a_y[2], a_x[2];
  bool a_live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ((tid + i * kTcThreads) >> 2);
    a_live[i] = m < M;
    const int mm = a_live[i] ? m : 0;
    a_n[i] = mm / (H * W);
    const int rem = mm - a_n[i] * H * W;
    a_y[i] = rem / W;
    a_x[i] = rem - a_y[i] * W;
  }
  const int part = (tid & 3) * 8;

  auto load_stage = [&](int kb, int stage) {
    const int tap = kb / C;
    const int c0 = kb - tap * C;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid + i * kTcThreads) >> 2;
      const int iy = a_y[i] + dy;
      const int ix = a_x[i] + dx;
      const bool ok = a_live[i] && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const __nv_bfloat16* src =
          ok ? x + (((size_t)a_n[i] * H + iy) * W + ix) * C + c0 + part : x;
      cp_async16(&As[stage][row][part], src, ok);
      const int o = o0 + row;
      const bool okb = o < O;
      const __nv_bfloat16* srcb = okb ? wt + (size_t)o * K + kb + part : wt;
      cp_async16(&Bs[stage][row][part], srcb, okb);
    }
    cp_async_commit();
  };

  // warp tile: rows wm*32 .. +31 (2 m16 tiles), cols wn*64 .. +63 (8 n8)
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int g = lane >> 2;   // group id
  const int t = lane & 3;    // thread in group
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int KT = K / kTcK;
  load_stage(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < KT) {
      load_stage((kt + 1) * kTcK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        a[i][0] =
            *reinterpret_cast<const uint32_t*>(&As[stage][r][kk + 2 * t]);
        a[i][1] =
            *reinterpret_cast<const uint32_t*>(&As[stage][r + 8][kk + 2 * t]);
        a[i][2] =
            *reinterpret_cast<const uint32_t*>(&As[stage][r][kk + 2 * t + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(
            &As[stage][r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = wn * 64 + j * 8 + g;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Bs[stage][n][kk + 2 * t]);
        b[1] =
            *reinterpret_cast<const uint32_t*>(&Bs[stage][n][kk + 2 * t + 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16_16816(acc[i][j], a[i], b);
      }
    }
    __syncthreads();
  }

  // epilogue: C fragment rows g and g + 8, columns 2t, 2t + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int o = o0 + wn * 64 + j * 8 + 2 * t;
    if (o >= O) continue;
    const float s0 = shift[o];
    const float s1 = shift[o + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        float v0 = acc[i][j][2 * h] + s0;
        float v1 = acc[i][j][2 * h + 1] + s1;
        const size_t off = (size_t)m * O + o;
        if (residual != nullptr) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(residual + off));
          v0 += r.x;
          v1 += r.y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + off) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
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

// wt: (O, 9*C), the folded weight with K contiguous; tensor-core path,
// bf16 only.
extern "C" int cobevt_conv3x3_tc(const void* x, const void* wt,
                                 const void* shift, const void* residual,
                                 void* out, int N, int H, int W, int C, int O,
                                 int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % kTcK != 0 ||
      O % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)N * H * W;
  const dim3 grid((unsigned)((M + kTcM - 1) / kTcM), (O + kTcN - 1) / kTcN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv3x3_tc_kernel<<<grid, kTcThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt), static_cast<const float*>(shift),
      static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), N, H, W, C, O, relu);
  return (int)cudaGetLastError();
}
