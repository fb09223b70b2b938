// K7: fused stride-1 SAME 3x3 convolution with int8 products for Hopper
// (sm_90a), inference; and the same kernel on int8-resident activations.
//
// Replaces the Pallas kernel cobevt_tpu/ops/conv2d.py:fused_conv3x3_int8
// (body _conv_kernel_int8).  Contract, as there: x (N, H, W, C) NHWC in f32
// or bf16; the folded weight arrives quantized per output channel (s8, here
// transposed to (O, 9*C) so K is contiguous); the activations are quantized
// per tensor INSIDE the kernel as clip(rint(f32(x) * inv), +-127) with
// inv = 1 / s_a read from device memory; nine shifted s8 x s8 -> s32
// products; epilogue f32(acc) * scale[o] + shift[o] (+ f32(residual)),
// optional ReLU, one store in x's dtype.  scale[o] = s_a * s_w[o] is
// computed by the caller.  C % 64 == 0, O % 8 == 0, W <= 128.
//
// The second entry, cobevt_conv3x3_s8, is the conv of the int8-resident
// chain (cobevt_tpu/ops/int8_chain.py:conv3x3_s8, plain XLA there: PyTorch
// has no integer convolution on CUDA): x arrives as s8 and is copied into
// the halo tile as it is; the residual is s8 at its own scale; the epilogue
// either requantizes, clip(rint(f / out_scale), +-127) stored as s8 with the
// clipped values counted, or casts to f32 / bf16 (the region's exit).
//
// What bounds it on the H100: a layer3 conv is 24 G multiply-adds x 2 against
// ~21 MB of activations, so the integer tensor cores, not memory, set its
// floor.  The design follows from where the TPU body puts its quantization
// (in the scratch build, never as a separate pass over device memory):
//
//  * A block owns up to 128 output pixels that are whole rows of one image
//    (TR = 128 / W rows) and 128 output channels (64 when O <= 64).  It
//    first stages the (TR + 2) x (W + 2) x C halo tile of x into shared
//    memory AS s8: each thread loads 8 channels (16 bytes of bf16),
//    multiplies by inv in f32, rounds half to even, clips and packs 8 bytes.
//    Halo rows and columns outside the image are written as 0.  So every
//    activation is quantized once per block, not once per tap, and x is read
//    from device memory once per column block.
//  * The nine taps then read their shifted A fragments straight from that
//    tile (a pixel row is C + 16 bytes, so the eight rows of a fragment hit
//    distinct banks); no per-tap staging of A.
//  * The s8 weights stream through a two-stage cp.async ring, 64 input
//    channels of one tap per stage (rows padded to 80 bytes).
//  * 8 warps each hold 32 x 64 (or 32 x 32) s32 accumulators and run
//    mma.sync.m16n8k32.s8.s8.s32; wgmma with TMA-staged weights is the next
//    step.
//  * The epilogue uses unfused multiplies, adds and divisions (__fmul_rn,
//    __fadd_rn, __fdiv_rn), so its results equal the plain PyTorch
//    version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kM = 128;        // output pixel slots per block
constexpr int kK = 64;         // input channels of one tap per stage
constexpr int kBRow = 80;      // bytes of a weight row in shared memory
constexpr int kAPad = 16;      // bytes added to a halo pixel's C channels
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

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

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
  o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// clip(rint(v * inv), +-127) as one byte; rint is round-half-to-even
__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  int q = __float2int_rn(__fmul_rn(v, inv));
  q = max(-127, min(127, q));
  return static_cast<uint32_t>(q) & 0xffu;
}

// 8 channels of one pixel as 8 s8 values: quantized, or copied when the
// activations are already s8
template <typename T>
__device__ __forceinline__ uint2 stage8(const T* p, float inv) {
  float v[8];
  load8(p, v);
  uint2 packed;
  packed.x = quantize(v[0], inv) | quantize(v[1], inv) << 8 |
             quantize(v[2], inv) << 16 | quantize(v[3], inv) << 24;
  packed.y = quantize(v[4], inv) | quantize(v[5], inv) << 8 |
             quantize(v[6], inv) << 16 | quantize(v[7], inv) << 24;
  return packed;
}
__device__ __forceinline__ uint2 stage8(const int8_t* p, float) {
  return *reinterpret_cast<const uint2*>(p);
}

// the residual's value in f32: as it is, or s8 times its scale
__device__ __forceinline__ float residual_value(float v, float) { return v; }
__device__ __forceinline__ float residual_value(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float residual_value(int8_t v, float scale) {
  return __fmul_rn((float)v, scale);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// clip(rint(v / out_scale), +-127) as s8; adds one to clipped when it clips
__device__ __forceinline__ int8_t requantize(float v, float out_scale,
                                             int& clipped) {
  const float ticks = rintf(__fdiv_rn(v, out_scale));
  clipped += fabsf(ticks) > 127.f;
  return (int8_t)(int)fminf(fmaxf(ticks, -127.f), 127.f);
}

// Pointers to the scalars a launch may need; each may be null.
struct Scalars {
  const float* inv;             // 1 / s_a: TIn is not s8
  const float* residual_scale;  // TRes is s8
  const float* out_scale;       // TOut is s8
  unsigned int* clipped;        // TOut is s8: += values the requantize clipped
};

// grid: (N * ceil(H / TR), ceil(O / kN)); block: kThreads; dynamic shared
// memory: the s8 halo tile, then two weight stages.  NT: n8 tiles a warp,
// 8 (a block owns 128 channels) or 4 (64).
template <typename TIn, typename TOut, typename TRes, int NT>
__global__ void __launch_bounds__(kThreads)
    conv3x3_int8_kernel(const TIn* __restrict__ x,
                        const int8_t* __restrict__ wt,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, Scalars scalars,
                        const TRes* __restrict__ residual,
                        TOut* __restrict__ out, int H, int W, int C, int O,
                        int TR, int relu) {
  constexpr int kN = 16 * NT;   // output channels per block
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = C + kAPad;                 // bytes of a halo pixel
  const int Wp = W + 2;
  unsigned char* As = smem;
  unsigned char* Bs = smem + (size_t)(TR + 2) * Wp * Cp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = (H + TR - 1) / TR;
  const int n = blockIdx.x / tiles;
  const int y0 = (blockIdx.x - n * tiles) * TR;
  const int o0 = blockIdx.y * kN;
  const int K = 9 * C;

  auto load_b = [&](int kt, int stage) {
#pragma unroll
    for (int i = 0; i < kN * 4 / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int row = q >> 2;
      const int part = (q & 3) * 16;
      const int o = o0 + row;
      const bool ok = o < O;
      const int8_t* src = ok ? wt + (size_t)o * K + kt * kK + part : wt;
      cp_async16(Bs + (stage * kN + row) * kBRow + part, src, ok);
    }
    cp_async_commit();
  };
  load_b(0, 0);

  // the halo tile, quantized once
  const float inv = scalars.inv != nullptr ? *scalars.inv : 0.f;
  const int c8 = C / 8;
  const int chunks = (TR + 2) * Wp * c8;
  for (int i = tid; i < chunks; i += kThreads) {
    const int pix = i / c8;
    const int ch = (i - pix * c8) * 8;
    const int hy = pix / Wp;
    const int iy = y0 - 1 + hy;
    const int ix = pix - hy * Wp - 1;
    uint2 packed = make_uint2(0u, 0u);
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      packed = stage8(x + (((size_t)n * H + iy) * W + ix) * C + ch, inv);
    *reinterpret_cast<uint2*>(As + (size_t)pix * Cp + ch) = packed;
  }

  // warp tile: pixel slots wm*32 .. +31 (2 m16 tiles), channels wn*NT*8 ..
  // (NT n8 tiles); fragment rows g and g + 8, k bytes 4t .. 4t+3 (+16)
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  int a_off[2][2];     // byte offset of the slot's own pixel in the halo tile
  int out_pix[2][2];   // its pixel index in the image, -1 when the slot is idle
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm * 32 + i * 16 + g + 8 * h;
      const int r = p / W;
      const int c = p - r * W;
      const bool live = r < TR && y0 + r < H;
      a_off[i][h] = live ? ((r + 1) * Wp + c + 1) * Cp : (Wp + 1) * Cp;
      out_pix[i][h] = live ? (y0 + r) * W + c : -1;
    }

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int per_tap = C / kK;
  const int KT = 9 * per_tap;
  for (int kt = 0; kt < KT; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < KT) {
      load_b(kt + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tap = kt / per_tap;
    const int dy = tap / 3 - 1;
    const int dx = tap - (tap / 3) * 3 - 1;
    const int a_shift = (dy * Wp + dx) * Cp + (kt - tap * per_tap) * kK;
    const unsigned char* bs = Bs + stage * kN * kBRow;
#pragma unroll
    for (int kk = 0; kk < kK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* lo = As + a_off[i][0] + a_shift + kk + 4 * t;
        const unsigned char* hi = As + a_off[i][1] + a_shift + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(lo);
        a[i][1] = *reinterpret_cast<const uint32_t*>(hi);
        a[i][2] = *reinterpret_cast<const uint32_t*>(lo + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(hi + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* bp =
            bs + ((wn * NT + j) * 8 + g) * kBRow + kk + 4 * t;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(bp);
        b[1] = *reinterpret_cast<const uint32_t*>(bp + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_s8_16832(acc[i][j], a[i], b);
      }
    }
    __syncthreads();
  }

  // epilogue: C fragment rows g and g + 8, columns 2t, 2t + 1
  const size_t image = (size_t)n * H * W;
  float res_scale = 0.f, out_scale = 1.f;
  if constexpr (std::is_same<TRes, int8_t>::value)
    if (residual != nullptr) res_scale = *scalars.residual_scale;
  if constexpr (std::is_same<TOut, int8_t>::value)
    out_scale = *scalars.out_scale;
  int clipped = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int o = o0 + (wn * NT + j) * 8 + 2 * t;
    if (o >= O) continue;
    const float sc0 = scale[o], sc1 = scale[o + 1];
    const float sh0 = shift[o], sh1 = shift[o + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (out_pix[i][h] < 0) continue;
        const size_t off = (image + out_pix[i][h]) * O + o;
        float v0 = __fadd_rn(__fmul_rn((float)acc[i][j][2 * h], sc0), sh0);
        float v1 = __fadd_rn(__fmul_rn((float)acc[i][j][2 * h + 1], sc1), sh1);
        if (residual != nullptr) {
          v0 = __fadd_rn(v0, residual_value(residual[off], res_scale));
          v1 = __fadd_rn(v1, residual_value(residual[off + 1], res_scale));
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if constexpr (std::is_same<TOut, int8_t>::value) {
          char2 q;
          q.x = requantize(v0, out_scale, clipped);
          q.y = requantize(v1, out_scale, clipped);
          *reinterpret_cast<char2*>(out + off) = q;
        } else {
          store2(out + off, v0, v1);
        }
      }
    }
  }
  if constexpr (std::is_same<TOut, int8_t>::value) {
    if (scalars.clipped != nullptr) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        clipped += __shfl_xor_sync(0xffffffffu, clipped, d);
      if (lane == 0 && clipped > 0)
        atomicAdd(scalars.clipped, (unsigned int)clipped);
    }
  }
}

struct Shape {
  int N, H, W, C, O;
};

bool shape_ok(const Shape& s) {
  return s.N > 0 && s.H > 0 && s.W > 0 && s.W <= kM && s.C > 0 && s.O > 0 &&
         s.C % kK == 0 && s.O % 8 == 0;
}

template <typename TIn, typename TOut, typename TRes, int NT>
cudaError_t launch_nt(const void* x, const void* wt, const void* scale,
                      const void* shift, Scalars scalars,
                      const void* residual, void* out, const Shape& s,
                      int relu, cudaStream_t stream) {
  constexpr int kN = 16 * NT;
  const int rows = kM / s.W > 1 ? kM / s.W : 1;
  const int TR = rows < s.H ? rows : s.H;
  const size_t bytes =
      (size_t)(TR + 2) * (s.W + 2) * (s.C + kAPad) + 2 * kN * kBRow;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = conv3x3_int8_kernel<TIn, TOut, TRes, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(s.N * ((s.H + TR - 1) / TR)),
                  (s.O + kN - 1) / kN);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TIn*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      scalars, static_cast<const TRes*>(residual), static_cast<TOut*>(out),
      s.H, s.W, s.C, s.O, TR, relu);
  return cudaGetLastError();
}

// 64-channel blocks when they cover O, else 128-channel blocks
template <typename TIn, typename TOut, typename TRes>
cudaError_t launch(const void* x, const void* wt, const void* scale,
                   const void* shift, Scalars scalars, const void* residual,
                   void* out, const Shape& s, int relu,
                   cudaStream_t stream) {
  if (s.O <= 64)
    return launch_nt<TIn, TOut, TRes, 4>(x, wt, scale, shift, scalars,
                                         residual, out, s, relu, stream);
  return launch_nt<TIn, TOut, TRes, 8>(x, wt, scale, shift, scalars,
                                       residual, out, s, relu, stream);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  wt: (O, 9*C) s8, the quantized
// folded weight with K contiguous; scale: (O,) f32, the product of the
// activations' and the weight's scales; shift: (O,) f32; residual may be
// null.  They return the cudaError_t of the launch (0 on success).

// K7.  x, residual and out in f32 or bf16; inv: one f32 on the device,
// 1 / s_a.
extern "C" int cobevt_conv3x3_int8(const void* x, const void* wt,
                                   const void* scale, const void* shift,
                                   const void* inv, const void* residual,
                                   void* out, int N, int H, int W, int C,
                                   int O, int relu, int is_bf16, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{N, H, W, C, O};
  if (!shape_ok(s) || inv == nullptr) return (int)cudaErrorInvalidValue;
  const Scalars scalars{static_cast<const float*>(inv), nullptr, nullptr,
                        nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        x, wt, scale, shift, scalars, residual, out, s, relu, st);
  else
    err = launch<float, float, float>(x, wt, scale, shift, scalars, residual,
                                      out, s, relu, st);
  return (int)err;
}

// The conv of the int8-resident chain.  x and residual are s8;
// residual_scale: one f32 on the device (read when residual is given).
// out_kind 0: requantize to s8 at *out_scale (one f32 on the device), adding
// the number of clipped values to *clipped (one u32 on the device, may be
// null); 1: cast to f32; 2: cast to bf16.
extern "C" int cobevt_conv3x3_s8(const void* x, const void* wt,
                                 const void* scale, const void* shift,
                                 const void* residual,
                                 const void* residual_scale, void* out,
                                 const void* out_scale, void* clipped, int N,
                                 int H, int W, int C, int O, int relu,
                                 int out_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{N, H, W, C, O};
  if (!shape_ok(s) || (residual != nullptr && residual_scale == nullptr) ||
      (out_kind == 0 && out_scale == nullptr) || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  const Scalars scalars{nullptr, static_cast<const float*>(residual_scale),
                        static_cast<const float*>(out_scale),
                        static_cast<unsigned int*>(clipped)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    err = launch<int8_t, int8_t, int8_t>(x, wt, scale, shift, scalars,
                                         residual, out, s, relu, st);
  else if (out_kind == 1)
    err = launch<int8_t, float, int8_t>(x, wt, scale, shift, scalars,
                                        residual, out, s, relu, st);
  else
    err = launch<int8_t, __nv_bfloat16, int8_t>(x, wt, scale, shift, scalars,
                                                residual, out, s, relu, st);
  return (int)err;
}
