// K7: fused stride-1 SAME 3x3 convolution with int8 products for Hopper
// (sm_90a), inference; and the same kernel on int8-resident activations.
//
// Replaces the Pallas kernel cobevt_tpu/ops/conv2d.py:fused_conv3x3_int8
// (body _conv_kernel_int8, scale _act_scale).  Contract, as there: x (N, H,
// W, C) NHWC in f32 or bf16; the folded weight arrives quantized per output
// channel (s8, here transposed to (O, 9*C) so K is contiguous); the
// activations are quantized per tensor INSIDE the kernel as
// clip(rint(f32(x) * inv), +-127); nine shifted s8 x s8 -> s32 products;
// epilogue f32(acc) * scale[o] + shift[o] (+ f32(residual)), optional ReLU,
// one store in x's dtype.  The scale is folded in: the kernel reads m, the
// bits of f32(max |x|), from a device slot and computes s_a = max(m / 127,
// 1e-12), inv = 1 / s_a and scale[o] = s_a * s_w[o] with the rounded
// operations of ops/conv2d.py:act_scale on the card (there the division by
// the Python scalar 127 is a multiply by its f32 reciprocal); with an
// output slot its epilogue folds the |max| of what it stored into it by an
// integer atomicMax (non-negative floats order as their bits), the next
// K7's input scale.  absmax_kernel fills a slot where the producer is not a
// K7.  C % 64 == 0, O % 8 == 0, W <= 128.
//
// The second entry, cobevt_conv3x3_s8, is the conv of the int8-resident
// chain (cobevt_tpu/ops/int8_chain.py:conv3x3_s8, plain XLA there: PyTorch
// has no integer convolution on CUDA): x arrives as s8; the residual is s8
// at its own scale; the epilogue either requantizes, clip(rint(f /
// out_scale), +-127) stored as s8 with the clipped values counted, or casts
// to f32 / bf16 (the region's exit).  At C = O = 64 and W <= 128 (layer1,
// (20, 128, 128, 64): every launch of the chain) it runs conv3x3_s8_strip
// (namespace chain), else conv3x3_int8_kernel with the s8 activations copied
// into its halo tile as they are.  A layer1 conv is 24 G multiply-adds x 2
// (0.012 ms at the int8 peak) against 21 MB of s8 in and out (+ 21 MB of
// residual; 0.013-0.019 ms at 3.35 TB/s): memory and the epilogue, not the
// tensor cores, bound it.  conv3x3_int8_kernel gave every image row its own
// block (2,560 blocks), each staging a 3-row halo and streaming the whole
// 36 KB weight through a two-stage ring: 0.158 / 0.171 / 0.132 ms a conv1 /
// conv2 / exit conv on an H100, on the card alone, 2.1 times cuDNN's bf16
// conv.  The strip kernel keeps the weight resident, reads each halo row
// once a strip of rows, and its epilogue runs on the full-rate pipes; its
// design is at the kernel and its times in PERF.md.
//
// What bounds it on the H100: a layer3 conv is 24 G multiply-adds x 2 against
// ~21 MB of activations, so the integer tensor cores, not memory, set its
// floor.  The design follows from where the TPU body puts its quantization
// (in the scratch build, never as a separate pass over device memory): a
// block owns up to 128 output pixels that are whole rows of one image (TR =
// 128 / W rows) and first stages the (TR + 2) x (W + 2) halo tile of x into
// shared memory AS s8 (8 channels a thread: 16 bytes of bf16 loaded,
// multiplied by inv in f32, rounded half to even, clipped, packed; zeros
// outside the image), so every activation is quantized once per block, not
// once per tap.  Two kernels:
//
//  * conv3x3_int8_wgmma (namespace wg; C a multiple of 128 and of its
//    channel group: every int8 trunk block): 128 output channels a block,
//    two warpgroups of 64 pixel slots each, wgmma m64n128k32 s8 with A from
//    registers (ldmatrix of the halo rows a tap shifts to) and the weight
//    streamed by TMA in 16 KB boxes through a ring with full / empty
//    mbarriers; the halo tile holds one group of 256 channels at a time, so
//    two blocks fit an SM at both trunk shapes.  Its design and what bounds
//    it are at the kernel;
//  * conv3x3_int8_kernel (the rest, and the chain's conv at other shapes):
//    128 channels a block, 8 warps each holding 32 x 64 (or 32 x 32) s32
//    accumulators on mma.sync.m16n8k32.s8.s8.s32, the weight through a
//    two-stage cp.async ring of 64 input channels of one tap (rows padded
//    to 80 bytes), the halo tile's pixels C + 16 bytes apart so the eight
//    rows of a fragment hit distinct banks.
//
// Every epilogue uses unfused multiplies, adds and divisions (__fmul_rn,
// __fadd_rn, __fdiv_rn, or exact replacements of them), so its results
// equal the plain PyTorch version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
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

// two neighbouring values (o even: 8- or 4-byte aligned) as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// The int8 chain's epilogue, 4,096 outputs a warpgroup a row, holds most
// of a block's time (tools/micro_s8.py), so it keeps its rounding and its
// s8 bytes on the full-rate floating-point pipes, off the conversions (F2I,
// FRND) that issue at a fraction of FADD's rate.  x + kMagic, for |x| <
// 2^22, is 1.5 * 2^23 + rint(x) (round half to even), the integer in the
// low mantissa bits.
constexpr float kMagic = 12582912.f;

// an s8 value as f32, exactly
__device__ __forceinline__ float s8_float(int b) {
  return __fsub_rn(__int_as_float(0x4B400000 + b), kMagic);
}

// rint(v / out_scale) as requantize computes it, with the quotient from a
// multiply by inv = 1 / out_scale and the division only where the two may
// round to different integers: the product's relative error against the
// exact quotient is below 2^-22 (two roundings and the reciprocal's), so
// their rint agree unless the product lies within that of a half-integer
// (every |q| >= 2^22 takes the division too)
__device__ __forceinline__ float requantize_ticks(float v, float out_scale,
                                                  float inv) {
  const float q = __fmul_rn(v, inv);
  const float r = __fsub_rn(__fadd_rn(q, kMagic), kMagic);
  return 0.5f - fabsf(q - r) <= fabsf(q) * 4.8e-7f
             ? rintf(__fdiv_rn(v, out_scale))
             : r;
}

// clip(ticks, +-127) as one s8 value (its two's complement byte)
__device__ __forceinline__ int8_t ticks_s8(float ticks) {
  return (int8_t)__float_as_int(
      __fadd_rn(fminf(fmaxf(ticks, -127.f), 127.f), kMagic));
}

// Pointers to the scalars a launch may need; each may be null.
struct Scalars {
  const unsigned* in_amax;      // TIn is not s8: the bits of f32(max |x|)
  const float* s_w;             // TIn is not s8: the weight's scales (O,)
  unsigned* out_amax;           // TOut is not s8: max |out| is folded in
  const float* residual_scale;  // TRes is s8
  const float* out_scale;       // TOut is s8
  unsigned int* clipped;        // TOut is s8: += values the requantize clipped
};

// s_a = max(f32(m) / 127, 1e-12) as PyTorch computes act_scale on the card
// (ops/conv2d.py: the division by a Python scalar is a multiply by its f32
// reciprocal there), then 1 / s_a; scale[o] = s_a * s_w[o] follows
__device__ __forceinline__ float act_scale_of(unsigned amax_bits) {
  return fmaxf(__fmul_rn(__uint_as_float(amax_bits), 1.f / 127.f), 1e-12f);
}

// max |v| over the warp into *slot (non-negative floats order as their
// bits); the caller's lanes all take part
__device__ __forceinline__ void fold_amax(float m, unsigned* slot) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  if ((threadIdx.x & 31) == 0 && m > 0.f) atomicMax(slot, __float_as_uint(m));
}

// the value a store of v in T keeps, as f32
__device__ __forceinline__ float stored(float v, float) { return v; }
__device__ __forceinline__ float stored(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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
  float s_a = 0.f, inv = 0.f;
  if (scalars.in_amax != nullptr) {
    s_a = act_scale_of(*scalars.in_amax);
    inv = __fdiv_rn(1.f, s_a);
  }
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
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int o = o0 + (wn * NT + j) * 8 + 2 * t;
    if (o >= O) continue;
    const float sc0 = scalars.s_w != nullptr
                          ? __fmul_rn(s_a, scalars.s_w[o]) : scale[o];
    const float sc1 = scalars.s_w != nullptr
                          ? __fmul_rn(s_a, scalars.s_w[o + 1]) : scale[o + 1];
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
          amax = fmaxf(amax, fmaxf(fabsf(stored(v0, TOut())),
                                   fabsf(stored(v1, TOut()))));
        }
      }
    }
  }
  if constexpr (!std::is_same<TOut, int8_t>::value)
    if (scalars.out_amax != nullptr) fold_amax(amax, scalars.out_amax);
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

// ---------------------------------------------------------------------------
// K7 on wgmma (C % 128 == 0: every int8 trunk block), f32 or bf16 x
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kSlots = 128;     // output pixel slots a block: 2 x 64
constexpr int kOut = 128;       // output channels a block
constexpr int kKBox = 128;      // input channels of one tap a ring box
constexpr int kBox = kOut * kKBox;   // bytes of a ring box (s8)
constexpr int kMaxStages = 4;

// The halo tile is quantized one channel group at a time (256 channels, or
// C when it is smaller), so a block's halo tile holds kGroup + 16 bytes a
// pixel and two layer4 blocks fit an SM.
constexpr int kGroup = 256;

__host__ __device__ inline int group_of(int C) {
  return C < kGroup ? C : kGroup;
}

// The halo tile, the scales, the ring and the barriers of a block with
// `stages` ring boxes; the host's plan (ops/conv2d.py:int8_tile_plan)
// computes the same bytes.
__host__ __device__ inline int halo_bytes(int TR, int W, int C) {
  return (TR + 2) * (W + 2) * (group_of(C) + kAPad);
}
__host__ __device__ inline int smem_bytes(int TR, int W, int C, int stages) {
  return 1024 + stages * kBox + ((halo_bytes(TR, W, C) + 1023) & ~1023) +
         2 * kOut * 4 + 2 * kMaxStages * 8;
}

// Quantizes channels c0 .. c0 + CG of the (TR + 2) x (W + 2) halo of image
// n, rows y0 - 1 .. y0 + TR, into As (CG + 16 bytes a pixel) as s8; zero
// outside the image.  Thread tid takes the 8-channel chunk tid % (CG / 8)
// of every (256 / (CG / 8))-th pixel, its position advanced by additions,
// and issues kBatch loads before it converts the first.
template <typename T>
__device__ __forceinline__ void quantize_halo(uint8_t* As, const T* x, int n,
                                              int y0, int H, int W, int C,
                                              int c0, int CG, int TR,
                                              float inv, int tid) {
  constexpr int kBatch = 8;
  constexpr int kWords = sizeof(T) / 2;   // 16-byte words of 8 values
  const int c8 = CG / 8;
  const int step = 256 / c8;              // pixels a pass (CG >= 128)
  const int Wp = W + 2, Cgp = CG + kAPad;
  const int pixels = (TR + 2) * Wp;
  const int ch = (tid % c8) * 8;
  int pix = tid / c8;
  int hy = pix / Wp, hx = pix - (pix / Wp) * Wp;
  while (pix < pixels) {
    uint4 raw[kBatch][kWords];
    int dst[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int iy = y0 - 1 + hy, ix = hx - 1;
      dst[b] = pix < pixels ? pix * Cgp + ch : -1;
      const bool inside =
          pix < pixels && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const uint4* src = reinterpret_cast<const uint4*>(
          x + (((size_t)n * H + iy) * W + ix) * C + c0 + ch);
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        raw[b][k] = inside ? src[k] : make_uint4(0u, 0u, 0u, 0u);
      pix += step;
      hx += step;
      while (hx >= Wp) {
        hx -= Wp;
        ++hy;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (dst[b] >= 0)
        *reinterpret_cast<uint2*>(As + dst[b]) =
            stage8(reinterpret_cast<const T*>(raw[b]), inv);
  }
}

// grid: (N * ceil(H / TR), ceil(O / 128)); block: two warpgroups, each
// owning 64 of the 128 pixel slots (TR whole image rows) and all 128 output
// channels.  The prologue turns the input's |max| slot into s_a, 1 / s_a
// and s_a * s_w[o] (the rounded operations of act_scale) while thread 0
// starts `stages` boxes of the (O, 9 C) s8 weight (128 channels of one tap
// x 128 output channels, 128B-swizzled, K-major) on their way by TMA.  Then
// per channel group the (TR + 2) x (W + 2) halo tile is quantized into
// shared memory as s8 once, and each box of the group is four k32 steps of
// wgmma m64n128k32 s8 with A from registers: ldmatrix_x4 of the shifted
// halo rows (a tap is a row shift of the tile, which does not align with
// wgmma's 8-row core matrices, so A cannot be a descriptor).  The epilogue
// is the plain version's:
// f32(acc) * scale[o] + shift[o] (+ f32(residual)), ReLU, one store; with
// out_amax it also folds the |max| of what it stored into that slot, the
// next K7's input scale.
template <typename T>
__global__ void __launch_bounds__(256, 2)
    conv3x3_int8_wgmma(const __grid_constant__ CUtensorMap wmap,
                       const T* __restrict__ x,
                       const unsigned* __restrict__ in_amax,
                       const float* __restrict__ s_w,
                       const float* __restrict__ shift,
                       const T* __restrict__ residual, T* __restrict__ out,
                       unsigned* __restrict__ out_amax, int H, int W, int C,
                       int O, int TR, int relu, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int CG = group_of(C);
  const int Cgp = CG + kAPad, Wp = W + 2;
  uint8_t* As = ring + stages * kBox;
  float* sc = reinterpret_cast<float*>(
      As + ((halo_bytes(TR, W, C) + 1023) & ~1023));
  float* sh = sc + kOut;
  uint64_t* full = reinterpret_cast<uint64_t*>(sh + kOut);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x, grp = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int tiles = (H + TR - 1) / TR;
  const int n = blockIdx.x / tiles;
  const int y0 = (blockIdx.x - n * tiles) * TR;
  const int o0 = blockIdx.y * kOut;
  const int per_tap = CG / kKBox;
  const int per_group = 9 * per_tap;
  const int KT = (C / CG) * per_group;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // item i: channel group i / per_group, tap, 128-channel box of the group
  int issued = 0;
  auto issue = [&]() {   // thread 0
    const int i = issued++;
    const int s = i % stages, r = i / stages;
    if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
    const int grp_i = i / per_group, j = i - grp_i * per_group;
    const int tap = j / per_tap;
    mbar_arrive_expect_tx(&full[s], kBox);
    tma_load_2d(ring + s * kBox, &wmap, &full[s],
                tap * C + grp_i * CG + (j - tap * per_tap) * kKBox, o0);
  };
  if (tid == 0)
    while (issued < KT && issued < stages) issue();

  // the scales of this call
  const float s_a = act_scale_of(*in_amax);
  const float inv = __fdiv_rn(1.f, s_a);
  if (tid < kOut) {
    const int o = o0 + tid;
    sc[tid] = o < O ? __fmul_rn(s_a, s_w[o]) : 0.f;
    sh[tid] = o < O ? shift[o] : 0.f;
  }

  // this lane's ldmatrix row: slot 64 grp + 16 warp + (lane % 8) + 8 (bit 3
  // of lane), bytes 16 (lane / 16) of the k32 step; an idle slot reads the
  // tile's first interior pixel
  int a_row;
  {
    const int p = grp * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int r = p / W, c = p - (p / W) * W;
    const bool live = r < TR && y0 + r < H;
    a_row = (live ? ((r + 1) * Wp + c + 1) * Cgp : (Wp + 1) * Cgp) +
            (lane >> 4) * 16;
  }
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int c0 = 0, kt = 0; c0 < C; c0 += CG) {
    if (c0 > 0) __syncthreads();   // every warp is done with the last group
    quantize_halo(As, x, n, y0, H, W, C, c0, CG, TR, inv, tid);
    __syncthreads();
    for (int j = 0; j < per_group; ++j, ++kt) {
      const int s = kt % stages;
      const int tap = j / per_tap;
      const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
      const uint8_t* a_base =
          As + a_row + (dy * Wp + dx) * Cgp + (j - tap * per_tap) * kKBox;
      uint32_t a[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) ldmatrix_x4(a[k], a_base + 32 * k);
      mbar_wait(&full[s], (kt / stages) & 1);
      const uint8_t* bs = ring + s * kBox;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n128k32_s8_rs(acc, a[k],
                               make_desc(bs + 32 * k, 1024, kSwizzle128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if ((tid & 127) == 0) mbar_arrive(&empty[s]);
      if (tid == 0 && issued < KT) issue();
      __syncwarp();
    }
  }

  // epilogue: accumulator rows 16 warp + g (+ 8), columns 8 j + 2 t (+ 1)
  const int g = lane >> 2, t = lane & 3;
  int out_pix[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int p = grp * 64 + warp * 16 + g + 8 * hr;
    const int r = p / W, c = p - (p / W) * W;
    out_pix[hr] = r < TR && y0 + r < H ? (y0 + r) * W + c : -1;
  }
  const size_t image = (size_t)n * H * W;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int oc = 8 * j + 2 * t;
    const int o = o0 + oc;
    if (o >= O) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (out_pix[hr] < 0) continue;
      const size_t off = (image + out_pix[hr]) * O + o;
      float v0 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * hr], sc[oc]),
                           sh[oc]);
      float v1 = __fadd_rn(
          __fmul_rn((float)acc[4 * j + 2 * hr + 1], sc[oc + 1]), sh[oc + 1]);
      if (residual != nullptr) {
        const float2 r = load2(residual + off);
        v0 = __fadd_rn(v0, r.x);
        v1 = __fadd_rn(v1, r.y);
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      store2(out + off, v0, v1);
      amax = fmaxf(amax, fmaxf(fabsf(stored(v0, T())), fabsf(stored(v1, T()))));
    }
  }
  if (out_amax != nullptr) fold_amax(amax, out_amax);
}

template <typename T>
cudaError_t launch(const void* x, const void* wt, const void* in_amax,
                   const void* s_w, const void* shift, const void* residual,
                   void* out, void* out_amax, const Shape& s, int relu,
                   int TR, int stages, cudaStream_t stream) {
  const int bytes = smem_bytes(TR, s.W, s.C, stages);
  if (stages < 2 || stages > kMaxStages || bytes > kMaxSmem ||
      TR * s.W > kSlots || s.C % kKBox || s.C % group_of(s.C))
    return cudaErrorInvalidValue;
  CUtensorMap wmap;
  const uint64_t dims[2] = {(uint64_t)9 * s.C, (uint64_t)s.O};
  const uint64_t strides[1] = {(uint64_t)9 * s.C};
  const uint32_t box[2] = {kKBox, kOut};
  cudaError_t err = hopper_host::make_map(
      &wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wt, dims, strides, box,
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_int8_wgmma<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(s.N * ((s.H + TR - 1) / TR)),
                  (s.O + kOut - 1) / kOut);
  kernel<<<grid, 256, bytes, stream>>>(
      wmap, static_cast<const T*>(x), static_cast<const unsigned*>(in_amax),
      static_cast<const float*>(s_w), static_cast<const float*>(shift),
      static_cast<const T*>(residual), static_cast<T*>(out),
      static_cast<unsigned*>(out_amax), s.H, s.W, s.C, s.O, TR, relu, stages);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The int8 chain's conv on wgmma: C = O = 64, W <= 128 (layer1), s8 in
// ---------------------------------------------------------------------------

namespace chain {

using namespace hopper;

constexpr int kCh = 64;                    // C = O
constexpr int kMaxW = 128;                 // two 64-pixel segments a row
constexpr int kHaloPix = kMaxW + 2;        // a halo row's pixels
constexpr int kHaloBytes = 8704;           // kHaloPix * 64, to 512 bytes
constexpr int kHaloStages = 5;
constexpr int kResBytes = kMaxW * kCh;
constexpr int kResStages = 2;
constexpr int kTapBytes = kCh * kCh;       // one tap of the weight
constexpr int kWBytes = 9 * kTapBytes;
constexpr int kOutBytes = 64 * kCh;        // a segment's s8 output row
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp

// Shared memory of a block, laid out from a 1024-byte aligned base; the
// host's plan (ops/int8_chain.py:s8_plan) computes the same bytes.
constexpr int kHaloOff = kWBytes;
constexpr int kResOff = kHaloOff + kHaloStages * kHaloBytes;
constexpr int kOutOff = kResOff + kResStages * kResBytes;
constexpr int kScaleOff = kOutOff + 2 * kOutBytes;
constexpr int kBarOff = kScaleOff + 2 * kCh * 4;
constexpr int kBars = 1 + 2 * kHaloStages + 2 * kResStages;
constexpr int kSmemBytes = 1024 + kBarOff + kBars * 8 + 16;

// Where a block's time goes (tools/micro_s8.py builds a copy that defines
// these to stamp the global timer): the time since the last mark counts to
// phase 0 (waiting for halo and residual rows), 1 (products) or 2
// (epilogue).
#ifndef S8_PHASES_BEGIN
#define S8_PHASES_BEGIN
#define S8_MARK(phase)
#define S8_PHASES_END
#endif

// byte of (pixel p, channel c) in a row of 64-byte pixels written by TMA
// with SWIZZLE_64B from a 512-byte aligned base: 16-byte chunk c / 16 of
// pixel p sits at chunk (c / 16) ^ ((p / 2) % 4)
__device__ __forceinline__ int sw64(int p, int c) {
  return p * 64 + ((((c >> 4) ^ (p >> 1)) & 3) << 4) + (c & 15);
}

// grid: persistent blocks, each walking strips blockIdx.x, + gridDim.x, ...
// of `strip` output rows of one image (the last strip of an image may be
// shorter); block: two consumer warpgroups, one 64-pixel segment of a row
// each, and a producer warp.  The producer's lane 0 TMA-loads the 36 KB
// weight once (nine 64 x 64 taps, SWIZZLE_64B), then streams the strip's
// halo rows (130 pixels x 64 channels from x = -1: TMA fills the columns
// and rows outside the image with zeros) through a ring of kHaloStages
// row buffers and the residual rows through a ring of kResStages, each
// buffer with full / empty mbarriers; every input row is read once a
// strip.  Output row y of the strip is the product of halo rows y - 1, y,
// y + 1: per row buffer, six m64n64k32 s8 products with A from registers
// (ldmatrix_x4 of the rows a tap shifts to, through the swizzle) and B the
// resident tap.  The epilogue is the plain version's, unfused: f32(acc) *
// scale[o] + shift[o] (+ f32(residual) * residual_scale), ReLU, then
// clip(rint(f / out_scale), +-127) into a swizzled staging row that one
// TMA store writes (KIND 0), or the cast to f32 (1) or bf16 (2) stored
// from registers (the chain's exit, once a frame).  Clipped values are
// counted in registers and added to *clipped once a block.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_s8_strip(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap rmap,
                     const __grid_constant__ CUtensorMap omap,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const float* __restrict__ residual_scale,
                     const float* __restrict__ out_scale,
                     unsigned int* __restrict__ clipped,
                     void* __restrict__ out, int N, int H, int W, int strip,
                     int has_res, int relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* w_s = base;
  uint8_t* halo = base + kHaloOff;
  uint8_t* res = base + kResOff;
  float* sc = reinterpret_cast<float*>(base + kScaleOff);
  float* sh = sc + kCh;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(base + kBarOff);
  uint64_t* hfull = wbar + 1;
  uint64_t* hempty = hfull + kHaloStages;
  uint64_t* rfull = hempty + kHaloStages;
  uint64_t* rempty = rfull + kResStages;
  unsigned int* clip_s = reinterpret_cast<unsigned int*>(rempty + kResStages);

  const int tid = threadIdx.x;
  const int per_image = (H + strip - 1) / strip;
  const int strips = N * per_image;
  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&hempty[s], kConsumers / 32);
    }
    for (int s = 0; s < kResStages; ++s) {
      mbar_init(&rfull[s], 1);
      mbar_init(&rempty[s], kConsumers / 32);
    }
    *clip_s = 0u;
    fence_barrier_init();
  }
  if (tid < kCh) {
    sc[tid] = scale[tid];
    sh[tid] = shift[tid];
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp; its lane 0 issues
    if (tid != kConsumers) return;
    mbar_arrive_expect_tx(wbar, kWBytes);
    for (int tap = 0; tap < 9; ++tap)
      tma_load_2d(w_s + tap * kTapBytes, &wmap, wbar, tap * kCh, 0);
    int hi = 0, ri = 0;
    auto halo_row = [&](int n, int y) {
      const int s = hi % kHaloStages, r = hi / kHaloStages;
      if (r > 0) mbar_wait(&hempty[s], (r - 1) & 1);
      mbar_arrive_expect_tx(&hfull[s], kHaloPix * kCh);
      tma_load_4d(halo + s * kHaloBytes, &xmap, &hfull[s], 0, -1, y, n);
      ++hi;
    };
    auto res_row = [&](int n, int y) {
      const int s = ri % kResStages, r = ri / kResStages;
      if (r > 0) mbar_wait(&rempty[s], (r - 1) & 1);
      mbar_arrive_expect_tx(&rfull[s], kResBytes);
      tma_load_4d(res + s * kResBytes, &rmap, &rfull[s], 0, 0, y, n);
      ++ri;
    };
    for (int st = blockIdx.x; st < strips; st += gridDim.x) {
      const int n = st / per_image, y0 = (st - n * per_image) * strip;
      const int rows = min(strip, H - y0);
      halo_row(n, y0 - 1);
      halo_row(n, y0);
      for (int j = 0; j < rows; ++j) {
        halo_row(n, y0 + j + 1);
        if (has_res) res_row(n, y0 + j);
      }
    }
    return;
  }

  const int grp = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int x0 = grp * 64;
  // this lane's ldmatrix row: halo pixel lp + dx of a tap, chunk 2k + lc
  const int lp = x0 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lc = lane >> 4;
  const float rs = has_res ? *residual_scale : 0.f;
  const float os = KIND == 0 ? *out_scale : 1.f;
  const float inv_os = KIND == 0 ? __fdiv_rn(1.f, os) : 1.f;
  const bool count = KIND == 0 && clipped != nullptr;
  uint8_t* stage = base + kOutOff + grp * kOutBytes;
  unsigned int nclip = 0;
  S8_PHASES_BEGIN
  mbar_wait(wbar, 0);
  int hi = 0, ri = 0;
  for (int st = blockIdx.x; st < strips; st += gridDim.x) {
    const int n = st / per_image, y0 = (st - n * per_image) * strip;
    const int rows = min(strip, H - y0);
    for (int j = 0; j < rows; ++j) {
      const int y = y0 + j;
      int acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int item = hi + j + dy;
        const int s = item % kHaloStages;
        mbar_wait(&hfull[s], (item / kHaloStages) & 1);
        S8_MARK(0)
        const uint8_t* hrow = halo + s * kHaloBytes;
        uint32_t a[3][2][4];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            ldmatrix_x4(a[dx][k], hrow + sw64(lp + dx, 32 * k + 16 * lc));
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            wgmma_m64n64k32_s8_rs(
                acc, a[dx][k],
                make_desc(w_s + (3 * dy + dx) * kTapBytes + 32 * k, 512,
                          kSwizzle64),
                1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        S8_MARK(1)
      }
      // halo row j has had its last reader in this warp
      __syncwarp();
      if (lane == 0) mbar_arrive(&hempty[(hi + j) % kHaloStages]);

      const uint8_t* rrow = nullptr;
      if (has_res) {
        const int s = ri % kResStages;
        mbar_wait(&rfull[s], (ri / kResStages) & 1);
        rrow = res + s * kResBytes;
        S8_MARK(0)
      }
      if constexpr (KIND == 0) {   // the last row's store has read the stage
        if ((tid & 127) == 0) tma_store_wait_read();
        named_barrier_sync(1 + grp, 128);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int o = 8 * jj + 2 * t;
        const float2 sc2 = *reinterpret_cast<const float2*>(sc + o);
        const float2 sh2 = *reinterpret_cast<const float2*>(sh + o);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int p = warp * 16 + g + 8 * hr;   // pixel of the segment
          const int x = x0 + p;
          float v0 = __fadd_rn(
              __fmul_rn((float)acc[4 * jj + 2 * hr], sc2.x), sh2.x);
          float v1 = __fadd_rn(
              __fmul_rn((float)acc[4 * jj + 2 * hr + 1], sc2.y), sh2.y);
          if (has_res) {
            const char2 r = *reinterpret_cast<const char2*>(rrow + sw64(x, o));
            v0 = __fadd_rn(v0, __fmul_rn(s8_float(r.x), rs));
            v1 = __fadd_rn(v1, __fmul_rn(s8_float(r.y), rs));
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if constexpr (KIND == 0) {
            const float q0 = requantize_ticks(v0, os, inv_os);
            const float q1 = requantize_ticks(v1, os, inv_os);
            if (count && x < W)
              nclip += (fabsf(q0) > 127.f) + (fabsf(q1) > 127.f);
            char2 q;
            q.x = ticks_s8(q0);
            q.y = ticks_s8(q1);
            *reinterpret_cast<char2*>(stage + sw64(p, o)) = q;
          } else if (x < W) {
            typedef typename std::conditional<KIND == 1, float,
                                              __nv_bfloat16>::type TOut;
            store2(static_cast<TOut*>(out) +
                       (((size_t)n * H + y) * W + x) * kCh + o,
                   v0, v1);
          }
        }
      }
      if (has_res) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&rempty[ri % kResStages]);
        ++ri;
      }
      if constexpr (KIND == 0) {
        fence_async_shared();
        named_barrier_sync(1 + grp, 128);
        if ((tid & 127) == 0 && x0 < W) {
          tma_store_4d(&omap, stage, 0, x0, y, n);
          tma_store_commit();
        }
      }
      S8_MARK(2)
    }
    // the strip's last two halo rows
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&hempty[(hi + rows) % kHaloStages]);
      mbar_arrive(&hempty[(hi + rows + 1) % kHaloStages]);
    }
    hi += rows + 2;
  }
  if constexpr (KIND == 0) {
    if ((tid & 127) == 0) tma_store_wait_all();
    if (clipped != nullptr) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        nclip += __shfl_xor_sync(0xffffffffu, nclip, d);
      if (lane == 0 && nclip) atomicAdd(clip_s, nclip);
      named_barrier_sync(3, kConsumers);
      if (tid == 0 && *clip_s) atomicAdd(clipped, *clip_s);
    }
  }
  S8_PHASES_END
}

// s8 (N, H, W, 64) as a 4-D map (channels, x, y, n) with boxes of `pixels`
// x 64 channels, SWIZZLE_64B
inline cudaError_t row_map(CUtensorMap* map, const void* base, const Shape& s,
                           int pixels) {
  const uint64_t dims[4] = {(uint64_t)kCh, (uint64_t)s.W, (uint64_t)s.H,
                            (uint64_t)s.N};
  const uint64_t strides[3] = {(uint64_t)kCh, (uint64_t)s.W * kCh,
                               (uint64_t)s.H * s.W * kCh};
  const uint32_t box[4] = {kCh, (uint32_t)pixels, 1, 1};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base,
                               dims, strides, box,
                               CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int KIND>
cudaError_t launch(const void* x, const void* wt, const void* scale,
                   const void* shift, const void* residual,
                   const void* residual_scale, void* out,
                   const void* out_scale, void* clipped, const Shape& s,
                   int relu, int strip, int blocks, cudaStream_t stream) {
  if (s.C != kCh || s.O != kCh || s.W > kMaxW || strip <= 0 || blocks <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, rmap, omap;
  cudaError_t err = row_map(&xmap, x, s, kHaloPix);
  if (err == cudaSuccess) {
    const uint64_t dims[2] = {9 * (uint64_t)kCh, (uint64_t)kCh};
    const uint64_t strides[1] = {9 * (uint64_t)kCh};
    const uint32_t box[2] = {kCh, kCh};
    err = hopper_host::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wt,
                                dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_64B);
  }
  rmap = omap = xmap;   // not read when absent
  if (err == cudaSuccess && residual != nullptr)
    err = row_map(&rmap, residual, s, kMaxW);
  if (err == cudaSuccess && KIND == 0) err = row_map(&omap, out, s, 64);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_s8_strip<KIND>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      xmap, wmap, rmap, omap, static_cast<const float*>(scale),
      static_cast<const float*>(shift),
      static_cast<const float*>(residual_scale),
      static_cast<const float*>(out_scale),
      static_cast<unsigned int*>(clipped), out, s.N, s.H, s.W, strip,
      residual != nullptr, relu);
  return cudaGetLastError();
}

}  // namespace chain

// max |x| over n values (n % 8 == 0) folded into *slot: 16-byte loads, one
// atomicMax a warp
template <typename T>
__global__ void __launch_bounds__(256)
    absmax_kernel(const T* __restrict__ x, long long n8,
                  unsigned* __restrict__ slot) {
  float m = 0.f;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n8;
       i += (long long)gridDim.x * 256) {
    float v[8];
    load8(x + i * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  fold_amax(m, slot);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  wt: (O, 9*C) s8, the quantized
// folded weight with K contiguous; scale: (O,) f32, the product of the
// activations' and the weight's scales; shift: (O,) f32; residual may be
// null.  They return the cudaError_t of the launch (0 on success).

// K7.  x, residual and out in f32 or bf16; in_amax: one u32 on the device,
// the bits of f32(max |x|); s_w: (O,) f32; out_amax: null or one u32 on the
// device into which the |max| of the stored output is folded (atomicMax:
// the caller zeroes it).  TR: image rows a block, stages: 0 for the
// mma.sync kernel (any C % 64 == 0), else the weight ring's depth of the
// wgmma kernel (C % 128 == 0), from ops/conv2d.py:int8_tile_plan.
extern "C" int cobevt_conv3x3_int8(const void* x, const void* wt,
                                   const void* s_w, const void* shift,
                                   const void* in_amax, const void* residual,
                                   void* out, void* out_amax, int N, int H,
                                   int W, int C, int O, int relu, int is_bf16,
                                   int TR, int stages, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{N, H, W, C, O};
  if (!shape_ok(s) || in_amax == nullptr || s_w == nullptr || TR <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages > 0) {
    if (is_bf16)
      err = wg::launch<__nv_bfloat16>(x, wt, in_amax, s_w, shift, residual,
                                      out, out_amax, s, relu, TR, stages, st);
    else
      err = wg::launch<float>(x, wt, in_amax, s_w, shift, residual, out,
                              out_amax, s, relu, TR, stages, st);
    return (int)err;
  }
  const Scalars scalars{static_cast<const unsigned*>(in_amax),
                        static_cast<const float*>(s_w),
                        static_cast<unsigned*>(out_amax), nullptr, nullptr,
                        nullptr};
  if (is_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        x, wt, nullptr, shift, scalars, residual, out, s, relu, st);
  else
    err = launch<float, float, float>(x, wt, nullptr, shift, scalars,
                                      residual, out, s, relu, st);
  return (int)err;
}

// max |x| of n values (f32 or bf16, n % 8 == 0, 16-byte aligned) folded into
// the u32 *slot (the caller zeroes it): the input scale of a K7 whose
// producer is not a K7.
extern "C" int cobevt_int8_absmax(const void* x, long long n, void* slot,
                                  int is_bf16, int blocks, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || n % 8 || slot == nullptr || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* u = static_cast<unsigned*>(slot);
  if (is_bf16)
    absmax_kernel<<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n / 8, u);
  else
    absmax_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(x), n / 8,
                                          u);
  return (int)cudaGetLastError();
}

// The conv of the int8-resident chain.  x and residual are s8;
// residual_scale: one f32 on the device (read when residual is given).
// out_kind 0: requantize to s8 at *out_scale (one f32 on the device), adding
// the number of clipped values to *clipped (one u32 on the device, may be
// null); 1: cast to f32; 2: cast to bf16.  strip_rows, blocks: the strip
// kernel's output rows a strip and persistent blocks (C = O = 64, W <= 128;
// ops/int8_chain.py:s8_plan), or strip_rows 0 for the mma.sync kernel.
extern "C" int cobevt_conv3x3_s8(const void* x, const void* wt,
                                 const void* scale, const void* shift,
                                 const void* residual,
                                 const void* residual_scale, void* out,
                                 const void* out_scale, void* clipped, int N,
                                 int H, int W, int C, int O, int relu,
                                 int out_kind, int strip_rows, int blocks,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape s{N, H, W, C, O};
  if (!shape_ok(s) || (residual != nullptr && residual_scale == nullptr) ||
      (out_kind == 0 && out_scale == nullptr) || out_kind < 0 ||
      out_kind > 2 || strip_rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strip_rows > 0) {
#define S8_STRIP(KIND)                                                     \
  chain::launch<KIND>(x, wt, scale, shift, residual, residual_scale, out, \
                      out_scale, clipped, s, relu, strip_rows, blocks, st)
    err = out_kind == 0 ? S8_STRIP(0) : (out_kind == 1 ? S8_STRIP(1)
                                                        : S8_STRIP(2));
#undef S8_STRIP
    return (int)err;
  }
  const Scalars scalars{nullptr, nullptr, nullptr,
                        static_cast<const float*>(residual_scale),
                        static_cast<const float*>(out_scale),
                        static_cast<unsigned int*>(clipped)};
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
