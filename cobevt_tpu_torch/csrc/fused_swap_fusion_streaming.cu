// K6: one FuseBEVT sublayer over a state too large to keep resident, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel cobevt_tpu/ops/fused_swap_fusion.py:
// fused_swap_fusion_streaming (-> pallas_call :409, body _stream_kernel
// :333, attention _grouped_attn :314).  One call applies one sublayer (LN ->
// QKV, q scaled after the cast -> attention with the 3-D rel-pos bias and
// the additive key mask, both in f32 -> out-projection -> residual -> LN ->
// FFN with erf-GELU -> residual) to every window (half 0) or grid cell
// (half 1) of the (B, L, H, W, D) state.  The agent pooling and the head
// stay outside, as the JAX package leaves them to XLA.
//
// What the TPU kernel is shaped by, and what is done here instead.  The TPU
// grid walks (batch, x, y) in order with the weights and the (T, heads*T)
// bias resident in VMEM, picks the window's mask row with a one-hot
// product, splits the heads into 128-channel groups for its block-diagonal
// products, and pays an XLA transpose of the whole state before and after
// every grid half.  None of that carries over: the cooperative-LiDAR state
// is (5, 96, 176, 256), 84,480 tokens of width 256, FFN width 512, windows
// of T = 320 tokens, and a block has 227 KB, so one C entry runs a sublayer
// as three launches on the caller's stream (the wrapper counts it once):
// token rows (window-major, found by index math on the state:
// swap_state.cuh, for window and grid cells alike, so no transposed copy of
// the state exists) through LN + QKV, the attention, and the rows again
// through out-projection + residual + LN + FFN + residual.  A sublayer
// reads one state buffer and writes another, never in place, because the
// blocks of one window read all of its tokens while other blocks write.
//
// bf16 at D 128 or 256 with head dim 16 or 32 and mlp a multiple of 128
// (every FuseBEVT of the repo; ops/fused_swap_fusion.py:stream_kernel_path)
// runs the wgmma kernels of namespace wg, modelled on K2's projections:
//   * QKV: persistent blocks of two warpgroups, one 64-row tile each; a
//     block's blockIdx.y picks q, k or v and TMA-loads that D x D slice of
//     Wqkv once (128 KB at D 256); the gather and the LN run in the prologue
//     (16 values a lane, every load issued first) into a bf16 A tile in the
//     128B-swizzled layout, the product is m64n128k16, and the cast (q's
//     scale after it) goes back into the A tile, which one TMA store writes
//     to the (3, rows, D) scratch: the packed (G, T, heads*hd) layout of K1;
//   * attention: K1's window_attention_wgmma_kernel itself
//     (window_attention.cuh) on q, k, v, with the f32 (T, heads*T) bias and
//     the (G, T) f32 key mask of this half, gathered once per half by the
//     wrapper; K1 adds -1e9 in f32 where the mask is <= 0, after the bias,
//     so a fully masked window stays finite and uniform, as here before.
//     K1 sums the exp unrounded where the plain version sums it rounded to
//     bf16 (K1's one documented difference), within K6's tolerance;
//   * output: persistent blocks of two warpgroups on a pair of tiles.  Wout,
//     w1 and w2 (640 KB at D 256 / mlp 512) cannot be resident, so thread 0
//     streams them through a ring of 4 boxes of 64 columns x D rows (32 KB)
//     by TMA with full / empty mbarriers, in the order the products consume
//     them; x1 = tok + att Wout stays in f32 in the accumulators, LN(cast
//     x1) goes back to the A tile, the FFN runs 128 hidden columns at a time
//     (erf-GELU and the cast into a hidden tile) and its second product is
//     summed onto x1 at once; + b2, cast, staged, stored row by row.
// f32, and bf16 at other widths, run the first kernels: 16-row blocks of f32
// tiles whose products run on mma.sync from weights read from L2
// (rowops.cuh, Gemm<T, 16>), and flash.cuh's attention reading the mask
// through the window map.
//
// Bound on the H100: operations.  A LiDAR sublayer is 88.6 GFLOP of
// projections and 27.7 GFLOP of attention (0.12 ms at the bf16 peak)
// against ~91 MB of state, bias and weights (0.03 ms).  The q/k/v scratch
// (130 MB in bf16) and the attention output (43 MB) are this design's own
// traffic through device memory; a window-resident kernel would keep them
// on the SM.
#include "flash.cuh"
#include "hopper.cuh"
#include "rowops.cuh"
#include "swap_state.cuh"
#include "window_attention.cuh"

namespace {

using rowops::Gemm;
using rowops::kThreads;
using rowops::layer_norm_rows;
using rowops::ld8;
using rowops::pad;
using rowops::rnd;
using rowops::st8;
using rowops::to_f;
using rowops::zero8;
using swap_state::Dims;
using swap_state::state_offset;

constexpr int kStreamRows = 16;  // token rows per row-kernel block

// 1. LN + QKV (no bias) into (B*nwin*T, 3D); q = cast(qkv) * scale, cast.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream_qkv_kernel(const T* __restrict__ S, const T* __restrict__ ln_a,
                      const T* __restrict__ wqkv_t, float scale,
                      T* __restrict__ qkv, Dims d) {
  constexpr int R = kStreamRows;
  extern __shared__ __align__(16) float smem[];
  __shared__ long long src_off[R];
  const long long rows = (long long)d.B * d.L * d.H * d.W;
  const long long row0 = (long long)blockIdx.x * R;
  const int D = d.D, N = 3 * d.D;
  const int D8 = D / 8, N8 = N / 8;
  const int lda = pad(D), ldo = pad(N);
  float* A = smem;
  float* O = smem + R * lda;
  for (int r = threadIdx.x; r < R; r += kThreads)
    src_off[r] = row0 + r < rows ? state_offset(d, row0 + r) : -1;
  __syncthreads();
  for (int i = threadIdx.x; i < R * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long off = src_off[r];
    float v[8];
    if (off < 0)
      zero8(v);
    else
      ld8(S + off + c, v);
    st8(A + r * lda + c, v);
  }
  __syncthreads();
  layer_norm_rows<T, R>(A, lda, D, ln_a, ln_a + D, true);
  __syncthreads();
  Gemm<T, R>::run(A, lda, wqkv_t, D, N, O, ldo);
  __syncthreads();
  for (int i = threadIdx.x; i < R * N8; i += kThreads) {
    const int r = i / N8, c = (i - r * N8) * 8;
    if (row0 + r >= rows) continue;
    float v[8];
    ld8(O + r * ldo + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = rnd<T>(v[e]);
      if (c < D) v[e] = v[e] * scale;  // the scale follows the cast
    }
    st8(qkv + (row0 + r) * N + c, v);
  }
}

// 3. att @ Wout + residual -> x1; x1 + FFN(LN(cast(x1))) into S_out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream_out_kernel(const T* __restrict__ att, const T* __restrict__ S_in,
                      const T* __restrict__ wout_t,
                      const T* __restrict__ ln_f, const T* __restrict__ w1_t,
                      const T* __restrict__ b1, const T* __restrict__ w2_t,
                      const T* __restrict__ b2, T* __restrict__ S_out,
                      Dims d) {
  constexpr int R = kStreamRows;
  extern __shared__ __align__(16) float smem[];
  __shared__ long long src_off[R];
  const long long rows = (long long)d.B * d.L * d.H * d.W;
  const long long row0 = (long long)blockIdx.x * R;
  const int D = d.D, M = d.mlp;
  const int D8 = D / 8, M8 = M / 8;
  const int ld = pad(D), ldh = pad(M);
  float* A = smem;          // att, then LN(x1), then FFN out
  float* X1 = A + R * ld;   // x1 in f32
  float* Hb = X1 + R * ld;  // FFN hidden
  for (int r = threadIdx.x; r < R; r += kThreads)
    src_off[r] = row0 + r < rows ? state_offset(d, row0 + r) : -1;
  for (int i = threadIdx.x; i < R * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    float v[8];
    if (row0 + r < rows)
      ld8(att + (row0 + r) * D + c, v);
    else
      zero8(v);
    st8(A + r * ld + c, v);
  }
  __syncthreads();
  Gemm<T, R>::run(A, ld, wout_t, D, D, X1, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < R * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long off = src_off[r];
    float v[8], tok[8];
    ld8(X1 + r * ld + c, v);
    if (off < 0)
      zero8(tok);
    else
      ld8(S_in + off + c, tok);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = tok[e] + v[e];  // x1 = tok + att
    st8(X1 + r * ld + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = rnd<T>(v[e]);
    st8(A + r * ld + c, v);
  }
  __syncthreads();
  layer_norm_rows<T, R>(A, ld, D, ln_f, ln_f + D, true);
  __syncthreads();
  Gemm<T, R>::run(A, ld, w1_t, D, M, Hb, ldh);
  __syncthreads();
  for (int i = threadIdx.x; i < R * M8; i += kThreads) {
    const int r = i / M8, c = (i - r * M8) * 8;
    float v[8];
    ld8(Hb + r * ldh + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = rnd<T>(rowops::gelu_erf(v[e] + to_f(b1[c + e])));
    st8(Hb + r * ldh + c, v);
  }
  __syncthreads();
  Gemm<T, R>::run(Hb, ldh, w2_t, M, D, A, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < R * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long off = src_off[r];
    if (off < 0) continue;
    float x1[8], f[8];
    ld8(X1 + r * ld + c, x1);
    ld8(A + r * ld + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) x1[e] = x1[e] + (f[e] + to_f(b2[c + e]));
    st8(S_out + off + c, x1);
  }
}

// the window attention of the sublayer: qkv (rows, 3D) -> att (rows, D)
cudaError_t attention_launch(const void* qkv, const float* bias,
                             const float* mask, void* att, const Dims& d,
                             bool is_bf16, cudaStream_t s) {
  const int T = d.L * d.w * d.w;
  const int X = d.H / d.w, Y = d.W / d.w;
  const int D = d.D;
  const size_t elt = is_bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  flash::Args a = {};
  a.q = base;
  a.k = base + D * elt;
  a.v = base + 2 * D * elt;
  a.q_win = a.kv_win = (long long)T * 3 * D;
  a.ldq = a.ldkv = 3 * D;
  a.out = att;
  a.o_win = (long long)T * D;
  a.ldo = D;
  a.Tq = T;
  a.nseg = 1;
  a.Tk = T;
  a.heads = d.heads;
  a.bias = bias;
  a.mask = mask;
  a.L = d.L;
  a.wsz = d.w;
  a.X = X;
  a.Y = Y;
  a.Hs = d.H;
  a.Ws = d.W;
  a.grid = d.grid;
  a.mask_add = -1e9f;
  return flash::launch<true>(a, d.B * X * Y, D / d.heads, is_bf16, s);
}

template <typename T>
cudaError_t sublayer_launch(const void* S_in, void* S_out, void* qkv,
                            void* att, const void* ln_a, const void* wqkv_t,
                            const void* wout_t, const void* ln_f,
                            const void* w1_t, const void* b1,
                            const void* w2_t, const void* b2,
                            const float* bias, const float* mask, float scale,
                            const Dims& d, bool is_bf16, cudaStream_t s) {
  constexpr int R = kStreamRows;
  const long long rows = (long long)d.B * d.L * d.H * d.W;
  const int blocks = (int)((rows + R - 1) / R);
  const int smem_qkv = R * (pad(d.D) + pad(3 * d.D)) * (int)sizeof(float);
  const int smem_out = R * (2 * pad(d.D) + pad(d.mlp)) * (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(stream_qkv_kernel<T>, smem_qkv);
  if (err != cudaSuccess) return err;
  err = rowops::allow_smem(stream_out_kernel<T>, smem_out);
  if (err != cudaSuccess) return err;
  stream_qkv_kernel<T><<<blocks, kThreads, smem_qkv, s>>>(
      (const T*)S_in, (const T*)ln_a, (const T*)wqkv_t, scale, (T*)qkv, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = attention_launch(qkv, bias, mask, att, d, is_bf16, s);
  if (err != cudaSuccess) return err;
  stream_out_kernel<T><<<blocks, kThreads, smem_out, s>>>(
      (const T*)att, (const T*)S_in, (const T*)wout_t, (const T*)ln_f,
      (const T*)w1_t, (const T*)b1, (const T*)w2_t, (const T*)b2, (T*)S_out,
      d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on wgmma + TMA (ops/fused_swap_fusion.py:stream_kernel_path): D 128 or
// 256, head dim 16 or 32, mlp a multiple of 128.  The launches' grids and
// the weight ring's depth come from ops/fused_swap_fusion.py:stream_plan.
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;      // token rows a tile: one warpgroup
constexpr int kGroups = 2;     // warpgroups a block, on alternate tiles
constexpr int kAtomRow = 128;  // bytes of a swizzled row: 64 values
constexpr int kMaxStages = 4;  // the output launch's weight ring
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
// D slice of Wqkv a block TMA-loads once.  Its two warpgroups walk alternate
// 64-row tiles of the window-major token rows: gather through state_offset
// (D / 16 lanes a row, 16 values a lane, every load issued first), LN in
// f32 into the bf16 A tile, the product on wgmma, the cast (and q's scale
// after it) into the A tile, and a TMA store of the tile into the (3, rows,
// D) scratch, which is the packed (G, T, heads * hd) layout K1 reads.
template <int D>
__global__ void __launch_bounds__(128 * kGroups, 1)
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
  float* gb = reinterpret_cast<float*>(w_s + kW + kGroups * kA);
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
  for (int i = threadIdx.x; i < D; i += 128 * kGroups) {
    const int cl = i >> 4, e = i & 15;
    gb[e * LPR + cl] = __bfloat162float(ln_a[i]);
    gb[D + e * LPR + cl] = __bfloat162float(ln_a[D + i]);
  }
  __syncthreads();
  auto group_sync = [&]() { named_barrier_sync(1 + grp, 128); };
  const int rs = lane / LPR, cl = lane % LPR;
  const int rows = d.B * d.L * d.H * d.W;
  const int tiles = (rows + kTile - 1) / kTile;
  mbar_wait(bar, 0);
  for (int tile = blockIdx.x * kGroups + grp; tile < tiles;
       tile += gridDim.x * kGroups) {
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

// One pass of the output launch's weight ring, for a pair of tiles: item i
// is a box of Wout (k-atom i, all D rows), then per 128 hidden columns c the
// boxes of w1 (rows c .. c + 127, each k-atom of D) and of w2 (all D rows,
// hidden columns c .. c + 127 as two k-atoms).  Mirrored by
// tests/test_torch_stream_int8_plans.py:stream_items.
struct Item {
  int which, row, col, bytes;   // which: 0 Wout, 1 w1, 2 w2
};

template <int D>
__device__ __forceinline__ Item item_of(int i) {
  constexpr int KA = D / 64;
  if (i < KA) return {0, 0, i * 64, D * kAtomRow};
  const int j = i - KA;
  const int c = j / (KA + 2), e = j - c * (KA + 2);
  if (e < KA) return {1, c * 128, e * 64, 128 * kAtomRow};
  return {2, 0, c * 128 + (e - KA) * 64, D * kAtomRow};
}

// The output launch.  A persistent block of two warpgroups walks pairs of
// 64-row tiles (one a warpgroup); thread 0 streams the 640 KB of Wout, w1
// and w2 (at D 256 / mlp 512) through a ring of `stages` boxes of 64
// columns, refilling a box once both warpgroups are past it (its empty
// mbarrier).  A warpgroup TMA-loads its attention rows, x1 = tok + att Wout
// stays in f32 in its accumulators, LN(cast x1) goes back to the A tile in
// bf16, the FFN runs 128 hidden columns at a time (erf-GELU, cast, into the
// hidden tile) and its second product is summed onto x1 at once; the sum,
// + b2, cast, is staged in the A tile and stored row by row through
// state_offset.
template <int D>
__global__ void __launch_bounds__(128 * kGroups, 1)
    stream_out_wgmma(const __grid_constant__ CUtensorMap attmap,
                     const __grid_constant__ CUtensorMap womap,
                     const __grid_constant__ CUtensorMap w1map,
                     const __grid_constant__ CUtensorMap w2map,
                     const bf16* __restrict__ S_in,
                     const bf16* __restrict__ ln_f,
                     const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                     bf16* __restrict__ S_out, Dims d, int stages) {
  constexpr int NH = D / 128;
  constexpr int KA = D / 64;
  constexpr int kStage = D * kAtomRow;   // the largest box: D rows
  constexpr int kA = kTile * D * 2;
  constexpr int kH = kTile * 128 * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  const int grp = threadIdx.x >> 7;
  uint8_t* a_s = ring + stages * kStage + grp * (kA + kH);
  uint8_t* h_s = a_s + kA;
  int* offs = reinterpret_cast<int*>(ring + stages * kStage +
                                     kGroups * (kA + kH)) + grp * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + stages * kStage + kGroups * (kA + kH) + kGroups * kTile * 4);
  uint64_t* empty = full + kMaxStages;
  uint64_t* abar = empty + kMaxStages;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  auto group_sync = [&]() { named_barrier_sync(1 + grp, 128); };

  const int rows = d.B * d.L * d.H * d.W;
  const int tiles = (rows + kTile - 1) / kTile;
  const int pairs = (tiles + kGroups - 1) / kGroups;
  const int per_pass = KA + (d.mlp / 128) * (KA + 2);
  const int my_pairs =
      blockIdx.x < pairs ? (pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_pairs * per_pass;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGroups);
    }
    for (int q = 0; q < kGroups; ++q) mbar_init(&abar[q], 1);
    fence_barrier_init();
  }
  __syncthreads();
  int issued = 0;   // thread 0's producer count
  auto issue = [&]() {
    const int i = issued++;
    const int s = i % stages, r = i / stages;
    if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
    const Item it = item_of<D>(i % per_pass);
    mbar_arrive_expect_tx(&full[s], it.bytes);
    tma_load_2d(ring + s * kStage,
                it.which == 0 ? &womap : (it.which == 1 ? &w1map : &w2map),
                &full[s], it.col, it.row);
  };
  if (threadIdx.x == 0)
    while (issued < total && issued < stages) issue();
  int used = 0;     // the items this thread's warpgroup consumed
  auto take = [&]() -> const uint8_t* {
    const int s = used % stages;
    mbar_wait(&full[s], (used / stages) & 1);
    return ring + s * kStage;
  };
  auto release = [&]() {   // after the products that read the box completed
    const int s = used % stages;
    ++used;
    if (tid == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && issued < total) issue();
    __syncwarp();
  };
  uint32_t aphase = 0;

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int row0 = (pair * kGroups + grp) * kTile;   // past the end: zeros
    if (tid == 0) {
      mbar_arrive_expect_tx(&abar[grp], kA);
      for (int a = 0; a < KA; ++a)
        tma_load_2d(a_s + a * kTile * kAtomRow, &attmap, &abar[grp], a * 64,
                    row0);
    }
    if (tid < kTile)
      offs[tid] = row0 + tid < rows ? state_offset32(d, row0 + tid) : -1;
    group_sync();
    int off[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) off[hr] = offs[warp * 16 + g + 8 * hr];
    // the residual tokens, in the accumulator layout
    uint32_t tok[NH][16][2];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          tok[nh][j][hr] =
              off[hr] >= 0 ? *reinterpret_cast<const uint32_t*>(
                                 S_in + off[hr] + nh * 128 + 8 * j + 2 * t)
                           : 0u;
    float acc[NH][64];
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[nh][i] = 0.f;
    mbar_wait(&abar[grp], aphase);
    aphase ^= 1;
    // att Wout
    for (int a = 0; a < KA; ++a) {
      const uint8_t* st = take();
      wgmma_fence();
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n128k16_ss(
              acc[nh],
              make_desc(a_s + a * kTile * kAtomRow + k * 32, 1024,
                        kSwizzle128),
              make_desc(st + nh * 128 * kAtomRow + k * 32, 1024,
                        kSwizzle128),
              1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int nh = 0; nh < NH; ++nh) fence_regs(acc[nh]);
      release();
    }
    // x1 = tok + att Wout in f32; LN(cast x1), cast, into the A tile
    float mu[2], inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float s = 0.f;
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 tv = unpack2(tok[nh][j][hr]);
          float& x0 = acc[nh][4 * j + 2 * hr];
          float& x1 = acc[nh][4 * j + 2 * hr + 1];
          x0 = tv.x + x0;
          x1 = tv.y + x1;
          s += rnd(x0) + rnd(x1);
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      mu[hr] = s / D;
      float sq = 0.f;
#pragma unroll
      for (int nh = 0; nh < NH; ++nh)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dv = rnd(acc[nh][4 * j + 2 * hr + e]) - mu[hr];
            sq += dv * dv;
          }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      inv[hr] = rsqrtf(sq / D + 1e-5f);
    }
    group_sync();   // every warp's products are done with the attention rows
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = nh * 128 + 8 * j + 2 * t;
        const float2 gg = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ln_f + c));
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ln_f + D + c));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(a_s + sw128(warp * 16 + g + 8 * hr, c)) =
              pack2((rnd(acc[nh][4 * j + 2 * hr]) - mu[hr]) * inv[hr] * gg.x +
                        bb.x,
                    (rnd(acc[nh][4 * j + 2 * hr + 1]) - mu[hr]) * inv[hr] *
                            gg.y +
                        bb.y);
      }
    fence_async_shared();
    group_sync();
    // the FFN, 128 hidden columns at a time; its second product sums onto x1
    for (int c0 = 0; c0 < d.mlp; c0 += 128) {
      float h[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) h[i] = 0.f;
      for (int a = 0; a < KA; ++a) {
        const uint8_t* st = take();
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n128k16_ss(
              h,
              make_desc(a_s + a * kTile * kAtomRow + k * 32, 1024,
                        kSwizzle128),
              make_desc(st + k * 32, 1024, kSwizzle128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(h);
        release();
      }
      if (c0 > 0) group_sync();   // the last chunk's products read h_s
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b1 + c0 + c));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(h_s + sw128(warp * 16 + g + 8 * hr, c)) =
              pack2(rowops::gelu_erf(h[4 * j + 2 * hr] + bb.x),
                    rowops::gelu_erf(h[4 * j + 2 * hr + 1] + bb.y));
      }
      fence_async_shared();
      group_sync();
      for (int kk = 0; kk < 2; ++kk) {
        const uint8_t* st = take();
        wgmma_fence();
#pragma unroll
        for (int nh = 0; nh < NH; ++nh)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wgmma_m64n128k16_ss(
                acc[nh],
                make_desc(h_s + kk * kTile * kAtomRow + k * 32, 1024,
                          kSwizzle128),
                make_desc(st + nh * 128 * kAtomRow + k * 32, 1024,
                          kSwizzle128),
                1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int nh = 0; nh < NH; ++nh) fence_regs(acc[nh]);
        release();
      }
    }
    // x1 + f + b2, cast, staged in the A tile and stored row by row
    group_sync();   // every warp's products are done with the A tile
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = nh * 128 + 8 * j + 2 * t;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b2 + c));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(a_s + sw128(warp * 16 + g + 8 * hr, c)) =
              pack2(acc[nh][4 * j + 2 * hr] + bb.x,
                    acc[nh][4 * j + 2 * hr + 1] + bb.y);
      }
    group_sync();
#pragma unroll 4
    for (int i = tid; i < kTile * D / 8; i += 128) {
      const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
      if (offs[r] >= 0)
        *reinterpret_cast<uint4*>(S_out + offs[r] + c) =
            *reinterpret_cast<const uint4*>(a_s + sw128(r, c));
    }
    fence_async_shared();   // the next tile's TMA rewrites the A tile
    group_sync();
  }
}

// Shared memory of the two launches (the output launch's with `stages`
// ring boxes); ops/fused_swap_fusion.py:stream_plan computes the same.
inline int qkv_smem(int D) {
  return 1024 + D * D * 2 + kGroups * kTile * D * 2 + 2 * D * 4 + 16;
}
inline int out_smem(int D, int stages) {
  return 1024 + stages * D * kAtomRow +
         kGroups * (kTile * D * 2 + kTile * 128 * 2) + kGroups * kTile * 4 +
         (2 * kMaxStages + kGroups) * 8;
}

inline cudaError_t map2d(CUtensorMap* map, const void* base, uint64_t inner,
                         uint64_t outer, uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint64_t strides[1] = {inner * 2};
  const uint32_t box[2] = {64, box_outer};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename K>
inline cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// plan: {QKV blocks, output blocks, ring stages}
template <int D>
cudaError_t sublayer(const void* S_in, void* S_out, void* qkv, void* att,
                     const void* ln_a, const void* wqkv_t, const void* wout_t,
                     const void* ln_f, const void* w1_t, const void* b1,
                     const void* w2_t, const void* b2, const float* bias,
                     const float* mask, float scale, const Dims& d,
                     const int* plan, int device, cudaStream_t s) {
  const int rows = d.B * d.L * d.H * d.W;
  const int stages = plan[2];
  const int smem_q = qkv_smem(D), smem_o = out_smem(D, stages);
  if (plan[0] <= 0 || plan[1] <= 0 || stages < 2 || stages > kMaxStages ||
      smem_q > kSmemMax || smem_o > kSmemMax)
    return cudaErrorInvalidValue;
  CUtensorMap wmap, qkvmap, attmap, womap, w1map, w2map;
  cudaError_t err = map2d(&wmap, wqkv_t, D, 3 * D, D);
  if (err == cudaSuccess) {
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)rows, 3};
    const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)rows * D * 2};
    const uint32_t box[3] = {64, kTile, 1};
    err = hopper_host::make_map(&qkvmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                qkv, dims, strides, box,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) err = map2d(&attmap, att, D, rows, kTile);
  if (err == cudaSuccess) err = map2d(&womap, wout_t, D, D, D);
  if (err == cudaSuccess) err = map2d(&w1map, w1_t, D, d.mlp, 128);
  if (err == cudaSuccess) err = map2d(&w2map, w2_t, d.mlp, D, D);
  if (err == cudaSuccess) err = allow(stream_qkv_wgmma<D>, smem_q);
  if (err == cudaSuccess) err = allow(stream_out_wgmma<D>, smem_o);
  if (err != cudaSuccess) return err;
  stream_qkv_wgmma<D><<<dim3(plan[0], 3), 128 * kGroups, smem_q, s>>>(
      wmap, qkvmap, static_cast<const bf16*>(S_in),
      static_cast<const bf16*>(ln_a), scale, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // K1's kernel on the (G, T, heads * hd) q, k, v; mask (G, T) f32
  const int T = d.L * d.w * d.w;
  const int G = rows / T;
  const int hd = D / d.heads;
  const bf16* q = static_cast<const bf16*>(qkv);
  err = wattn::dispatch_wgmma(q, q + (size_t)rows * D, q + 2 * (size_t)rows * D,
                              bias, mask, nullptr, att, nullptr, G, T, T,
                              d.heads, hd, 0,
                              wattn::packed_layout(T, T, d.heads, hd),
                              device, s);
  if (err != cudaSuccess) return err;
  stream_out_wgmma<D><<<plan[1], 128 * kGroups, smem_o, s>>>(
      attmap, womap, w1map, w2map, static_cast<const bf16*>(S_in),
      static_cast<const bf16*>(ln_f), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(b2), static_cast<bf16*>(S_out), d, stages);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// Plain C entry point, loaded with ctypes: one sublayer, S_in -> S_out
// (two different (B, L, H, W, D) buffers).  bias (T, heads*T) f32 or null;
// dims: the 9 ints (B, L, H, W, D, window, heads, mlp, grid).  is_bf16: 0
// f32 and 1 bf16 on the row kernels and flash.cuh (widths multiples of 64):
// qkv (rows, 3D) and att (rows, D) scratch in the compute dtype, mask
// (B, L, H, W) f32 or null (keys with mask <= 0 get -1e9); 2 bf16 on the
// wgmma kernels (ops/fused_swap_fusion.py:stream_kernel_path; every operand
// 16-byte aligned): qkv the (3, rows, D) scratch, mask the (G, T) f32 key
// mask of this half gathered in window-major order, or null, and plan the 3
// ints of ops/fused_swap_fusion.py:stream_plan.  Returns the first
// cudaError_t of its three launches (0 on success).
extern "C" int cobevt_fusion_stream_sublayer(
    const void* S_in, void* S_out, void* qkv, void* att, const void* ln_a,
    const void* wqkv_t, const void* wout_t, const void* ln_f,
    const void* w1_t, const void* b1, const void* w2_t, const void* b2,
    const float* bias, const float* mask, float scale, const int* dims,
    const int* plan, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = swap_state::make_dims(dims);
  if (!swap_state::dims_ok(d) || d.D % 64 || d.mlp % 64 || S_in == S_out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 == 2) {
    const long long elems = (long long)d.B * d.L * d.H * d.W * d.D;
    const int hd = d.D / d.heads;
    if (plan == nullptr || elems >= (1LL << 31) || d.mlp % 128 ||
        (hd != 16 && hd != 32) || (d.L * d.w * d.w) % 8)
      return (int)cudaErrorInvalidValue;
#define K6_WG(D)                                                             \
  wg::sublayer<D>(S_in, S_out, qkv, att, ln_a, wqkv_t, wout_t, ln_f, w1_t,  \
                  b1, w2_t, b2, bias, mask, scale, d, plan, device, s)
    if (d.D == 256) return (int)K6_WG(256);
    if (d.D == 128) return (int)K6_WG(128);
#undef K6_WG
    return (int)cudaErrorInvalidValue;
  }
#define K6_LAUNCH(T)                                                        \
  sublayer_launch<T>(S_in, S_out, qkv, att, ln_a, wqkv_t, wout_t, ln_f,     \
                     w1_t, b1, w2_t, b2, bias, mask, scale, d, is_bf16 != 0, \
                     s)
  err = is_bf16 ? K6_LAUNCH(__nv_bfloat16) : K6_LAUNCH(float);
#undef K6_LAUNCH
  return (int)err;
}
