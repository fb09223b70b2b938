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
// (ops/fused_swap_fusion.py:stream_kernel_path) runs the wgmma kernels of
// namespace wg, modelled on K2's projections (D 512, SECOND's map, runs
// those of namespace wide, described where they are defined):
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
// f32, and bf16 at the other widths, run the first kernels: 16-row blocks
// of f32 tiles whose products run on mma.sync from weights read from L2
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
#include "swap_wgmma.cuh"
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

using namespace swapwg;

constexpr int kGroups = 2;   // warpgroups a block, on alternate tiles
constexpr int kMaxStages = 4;  // the output launch's weight ring

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

// Shared memory of the output launch with `stages` ring boxes;
// ops/fused_swap_fusion.py:stream_plan computes the same.
inline int out_smem(int D, int stages) {
  return 1024 + stages * D * kAtomRow +
         kGroups * (kTile * D * 2 + kTile * 128 * 2) + kGroups * kTile * 4 +
         (2 * kMaxStages + kGroups) * 8;
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
  const int smem_q = qkv_smem(D, kGroups);
  const int smem_o = out_smem(D, stages);
  if (plan[0] <= 0 || plan[1] <= 0 || stages < 2 || stages > kMaxStages ||
      smem_q > kSmemMax || smem_o > kSmemMax)
    return cudaErrorInvalidValue;
  CUtensorMap wmap, qkvmap, attmap, womap, w1map, w2map;
  cudaError_t err = map2d(&wmap, wqkv_t, D, 3 * D, D);
  if (err == cudaSuccess) err = qkv_map(&qkvmap, qkv, rows, D);
  if (err == cudaSuccess) err = map2d(&attmap, att, D, rows, kTile);
  if (err == cudaSuccess) err = map2d(&womap, wout_t, D, D, D);
  if (err == cudaSuccess) err = map2d(&w1map, w1_t, D, d.mlp, 128);
  if (err == cudaSuccess) err = map2d(&w2map, w2_t, d.mlp, D, D);
  if (err == cudaSuccess) err = allow(stream_qkv_wgmma<D, kGroups>, smem_q);
  if (err == cudaSuccess) err = allow(stream_out_wgmma<D>, smem_o);
  if (err != cudaSuccess) return err;
  stream_qkv_wgmma<D, kGroups><<<dim3(plan[0], 3), 128 * kGroups, smem_q,
                                 s>>>(
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
                              bias, mask, nullptr, att, nullptr, 0, G, T, T,
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

// ---------------------------------------------------------------------------
// bf16 at D 512 on wgmma + TMA (SECOND's map; ops/fused_swap_fusion.py:
// stream_kernel_path and wide_plan, which sets the grids and the two rings'
// depths).  The wg kernels do not fit here: their QKV launch keeps a D x D
// slice of Wqkv resident (512 KB at D 512), and their output launch gives
// each of two warpgroups a 64 x D tile and x1 over all D columns (256 f32
// accumulators a thread).
//
// QKV launch.  Either the state is read again for every column slice of a
// resident weight (a 128 KB slice: 12 passes over the 90 MB state, which
// does not fit the 50 MB L2, ~1.1 GB from device memory), or the 1.5 MB of
// Wqkv, which stays in L2, is streamed past every tile.  The second reads
// the state once; a block of two warpgroups shares each weight box between
// two 64-row tiles, so the weight traffic is 1.5 MB per 128 rows, ~1 GB out
// of L2 at SECOND's 88,000 rows, against ~1.1 GB out of device memory for
// the first.  Each warpgroup gathers and LayerNorms its tile into its A
// tile once (64 KB), then runs 12 chunks of 128 output columns (q, k, v x
// 4), each 8 boxes of 128 weight rows x 64 columns (16 KB) from a ring that
// thread 0 refills once both warpgroups are past a box; the cast (q's scale
// after it) goes from the accumulators to the (3, rows, D) scratch.
//
// Output launch (modelled on K4's wg4::out_k4).  Four warpgroups share one
// 64-row tile; warpgroup w owns output columns 128 w .. 128 w + 127 of every
// product (64 f32 accumulators a thread for x1) and hidden chunks w, w + 4,
// ... of 64 columns, and streams its own boxes of 64 weight rows x 64
// columns (8 KB) through its own ring.  The A tile (64 KB), the hidden tile
// (32 KB at mlp 256) and four rings of 3 boxes (96 KB) fit the 227 KB; the
// LayerNorm's row sums are exchanged through shared memory.
//
// Bound on the H100 at SECOND's sublayer: 250 GFLOP of projections and
// attention (0.25 ms at the bf16 peak) against ~0.1 GB of state, weights
// and bias (0.03 ms).  This design's own traffic: the (3, rows, D) scratch
// written and read (270 MB each way), the attention output written and read
// (90 MB each), the state read three times (gather, residual) and written
// once, ~1 GB a sublayer, 0.3 ms at 3.35 TB/s; the weights re-read from L2
// (~2.4 GB) come on top.  The products are issued box after box with one
// group in flight (wgmma_wait<1>), so a box's load overlaps the product
// before it.
// ---------------------------------------------------------------------------

namespace wide {

using namespace swapwg;

constexpr int kD = 512;
constexpr int KA = kD / 64;              // k-atoms of a token row
constexpr int kA = kTile * kD * 2;       // an A tile: 64 KB
// the QKV launch
constexpr int kQGroups = 2;              // warpgroups a block, a tile each
constexpr int kQCols = 128;              // output columns a chunk
constexpr int kQBox = kQCols * kAtomRow; // 128 weight rows x 64 columns
constexpr int kQMaxStages = 6;
constexpr int kQChunks = 3 * kD / kQCols;
// the output launch
constexpr int kOGroups = 4;              // warpgroups sharing a tile
constexpr int kOCols = kD / kOGroups;    // output columns a warpgroup
constexpr int kOHidden = 64;             // hidden columns a chunk
constexpr int kOBox = 64 * kAtomRow;     // 64 weight rows x 64 columns
constexpr int kOMaxStages = 4;

// Shared memory of the QKV launch with `stages` ring boxes and of the
// output launch with `stages` boxes in each warpgroup's ring;
// ops/fused_swap_fusion.py:wide_plan computes the same.
inline int qkv_smem(int stages) {
  return 1024 + stages * kQBox + kQGroups * kA + 2 * kD * 4 +
         2 * kQMaxStages * 8;
}

inline int out_smem(int mlp, int stages) {
  return 1024 + kA + kTile * mlp * 2 + kOGroups * stages * kOBox +
         kTile * 4 + 2 * kOGroups * kTile * 4 +
         (2 * kOGroups * kOMaxStages + 1) * 8;
}

// acc (64 x 64) {+}= a k-atom of an A tile (64 x 64 at a) times a ring box
// (64 weight rows x 64 columns)^T: four k16 steps, committed, not waited
__device__ __forceinline__ void mma_box64(float (&acc)[32], const uint8_t* a,
                                          const uint8_t* box) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_m64n64k16_ss(acc, make_desc(a + k * 32, 1024, kSwizzle128),
                       make_desc(box + k * 32, 1024, kSwizzle128), 1);
  wgmma_commit();
}

// The QKV launch: grid (blocks), 128 x kQGroups threads.  Warpgroup grp of
// block b walks tiles 2 p + grp for pairs p = b, b + blocks, ...; a tile
// past the end reads the last row and stores nothing.  Item i of a pair's
// pass of the ring is chunk i / KA, k-atom i % KA.  Mirrored by
// tests/test_torch_stream_int8_plans.py (wide_qkv_items).
__global__ void __launch_bounds__(128 * kQGroups, 1)
    qkv_wide(const __grid_constant__ CUtensorMap wmap,
             const bf16* __restrict__ S, const bf16* __restrict__ ln_a,
             float scale, bf16* __restrict__ qkv, Dims d, int stages) {
  constexpr int kPass = kQChunks * KA;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  const int grp = threadIdx.x >> 7;
  uint8_t* a_s = ring + stages * kQBox + grp * kA;
  float* gb = reinterpret_cast<float*>(ring + stages * kQBox + kQGroups * kA);
  uint64_t* full = reinterpret_cast<uint64_t*>(gb + 2 * kD);
  uint64_t* empty = full + kQMaxStages;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  auto group_sync = [&]() { named_barrier_sync(1 + grp, 128); };

  const int rows = d.B * d.L * d.H * d.W;
  const int tiles = (rows + kTile - 1) / kTile;
  const int pairs = (tiles + kQGroups - 1) / kQGroups;
  const int my_pairs =
      blockIdx.x < pairs ? (pairs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_pairs * kPass;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQGroups);
    }
    fence_barrier_init();
  }
  // gamma, beta: value e of lane l's columns 16 l .. 16 l + 15 at [e * 32 +
  // l], so that the 32 lanes of a row read 32 banks
  for (int i = threadIdx.x; i < kD; i += 128 * kQGroups) {
    const int l = i >> 4, e = i & 15;
    gb[e * 32 + l] = __bfloat162float(ln_a[i]);
    gb[kD + e * 32 + l] = __bfloat162float(ln_a[kD + i]);
  }
  __syncthreads();
  int issued = 0;   // thread 0's producer count
  auto issue = [&]() {
    const int i = issued++;
    const int s = i % stages, r = i / stages;
    if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
    const int it = i % kPass;
    mbar_arrive_expect_tx(&full[s], kQBox);
    tma_load_2d(ring + s * kQBox, &wmap, &full[s], (it % KA) * 64,
                (it / KA) * kQCols);
  };
  if (threadIdx.x == 0)
    while (issued < total && issued < stages) issue();
  int taken = 0, freed = 0;   // this warpgroup's ring items
  auto take = [&]() -> const uint8_t* {
    const int s = taken % stages;
    mbar_wait(&full[s], (taken / stages) & 1);
    ++taken;
    return ring + s * kQBox;
  };
  auto release = [&]() {   // after the products that read the box completed
    const int s = freed % stages;
    ++freed;
    if (tid == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && issued < total) issue();
    __syncwarp();
  };

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const int row0 = (pair * kQGroups + grp) * kTile;
    group_sync();   // the last pair's products are done with the A tile
    // warp w gathers and LayerNorms rows 16 w .. 16 w + 15, four at a time
    // with their loads issued first; lane l holds columns 16 l .. 16 l + 15
#pragma unroll 1
    for (int r4 = 0; r4 < 16; r4 += 4) {
      uint4 raw[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = min(row0 + warp * 16 + r4 + u, rows - 1);
        const uint4* src = reinterpret_cast<const uint4*>(
            S + state_offset32(d, rr) + 16 * lane);
        raw[u][0] = src[0];
        raw[u][1] = src[1];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float x[16];
        const uint32_t* w32 = reinterpret_cast<const uint32_t*>(raw[u]);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 v = unpack2(w32[i]);
          x[2 * i] = v.x;
          x[2 * i + 1] = v.y;
          sum += v.x + v.y;
        }
        const float mu = rowops::warp_sum(sum) / kD;
        float sq = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) sq += (x[e] - mu) * (x[e] - mu);
        const float inv = rsqrtf(rowops::warp_sum(sq) / kD + 1e-5f);
        uint32_t wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = 2 * i;
          wv[i] = pack2(
              (x[e] - mu) * inv * gb[e * 32 + lane] + gb[kD + e * 32 + lane],
              (x[e + 1] - mu) * inv * gb[(e + 1) * 32 + lane] +
                  gb[kD + (e + 1) * 32 + lane]);
        }
        const int r = warp * 16 + r4 + u;
        *reinterpret_cast<uint4*>(a_s + sw128(r, 16 * lane)) =
            make_uint4(wv[0], wv[1], wv[2], wv[3]);
        *reinterpret_cast<uint4*>(a_s + sw128(r, 16 * lane + 8)) =
            make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
    }
    fence_async_shared();
    group_sync();
#pragma unroll 1
    for (int c = 0; c < kQChunks; ++c) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        const uint8_t* st = take();
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n128k16_ss(
              acc,
              make_desc(a_s + a * kTile * kAtomRow + k * 32, 1024,
                        kSwizzle128),
              make_desc(st + k * 32, 1024, kSwizzle128), 1);
        wgmma_commit();
        if (a > 0) {   // the box before this one is read
          wgmma_wait<1>();
          release();
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release();
      // the cast, and q's scale after it, to the (3, rows, D) scratch
      const int slice = c / (kD / kQCols);
      bf16* dst =
          qkv + (size_t)slice * rows * kD + (c % (kD / kQCols)) * kQCols;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + warp * 16 + g + 8 * hr;
        if (row >= rows) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float v0 = rnd(acc[4 * j + 2 * hr]);
          float v1 = rnd(acc[4 * j + 2 * hr + 1]);
          if (slice == 0) {
            v0 *= scale;
            v1 *= scale;
          }
          *reinterpret_cast<uint32_t*>(dst + (size_t)row * kD + 8 * j +
                                       2 * t) = pack2(v0, v1);
        }
      }
    }
  }
}

// One warpgroup's pass of its output-launch ring for one tile: item i is
// (map, column, row): Wout rows kOCols w + 64 n .. by k-atom a (item 2 a +
// n); then w1 rows 64 c .. of each of its hidden chunks c = w, w + 4, ...
// by k-atom; then w2 rows kOCols w + 64 n .. by hidden k-atom ka (item 2 ka
// + n).  Every box is 64 rows x 64 columns.  Mirrored by
// tests/test_torch_stream_int8_plans.py (wide_out_items).
struct ItemW {
  int map, col, row;   // map: 0 Wout, 1 w1, 2 w2
};

__device__ __forceinline__ ItemW itemw_of(int i, int w, int chunks_w) {
  if (i < 2 * KA) return {0, (i >> 1) * 64, kOCols * w + (i & 1) * 64};
  i -= 2 * KA;
  if (i < chunks_w * KA)
    return {1, (i % KA) * 64, kOHidden * (w + kOGroups * (i / KA))};
  i -= chunks_w * KA;
  return {2, (i >> 1) * 64, kOCols * w + (i & 1) * 64};
}

// The output launch: a persistent block of kOGroups warpgroups a 64-row
// tile (tile = block, block + blocks, ...).  x1 = tok + att Wout in f32 in
// each warpgroup's accumulators (its 128 columns as two 64-column halves),
// LN(cast x1) into the A tile with the row statistics summed across the
// warpgroups, the FFN's hidden chunks through erf-GELU into the hidden
// tile, the second FFN product over the whole hidden tile summed onto x1,
// + b2, cast, staged in the A tile and stored row by row through
// state_offset.  The numerics are those of wg::stream_out_wgmma.
__global__ void __launch_bounds__(128 * kOGroups, 1)
    out_wide(const __grid_constant__ CUtensorMap attmap,
             const __grid_constant__ CUtensorMap womap,
             const __grid_constant__ CUtensorMap w1map,
             const __grid_constant__ CUtensorMap w2map,
             const bf16* __restrict__ S_in, const bf16* __restrict__ ln_f,
             const bf16* __restrict__ b1, const bf16* __restrict__ b2,
             bf16* __restrict__ S_out, Dims d, int stages) {
  constexpr int C = kOCols, HC = kOHidden, NWG = kOGroups;
  constexpr int kThreads = 128 * NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = align1024(smem_raw);
  uint8_t* h_s = a_s + kA;
  const int mlp = d.mlp;
  uint8_t* rings = h_s + kTile * mlp * 2;
  int* offs = reinterpret_cast<int*>(rings + NWG * stages * kOBox);
  float* red = reinterpret_cast<float*>(offs + kTile);  // [2][NWG][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * NWG * kTile);
  uint64_t* empty = full + NWG * kOMaxStages;
  uint64_t* abar = empty + NWG * kOMaxStages;
  const int grp = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = C * grp;   // this warpgroup's output columns
  uint8_t* ring = rings + grp * stages * kOBox;
  uint64_t* gfull = full + grp * kOMaxStages;
  uint64_t* gempty = empty + grp * kOMaxStages;

  const int rows = d.B * d.L * d.H * d.W;
  const int tiles = (rows + kTile - 1) / kTile;
  const int chunks = mlp / HC;
  const int chunks_w = (chunks - grp + NWG - 1) / NWG;
  const int per_pass = 2 * KA + chunks_w * KA + 2 * chunks;
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * per_pass;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NWG * kOMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(abar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  int issued = 0;   // the warpgroup's thread 0: its producer count
  auto issue = [&]() {
    const int i = issued++;
    const int s = i % stages, r = i / stages;
    if (r > 0) mbar_wait(&gempty[s], (r - 1) & 1);
    const ItemW it = itemw_of(i % per_pass, grp, chunks_w);
    const CUtensorMap* map =
        it.map == 0 ? &womap : (it.map == 1 ? &w1map : &w2map);
    mbar_arrive_expect_tx(&gfull[s], kOBox);
    tma_load_2d(ring + s * kOBox, map, &gfull[s], it.col, it.row);
  };
  if (tid == 0)
    while (issued < total && issued < stages) issue();
  int taken = 0, freed = 0;
  auto take = [&]() -> const uint8_t* {
    const int s = taken % stages;
    mbar_wait(&gfull[s], (taken / stages) & 1);
    ++taken;
    return ring + s * kOBox;
  };
  auto release = [&]() {   // after the products that read the box completed
    const int s = freed % stages;
    ++freed;
    if (tid == 0) {
      mbar_arrive(&gempty[s]);
      if (issued < total) issue();
    }
    __syncwarp();
  };
  // the sums over all kD columns of this thread's two rows from the partial
  // sums of this warpgroup's threads: reduced over the four threads of a
  // row, then across the warpgroups through shared memory (slot `pass`)
  auto row_totals = [&](float (&part)[2], int pass) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      part[hr] += __shfl_xor_sync(0xffffffffu, part[hr], 1);
      part[hr] += __shfl_xor_sync(0xffffffffu, part[hr], 2);
    }
    float* r = red + pass * NWG * kTile;
    if (t == 0) {
      r[grp * kTile + warp * 16 + g] = part[0];
      r[grp * kTile + warp * 16 + g + 8] = part[1];
    }
    __syncthreads();
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = warp * 16 + g + 8 * hr;
      float tot = 0.f;
#pragma unroll
      for (int q = 0; q < NWG; ++q) tot += r[q * kTile + row];
      part[hr] = tot;
    }
  };
  uint32_t aphase = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(abar, kA);
      for (int a = 0; a < KA; ++a)
        tma_load_2d(a_s + a * kTile * kAtomRow, &attmap, abar, a * 64, row0);
    }
    if (threadIdx.x < kTile)
      offs[threadIdx.x] = row0 + (int)threadIdx.x < rows
                              ? state_offset32(d, row0 + threadIdx.x)
                              : -1;
    __syncthreads();
    float x[2][32];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) x[n][i] = 0.f;
    mbar_wait(abar, aphase);
    aphase ^= 1;
    // att Wout, this warpgroup's columns.  The box loops stay rolled:
    // unrolled, ptxas hoists every product's descriptors out of the tile
    // loop and spills more of the 128 registers a thread has.
#pragma unroll 1
    for (int a = 0; a < KA; ++a) {
      const uint8_t* at = a_s + a * kTile * kAtomRow;
      mma_box64(x[0], at, take());
      if (a > 0) {
        wgmma_wait<1>();
        release();
      }
      mma_box64(x[1], at, take());
      wgmma_wait<1>();
      release();
    }
    wgmma_wait<0>();
    fence_regs(x[0]);
    fence_regs(x[1]);
    release();
    // x1 = tok + att Wout in f32 (the residual tokens read here, in the
    // accumulator layout: column c0 + 64 n + 8 j + 2 t; read before the
    // products, they would hold 32 registers through them); LN(cast x1),
    // cast, into the A tile
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int off = offs[warp * 16 + g + 8 * hr];
      if (off < 0) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t tok[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tok[j] = *reinterpret_cast<const uint32_t*>(
              S_in + off + c0 + 64 * n + 8 * j + 2 * t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 tv = unpack2(tok[j]);
          x[n][4 * j + 2 * hr] += tv.x;
          x[n][4 * j + 2 * hr + 1] += tv.y;
        }
      }
    }
    // mean and 1 / sqrt(var + eps) of the rounded x1, two passes (the
    // barriers of row_totals: every warpgroup's products are done)
    float mu[2], inv[2];
    {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            part[hr] += rnd(x[n][4 * j + 2 * hr]) +
                        rnd(x[n][4 * j + 2 * hr + 1]);
      row_totals(part, 0);
      mu[0] = part[0] / kD;
      mu[1] = part[1] / kD;
    }
    {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dv = rnd(x[n][4 * j + 2 * hr + e]) - mu[hr];
              part[hr] += dv * dv;
            }
      row_totals(part, 1);
      inv[0] = rsqrtf(part[0] / kD + 1e-5f);
      inv[1] = rsqrtf(part[1] / kD + 1e-5f);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + 64 * n + 8 * j + 2 * t;
        const float2 gg = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ln_f + c));
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ln_f + kD + c));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(a_s + sw128(warp * 16 + g + 8 * hr, c)) =
              pack2((rnd(x[n][4 * j + 2 * hr]) - mu[hr]) * inv[hr] * gg.x +
                        bb.x,
                    (rnd(x[n][4 * j + 2 * hr + 1]) - mu[hr]) * inv[hr] *
                            gg.y +
                        bb.y);
      }
    fence_async_shared();
    __syncthreads();
    // this warpgroup's FFN hidden chunks: erf-GELU into the hidden tile
#pragma unroll 1
    for (int cc = grp; cc < chunks; cc += NWG) {
      float h[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) h[i] = 0.f;
#pragma unroll 1
      for (int a = 0; a < KA; ++a) {
        mma_box64(h, a_s + a * kTile * kAtomRow, take());
        if (a > 0) {
          wgmma_wait<1>();
          release();
        }
      }
      wgmma_wait<0>();
      fence_regs(h);
      release();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = HC * cc + 8 * j + 2 * t;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b1 + c));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(h_s + sw128(warp * 16 + g + 8 * hr, c)) =
              pack2(rowops::gelu_erf(h[4 * j + 2 * hr] + bb.x),
                    rowops::gelu_erf(h[4 * j + 2 * hr + 1] + bb.y));
      }
    }
    fence_async_shared();
    __syncthreads();   // the whole hidden tile is written
    // the second FFN product, summed onto x1's columns
#pragma unroll 1
    for (int ka = 0; ka < chunks; ++ka) {
      const uint8_t* ht = h_s + ka * kTile * kAtomRow;
      mma_box64(x[0], ht, take());
      if (ka > 0) {
        wgmma_wait<1>();
        release();
      }
      mma_box64(x[1], ht, take());
      wgmma_wait<1>();
      release();
    }
    wgmma_wait<0>();
    fence_regs(x[0]);
    fence_regs(x[1]);
    release();
    // x1 + f + b2, cast: the new state, staged in the A tile (every
    // warpgroup's products read it before the barrier above) and stored
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + 64 * n + 8 * j + 2 * t;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b2 + c));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(a_s + sw128(warp * 16 + g + 8 * hr, c)) =
              pack2(x[n][4 * j + 2 * hr] + bb.x,
                    x[n][4 * j + 2 * hr + 1] + bb.y);
      }
    __syncthreads();
#pragma unroll 2
    for (int i = threadIdx.x; i < kTile * kD / 8; i += kThreads) {
      const int r = i / (kD / 8), c = (i - r * (kD / 8)) * 8;
      if (offs[r] >= 0)
        *reinterpret_cast<uint4*>(S_out + offs[r] + c) =
            *reinterpret_cast<const uint4*>(a_s + sw128(r, c));
    }
    fence_async_shared();   // the next tile's TMA rewrites the A tile
    __syncthreads();
  }
}

// plan: {QKV blocks, output blocks, output ring stages, QKV ring stages}
cudaError_t sublayer(const void* S_in, void* S_out, void* qkv, void* att,
                     const void* ln_a, const void* wqkv_t, const void* wout_t,
                     const void* ln_f, const void* w1_t, const void* b1,
                     const void* w2_t, const void* b2, const float* bias,
                     const float* mask, float scale, const Dims& d,
                     const int* plan, int device, cudaStream_t s) {
  const int rows = d.B * d.L * d.H * d.W;
  const int ostages = plan[2], qstages = plan[3];
  const int smem_q = qkv_smem(qstages);
  const int smem_o = out_smem(d.mlp, ostages);
  if (d.D != kD || d.mlp % 128 || plan[0] <= 0 || plan[1] <= 0 ||
      qstages < 2 || qstages > kQMaxStages || ostages < 2 ||
      ostages > kOMaxStages || smem_q > kSmemMax || smem_o > kSmemMax)
    return cudaErrorInvalidValue;
  CUtensorMap wmap, attmap, womap, w1map, w2map;
  cudaError_t err = map2d(&wmap, wqkv_t, kD, 3 * kD, kQCols);
  if (err == cudaSuccess) err = map2d(&attmap, att, kD, rows, kTile);
  if (err == cudaSuccess) err = map2d(&womap, wout_t, kD, kD, 64);
  if (err == cudaSuccess) err = map2d(&w1map, w1_t, kD, d.mlp, 64);
  if (err == cudaSuccess) err = map2d(&w2map, w2_t, d.mlp, kD, 64);
  if (err == cudaSuccess) err = allow(qkv_wide, smem_q);
  if (err == cudaSuccess) err = allow(out_wide, smem_o);
  if (err != cudaSuccess) return err;
  qkv_wide<<<plan[0], 128 * kQGroups, smem_q, s>>>(
      wmap, static_cast<const bf16*>(S_in), static_cast<const bf16*>(ln_a),
      scale, static_cast<bf16*>(qkv), d, qstages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // K1's kernel on the (G, T, heads * hd) q, k, v; mask (G, T) f32
  const int T = d.L * d.w * d.w;
  const int hd = kD / d.heads;
  const bf16* q = static_cast<const bf16*>(qkv);
  err = wattn::dispatch_wgmma(q, q + (size_t)rows * kD,
                              q + 2 * (size_t)rows * kD, bias, mask, nullptr,
                              att, nullptr, 0, rows / T, T, T, d.heads, hd, 0,
                              wattn::packed_layout(T, T, d.heads, hd), device,
                              s);
  if (err != cudaSuccess) return err;
  out_wide<<<plan[1], 128 * kOGroups, smem_o, s>>>(
      attmap, womap, w1map, w2map, static_cast<const bf16*>(S_in),
      static_cast<const bf16*>(ln_f), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(b2), static_cast<bf16*>(S_out), d, ostages);
  return cudaGetLastError();
}

}  // namespace wide

}  // namespace

// Plain C entry point, loaded with ctypes: one sublayer, S_in -> S_out
// (two different (B, L, H, W, D) buffers).  bias (T, heads*T) f32 or null;
// dims: the 9 ints (B, L, H, W, D, window, heads, mlp, grid).  is_bf16: 0
// f32 and 1 bf16 on the row kernels and flash.cuh (widths multiples of 64):
// qkv (rows, 3D) and att (rows, D) scratch in the compute dtype, mask
// (B, L, H, W) f32 or null (keys with mask <= 0 get -1e9); 2 bf16 on the
// wgmma kernels (ops/fused_swap_fusion.py:stream_kernel_path; every operand
// 16-byte aligned): qkv the (3, rows, D) scratch, mask the (G, T) f32 key
// mask of this half gathered in window-major order, or null, and plan the 4
// ints of ops/fused_swap_fusion.py:stream_plan (D 128 / 256; the fourth is
// not read) or wide_plan (D 512).  Returns the first cudaError_t of its
// three launches (0 on success).
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
    if (d.D == 512)
      return (int)wide::sublayer(S_in, S_out, qkv, att, ln_a, wqkv_t, wout_t,
                                 ln_f, w1_t, b1, w2_t, b2, bias, mask, scale,
                                 d, plan, device, s);
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
