// K4: the FuseBEVT encoder (SwapFusionEncoder), fused, for Hopper (sm_90a).
//
// Replaces the Pallas kernel cobevt_tpu/ops/fused_swap_fusion.py:
// fused_swap_fusion (-> pallas_call :260, body _kernel :90).  Per block of
// the stack and per half (window cells, then grid cells): LN -> QKV (q
// scaled after the cast) -> attention with the 3-D rel-pos bias and the
// additive key mask -> out-projection -> residual -> LN -> FFN (erf-GELU)
// -> residual; then the agent mean (over max_cav, or the live agents) ->
// LN -> Linear head.
//
// What bounds it on the H100, and the design.  The TPU kernel keeps the
// whole (L, H, W, D) state resident in VMEM across all sublayers (1.3 MB at
// CorpBEVT); an SM has 227 KB, and the blocks of a launch run in parallel
// in no order, so nothing carries over between them: the state stays in
// device memory between launches (it is L2-resident at this size), and a
// sublayer reads one state buffer and writes the other (ping-pong), never
// in place, because the blocks of one window read all of its tokens while
// other blocks write.  At CorpBEVT the encoder is ~13 GFLOP over 5,120
// token rows, 0.013 ms at the bf16 peak: far too little work to fill the
// card, so a launch's time is the latency chain of one block, and the
// design cuts the number of dependent launches and the length of each
// block's chain.
//
// bf16 at D 128 (ops/fused_swap_fusion.py:k4_kernel_path; CorpBEVT) runs
// on wgmma + TMA, 2 + 2 x sublayers launches (14 at depth 3):
//   * the first sublayer's LN + QKV: swap_wgmma.cuh's stream_qkv_wgmma with
//     one warpgroup a 64-row tile (80 tiles x q, k, v = 240 blocks);
//   * per sublayer, the attention: K1's window_attention_wgmma_kernel with
//     K4's numerics (bf16 bias, -1e9 rounded to bf16 on masked keys, the
//     softmax sum over the exp rounded to bf16; window_attention.cuh);
//   * per sublayer, the output launch (wg4::out_k4): a block of four
//     warpgroups a 64-row tile (80 blocks), each owning a quarter of every
//     product's columns, through out-projection, LN, FFN and the residual,
//     and then, for the next sublayer, its LN + QKV into the next
//     partition's rows of the q, k, v scratch, so the next sublayer's QKV
//     launch disappears;
//   * the head (fusion_head_kernel, 16-row blocks).
// f32 and the other widths run the first kernels, 3 x sublayers + 1
// launches (19 at depth 3): fusion_qkv (LN + QKV, window-major by index
// math), flash.cuh's attention (bias and mask in the compute dtype), and
// fusion_out, 64-row blocks of f32 tiles whose products run on mma.sync
// from weights read from L2 (rowops.cuh), and the head.
//
// Measured on an H100 (chip_smoke.py --kernels K4, on the card alone, bf16
// at encoder_masked): the 19 row launches took 0.847 ms (QKV 0.336,
// attention 0.172, output 0.300, head 0.021), device time that a frame
// pays in full; the wgmma route's numbers are in PERF.md.
#include "flash.cuh"
#include "hopper.cuh"
#include "rowops.cuh"
#include "swap_state.cuh"
#include "swap_wgmma.cuh"
#include "window_attention.cuh"

namespace {

using rowops::Gemm;
using rowops::kRows;
using rowops::kThreads;
using rowops::layer_norm_rows;
using rowops::ld8;
using rowops::pad;
using rowops::rnd;
using rowops::st8;
using rowops::to_f;
using rowops::zero8;
using swap_state::Dims;
using swap_state::dims_ok;
using swap_state::make_dims;
using swap_state::state_offset;

// 1. LN + QKV (no bias) into (B*nwin*T, 3D); q = cast(qkv) * scale, cast.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fusion_qkv_kernel(const T* __restrict__ S, const T* __restrict__ ln_a,
                      const T* __restrict__ wqkv_t, float scale,
                      T* __restrict__ qkv, Dims d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long src_off[kRows];
  const long long rows = (long long)d.B * d.L * d.H * d.W;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int D = d.D, N = 3 * d.D;
  const int D8 = D / 8, N8 = N / 8;
  const int lda = pad(D), ldo = pad(N);
  float* A = smem;
  float* O = smem + kRows * lda;
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    src_off[r] = row0 + r < rows ? state_offset(d, row0 + r) : -1;
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
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
  layer_norm_rows<T>(A, lda, D, ln_a, ln_a + D, true);
  __syncthreads();
  Gemm<T>::run(A, lda, wqkv_t, D, N, O, ldo);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * N8; i += kThreads) {
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
    fusion_out_kernel(const T* __restrict__ att, const T* __restrict__ S_in,
                      const T* __restrict__ wout_t,
                      const T* __restrict__ ln_f, const T* __restrict__ w1_t,
                      const T* __restrict__ b1, const T* __restrict__ w2_t,
                      const T* __restrict__ b2, T* __restrict__ S_out,
                      Dims d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long src_off[kRows];
  const long long rows = (long long)d.B * d.L * d.H * d.W;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int D = d.D, M = d.mlp;
  const int D8 = D / 8, M8 = M / 8;
  const int ld = pad(D), ldh = pad(M);
  float* A = smem;              // att, then LN(x1), then FFN out
  float* X1 = A + kRows * ld;   // x1 in f32
  float* Hb = X1 + kRows * ld;  // FFN hidden
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    src_off[r] = row0 + r < rows ? state_offset(d, row0 + r) : -1;
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    float v[8];
    if (row0 + r < rows)
      ld8(att + (row0 + r) * D + c, v);
    else
      zero8(v);
    st8(A + r * ld + c, v);
  }
  __syncthreads();
  Gemm<T>::run(A, ld, wout_t, D, D, X1, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
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
  layer_norm_rows<T>(A, ld, D, ln_f, ln_f + D, true);
  __syncthreads();
  Gemm<T>::run(A, ld, w1_t, D, M, Hb, ldh);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * M8; i += kThreads) {
    const int r = i / M8, c = (i - r * M8) * 8;
    float v[8];
    ld8(Hb + r * ldh + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = rnd<T>(rowops::gelu_erf(v[e] + to_f(b1[c + e])));
    st8(Hb + r * ldh + c, v);
  }
  __syncthreads();
  Gemm<T>::run(Hb, ldh, w2_t, M, D, A, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
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

// agent pooling (mean over L, or over the live agents of agent_mask) ->
// cast -> LN -> @ Wh + bh, one row per (b, y, x) of the (B, H, W, D)
// output; R rows a block: 16 where D % 64 == 0 (64 blocks at CorpBEVT's
// 1,024 pixels; Gemm's 16-row split needs N % 64), else 64
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    fusion_head_kernel(const T* __restrict__ S,
                       const float* __restrict__ agent_mask,
                       const T* __restrict__ ln_h, const T* __restrict__ wh_t,
                       const T* __restrict__ bh, T* __restrict__ out,
                       Dims d) {
  constexpr int kRows = R;
  extern __shared__ __align__(16) float smem[];
  const long long rows = (long long)d.B * d.H * d.W;
  const long long row0 = (long long)blockIdx.x * kRows;
  hopper::pdl_wait();   // the state of the last output launch
  const int D = d.D;
  const int D8 = D / 8;
  const int ld = pad(D);
  float* A = smem;
  float* O = smem + kRows * ld;
  const long long plane = (long long)d.H * d.W * D;
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long rr = row0 + r;
    float pooled[8];
    zero8(pooled);
    if (rr < rows) {
      const int b = (int)(rr / ((long long)d.H * d.W));
      const long long pix = rr - (long long)b * d.H * d.W;
      const T* sp = S + (long long)b * d.L * plane + pix * D + c;
      float tot = 0.f;
      for (int l = 0; l < d.L; ++l) {
        float v[8];
        ld8(sp + l * plane, v);
        const float am = agent_mask != nullptr ? agent_mask[b * d.L + l] : 1.f;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          pooled[e] = agent_mask != nullptr ? pooled[e] + v[e] * am
                                            : pooled[e] + v[e];
        tot += am;
      }
      const float div = agent_mask != nullptr ? fmaxf(tot, 1.f) : (float)d.L;
#pragma unroll
      for (int e = 0; e < 8; ++e) pooled[e] = rnd<T>(pooled[e] / div);
    }
    st8(A + r * ld + c, pooled);
  }
  __syncthreads();
  layer_norm_rows<T, kRows>(A, ld, D, ln_h, ln_h + D, true);
  __syncthreads();
  Gemm<T, kRows>::run(A, ld, wh_t, D, D, O, ld);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    if (row0 + r >= rows) continue;
    float v[8];
    ld8(O + r * ld + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += to_f(bh[c + e]);
    st8(out + (row0 + r) * D + c, v);
  }
}

int row_blocks(long long rows, int per_block = kRows) {
  return (int)((rows + per_block - 1) / per_block);
}

template <typename T>
int qkv_launch(const void* S, const void* ln_a, const void* wqkv_t,
               float scale, void* qkv, const Dims& d, cudaStream_t s) {
  const int smem = kRows * (pad(d.D) + pad(3 * d.D)) * (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(fusion_qkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * d.L * d.H * d.W;
  fusion_qkv_kernel<T><<<row_blocks(rows), kThreads, smem, s>>>(
      (const T*)S, (const T*)ln_a, (const T*)wqkv_t, scale, (T*)qkv, d);
  return (int)cudaGetLastError();
}

template <typename T>
int out_launch(const void* att, const void* S_in, const void* wout_t,
               const void* ln_f, const void* w1_t, const void* b1,
               const void* w2_t, const void* b2, void* S_out, const Dims& d,
               cudaStream_t s) {
  const int smem = kRows * (2 * pad(d.D) + pad(d.mlp)) * (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(fusion_out_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * d.L * d.H * d.W;
  fusion_out_kernel<T><<<row_blocks(rows), kThreads, smem, s>>>(
      (const T*)att, (const T*)S_in, (const T*)wout_t, (const T*)ln_f,
      (const T*)w1_t, (const T*)b1, (const T*)w2_t, (const T*)b2, (T*)S_out,
      d);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int head_launch_rows(const void* S, const float* agent_mask,
                     const void* ln_h, const void* wh_t, const void* bh,
                     void* out, const Dims& d, bool pdl, cudaStream_t s) {
  const int smem = R * 2 * pad(d.D) * (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(fusion_head_kernel<T, R>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * d.H * d.W;
  return (int)hopper_host::launch_pdl(
      pdl, fusion_head_kernel<T, R>, dim3(row_blocks(rows, R)),
      dim3(kThreads), smem, s, (const T*)S, agent_mask, (const T*)ln_h,
      (const T*)wh_t, (const T*)bh, (T*)out, d);
}

template <typename T>
int head_launch(const void* S, const float* agent_mask, const void* ln_h,
                const void* wh_t, const void* bh, void* out, const Dims& d,
                bool pdl, cudaStream_t s) {
  return d.D % 64 == 0 ? head_launch_rows<T, 16>(S, agent_mask, ln_h, wh_t,
                                                 bh, out, d, pdl, s)
                       : head_launch_rows<T, kRows>(S, agent_mask, ln_h,
                                                    wh_t, bh, out, d, pdl, s);
}

// ---------------------------------------------------------------------------
// bf16 at D 128 on wgmma + TMA (ops/fused_swap_fusion.py:k4_kernel_path):
// the row launches of swap_wgmma.cuh with one warpgroup a block, so that the
// 80 tiles of CorpBEVT's 5,120 token rows spread over 80 SMs, and the next
// sublayer's LN + QKV in each output launch's epilogue; K1's kernel between
// them.  Grids and ring depth: ops/fused_swap_fusion.py:k4_plan.
// ---------------------------------------------------------------------------

namespace wg4 {

using namespace swapwg;

constexpr int kD = 128;
constexpr int kGroups = 1;    // the first QKV launch: a warpgroup a tile
constexpr int kRingMax = 8;

// out_k4's split of a tile's work between its two warpgroups: the output
// columns of every product a warpgroup owns, the hidden columns of its FFN
// chunks (chunk c = w, w + 2, ...), and a ring box's largest size
constexpr int kWG = 2;
constexpr int kCols = kD / kWG;
constexpr int kHidden = 128;
constexpr int kStage = kHidden * kAtomRow;

// Shared memory of out_k4 with `stages` boxes in each warpgroup's ring:
// the A tile (64 x 128 bf16), the hidden tile (64 x mlp bf16), the rings,
// the row map, the row statistics and the barriers;
// ops/fused_swap_fusion.py:k4_plan computes the same.
__host__ __device__ inline int out_k4_smem(int mlp, int stages) {
  return 1024 + kTile * kD * 2 + kTile * mlp * 2 + kWG * stages * kStage +
         kTile * 4 + 2 * kWG * kTile * 4 + (2 * kWG * kRingMax + 1) * 8;
}

// One warpgroup's pass of its ring for one tile: item i is (map, column,
// row, bytes): Wout rows kCols w .. (its output columns) by k-atom; w1
// rows kHidden c .. for each of its hidden chunks by k-atom; w2 rows
// kCols w .. by hidden k-atom; with a next sublayer its Wqkv rows 128 s +
// kCols w .. by k-atom for s = q, k, v.  Mirrored by
// tests/test_torch_chain_k4_plans.py:k4_items.
struct Item4 {
  int map, col, row, bytes;   // map: 0 Wout, 1 w1, 2 w2, 3 next Wqkv
};

__device__ __forceinline__ Item4 item4_of(int i, int w, int chunks_w,
                                          int mlp) {
  constexpr int KA = kD / 64;
  constexpr int C = kCols, HC = kHidden;
  if (i < KA) return {0, i * 64, C * w, C * kAtomRow};
  i -= KA;
  if (i < chunks_w * KA) {
    const int c = w + kWG * (i / KA);
    return {1, (i % KA) * 64, HC * c, HC * kAtomRow};
  }
  i -= chunks_w * KA;
  if (i < mlp / 64) return {2, i * 64, C * w, C * kAtomRow};
  i -= mlp / 64;
  return {3, (i % KA) * 64, (i / KA) * kD + C * w, C * kAtomRow};
}

// acc (64 x N) += A (64 x 64 k-atom at a) B^T, B an N-row box of the
// ring, both K-major 128B-swizzled: four k16 steps, fenced, committed and
// waited on
template <int N>
__device__ __forceinline__ void mma_atom(float (&acc)[N / 2],
                                         const uint8_t* a,
                                         const uint8_t* box) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t da = make_desc(a + k * 32, 1024, kSwizzle128);
    const uint64_t db = make_desc(box + k * 32, 1024, kSwizzle128);
    if constexpr (N == 128)
      wgmma_m64n128k16_ss(acc, da, db, 1);
    else
      wgmma_m64n64k16_ss(acc, da, db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The output launch of K4's wgmma route.  A block of two warpgroups owns
// one 64-row tile at a time (persistent over tiles) and splits every
// product's output columns between them, so that a tile's serial chain of
// products, LayerNorms, erf-GELUs and stores is half as long per thread as
// with one warpgroup, and eight warps an SM hide each other's latencies
// (four warpgroups a tile measured no faster): warpgroup w computes x1 =
// tok + att Wout for its kCols columns, the LN's row sums are exchanged
// through shared memory, its FFN hidden chunks go through erf-GELU into
// the shared hidden tile, the second FFN product over the whole hidden
// tile sums onto x1's columns, and the rounded state is staged and stored
// by the whole block; with a
// next sublayer the rows' LN + QKV follow (its columns of q, k and v a
// warpgroup) into the next partition's rows of the (3, rows, 128)
// scratch.  Each warpgroup streams the weight boxes it reads through its
// own ring (thread 0 of the warpgroup refills a box once its products are
// done).  The numerics are those of K6's stream_out_wgmma.
__global__ void __launch_bounds__(128 * kWG, 1)
    out_k4(const __grid_constant__ CUtensorMap attmap,
           const __grid_constant__ CUtensorMap womap,
           const __grid_constant__ CUtensorMap w1map,
           const __grid_constant__ CUtensorMap w2map,
           const __grid_constant__ CUtensorMap wqmap,
           const bf16* __restrict__ S_in, const bf16* __restrict__ ln_f,
           const bf16* __restrict__ b1, const bf16* __restrict__ b2,
           bf16* __restrict__ S_out, Dims d, int stages,
           const bf16* __restrict__ ln_next, bf16* __restrict__ qkv_next,
           float scale) {
  constexpr int KA = kD / 64;
  constexpr int C = kCols, HC = kHidden, NWG = kWG;
  constexpr int kThreads = 128 * NWG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = align1024(smem_raw);
  uint8_t* h_s = a_s + kTile * kD * 2;
  const int mlp = d.mlp;
  uint8_t* rings = h_s + kTile * mlp * 2;
  int* offs = reinterpret_cast<int*>(rings + NWG * stages * kStage);
  float* red = reinterpret_cast<float*>(offs + kTile);  // [2][NWG][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * NWG * kTile);
  uint64_t* empty = full + NWG * kRingMax;
  uint64_t* abar = empty + NWG * kRingMax;
  const int grp = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = C * grp;   // this warpgroup's output columns
  uint8_t* ring = rings + grp * stages * kStage;
  uint64_t* gfull = full + grp * kRingMax;
  uint64_t* gempty = empty + grp * kRingMax;
  const bool next = qkv_next != nullptr;

  const int rows = d.B * d.L * d.H * d.W;
  const int tiles = (rows + kTile - 1) / kTile;
  const int chunks_w = (mlp / HC - grp + NWG - 1) / NWG;
  const int per_pass = KA + chunks_w * KA + mlp / 64 + (next ? 3 * KA : 0);
  const int my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * per_pass;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NWG * kRingMax; ++s) {
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
    const Item4 it = item4_of(i % per_pass, grp, chunks_w, mlp);
    const CUtensorMap* map = it.map == 0 ? &womap
                             : it.map == 1 ? &w1map
                             : it.map == 2 ? &w2map : &wqmap;
    mbar_arrive_expect_tx(&gfull[s], it.bytes);
    tma_load_2d(ring + s * kStage, map, &gfull[s], it.col, it.row);
  };
  if (tid == 0)
    while (issued < total && issued < stages) issue();
  // the weights are the call's own; what the last launches wrote is read
  // from here on
  pdl_launch_dependents();
  pdl_wait();
  int used = 0;
  auto take = [&]() -> const uint8_t* {
    const int s = used % stages;
    mbar_wait(&gfull[s], (used / stages) & 1);
    return ring + s * kStage;
  };
  auto release = [&]() {   // after the products that read the box completed
    const int s = used % stages;
    ++used;
    if (tid == 0) {
      mbar_arrive(&gempty[s]);
      if (issued < total) issue();
    }
    __syncwarp();
  };
  // mean and 1 / sqrt(var + eps) of each of this thread's two rows over all
  // 128 columns of the rounded values x (this warpgroup holds C): two-pass,
  // the warpgroups' sums exchanged through shared memory
  auto row_stats = [&](const float (&x)[C / 2], float (&mu)[2],
                       float (&inv)[2]) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float part[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = x[4 * j + 2 * hr + e];
            s += pass == 0 ? v : (v - mu[hr]) * (v - mu[hr]);
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        part[hr] = s;
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
        if (pass == 0)
          mu[hr] = tot / kD;
        else
          inv[hr] = rsqrtf(tot / kD + 1e-5f);
      }
    }
  };
  // LN(x) with (gamma, beta) of ln, cast, into this warpgroup's columns of
  // the A tile
  auto ln_to_a = [&](const float (&x)[C / 2], const float (&mu)[2],
                     const float (&inv)[2], const bf16* ln) {
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const float2 gg = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ln + c));
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ln + kD + c));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(a_s + sw128(warp * 16 + g + 8 * hr, c)) =
            pack2((x[4 * j + 2 * hr] - mu[hr]) * inv[hr] * gg.x + bb.x,
                  (x[4 * j + 2 * hr + 1] - mu[hr]) * inv[hr] * gg.y + bb.y);
    }
  };
  // the staged 64 x 128 tile (sw128 layout at `tile`) to dst rows offs[r]
  // (-1: not stored) times scale_r, 16 bytes a thread and step
  auto store_rows = [&](const uint8_t* tile, bf16* dst, int scale_r) {
#pragma unroll 2
    for (int i = threadIdx.x; i < kTile * kD / 8; i += kThreads) {
      const int r = i / (kD / 8), c = (i - r * (kD / 8)) * 8;
      if (offs[r] >= 0)
        *reinterpret_cast<uint4*>(dst + (size_t)offs[r] * scale_r + c) =
            *reinterpret_cast<const uint4*>(tile + sw128(r, c));
    }
  };
  uint32_t aphase = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(abar, kTile * kD * 2);
      for (int a = 0; a < KA; ++a)
        tma_load_2d(a_s + a * kTile * kAtomRow, &attmap, abar, a * 64, row0);
    }
    if (threadIdx.x < kTile)
      offs[threadIdx.x] = row0 + (int)threadIdx.x < rows
                              ? state_offset32(d, row0 + threadIdx.x)
                              : -1;
    __syncthreads();
    int off[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) off[hr] = offs[warp * 16 + g + 8 * hr];
    // the residual tokens of this warpgroup's columns
    uint32_t tok[C / 8][2];
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        tok[j][hr] = off[hr] >= 0 ? *reinterpret_cast<const uint32_t*>(
                                        S_in + off[hr] + c0 + 8 * j + 2 * t)
                                  : 0u;
    float x[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) x[i] = 0.f;
    mbar_wait(abar, aphase);
    aphase ^= 1;
    for (int a = 0; a < KA; ++a) {
      mma_atom<C>(x, a_s + a * kTile * kAtomRow, take());
      release();
    }
    // x1 = tok + att Wout (f32, kept); LN(cast x1) into the A tile
    float xr[C / 2], mu[2], inv[2];
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 tv = unpack2(tok[j][hr]);
        x[4 * j + 2 * hr] += tv.x;
        x[4 * j + 2 * hr + 1] += tv.y;
        xr[4 * j + 2 * hr] = swapwg::rnd(x[4 * j + 2 * hr]);
        xr[4 * j + 2 * hr + 1] = swapwg::rnd(x[4 * j + 2 * hr + 1]);
      }
    row_stats(xr, mu, inv);   // its barriers: every warpgroup's products done
    ln_to_a(xr, mu, inv, ln_f);
    fence_async_shared();
    __syncthreads();
    // this warpgroup's FFN hidden chunks: erf-GELU into the hidden tile
    for (int c = grp; c < mlp / HC; c += NWG) {
      float h[HC / 2];
#pragma unroll
      for (int i = 0; i < HC / 2; ++i) h[i] = 0.f;
      for (int a = 0; a < KA; ++a) {
        mma_atom<HC>(h, a_s + a * kTile * kAtomRow, take());
        release();
      }
#pragma unroll
      for (int j = 0; j < HC / 8; ++j) {
        const int cc = HC * c + 8 * j + 2 * t;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b1 + cc));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(
              h_s + sw128(warp * 16 + g + 8 * hr, cc)) =
              pack2(rowops::gelu_erf(h[4 * j + 2 * hr] + bb.x),
                    rowops::gelu_erf(h[4 * j + 2 * hr + 1] + bb.y));
      }
    }
    fence_async_shared();
    __syncthreads();   // the whole hidden tile is written
    for (int ka = 0; ka < mlp / 64; ++ka) {
      mma_atom<C>(x, h_s + ka * kTile * kAtomRow, take());
      release();
    }
    // x1 + f + b2, rounded: the new state, staged in the A tile and stored
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int c = c0 + 8 * j + 2 * t;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b2 + c));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        xr[4 * j + 2 * hr] = swapwg::rnd(x[4 * j + 2 * hr] + bb.x);
        xr[4 * j + 2 * hr + 1] = swapwg::rnd(x[4 * j + 2 * hr + 1] + bb.y);
        *reinterpret_cast<uint32_t*>(a_s + sw128(warp * 16 + g + 8 * hr, c)) =
            pack2(xr[4 * j + 2 * hr], xr[4 * j + 2 * hr + 1]);
      }
    }
    __syncthreads();
    store_rows(a_s, S_out, 1);
    if (next) {
      // the next sublayer's LN + QKV of the rounded rows
      row_stats(xr, mu, inv);   // its barriers: the stores read the A tile
      if (threadIdx.x < kTile) {
        Dims dn = d;
        dn.grid = !d.grid;
        const int o = offs[threadIdx.x];
        offs[threadIdx.x] = o >= 0 ? row_of(dn, o) : -1;
      }
      ln_to_a(xr, mu, inv, ln_next);
      fence_async_shared();
      __syncthreads();
      for (int sl = 0; sl < 3; ++sl) {
        float q[C / 2];
#pragma unroll
        for (int i = 0; i < C / 2; ++i) q[i] = 0.f;
        for (int a = 0; a < KA; ++a) {
          mma_atom<C>(q, a_s + a * kTile * kAtomRow, take());
          release();
        }
        if (sl > 0) __syncthreads();   // the last slice's rows are stored
#pragma unroll
        for (int j = 0; j < C / 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float v0 = swapwg::rnd(q[4 * j + 2 * hr]);
            float v1 = swapwg::rnd(q[4 * j + 2 * hr + 1]);
            if (sl == 0) {
              v0 *= scale;
              v1 *= scale;
            }
            *reinterpret_cast<uint32_t*>(
                h_s + sw128(warp * 16 + g + 8 * hr, c0 + 8 * j + 2 * t)) =
                pack2(v0, v1);
          }
        __syncthreads();
        store_rows(h_s, qkv_next + (size_t)sl * rows * kD, kD);
      }
    }
    fence_async_shared();   // the next tile's TMA rewrites the A tile
    __syncthreads();
  }
}

cudaError_t out_launch(const void* att, const void* S_in, const void* wout_t,
                       const void* ln_f, const void* w1_t, const void* b1,
                       const void* w2_t, const void* b2, void* S_out,
                       const void* ln_next, const void* wqkv_next,
                       void* qkv_next, float scale, const Dims& d,
                       int blocks, int stages, bool pdl,
                       cudaStream_t stream) {
  constexpr int C = kCols;
  const bool next = wqkv_next != nullptr;
  const int smem = out_k4_smem(d.mlp, stages);
  if (d.mlp % kHidden || stages > kRingMax || smem > kSmemMax ||
      (next && (ln_next == nullptr || qkv_next == nullptr)))
    return cudaErrorInvalidValue;
  const int rows = d.B * d.L * d.H * d.W;
  CUtensorMap attmap, womap, w1map, w2map, wqmap;
  cudaError_t err = map2d(&attmap, att, kD, rows, kTile);
  if (err == cudaSuccess) err = map2d(&womap, wout_t, kD, kD, C);
  if (err == cudaSuccess)
    err = map2d(&w1map, w1_t, kD, d.mlp, kHidden);
  if (err == cudaSuccess) err = map2d(&w2map, w2_t, d.mlp, kD, C);
  wqmap = womap;   // not read without a next sublayer
  if (err == cudaSuccess && next)
    err = map2d(&wqmap, wqkv_next, kD, 3 * kD, C);
  if (err == cudaSuccess) err = allow(out_k4, smem);
  if (err != cudaSuccess) return err;
  return hopper_host::launch_pdl(
      pdl, out_k4, dim3(blocks), dim3(128 * kWG), smem, stream, attmap, womap,
      w1map, w2map, wqmap, static_cast<const bf16*>(S_in),
      static_cast<const bf16*>(ln_f), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(b2), static_cast<bf16*>(S_out), d, stages,
      static_cast<const bf16*>(ln_next),
      next ? static_cast<bf16*>(qkv_next) : nullptr, scale);
}

}  // namespace wg4

}  // namespace

// Plain C entry points, loaded with ctypes.  dims: the 9 ints of Dims in
// order (B, L, H, W, D, window, heads, mlp, grid).  Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int cobevt_fusion_qkv(const void* S, const void* ln_a,
                                 const void* wqkv_t, float scale, void* qkv,
                                 const int* dims, int is_bf16, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? qkv_launch<__nv_bfloat16>(S, ln_a, wqkv_t, scale, qkv, d,
                                             s)
                 : qkv_launch<float>(S, ln_a, wqkv_t, scale, qkv, d, s);
}

// qkv (B*nwin*T, 3D) -> att (B*nwin*T, D); bias (T, heads*T) in the
// compute dtype or null; mask (B, L, H, W) f32 or null, masked keys get
// mask_add.
extern "C" int cobevt_fusion_attention(const void* qkv, const void* bias,
                                       const float* mask, float mask_add,
                                       void* att, const int* dims,
                                       int is_bf16, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  const int T = d.L * d.w * d.w;
  const int X = d.H / d.w, Y = d.W / d.w;
  const int D = d.D;
  flash::Args a = {};
  const char* base = static_cast<const char*>(qkv);
  const size_t elt = is_bf16 ? 2 : 4;
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
  a.mask_add = mask_add;
  return (int)flash::launch(a, d.B * X * Y, D / d.heads, is_bf16 != 0,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int cobevt_fusion_out(const void* att, const void* S_in,
                                 const void* wout_t, const void* ln_f,
                                 const void* w1_t, const void* b1,
                                 const void* w2_t, const void* b2,
                                 void* S_out, const int* dims, int is_bf16,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d) || S_in == S_out) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? out_launch<__nv_bfloat16>(att, S_in, wout_t, ln_f, w1_t,
                                             b1, w2_t, b2, S_out, d, s)
                 : out_launch<float>(att, S_in, wout_t, ln_f, w1_t, b1, w2_t,
                                     b2, S_out, d, s);
}

// pdl: the launch may start before the kernel ahead of it has finished
// (hopper_host::launch_pdl), as on K4's wgmma route.
extern "C" int cobevt_fusion_head(const void* S, const float* agent_mask,
                                  const void* ln_h, const void* wh_t,
                                  const void* bh, void* out, const int* dims,
                                  int is_bf16, int pdl, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? head_launch<__nv_bfloat16>(S, agent_mask, ln_h, wh_t, bh,
                                              out, d, pdl != 0, s)
                 : head_launch<float>(S, agent_mask, ln_h, wh_t, bh, out, d,
                                      pdl != 0, s);
}

// K4's wgmma route (bf16, D 128, head dim 16 or 32, mlp a multiple of 128;
// every operand 16-byte aligned; pdl: each launch may start before the one
// ahead of it has finished, hopper_host::launch_pdl).  The first sublayer's
// LN + QKV: S (B, L, H, W, 128) -> qkv, the (3, rows, 128) q, k, v scratch
// in the window-major rows of dims' half; grid (blocks, 3).
extern "C" int cobevt_fusion_wg_qkv(const void* S, const void* ln_a,
                                    const void* wqkv_t, float scale, void* qkv,
                                    const int* dims, int blocks, int pdl,
                                    int device, void* stream) {
  using namespace wg4;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d) || d.D != kD || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int rows = d.B * d.L * d.H * d.W;
  const int smem = qkv_smem(kD, kGroups);
  CUtensorMap wmap, qkvmap;
  err = map2d(&wmap, wqkv_t, kD, 3 * kD, kD);
  if (err == cudaSuccess) err = qkv_map(&qkvmap, qkv, rows, kD);
  if (err == cudaSuccess) err = allow(stream_qkv_wgmma<kD, kGroups>, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)hopper_host::launch_pdl(
      pdl != 0, stream_qkv_wgmma<kD, kGroups>, dim3(blocks, 3),
      dim3(128 * kGroups), smem, static_cast<cudaStream_t>(stream), wmap,
      qkvmap,
      static_cast<const bf16*>(S), static_cast<const bf16*>(ln_a), scale, d);
}

// The attention of one sublayer: K1's wgmma kernel on the (3, rows, 128)
// scratch -> att (rows, 128) with K4's numerics: bias (T, heads*T) bf16;
// mask (G, T) f32 gathered in the window-major order of this half, or null;
// masked keys add -1e9 rounded to bf16; the softmax sum runs over the exp
// rounded to bf16, as K4's numerator.
extern "C" int cobevt_fusion_wg_attention(const void* qkv, const void* bias,
                                          const float* mask, void* att,
                                          const int* dims, int pdl,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  const int hd = d.heads > 0 ? d.D / d.heads : 0;
  if (!dims_ok(d) || d.D != wg4::kD || (hd != 16 && hd != 32) ||
      (d.L * d.w * d.w) % 8)
    return (int)cudaErrorInvalidValue;
  const int rows = d.B * d.L * d.H * d.W;
  const int T = d.L * d.w * d.w;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  return (int)wattn::dispatch_wgmma(
      q, q + (size_t)rows * d.D, q + 2 * (size_t)rows * d.D, bias, mask,
      nullptr, att, nullptr, 0, rows / T, T, T, d.heads, hd, 0,
      wattn::packed_layout(T, T, d.heads, hd), device,
      static_cast<cudaStream_t>(stream), true, pdl != 0);
}

// The output launch of one sublayer, S_in -> S_out (two buffers); with
// wqkv_next (and ln_next, qkv_next) also the next sublayer's LN + QKV into
// the (3, rows, 128) scratch at the rows of the other half.  blocks,
// stages: the persistent grid and each warpgroup's weight ring depth.
extern "C" int cobevt_fusion_wg_out(
    const void* att, const void* S_in, const void* wout_t, const void* ln_f,
    const void* w1_t, const void* b1, const void* w2_t, const void* b2,
    void* S_out, const void* ln_next, const void* wqkv_next, void* qkv_next,
    float scale, const int* dims, int blocks, int stages, int pdl,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d) || d.D != wg4::kD || S_in == S_out || blocks <= 0 ||
      stages < 2)
    return (int)cudaErrorInvalidValue;
  return (int)wg4::out_launch(att, S_in, wout_t, ln_f, w1_t, b1, w2_t, b2,
                              S_out, ln_next, wqkv_next, qkv_next, scale, d,
                              blocks, stages, pdl != 0,
                              static_cast<cudaStream_t>(stream));
}
