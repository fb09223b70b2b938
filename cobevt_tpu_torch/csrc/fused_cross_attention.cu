// K2: one FAX cross-view branch, fused, for Hopper (sm_90a).
//
// Replaces the Pallas kernel cobevt_tpu/ops/fused_cross_attention.py:
// fused_cross_view_attention (-> _forward_impl -> _kernel :113).  It
// computes, per BEV window and camera, the query
// LN_q(normalize(w_embed - c_embed_i) + x) @ Wq + bq (scaled after its
// bias), K and V as LN(key) @ Wk + bk and LN(val) @ Wv + bv over the
// matching (local or grid) key window of every camera, window attention,
// the camera mean of the f32 outputs, @ Wo + bo, the skip, and optionally
// the token MLP (LN -> Dense -> erf-GELU -> Dense -> residual) and a post-LN.
// The Q/K/V and attention scratches are in the compute dtype, exactly where
// the TPU body casts, so the chain rounds where the TPU's does.
//
// The TPU body keeps a whole window row, its keys and every weight resident
// in VMEM; an SM has 227 KB, and at FAX stage 2 K and V alone take 512 KB a
// window.  So the branch runs as four launches on the stream:
//
//   1. K/V:       LN + K and V projections of every key row, written once
//                 in window-major order (grid windows by index math: the
//                 JAX package's factor-swap copy at models/fax.py:493-498
//                 does not exist here);
//   2. Q:         query build (embedding difference, its norm, the casts),
//                 LN_q, Q projection, bias, scale;
//   3. attention: the cameras as segments whose normalised outputs are
//                 averaged in f32 in registers;
//   4. out:       O projection, bias, skip, MLP, post-LN, and the store to
//                 the (B, H, W, D) map (un-windowing by index math).
//
// What bounds it on the H100.  A 5-agent CorpBEVT frame (six branches, D =
// C = 128, 4 heads of 32, MLP hidden 256) is ~64 GFLOP of projections and
// ~64 GFLOP of attention, 80% of it at stage 0, against ~0.1 GB of
// activations: the operations bind, 0.130 ms a frame at the tensor cores'
// rate (stage0_local 0.073, stage0_grid 0.033, stage 1 0.008 and stage 2
// 0.004 a branch).  The rows are short (128 values) and the weights small
// (32 KB), so what sets the pace is latency: the gathers by index math, the
// LayerNorms (reductions across a row), the exp of the attention.
//
// bf16 at CorpBEVT's widths (ops/fused_cross_attention.py:kernel_path:
// D = C = 128, hidden 0/128/256, head dim 16/32, 1 or 4 query segments) runs
// the wgmma kernels of namespace wg, every product a wgmma with operands in
// shared memory in the 128B-swizzled K-major layout that TMA writes:
//   * projections (launches 1, 2, 4): persistent blocks of one warpgroup
//     (two in launch 4, on alternate tiles) walk 64-row tiles.  A block
//     TMA-loads its weights once (Wq or Wk/Wv, 32 KB; Wo, w1 and w2, 160 KB
//     in launch 4).  The gather and LayerNorm run in the prologue, eight
//     lanes a row (four rows a warp at a time, all loads issued first), and
//     write the bf16 A tile in the swizzled layout; products are m64n128k16
//     with f32 accumulators in registers; bias, scale, skip, GELU and the
//     casts run on the accumulators at the TPU body's rounding points; the
//     token MLP's LayerNorm reduces across the four threads that hold a
//     row, its hidden activations go back to shared memory 128 columns at a
//     time and are summed into the second product at once.
//   * attention (launch 3): K1's window_attention_wgmma_kernel with the
//     cameras as segments: a block owns 64 query rows of one (window, head)
//     in every segment (TMA, once), streams the window's shared keys once
//     through a 4-stage ring, keeps one online softmax and accumulator a
//     segment (m64n64k16 for S, the probabilities as register A fragments of
//     m64n{32,16}k16 for P v), and stores the camera mean rounded once.  The
//     probabilities are rounded to bf16 before both the numerator and the
//     sum, as flash.cuh's contract and the TPU body do.
// f32, and bf16 at the other shapes, run the first kernels: token-row
// kernels (rowops.cuh: f32 tiles in shared memory, LayerNorms one warp a
// row, bf16 products on mma.sync with weights read from L2, f32 products as
// scalar FMAs) and flash.cuh's attention.
#include "flash.cuh"
#include "hopper.cuh"
#include "rowops.cuh"

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
using rowops::warp_sum;
using rowops::zero8;

struct Dims {
  int B, n, H, W, D, C, h, w, wh, ww, kh, kw, nq, grid_keys;
};

__device__ __forceinline__ void window_of(const Dims& d, long long gw,
                                          int* b, int* wx, int* wy) {
  const int X = d.H / d.wh, Y = d.W / d.ww;
  *b = (int)(gw / (X * Y));
  const int wi = (int)(gw - (long long)*b * X * Y);
  *wx = wi / Y;
  *wy = wi - *wx * Y;
}

// 1. K and V: LN + projection of every key row into (G*Tk, C), window-major.
// grid: (ceil(G*Tk / kRows), 2); blockIdx.y picks key (0) or value (1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    xattn_kv_kernel(const T* __restrict__ key, const T* __restrict__ val,
                    const T* __restrict__ ln_k, const T* __restrict__ ln_v,
                    const T* __restrict__ wk_t, const T* __restrict__ wv_t,
                    const T* __restrict__ bk, const T* __restrict__ bv,
                    T* __restrict__ k_out, T* __restrict__ v_out, Dims d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long src_off[kRows];
  const bool is_v = blockIdx.y == 1;
  const T* src = is_v ? val : key;
  const T* ln = is_v ? ln_v : ln_k;
  const T* wt = is_v ? wv_t : wk_t;
  const T* bias = is_v ? bv : bk;
  T* dst = is_v ? v_out : k_out;

  const int X = d.H / d.wh, Y = d.W / d.ww;
  const int cam_tok = d.kh * d.kw;
  const int Tk = d.n * cam_tok;
  const long long rows = (long long)d.B * X * Y * Tk;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int lda = pad(d.D), ldo = pad(d.C);
  const int D8 = d.D / 8, C8 = d.C / 8;
  float* A = smem;
  float* O = smem + kRows * lda;

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const long long rr = row0 + r;
    long long off = -1;
    if (rr < rows) {
      const long long gw = rr / Tk;
      const int j = (int)(rr - gw * Tk);
      int b, wx, wy;
      window_of(d, gw, &b, &wx, &wy);
      const int cam = j / cam_tok;
      const int p = (j - cam * cam_tok) / d.kw;
      const int s = j - cam * cam_tok - p * d.kw;
      const int y = d.grid_keys ? p * X + wx : wx * d.kh + p;
      const int x = d.grid_keys ? s * Y + wy : wy * d.kw + s;
      off = (((long long)(b * d.n + cam) * d.h + y) * d.w + x) * d.D;
    }
    src_off[r] = off;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long off = src_off[r];
    float v[8];
    if (off < 0)
      zero8(v);
    else
      ld8(src + off + c, v);
    st8(A + r * lda + c, v);
  }
  __syncthreads();
  layer_norm_rows<T>(A, lda, d.D, ln, ln + d.D, true);
  __syncthreads();
  Gemm<T>::run(A, lda, wt, d.D, d.C, O, ldo);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * C8; i += kThreads) {
    const int r = i / C8, c = (i - r * C8) * 8;
    if (row0 + r >= rows) continue;
    float v[8];
    ld8(O + r * ldo + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += to_f(bias[c + e]);
    st8(dst + (row0 + r) * d.C + c, v);
  }
}

// 2. Q: query build + LN_q + projection + bias + scale into (G*Tq, C) with
// Tq = nq * wh * ww, camera-major inside a window.  w_embed (H, W, D) and
// c_embed (B, n, D) are null for a branch without the embedding (nq = 1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    xattn_q_kernel(const T* __restrict__ x, const T* __restrict__ w_embed,
                   const T* __restrict__ c_embed, const T* __restrict__ ln_q,
                   const T* __restrict__ wq_t, const T* __restrict__ bq,
                   float scale, T* __restrict__ q_out, Dims d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long pos_off[kRows];  // (b, y, x) token of x
  __shared__ int cam_of[kRows];
  const int X = d.H / d.wh, Y = d.W / d.ww;
  const int Twin = d.wh * d.ww;
  const int Tq = d.nq * Twin;
  const long long rows = (long long)d.B * X * Y * Tq;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int lda = pad(d.D), ldo = pad(d.C);
  const int D8 = d.D / 8, C8 = d.C / 8;
  float* A = smem;
  float* O = smem + kRows * lda;
  const bool embed = w_embed != nullptr;

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const long long rr = row0 + r;
    long long off = -1;
    int cam = 0;
    if (rr < rows) {
      const long long gw = rr / Tq;
      const int j = (int)(rr - gw * Tq);
      int b, wx, wy;
      window_of(d, gw, &b, &wx, &wy);
      cam = j / Twin;
      const int t = j - cam * Twin;
      const int ty = t / d.ww;
      const int y = wx * d.wh + ty;
      const int xx = wy * d.ww + (t - ty * d.ww);
      off = ((long long)(b * d.H + y) * d.W + xx) * d.D;
      cam += b * d.n;  // row of c_embed
    }
    pos_off[r] = off;
    cam_of[r] = cam;
  }
  __syncthreads();
  const long long plane = (long long)d.H * d.W * d.D;
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long off = pos_off[r];
    float v[8];
    if (off < 0) {
      zero8(v);
    } else if (embed) {
      // w_embed - c_embed_i; normalised below once the row's norm is known
      float cv[8];
      ld8(w_embed + off % plane + c, v);
      ld8(c_embed + (long long)cam_of[r] * d.D + c, cv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] -= cv[e];
    } else {
      ld8(x + off + c, v);  // the query of a branch without embed
    }
    st8(A + r * lda + c, v);
  }
  __syncthreads();
  if (embed) {
    // emb / (||emb|| + 1e-7) in f32, cast, + x in the compute dtype
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float* row = A + r * lda;
      float sq = 0.f;
      for (int c = lane; c < d.D; c += 32) sq += row[c] * row[c];
      const float nrm = sqrtf(warp_sum(sq)) + 1e-7f;
      const long long off = pos_off[r];
      for (int c = lane; c < d.D; c += 32) {
        const float xv = off < 0 ? 0.f : to_f(x[off + c]);
        row[c] = rnd<T>(rnd<T>(row[c] / nrm) + xv);
      }
    }
    __syncthreads();
  }
  layer_norm_rows<T>(A, lda, d.D, ln_q, ln_q + d.D, true);
  __syncthreads();
  Gemm<T>::run(A, lda, wq_t, d.D, d.C, O, ldo);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * C8; i += kThreads) {
    const int r = i / C8, c = (i - r * C8) * 8;
    if (row0 + r >= rows) continue;
    float v[8];
    ld8(O + r * ldo + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] + to_f(bq[c + e])) * scale;
    st8(q_out + (row0 + r) * d.C + c, v);
  }
}

// 4. O projection + bias + skip, then the optional MLP and post-LN, stored
// at the tokens' (b, y, x) places of the (B, H, W, D) output.  attn is the
// (G*wh*ww, C) camera mean.  ln_m/w1_t/... are null without the MLP, ln_p
// without the post-LN.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    xattn_out_kernel(const T* __restrict__ attn, const T* __restrict__ x,
                     const T* __restrict__ wo_t, const T* __restrict__ bo,
                     const T* __restrict__ ln_m, const T* __restrict__ w1_t,
                     const T* __restrict__ b1, const T* __restrict__ w2_t,
                     const T* __restrict__ b2, const T* __restrict__ ln_p,
                     T* __restrict__ out, Dims d, int hidden, int add_skip) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long pos_off[kRows];
  const int X = d.H / d.wh, Y = d.W / d.ww;
  const int Twin = d.wh * d.ww;
  const long long rows = (long long)d.B * X * Y * Twin;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int D = d.D, C = d.C;
  const int D8 = D / 8, C8 = C / 8, H8 = hidden / 8;
  const int ld0 = pad(max(C, D)), ldy = pad(D), ldh = pad(hidden);
  float* A = smem;                  // attention rows, then LN(y), then m
  float* Yt = A + kRows * ld0;      // y
  float* Hb = Yt + kRows * ldy;     // MLP hidden
  const bool mlp = w1_t != nullptr;

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const long long rr = row0 + r;
    long long off = -1;
    if (rr < rows) {
      const long long gw = rr / Twin;
      const int t = (int)(rr - gw * Twin);
      int b, wx, wy;
      window_of(d, gw, &b, &wx, &wy);
      const int ty = t / d.ww;
      off = ((long long)(b * d.H + wx * d.wh + ty) * d.W + wy * d.ww +
             (t - ty * d.ww)) * D;
    }
    pos_off[r] = off;
  }
  for (int i = threadIdx.x; i < kRows * C8; i += kThreads) {
    const int r = i / C8, c = (i - r * C8) * 8;
    float v[8];
    if (row0 + r < rows)
      ld8(attn + (row0 + r) * C + c, v);
    else
      zero8(v);
    st8(A + r * ld0 + c, v);
  }
  __syncthreads();
  Gemm<T>::run(A, ld0, wo_t, C, D, Yt, ldy);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long off = pos_off[r];
    float v[8], xv[8];
    ld8(Yt + r * ldy + c, v);
    if (add_skip && off >= 0)
      ld8(x + off + c, xv);
    else
      zero8(xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = v[e] + to_f(bo[c + e]) + xv[e];
      if (mlp) v[e] = rnd<T>(v[e]);  // the MLP residual starts from y cast
    }
    st8(Yt + r * ldy + c, v);
    if (mlp) st8(A + r * ld0 + c, v);
  }
  __syncthreads();
  if (mlp) {
    layer_norm_rows<T>(A, ld0, D, ln_m, ln_m + D, true);
    __syncthreads();
    Gemm<T>::run(A, ld0, w1_t, D, hidden, Hb, ldh);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * H8; i += kThreads) {
      const int r = i / H8, c = (i - r * H8) * 8;
      float v[8];
      ld8(Hb + r * ldh + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = rnd<T>(rowops::gelu_erf(v[e] + to_f(b1[c + e])));
      st8(Hb + r * ldh + c, v);
    }
    __syncthreads();
    Gemm<T>::run(Hb, ldh, w2_t, hidden, D, A, ld0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
      const int r = i / D8, c = (i - r * D8) * 8;
      float v[8], m[8];
      ld8(Yt + r * ldy + c, v);
      ld8(A + r * ld0 + c, m);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] += m[e] + to_f(b2[c + e]);
        if (ln_p != nullptr) v[e] = rnd<T>(v[e]);  // the post-LN reads y cast
      }
      st8(Yt + r * ldy + c, v);
    }
    __syncthreads();
  } else if (ln_p != nullptr) {
    for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
      const int r = i / D8, c = (i - r * D8) * 8;
      float v[8];
      ld8(Yt + r * ldy + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rnd<T>(v[e]);
      st8(Yt + r * ldy + c, v);
    }
    __syncthreads();
  }
  if (ln_p != nullptr) {
    layer_norm_rows<T>(Yt, ldy, D, ln_p, ln_p + D, false);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kRows * D8; i += kThreads) {
    const int r = i / D8, c = (i - r * D8) * 8;
    const long long off = pos_off[r];
    if (off < 0) continue;
    float v[8];
    ld8(Yt + r * ldy + c, v);
    st8(out + off + c, v);
  }
}

int row_blocks(long long rows) { return (int)((rows + kRows - 1) / kRows); }

bool dims_ok(const Dims& d) {
  return d.B > 0 && d.n > 0 && d.nq > 0 && d.D % 16 == 0 &&
         d.C % 16 == 0 &&
         d.wh > 0 && d.ww > 0 && d.kh > 0 && d.kw > 0 && d.H % d.wh == 0 &&
         d.W % d.ww == 0 && d.h % d.kh == 0 && d.w % d.kw == 0 &&
         d.H / d.wh == d.h / d.kh && d.W / d.ww == d.w / d.kw;
}

template <typename T>
int kv(const void* key, const void* val, const void* ln_k, const void* ln_v,
       const void* wk_t, const void* wv_t, const void* bk, const void* bv,
       void* k_out, void* v_out, const Dims& d, cudaStream_t s) {
  const int smem = kRows * (pad(d.D) + pad(d.C)) * (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(xattn_kv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * (d.H / d.wh) * (d.W / d.ww) *
                         d.n * d.kh * d.kw;
  xattn_kv_kernel<T><<<dim3(row_blocks(rows), 2), kThreads, smem, s>>>(
      (const T*)key, (const T*)val, (const T*)ln_k, (const T*)ln_v,
      (const T*)wk_t, (const T*)wv_t, (const T*)bk, (const T*)bv, (T*)k_out,
      (T*)v_out, d);
  return (int)cudaGetLastError();
}

template <typename T>
int q(const void* x, const void* w_embed, const void* c_embed,
      const void* ln_q, const void* wq_t, const void* bq, float scale,
      void* q_out, const Dims& d, cudaStream_t s) {
  const int smem = kRows * (pad(d.D) + pad(d.C)) * (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(xattn_q_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * (d.H / d.wh) * (d.W / d.ww) *
                         d.nq * d.wh * d.ww;
  xattn_q_kernel<T><<<row_blocks(rows), kThreads, smem, s>>>(
      (const T*)x, (const T*)w_embed, (const T*)c_embed, (const T*)ln_q,
      (const T*)wq_t, (const T*)bq, scale, (T*)q_out, d);
  return (int)cudaGetLastError();
}

template <typename T>
int out(const void* attn, const void* x, const void* wo_t, const void* bo,
        const void* ln_m, const void* w1_t, const void* b1, const void* w2_t,
        const void* b2, const void* ln_p, void* o, const Dims& d, int hidden,
        int add_skip, cudaStream_t s) {
  const int smem = kRows * (pad(max(d.C, d.D)) + pad(d.D) +
                            (hidden > 0 ? pad(hidden) : 0)) *
                   (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(xattn_out_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * d.H * d.W;
  xattn_out_kernel<T><<<row_blocks(rows), kThreads, smem, s>>>(
      (const T*)attn, (const T*)x, (const T*)wo_t, (const T*)bo,
      (const T*)ln_m, (const T*)w1_t, (const T*)b1, (const T*)w2_t,
      (const T*)b2, (const T*)ln_p, (T*)o, d, hidden, add_skip);
  return (int)cudaGetLastError();
}

Dims make_dims(const int* dims) {
  Dims d;
  d.B = dims[0];
  d.n = dims[1];
  d.H = dims[2];
  d.W = dims[3];
  d.D = dims[4];
  d.C = dims[5];
  d.h = dims[6];
  d.w = dims[7];
  d.wh = dims[8];
  d.ww = dims[9];
  d.kh = dims[10];
  d.kw = dims[11];
  d.nq = dims[12];
  d.grid_keys = dims[13];
  return d;
}

// ---------------------------------------------------------------------------
// bf16 on wgmma + TMA: D = C = 128, MLP hidden 0, 128 or 256, head dim 16
// or 32, 1 or 4 query segments (ops/fused_cross_attention.py:kernel_path)
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;            // token rows a tile, one warpgroup
constexpr int kWidth = 128;          // D = C
constexpr int kAtomRow = 128;        // bytes of a swizzled row: 64 values
constexpr int kStageLd = kWidth + 8;  // staged output row (halves): 272 B,
                                      // so the accumulator-layout writes
                                      // of 8 rows x 4 threads hit 32 banks
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round1024(int b) { return (b + 1023) & ~1023; }

// Byte offset of element (r, c) in a K-major 128B-swizzled tile of `rows`
// rows: 64-column atoms of rows x 128 bytes, as TMA writes a (64, rows) box
// and wgmma reads it (SBO 1024).
__device__ __forceinline__ uint32_t sw128(int rows, int r, int c) {
  return (c >> 6) * rows * kAtomRow + r * kAtomRow +
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

// acc (64 x 128, f32) {+}= A (64 x K) W[n0 .. n0 + 127, k0 .. k0 + K)^T:
// A a 64-row tile and W an (N x *) weight, both K-major 128B-swizzled in
// shared memory (k0 a multiple of 64).  The caller fences A's writes
// (fence_async_shared + barrier) first.
__device__ __forceinline__ void gemm_n128(float (&acc)[64], const uint8_t* a_s,
                                          const uint8_t* w_s, int N, int n0,
                                          int K, int k0 = 0,
                                          bool accumulate = false) {
  if (!accumulate) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  }
  wgmma_fence();
#pragma unroll 4
  for (int k = 0; k < K / 16; ++k) {
    const uint64_t da = make_desc(
        a_s + (k >> 2) * kTile * kAtomRow + (k & 3) * 32, 1024, kSwizzle128);
    const uint64_t db = make_desc(
        w_s + ((k0 >> 6) + (k >> 2)) * N * kAtomRow + n0 * kAtomRow +
            (k & 3) * 32,
        1024, kSwizzle128);
    wgmma_m64n128k16_ss(acc, da, db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// TMA of an (N x K) bf16 weight into its swizzled place: K / 64 boxes of
// 64 columns x N rows, completing on `bar`
__device__ __forceinline__ void load_weight(uint8_t* w_s,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int N, int K) {
  for (int a = 0; a < K / 64; ++a)
    tma_load_2d(w_s + a * N * kAtomRow, map, bar, a * 64, 0);
}

// A warp gathers and LayerNorms its 16 rows of a tile four at a time: lane
// 8 rs + cl holds columns 16 cl .. 16 cl + 15 of row 4 i + rs (two 16-byte
// loads), so one load instruction moves four 256-byte rows and a row's sums
// take three shuffles among its eight lanes.
__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__device__ __forceinline__ void load16(const bf16* p, uint4 (&raw)[2]) {
  raw[0] = *reinterpret_cast<const uint4*>(p);
  raw[1] = *reinterpret_cast<const uint4*>(p + 8);
}

__device__ __forceinline__ void unpack16(const uint4 (&raw)[2],
                                         float (&x)[16]) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 v = unpack2(u[i]);
    x[2 * i] = v.x;
    x[2 * i + 1] = v.y;
  }
}

// gamma and beta of a (2, 128) LayerNorm pair as f32 in shared memory, value
// i of lane cl's columns at [i * 8 + cl], so the eight lanes of a row read
// eight banks.  All 128 threads; the caller syncs before use.
__device__ __forceinline__ void ln_params(const bf16* ln, float* gb, int tid) {
  const int cl = tid >> 4, i = tid & 15;
  gb[i * 8 + cl] = __bfloat162float(ln[tid]);
  gb[128 + i * 8 + cl] = __bfloat162float(ln[kWidth + tid]);
}

// LayerNorm (eps 1e-5, f32) of the row whose 16 values x this lane holds
// (columns 16 cl ..), rounded to bf16 into row r of the A tile:
// (x - mu) * rsqrt(var + eps) * gamma + beta, as rowops::layer_norm_rows.
__device__ __forceinline__ void ln16_to_a(uint8_t* a_s, int r, int cl,
                                          const float (&x)[16],
                                          const float* gb) {
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) sum += x[e];
  const float mu = group8_sum(sum) / kWidth;
  float sq = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) sq += (x[e] - mu) * (x[e] - mu);
  const float inv = rsqrtf(group8_sum(sq) / kWidth + 1e-5f);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = 2 * i;
    w[i] = pack2((x[e] - mu) * inv * gb[e * 8 + cl] + gb[128 + e * 8 + cl],
                 (x[e + 1] - mu) * inv * gb[(e + 1) * 8 + cl] +
                     gb[128 + (e + 1) * 8 + cl]);
  }
  *reinterpret_cast<uint4*>(a_s + sw128(kTile, r, 16 * cl)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(a_s + sw128(kTile, r, 16 * cl + 8)) =
      make_uint4(w[4], w[5], w[6], w[7]);
}

// (b, wx, wy) of window gw, in 32-bit arithmetic (the wgmma route takes
// fewer than 2^31 rows)
__device__ __forceinline__ void window_of32(const Dims& d, int gw, int* b,
                                            int* wx, int* wy) {
  const int X = d.H / d.wh, Y = d.W / d.ww;
  *b = gw / (X * Y);
  const int wi = gw - *b * X * Y;
  *wx = wi / Y;
  *wy = wi - *wx * Y;
}

// The accumulator tile (+ bias, * scale) rounded to bf16 into the staging
// tile (row stride kStageLd halves).  Accumulator layout (hopper.cuh):
// acc[4j + e] is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2.
__device__ __forceinline__ void stage_acc(bf16* stage, const float (&acc)[64],
                                          const bf16* bias, float scale,
                                          int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 bb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + c));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = warp * 16 + g + 8 * hr;
      *reinterpret_cast<uint32_t*>(stage + r * kStageLd + c) =
          pack2((acc[4 * j + 2 * hr] + bb.x) * scale,
                (acc[4 * j + 2 * hr + 1] + bb.y) * scale);
    }
  }
}

// Rows of the staging tile to device memory, 16 bytes a thread: row r goes
// to dst_of(r) (null: not stored)
template <typename F>
__device__ __forceinline__ void store_stage(const bf16* stage, F dst_of,
                                            int tid) {
#pragma unroll 4
  for (int i = tid; i < kTile * kWidth / 8; i += 128) {
    const int r = i / (kWidth / 8), c = (i % (kWidth / 8)) * 8;
    bf16* dst = dst_of(r);
    if (dst != nullptr)
      *reinterpret_cast<uint4*>(dst + c) =
          *reinterpret_cast<const uint4*>(stage + r * kStageLd + c);
  }
}

// Shared memory of the K/V and Q launches: the weight (32 KB), the A tile
// (16 KB), the staged output (17 KB), the LayerNorm pair (1 KB), the
// barrier.
constexpr int kWeightBytes = kWidth * kWidth * 2;
constexpr int kABytes = kTile * kWidth * 2;
constexpr int kStageBytes = round1024(kTile * kStageLd * 2);
constexpr int kProjSmem =
    1024 + kWeightBytes + kABytes + kStageBytes + 1024 + 16;
constexpr int kProjBlocksPerSm = 3;

// 1. K and V, wgmma.  grid: (persistent blocks, 2); blockIdx.y picks key (0)
// or value (1).  A block loads its weight once and walks 64-row tiles of the
// (G*Tk) window-major key rows: gather (index math), LN, product, + bias.
__global__ void __launch_bounds__(128, kProjBlocksPerSm)
    xattn_kv_wgmma(const __grid_constant__ CUtensorMap wkmap,
                   const __grid_constant__ CUtensorMap wvmap,
                   const bf16* __restrict__ key, const bf16* __restrict__ val,
                   const bf16* __restrict__ ln_k,
                   const bf16* __restrict__ ln_v,
                   const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                   bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                   Dims d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* w_s = smem;
  uint8_t* a_s = w_s + kWeightBytes;
  bf16* stage = reinterpret_cast<bf16*>(a_s + kABytes);
  float* gb = reinterpret_cast<float*>(a_s + kABytes + kStageBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(a_s + kABytes + kStageBytes +
                                              1024);
  const bool is_v = blockIdx.y == 1;
  const bf16* src = is_v ? val : key;
  const bf16* bias = is_v ? bv : bk;
  bf16* dst = is_v ? v_out : k_out;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar, kWeightBytes);
    load_weight(w_s, is_v ? &wvmap : &wkmap, bar, kWidth, kWidth);
  }
  ln_params(is_v ? ln_v : ln_k, gb, tid);
  __syncthreads();
  const int rs = lane >> 3, cl = lane & 7;

  const int X = d.H / d.wh, Y = d.W / d.ww;
  const int cam_tok = d.kh * d.kw;
  const int Tk = d.n * cam_tok;
  const int rows = d.B * X * Y * Tk;
  const int tiles = (rows + kTile - 1) / kTile;
  mbar_wait(bar, 0);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    // warp w gathers rows 16 w .. 16 w + 15, four at a time, all loads
    // first (a row past the end reads the last row, and is not stored)
    uint4 raw[4][2];
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int rr = min(row0 + warp * 16 + 4 * it + rs, rows - 1);
      const int gw = rr / Tk;
      const int j = rr - gw * Tk;
      int b, wx, wy;
      window_of32(d, gw, &b, &wx, &wy);
      const int cam = j / cam_tok;
      const int p = (j - cam * cam_tok) / d.kw;
      const int s = j - cam * cam_tok - p * d.kw;
      const int y = d.grid_keys ? p * X + wx : wx * d.kh + p;
      const int xx = d.grid_keys ? s * Y + wy : wy * d.kw + s;
      load16(src + (((long long)(b * d.n + cam) * d.h + y) * d.w + xx) *
                       kWidth + 16 * cl,
             raw[it]);
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      float xv[16];
      unpack16(raw[it], xv);
      ln16_to_a(a_s, warp * 16 + 4 * it + rs, cl, xv, gb);
    }
    fence_async_shared();
    __syncthreads();
    float acc[64];
    gemm_n128(acc, a_s, w_s, kWidth, 0, kWidth);
    stage_acc(stage, acc, bias, 1.f, warp, g, t);
    __syncthreads();
    store_stage(stage, [&](int r) -> bf16* {
      return row0 + r < rows ? dst + (long long)(row0 + r) * kWidth
                             : nullptr;
    }, tid);
    __syncthreads();
  }
}

// 2. Q, wgmma: query build (embedding difference, its norm, the casts), LN_q,
// product, + bias, * scale, into (G*Tq, C), camera-major in a window.
__global__ void __launch_bounds__(128, kProjBlocksPerSm)
    xattn_q_wgmma(const __grid_constant__ CUtensorMap wqmap,
                  const bf16* __restrict__ x, const bf16* __restrict__ w_embed,
                  const bf16* __restrict__ c_embed,
                  const bf16* __restrict__ ln_q, const bf16* __restrict__ bq,
                  float scale, bf16* __restrict__ q_out, Dims d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* w_s = smem;
  uint8_t* a_s = w_s + kWeightBytes;
  bf16* stage = reinterpret_cast<bf16*>(a_s + kABytes);
  float* gb = reinterpret_cast<float*>(a_s + kABytes + kStageBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(a_s + kABytes + kStageBytes +
                                              1024);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar, kWeightBytes);
    load_weight(w_s, &wqmap, bar, kWidth, kWidth);
  }
  ln_params(ln_q, gb, tid);
  __syncthreads();
  const int rs = lane >> 3, cl = lane & 7;
  const bool embed = w_embed != nullptr;

  const int X = d.H / d.wh, Y = d.W / d.ww;
  const int Twin = d.wh * d.ww;
  const int Tq = d.nq * Twin;
  const int rows = d.B * X * Y * Tq;
  const int tiles = (rows + kTile - 1) / kTile;
  mbar_wait(bar, 0);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTile;
    // warp w gathers rows 16 w .. 16 w + 15, four at a time, all loads
    // first (a row past the end reads the last row, and is not stored)
    uint4 rx[4][2], rw[4][2], rc[4][2];
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int rr = min(row0 + warp * 16 + 4 * it + rs, rows - 1);
      const int gw = rr / Tq;
      const int j = rr - gw * Tq;
      int b, wx, wy;
      window_of32(d, gw, &b, &wx, &wy);
      const int cam = j / Twin;
      const int tk = j - cam * Twin;
      const int ty = tk / d.ww;
      const int pos = (wx * d.wh + ty) * d.W + wy * d.ww + (tk - ty * d.ww);
      load16(x + ((long long)b * d.H * d.W + pos) * kWidth + 16 * cl,
             rx[it]);
      if (embed) {
        load16(w_embed + (long long)pos * kWidth + 16 * cl, rw[it]);
        load16(c_embed + (long long)(b * d.n + cam) * kWidth + 16 * cl,
               rc[it]);
      }
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      float xv[16];
      unpack16(rx[it], xv);
      if (embed) {
        // normalize(w_embed - c_embed_i) in f32, cast, + x in bf16
        float we[16], ce[16];
        unpack16(rw[it], we);
        unpack16(rc[it], ce);
        float sq = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          we[e] -= ce[e];
          sq += we[e] * we[e];
        }
        const float nrm = sqrtf(group8_sum(sq)) + 1e-7f;
#pragma unroll
        for (int e = 0; e < 16; ++e) xv[e] = rnd(rnd(we[e] / nrm) + xv[e]);
      }
      ln16_to_a(a_s, warp * 16 + 4 * it + rs, cl, xv, gb);
    }
    fence_async_shared();
    __syncthreads();
    float acc[64];
    gemm_n128(acc, a_s, w_s, kWidth, 0, kWidth);
    stage_acc(stage, acc, bq, scale, warp, g, t);
    __syncthreads();
    store_stage(stage, [&](int r) -> bf16* {
      return row0 + r < rows ? q_out + (long long)(row0 + r) * kWidth
                             : nullptr;
    }, tid);
    __syncthreads();
  }
}

// Shared memory of the output launch: Wo, w1, w2 (hidden x 128 each way),
// then for each of the two warpgroups its A tile and its tile of 128 hidden
// columns.
constexpr int kOutGroups = 2;
__host__ __device__ inline int out_smem(int hidden) {
  return 1024 + kWeightBytes + 2 * hidden * kWidth * 2 +
         kOutGroups * 2 * kABytes + 16;
}

// this thread's two rows of the accumulator tile: LayerNorm in f32 (eps
// 1e-5) over the 128 columns held by the four threads of a group
__device__ __forceinline__ void ln_acc(float (&y)[64], const bf16* ln, int t,
                                       bool round_out) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += y[4 * j + 2 * hr] + y[4 * j + 2 * hr + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s / kWidth;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dv = y[4 * j + 2 * hr + e] - mu;
        sq += dv * dv;
      }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float inv = rsqrtf(sq / kWidth + 1e-5f);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 gg = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ln + c));
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(ln + kWidth + c));
      float& y0 = y[4 * j + 2 * hr];
      float& y1 = y[4 * j + 2 * hr + 1];
      y0 = (y0 - mu) * inv * gg.x + bb.x;
      y1 = (y1 - mu) * inv * gg.y + bb.y;
      if (round_out) {
        y0 = rnd(y0);
        y1 = rnd(y1);
      }
    }
  }
}

// 4. O projection + bias + skip, then the optional MLP and post-LN, stored
// at the tokens' (b, y, x) places of the (B, H, W, D) output, wgmma.  A
// block loads Wo, w1, w2 once (TMA) and its two warpgroups walk 64-row tiles
// of the (G*Tw) camera-mean rows independently (named barriers); y stays in
// registers between the products, LN_m(y) goes back to shared memory as the
// A tile, and the hidden activations 128 columns at a time, each half
// summed into the second product at once.
__global__ void __launch_bounds__(128 * kOutGroups, 1)
    xattn_out_wgmma(const __grid_constant__ CUtensorMap womap,
                    const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap w2map,
                    const bf16* __restrict__ attn, const bf16* __restrict__ x,
                    const bf16* __restrict__ bo, const bf16* __restrict__ ln_m,
                    const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                    const bf16* __restrict__ ln_p, bf16* __restrict__ out,
                    Dims d, int hidden, int add_skip) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wo_s = smem;
  uint8_t* w1_s = wo_s + kWeightBytes;
  uint8_t* w2_s = w1_s + hidden * kWidth * 2;
  const int grp = threadIdx.x >> 7;
  uint8_t* a_s = w2_s + hidden * kWidth * 2 + grp * 2 * kABytes;
  uint8_t* h_s = a_s + kABytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      w2_s + hidden * kWidth * 2 + kOutGroups * 2 * kABytes);
  const bool mlp = hidden > 0;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the warpgroup's own barrier (ids 1, 2; 0 is __syncthreads)
  auto group_sync = [&]() { named_barrier_sync(1 + grp, 128); };
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar, kWeightBytes + 2 * hidden * kWidth * 2);
    load_weight(wo_s, &womap, bar, kWidth, kWidth);
    if (mlp) {
      load_weight(w1_s, &w1map, bar, hidden, kWidth);
      load_weight(w2_s, &w2map, bar, kWidth, hidden);
    }
  }
  __syncthreads();

  const int X = d.H / d.wh, Y = d.W / d.ww;
  const int Twin = d.wh * d.ww;
  const long long rows = (long long)d.B * X * Y * Twin;
  const long long tiles = (rows + kTile - 1) / kTile;
  // (b, y, x) token of row rr, or -1 past the rows
  auto pos_of = [&](long long rr) -> long long {
    if (rr >= rows) return -1;
    const long long gw = rr / Twin;
    const int tk = (int)(rr - gw * Twin);
    int b, wx, wy;
    window_of(d, gw, &b, &wx, &wy);
    const int ty = tk / d.ww;
    return ((long long)(b * d.H + wx * d.wh + ty) * d.W + wy * d.ww +
            (tk - ty * d.ww));
  };
  mbar_wait(bar, 0);
  for (long long tile = (long long)blockIdx.x * kOutGroups + grp;
       tile < tiles; tile += (long long)gridDim.x * kOutGroups) {
    const long long row0 = tile * kTile;
    // the camera-mean rows as the A tile, 16 bytes a thread
#pragma unroll 4
    for (int i = tid; i < kTile * kWidth / 8; i += 128) {
      const int r = i / (kWidth / 8), c = (i % (kWidth / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < rows)
        v = *reinterpret_cast<const uint4*>(attn + (row0 + r) * kWidth + c);
      *reinterpret_cast<uint4*>(a_s + sw128(kTile, r, c)) = v;
    }
    fence_async_shared();
    group_sync();
    float y[64];
    gemm_n128(y, a_s, wo_s, kWidth, 0, kWidth);
    long long pos[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      pos[hr] = pos_of(row0 + warp * 16 + g + 8 * hr);
    // y = attn Wo + bo + skip; the MLP residual and the post-LN start from
    // y cast
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(bo + c));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2 xv = make_float2(0.f, 0.f);
        if (add_skip && pos[hr] >= 0)
          xv = unpack2(*reinterpret_cast<const uint32_t*>(
              x + pos[hr] * kWidth + c));
        float& y0 = y[4 * j + 2 * hr];
        float& y1 = y[4 * j + 2 * hr + 1];
        y0 = y0 + bb.x + xv.x;
        y1 = y1 + bb.y + xv.y;
        if (mlp || ln_p != nullptr) {
          y0 = rnd(y0);
          y1 = rnd(y1);
        }
      }
    }
    if (mlp) {
      // LN_m(y) rounded, as the A tile of the first MLP product
      float m2[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) m2[i] = y[i];
      ln_acc(m2, ln_m, t, true);
      group_sync();   // every warp is past the Wo product's A tile
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(
              a_s + sw128(kTile, warp * 16 + g + 8 * hr, 8 * j + 2 * t)) =
              pack2(m2[4 * j + 2 * hr], m2[4 * j + 2 * hr + 1]);
      fence_async_shared();
      group_sync();
      // m2 = gelu(LN_m(y) w1 + b1) w2, 128 hidden columns at a time: each
      // half rounded into the hidden tile and summed into m2 at once
      for (int n0 = 0; n0 < hidden; n0 += kWidth) {
        float hcc[64];
        gemm_n128(hcc, a_s, w1_s, hidden, n0, kWidth);
        if (n0 > 0) group_sync();   // the last half's product is done
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(b1 + n0 + c));
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<uint32_t*>(
                h_s + sw128(kTile, warp * 16 + g + 8 * hr, c)) =
                pack2(rowops::gelu_erf(hcc[4 * j + 2 * hr] + bb.x),
                      rowops::gelu_erf(hcc[4 * j + 2 * hr + 1] + bb.y));
        }
        fence_async_shared();
        group_sync();
        gemm_n128(m2, h_s, w2_s, kWidth, 0, kWidth, n0, n0 > 0);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(b2 + c));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& y0 = y[4 * j + 2 * hr];
          float& y1 = y[4 * j + 2 * hr + 1];
          y0 += m2[4 * j + 2 * hr] + bb.x;
          y1 += m2[4 * j + 2 * hr + 1] + bb.y;
          if (ln_p != nullptr) {   // the post-LN reads y cast
            y0 = rnd(y0);
            y1 = rnd(y1);
          }
        }
      }
    }
    if (ln_p != nullptr) ln_acc(y, ln_p, t, false);
    // each row is one 256-byte run of the output: 16 bytes a group of four
    // threads a store
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (pos[hr] < 0) continue;
      bf16* op = out + pos[hr] * kWidth;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) =
            pack2(y[4 * j + 2 * hr], y[4 * j + 2 * hr + 1]);
    }
    group_sync();   // the A and hidden tiles are free for the next tile
  }
}

// 3. Attention, wgmma: K1's window_attention_wgmma_kernel with the cameras
// as NSEG query segments.  grid: G * heads * ceil(Tw / 64) blocks of one
// warpgroup (query tiles fastest); a block holds the 64 query rows of its
// tile in every segment (TMA, once), streams the window's shared keys once
// through a ring of 64-key stages, keeps an online softmax and an f32
// accumulator per segment, and stores the mean over the segments of the
// normalised outputs, rounded once.  The probabilities are rounded to bf16
// before both the numerator and the sum (flash.cuh's contract).  Maps: q as
// 4D (D, heads, NSEG*Tw, G), k/v as (D, heads, Tk, G), boxes of 64 rows x D.
constexpr int kAttnStages = 4;

template <int D, int NSEG>
__global__ void __launch_bounds__(128, NSEG == 1 ? 6 : 3)
    xattn_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          bf16* __restrict__ out, int Tw, int Tk, int heads) {
  constexpr Swizzle kSw = D == 32 ? kSwizzle64 : kSwizzle32;
  constexpr uint32_t kRowBytes = D * 2;
  constexpr int kTileBytes = kTile * D * 2;   // 4 or 2 KB: 1024-aligned
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* ring = q_s + NSEG * kTileBytes;
  uint64_t* qbar =
      reinterpret_cast<uint64_t*>(ring + kAttnStages * 2 * kTileBytes);
  uint64_t* full = qbar + 1;

  const int QT = (Tw + kTile - 1) / kTile;
  int b = blockIdx.x;
  const int qt = b % QT;
  b /= QT;
  const int h = b % heads;
  const int win = b / heads;
  const int q0 = qt * kTile;
  const int KT = (Tk + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kAttnStages; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();
  auto load_tile = [&](int kt) {
    const int s = kt % kAttnStages;
    uint8_t* st = ring + s * 2 * kTileBytes;
    mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
    tma_load_4d(st, &kmap, &full[s], 0, h, kt * kTile, win);
    tma_load_4d(st + kTileBytes, &vmap, &full[s], 0, h, kt * kTile, win);
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(qbar, NSEG * kTileBytes);
    for (int sg = 0; sg < NSEG; ++sg)
      tma_load_4d(q_s + sg * kTileBytes, &qmap, qbar, 0, h, sg * Tw + q0,
                  win);
    for (int kt = 0; kt < kAttnStages && kt < KT; ++kt) load_tile(kt);
  }
  const int gq = lane >> 2, t = lane & 3;
  const int rl[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  mbar_wait(qbar, 0);

  float o[NSEG][D / 2];
  float ml[NSEG][2], l[NSEG][2];
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[sg][i] = 0.f;
    ml[sg][0] = ml[sg][1] = -INFINITY;
    l[sg][0] = l[sg][1] = 0.f;
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kAttnStages;
    mbar_wait(&full[s], (kt / kAttnStages) & 1);
    uint8_t* st = ring + s * 2 * kTileBytes;
    const uint64_t dk = make_desc(st, 8 * kRowBytes, kSw);
    const uint64_t dv = make_desc(st + kTileBytes, 8 * kRowBytes, kSw);
    const int k0 = kt * kTile;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      const uint64_t dq = make_desc(q_s + sg * kTileBytes, 8 * kRowBytes, kSw);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        wgmma_m64n64k16_ss(sc, desc_add(dq, 32 * kd), desc_add(dk, 32 * kd),
                           1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        if (k0 + 8 * j + 2 * t >= Tk) {   // Tk % 8 == 0: both columns past
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * j + e] = -INFINITY;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], sc[4 * j + e]);
      }
      float alpha[2], mlog[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        tile_max[hr] = fmaxf(tile_max[hr],
                             __shfl_xor_sync(0xffffffffu, tile_max[hr], 1));
        tile_max[hr] = fmaxf(tile_max[hr],
                             __shfl_xor_sync(0xffffffffu, tile_max[hr], 2));
        mlog[hr] = fmaxf(ml[sg][hr], tile_max[hr] * kLog2e);   // finite
        alpha[hr] = exp2f(ml[sg][hr] - mlog[hr]);
        ml[sg][hr] = mlog[hr];
        l[sg][hr] *= alpha[hr];
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[sg][e] *= alpha[(e >> 1) & 1];
      uint32_t pa[kTile / 16][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const uint32_t lo = pack2(exp2f(fmaf(sc[4 * j], kLog2e, -mlog[0])),
                                  exp2f(fmaf(sc[4 * j + 1], kLog2e, -mlog[0])));
        const uint32_t hi = pack2(exp2f(fmaf(sc[4 * j + 2], kLog2e, -mlog[1])),
                                  exp2f(fmaf(sc[4 * j + 3], kLog2e, -mlog[1])));
        const float2 plo = unpack2(lo), phi = unpack2(hi);
        l[sg][0] += plo.x + plo.y;
        l[sg][1] += phi.x + phi.y;
        pa[j >> 1][(j & 1) * 2] = lo;
        pa[j >> 1][(j & 1) * 2 + 1] = hi;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if constexpr (D == 32)
          wgmma_m64n32k16_rs_mn(o[sg], pa[kk],
                                desc_add(dv, 16 * kRowBytes * kk), 1);
        else
          wgmma_m64n16k16_rs_mn(o[sg], pa[kk],
                                desc_add(dv, 16 * kRowBytes * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o[sg]);
    }
    if (kt + kAttnStages < KT) {
      __syncthreads();
      if (tid == 0) load_tile(kt + kAttnStages);
    }
  }
  float mean[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) mean[i] = 0.f;
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg) {
    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[sg][hr] += __shfl_xor_sync(0xffffffffu, l[sg][hr], 1);
      l[sg][hr] += __shfl_xor_sync(0xffffffffu, l[sg][hr], 2);
      inv[hr] = 1.f / l[sg][hr];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) mean[i] += o[sg][i] * inv[(i >> 1) & 1];
  }
  const float inv_seg = 1.f / NSEG;
  const int C = heads * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + rl[hr];
    if (row >= Tw) continue;
    bf16* op = out + ((size_t)win * Tw + row) * C + h * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(op + nd * 8 + 2 * t) =
          __floats2bfloat162_rn(mean[4 * nd + 2 * hr] * inv_seg,
                                mean[4 * nd + 2 * hr + 1] * inv_seg);
  }
}

template <int D, int NSEG>
constexpr int attention_smem() {
  return 1024 + (NSEG + 2 * kAttnStages) * kTile * D * 2 +
         (1 + kAttnStages) * 8;
}

// The SM count, once per device, for the persistent grids
inline int sm_count(int device) {
  static int count[64] = {};
  if (device >= 64) return 132;
  if (count[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0)
      n = 132;
    count[device] = n;
  }
  return count[device];
}

inline int persistent_blocks(long long rows, int per_sm, int device) {
  const long long tiles = (rows + kTile - 1) / kTile;
  const long long cap = (long long)sm_count(device) * per_sm;
  return (int)(tiles < cap ? tiles : cap);
}

// 2D map of an (N, K) bf16 weight, boxes of 64 columns x N rows, 128B
// swizzle
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int N, int K) {
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t strides[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {64, (uint32_t)N};
  return hopper_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                               dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// 4D map (D, heads, T, G) of a (G, T, heads*D) bf16 tensor, boxes of 64 rows
inline cudaError_t rows_map(CUtensorMap* map, const void* base, int G, int T,
                            int heads, int D) {
  const uint64_t row = (uint64_t)D * 2, C = (uint64_t)heads * D;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)T,
                            (uint64_t)G};
  const uint64_t strides[3] = {row, C * 2, (uint64_t)T * C * 2};
  const uint32_t box[4] = {(uint32_t)D, 1, kTile, 1};
  return hopper_host::make_map(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <typename K>
inline cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the shapes this route takes (ops/fused_cross_attention.py:kernel_path)
inline bool takes(const Dims& d) { return d.D == kWidth && d.C == kWidth; }

int kv(const void* key, const void* val, const void* ln_k, const void* ln_v,
       const void* wk_t, const void* wv_t, const void* bk, const void* bv,
       void* k_out, void* v_out, const Dims& d, int device, cudaStream_t s) {
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap wk, wv;
  cudaError_t err = weight_map(&wk, wk_t, kWidth, kWidth);
  if (err == cudaSuccess) err = weight_map(&wv, wv_t, kWidth, kWidth);
  if (err == cudaSuccess) err = allow(xattn_kv_wgmma, kProjSmem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * (d.H / d.wh) * (d.W / d.ww) *
                         d.n * d.kh * d.kw;
  if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  xattn_kv_wgmma<<<dim3(persistent_blocks(rows, kProjBlocksPerSm, device), 2),
                   128, kProjSmem, s>>>(
      wk, wv, (const bf16*)key, (const bf16*)val, (const bf16*)ln_k,
      (const bf16*)ln_v, (const bf16*)bk, (const bf16*)bv, (bf16*)k_out,
      (bf16*)v_out, d);
  return (int)cudaGetLastError();
}

int q(const void* x, const void* w_embed, const void* c_embed,
      const void* ln_q, const void* wq_t, const void* bq, float scale,
      void* q_out, const Dims& d, int device, cudaStream_t s) {
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap wq;
  cudaError_t err = weight_map(&wq, wq_t, kWidth, kWidth);
  if (err == cudaSuccess) err = allow(xattn_q_wgmma, kProjSmem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * (d.H / d.wh) * (d.W / d.ww) *
                         d.nq * d.wh * d.ww;
  if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  xattn_q_wgmma<<<persistent_blocks(rows, kProjBlocksPerSm, device), 128,
                  kProjSmem, s>>>(wq, (const bf16*)x, (const bf16*)w_embed,
                                  (const bf16*)c_embed, (const bf16*)ln_q,
                                  (const bf16*)bq, scale, (bf16*)q_out, d);
  return (int)cudaGetLastError();
}

int out(const void* attn, const void* x, const void* wo_t, const void* bo,
        const void* ln_m, const void* w1_t, const void* b1, const void* w2_t,
        const void* b2, const void* ln_p, void* o, const Dims& d, int hidden,
        int add_skip, int device, cudaStream_t s) {
  if (!takes(d) || (hidden != 0 && hidden != 128 && hidden != 256) ||
      (hidden > 0) != (w1_t != nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap wo, w1, w2;
  cudaError_t err = weight_map(&wo, wo_t, kWidth, kWidth);
  w1 = w2 = wo;
  if (err == cudaSuccess && hidden > 0) {
    err = weight_map(&w1, w1_t, hidden, kWidth);
    if (err == cudaSuccess) err = weight_map(&w2, w2_t, kWidth, hidden);
  }
  const int smem = out_smem(hidden);
  if (err == cudaSuccess) err = allow(xattn_out_wgmma, smem);
  if (err != cudaSuccess) return (int)err;
  // one block an SM, its warpgroups on alternate tiles
  const long long pairs = ((long long)d.B * d.H * d.W + 2 * kTile - 1) /
                          (2 * kTile);
  const int blocks = (int)(pairs < sm_count(device) ? pairs : sm_count(device));
  xattn_out_wgmma<<<blocks, 128 * kOutGroups, smem, s>>>(
      wo, w1, w2, (const bf16*)attn, (const bf16*)x, (const bf16*)bo,
      (const bf16*)ln_m, (const bf16*)b1, (const bf16*)b2,
      (const bf16*)ln_p, (bf16*)o, d, hidden, add_skip);
  return (int)cudaGetLastError();
}

template <int D, int NSEG>
cudaError_t attention_launch(const CUtensorMap* maps, void* out, int G,
                             int Tw, int Tk, int heads, cudaStream_t s) {
  constexpr int smem = attention_smem<D, NSEG>();
  cudaError_t err = allow(xattn_attention_wgmma<D, NSEG>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)G * heads * ((Tw + kTile - 1) / kTile);
  xattn_attention_wgmma<D, NSEG><<<(unsigned)blocks, 128, smem, s>>>(
      maps[0], maps[1], maps[2], (bf16*)out, Tw, Tk, heads);
  return cudaGetLastError();
}

int attention(const void* q, const void* k, const void* v, void* out, int G,
              int Tw, int nq, int Tk, int heads, int C, cudaStream_t s) {
  const int D = C / heads;
  if ((D != 16 && D != 32) || (nq != 1 && nq != 4) || Tk % 8 || G <= 0 ||
      Tw <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  cudaError_t err = rows_map(&maps[0], q, G, nq * Tw, heads, D);
  if (err == cudaSuccess) err = rows_map(&maps[1], k, G, Tk, heads, D);
  if (err == cudaSuccess) err = rows_map(&maps[2], v, G, Tk, heads, D);
  if (err != cudaSuccess) return (int)err;
  if (D == 32)
    err = nq == 4 ? attention_launch<32, 4>(maps, out, G, Tw, Tk, heads, s)
                  : attention_launch<32, 1>(maps, out, G, Tw, Tk, heads, s);
  else
    err = nq == 4 ? attention_launch<16, 4>(maps, out, G, Tw, Tk, heads, s)
                  : attention_launch<16, 1>(maps, out, G, Tw, Tk, heads, s);
  return (int)err;
}

}  // namespace wg

}  // namespace

// Plain C entry points, loaded with ctypes.  dims: the 14 ints of Dims in
// order (B, n, H, W, D, C, h, w, wh, ww, kh, kw, nq, grid_keys).  is_bf16:
// 0 f32 (scalar), 1 bf16 on the row kernels and flash.cuh, 2 bf16 on the
// wgmma kernels (the shapes of ops/fused_cross_attention.py:kernel_path;
// every operand 16-byte aligned).  Each returns the cudaError_t of its
// launch (0 on success).
extern "C" int cobevt_xattn_kv(const void* key, const void* val,
                               const void* ln_k, const void* ln_v,
                               const void* wk_t, const void* wv_t,
                               const void* bk, const void* bv, void* k_out,
                               void* v_out, const int* dims, int is_bf16,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 == 2)
    return wg::kv(key, val, ln_k, ln_v, wk_t, wv_t, bk, bv, k_out, v_out, d,
                  device, s);
  return is_bf16 ? kv<__nv_bfloat16>(key, val, ln_k, ln_v, wk_t, wv_t, bk,
                                     bv, k_out, v_out, d, s)
                 : kv<float>(key, val, ln_k, ln_v, wk_t, wv_t, bk, bv, k_out,
                             v_out, d, s);
}

extern "C" int cobevt_xattn_q(const void* x, const void* w_embed,
                              const void* c_embed, const void* ln_q,
                              const void* wq_t, const void* bq, float scale,
                              void* q_out, const int* dims, int is_bf16,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 == 2)
    return wg::q(x, w_embed, c_embed, ln_q, wq_t, bq, scale, q_out, d, device,
                 s);
  return is_bf16 ? q<__nv_bfloat16>(x, w_embed, c_embed, ln_q, wq_t, bq,
                                    scale, q_out, d, s)
                 : q<float>(x, w_embed, c_embed, ln_q, wq_t, bq, scale, q_out,
                            d, s);
}

// q (G, nq*Tw, C), k/v (G, Tk, C) -> out (G, Tw, C), the mean over the nq
// query segments; G windows, Tw = wh*ww.
extern "C" int cobevt_xattn_attention(const void* q, const void* k,
                                      const void* v, void* out, int G,
                                      int Tw, int nq, int Tk, int heads,
                                      int C, int is_bf16, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (heads <= 0 || C % heads) return (int)cudaErrorInvalidValue;
  if (is_bf16 == 2)
    return wg::attention(q, k, v, out, G, Tw, nq, Tk, heads, C,
                         static_cast<cudaStream_t>(stream));
  flash::Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_win = (long long)nq * Tw * C;
  a.kv_win = (long long)Tk * C;
  a.ldq = a.ldkv = a.ldo = C;
  a.out = out;
  a.o_win = (long long)Tw * C;
  a.Tq = Tw;
  a.nseg = nq;
  a.Tk = Tk;
  a.heads = heads;
  return (int)flash::launch(a, G, C / heads, is_bf16 != 0,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int cobevt_xattn_out(const void* attn, const void* x,
                                const void* wo_t, const void* bo,
                                const void* ln_m, const void* w1_t,
                                const void* b1, const void* w2_t,
                                const void* b2, const void* ln_p, void* o,
                                const int* dims, int hidden, int add_skip,
                                int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d) || hidden % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 == 2)
    return wg::out(attn, x, wo_t, bo, ln_m, w1_t, b1, w2_t, b2, ln_p, o, d,
                   hidden, add_skip, device, s);
  return is_bf16 ? out<__nv_bfloat16>(attn, x, wo_t, bo, ln_m, w1_t, b1,
                                      w2_t, b2, ln_p, o, d, hidden, add_skip,
                                      s)
                 : out<float>(attn, x, wo_t, bo, ln_m, w1_t, b1, w2_t, b2,
                              ln_p, o, d, hidden, add_skip, s);
}
