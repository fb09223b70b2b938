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
//
// What bounds it on the H100, and the design.  The TPU body keeps a whole
// window row, its keys and every weight resident in VMEM; an SM has 227 KB,
// and at FAX stage 2 K and V alone take 512 KB per window.  So the branch
// runs as four launches on the stream, each a hand-written kernel:
//
//   1. xattn_kv:  LN + K and V projections of every key row, written once
//                 in window-major order (grid windows by index math: the
//                 JAX package's factor-swap copy at models/fax.py:493-498
//                 does not exist here);
//   2. xattn_q:   query build (embedding difference, its norm, the casts),
//                 LN_q, Q projection, bias, scale;
//   3. attention: flash.cuh over key tiles with an online softmax, the
//                 cameras as segments whose normalised outputs are averaged
//                 in f32 in registers;
//   4. xattn_out: O projection, bias, skip, MLP, post-LN, and the store to
//                 the (B, H, W, D) map (un-windowing by index math).
//
// Launches 1, 2 and 4 are token-row kernels (rowops.cuh): 64 rows and 8
// warps a block, f32 tiles in shared memory, LayerNorms one warp per row,
// products on the tensor cores in bf16 (weights read from L2) and scalar
// FMAs in f32.  The Q/K/V and attention scratches are in the compute
// dtype, exactly where the TPU body casts, so the chain rounds where the
// TPU's does.  A 5-agent CorpBEVT frame is ~65 GFLOP of projections and
// ~65 GFLOP of attention over 6 branches.  The row kernels are bound by
// latency, not by device memory or the tensor cores: every mma.sync waits
// on its weight fragment from L2, and f32 tiles of 70-140 KB leave one to
// three blocks per SM (~20 TFLOP/s measured on the H100).
#include "flash.cuh"
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

}  // namespace

// Plain C entry points, loaded with ctypes.  dims: the 14 ints of Dims in
// order (B, n, H, W, D, C, h, w, wh, ww, kh, kw, nq, grid_keys).  Each
// returns the cudaError_t of its launch (0 on success).
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
  return is_bf16 ? out<__nv_bfloat16>(attn, x, wo_t, bo, ln_m, w1_t, b1,
                                      w2_t, b2, ln_p, o, d, hidden, add_skip,
                                      s)
                 : out<float>(attn, x, wo_t, bo, ln_m, w1_t, b1, w2_t, b2,
                              ln_p, o, d, hidden, add_skip, s);
}
