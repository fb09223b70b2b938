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
// in no order, so nothing carries over between them.  Each sublayer is
// therefore three launches, each a hand-written kernel, and the state
// stays in device memory (it is L2-resident at this size):
//
//   1. fusion_qkv:  LN + QKV projection of every token, window-major
//                   (window or grid cells by index math: no factor-swap
//                   copy), into a (tokens, 3D) scratch in the compute dtype;
//   2. attention:   flash.cuh, one block per (64-query tile, head, window),
//                   key tiles streamed with an online softmax; bias and
//                   mask in the compute dtype as on the TPU, the mask read
//                   from the (B, L, H, W) mask through the window map;
//   3. fusion_out:  out-projection, residual, LN, FFN, residual, stored to
//                   the tokens' places in a second state buffer.
//
// A sublayer reads one state buffer and writes the other (ping-pong): the
// blocks of one window read all of its tokens while other blocks write, so
// it never updates in place.  fusion_head pools the agents and runs the
// head.  At CorpBEVT that is 6 x 3 + 1 = 19 launches and ~17 GFLOP a frame
// (12 in the projections and FFNs); the row kernels are latency-bound as
// in K2 (rowops.cuh), and the call's 0.8 ms of device time is smaller than
// its host dispatch.
#include "flash.cuh"
#include "rowops.cuh"
#include "swap_state.cuh"

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
// cast -> LN -> @ Wh + bh, one row per (b, y, x) of the (B, H, W, D) output
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fusion_head_kernel(const T* __restrict__ S,
                       const float* __restrict__ agent_mask,
                       const T* __restrict__ ln_h, const T* __restrict__ wh_t,
                       const T* __restrict__ bh, T* __restrict__ out,
                       Dims d) {
  extern __shared__ __align__(16) float smem[];
  const long long rows = (long long)d.B * d.H * d.W;
  const long long row0 = (long long)blockIdx.x * kRows;
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
  layer_norm_rows<T>(A, ld, D, ln_h, ln_h + D, true);
  __syncthreads();
  Gemm<T>::run(A, ld, wh_t, D, D, O, ld);
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

int row_blocks(long long rows) { return (int)((rows + kRows - 1) / kRows); }

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

template <typename T>
int head_launch(const void* S, const float* agent_mask, const void* ln_h,
                const void* wh_t, const void* bh, void* out, const Dims& d,
                cudaStream_t s) {
  const int smem = kRows * 2 * pad(d.D) * (int)sizeof(float);
  cudaError_t err = rowops::allow_smem(fusion_head_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)d.B * d.H * d.W;
  fusion_head_kernel<T><<<row_blocks(rows), kThreads, smem, s>>>(
      (const T*)S, agent_mask, (const T*)ln_h, (const T*)wh_t, (const T*)bh,
      (T*)out, d);
  return (int)cudaGetLastError();
}

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

extern "C" int cobevt_fusion_head(const void* S, const float* agent_mask,
                                  const void* ln_h, const void* wh_t,
                                  const void* bh, void* out, const int* dims,
                                  int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = make_dims(dims);
  if (!dims_ok(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? head_launch<__nv_bfloat16>(S, agent_mask, ln_h, wh_t, bh,
                                              out, d, s)
                 : head_launch<float>(S, agent_mask, ln_h, wh_t, bh, out, d,
                                      s);
}
