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
// every grid half.  None of that carries over:
//
//   * the cooperative-LiDAR state is (5, 96, 176, 256): 84,480 tokens of
//     width 256, FFN width 512, windows of T = 320 tokens.  K4's row tiles
//     (64 rows of f32, widths D + 3D, or 2D + mlp) would take 266 KB, over
//     the 227 KB a block may have, and a window's QKV (320 x 768) does not
//     fit either.  So the row kernels here own 16 rows a block (67 KB at
//     the LiDAR width, three blocks to an SM): the 8 warps each take an
//     eighth of a product's columns (rowops.cuh, Gemm<T, 16>).  The row
//     kernels wait on their weight loads, so blocks in flight count: 16
//     rows run the four LiDAR sublayers in 11.3 ms where 32 rows (one block
//     to an SM) took 16.5 ms (NVIDIA H100 80GB HBM3, 700 W, bf16).  The
//     8-way column split in 8-column tiles makes every width a multiple
//     of 64;
//   * rows are window-major tokens found by index math on the state
//     (swap_state.cuh), for window and grid cells alike, so there is no
//     transposed copy of the state; a sublayer reads one state buffer and
//     writes another, never in place, because the blocks of one window read
//     all of its tokens while other blocks write;
//   * attention is flash.cuh per (64-query tile, head, window) with an
//     online softmax per head: the bias is read in f32 (TB = float) and the
//     masked keys get -1e9 itself, which f32 holds exactly, read from the
//     (B, L, H, W) mask through the window map.  A fully masked window gets
//     the same -1e9 on every key and stays finite and uniform.
//
// One C entry runs the three launches of a sublayer (QKV rows, attention,
// output rows) on the caller's stream; the wrapper counts it once.
//
// Bound on the H100: operations.  A LiDAR sublayer is 88.6 GFLOP of
// projections and 27.7 GFLOP of attention (0.12 ms at the bf16 peak)
// against ~91 MB of state, bias and weights (0.03 ms).  The QKV scratch
// (130 MB in bf16) and the attention output (43 MB) are this design's own
// traffic through device memory; a window-resident kernel would keep them
// on the SM.
#include "flash.cuh"
#include "rowops.cuh"
#include "swap_state.cuh"

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

}  // namespace

// Plain C entry point, loaded with ctypes: one sublayer, S_in -> S_out
// (two different (B, L, H, W, D) buffers).  qkv (rows, 3D) and att (rows, D)
// are the caller's scratch in the compute dtype; bias (T, heads*T) f32 or
// null; mask (B, L, H, W) f32 or null (keys with mask <= 0 get -1e9); dims:
// the 9 ints (B, L, H, W, D, window, heads, mlp, grid).  Widths are
// multiples of 64 (the row product's column split).  Returns the first
// cudaError_t of its three launches (0 on success).
extern "C" int cobevt_fusion_stream_sublayer(
    const void* S_in, void* S_out, void* qkv, void* att, const void* ln_a,
    const void* wqkv_t, const void* wout_t, const void* ln_f,
    const void* w1_t, const void* b1, const void* w2_t, const void* b2,
    const float* bias, const float* mask, float scale, const int* dims,
    int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d = swap_state::make_dims(dims);
  if (!swap_state::dims_ok(d) || d.D % 64 || d.mlp % 64 || S_in == S_out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K6_LAUNCH(T)                                                        \
  sublayer_launch<T>(S_in, S_out, qkv, att, ln_a, wqkv_t, wout_t, ln_f,     \
                     w1_t, b1, w2_t, b2, bias, mask, scale, d, is_bf16 != 0, \
                     s)
  err = is_bf16 ? K6_LAUNCH(__nv_bfloat16) : K6_LAUNCH(float);
#undef K6_LAUNCH
  return (int)err;
}
