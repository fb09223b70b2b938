// K1: packed window attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel cobevt_tpu/ops/window_attention.py:
// fused_window_attention_packed (-> _packed_forward_core -> _packed_kernel /
// _packed_body).  Contract, as there:
//   q (G, Tq, H*D) pre-scaled, k/v (G, Tk, H*D), heads interleaved in the
//   channel axis; optional f32 bias (Tq, H*Tk) shared by all windows
//   (column block h holds head h); optional f32 key mask (G, Tk) added as
//   -1e9 where mask <= 0 (not -inf: a fully masked row stays finite and
//   comes out as uniform weights, as in JAX); optional post-softmax weight
//   (G, Tq, H*Tk) in q's dtype that scales the numerator only.  Output
//   (G, Tq, H*D) in q's dtype.  f32 or bf16, D in {16, 32}, Tq and Tk
//   multiples of 8.
//
// What bounds it on the H100: two (Tq x Tk x D) products per (window, head)
// against q/k/v in and the output out: Tq Tk / (Tq + Tk) operations per
// byte in bf16, 128 to 512 at the CorpBEVT shapes, around the card's ~295.
// So the bytes bind for the 256-key windows (0.063 ms at the largest shape,
// G 320, 1024 x 256, with the arithmetic at 0.043 ms) and the arithmetic for
// the 1024 x 1024 ones; where there is a bias it is the largest byte stream
// (16.8 MB of f32 at the self-attention).  With D 32 every score also costs
// one exp: at 16 a clock an SM the exps take about as long as the two
// products at the tensor cores' rate, so the softmax, not the products,
// sets the pace once the loads are hidden.
// Both kernels are flash style: key tiles streamed through shared memory,
// an online softmax with f32 running max, sum and accumulator, so the
// similarity matrix never leaves registers.  The bias and weight are read
// tile by tile: the 16 MB self-attention bias is never resident.
//
//  * window_attention_wgmma_kernel (bf16): one block per (window, head,
//    64 query rows: ops/window_attention.py:attention_tile_plan), one
//    warpgroup, six blocks an SM.  Its thread 0 streams 64-key stages
//    through a ring in shared memory by TMA with mbarrier completion,
//    refilling a stage once the warpgroup is past it: k and v (64-byte
//    rows, read in place by wgmma: k as the K-major B operand of S = q k^T,
//    v as the MN-major B operand of O += P v), the f32 bias of the block's
//    rows (two 32-key
//    boxes, 128B-swizzled so the accumulator-layout reads hit distinct
//    banks), the bf16 weight and the raw key mask.  Out-of-range rows and
//    keys (ragged Tq and Tk) arrive as zeros from TMA; keys past Tk are then
//    set to -inf.  The S accumulators become the A operand of P v in
//    registers.  Where a gradient will run K5 (no weight), the kernel also
//    keeps the sum of the exp rounded to bf16 at the running maximum and
//    writes it (inverted) with the maximum times log2(e) to K5's statistics
//    scratch, so K5 skips its own statistics sweep.  With a bias, the blocks of one (head, query tile) run
//    side by side over the windows, so the bias tile is read from device
//    memory once and from L2 for the other windows.
//  * window_attention_kernel (f32): scalar f32 FMAs; one thread owns one
//    query row; k/v tiles are read from shared memory as warp-wide
//    broadcasts.
//
// K8, the head-major twin (cobevt_tpu/ops/window_attention.py:
// fused_window_attention -> _forward_core -> _attn_body), runs the same two
// kernels through other strides and tensor maps: q (G, H, Tq, D), k/v
// (G, H, Tk, D), bias (H, Tq, Tk), no weight.  _attn_body sums the exp in
// f32 before it rounds it for the e v product, which is what these kernels
// do, so K8 needs no numeric switch: only the layout differs (entry point
// cobevt_window_attention_hm).  The same bound holds: arithmetic.
//
// Numerics differ from the TPU body of K1 in one documented place: there the
// exp is rounded to bf16 once and that value feeds both the sum and the AV
// product.  The bf16 kernel rounds the probabilities to bf16 for the P v
// product (as the TPU does) but sums them in f32; the f32 kernel keeps
// them f32 throughout.  The bf16 tolerance of the comparisons covers it.

#include "window_attention.cuh"

namespace {

using namespace wattn;

constexpr int kBlockQ = 64;  // query rows per block, one per thread
constexpr int kBlockK = 32;  // keys per shared-memory tile

// f32 path.  grid: (ceil(Tq / kBlockQ), H, G); block: kBlockQ threads.
template <int D>
__global__ void __launch_bounds__(kBlockQ)
    window_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            const float* __restrict__ weight,
                            float* __restrict__ out, int Tq, int Tk, int H,
                            Layout L) {
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];
  __shared__ float bs[kBlockQ][kBlockK + 1];  // +1: conflict-free row reads
  __shared__ float ws[kBlockQ][kBlockK + 1];
  __shared__ float ms[kBlockK];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const size_t HTk = (size_t)H * Tk;
  const int row = q0 + tid;
  const bool live = row < Tq;

  float qr[D];
  float acc[D];
  {
    const float* qp = q + g * L.q_win + (size_t)(live ? row : 0) * L.ldq +
                      h * L.q_head;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = live ? qp[d] : 0.f;
      acc[d] = 0.f;
    }
  }
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    const int nk = min(kBlockK, Tk - k0);
    for (int i = tid; i < kBlockK * D; i += kBlockQ) {
      const int j = i / D;
      const int d = i - j * D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const size_t off =
            g * L.kv_win + (size_t)(k0 + j) * L.ldkv + h * L.kv_head + d;
        kv = k[off];
        vv = v[off];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (bias != nullptr) {
      for (int i = tid; i < kBlockQ * kBlockK; i += kBlockQ) {
        const int r = i / kBlockK;
        const int c = i - r * kBlockK;
        float b = 0.f;
        if (q0 + r < Tq && c < nk)
          b = bias[h * L.b_head + (q0 + r) * L.ldb + k0 + c];
        bs[r][c] = b;
      }
    }
    if (weight != nullptr) {
      for (int i = tid; i < kBlockQ * kBlockK; i += kBlockQ) {
        const int r = i / kBlockK;
        const int c = i - r * kBlockK;
        float w = 0.f;
        if (q0 + r < Tq && c < nk)
          w = weight[((size_t)g * Tq + q0 + r) * HTk + (size_t)h * Tk + k0 +
                     c];
        ws[r][c] = w;
      }
    }
    if (mask != nullptr && tid < kBlockK) {
      float add = 0.f;
      if (tid < nk && !(mask[(size_t)g * Tk + k0 + tid] > 0.f)) add = kMaskAdd;
      ms[tid] = add;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      // same order as the reference: (q.k + bias) + mask
      if (bias != nullptr) dot += bs[tid][j];
      if (mask != nullptr) dot += ms[j];
      s[j] = (j < nk) ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // every tile holds at least one key, so m_new is finite
    const float m_new = fmaxf(m_run, tile_max);
    const float alpha = __expf(m_run - m_new);
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float p = __expf(s[j] - m_new);
      l_run += p;  // the denominator stays unweighted
      if (weight != nullptr) p *= ws[tid][j];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m_run = m_new;
    __syncthreads();
  }

  if (live) {
    const float inv = 1.f / l_run;
    float* op = out + g * L.q_win + (size_t)row * L.ldq + h * L.q_head;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const void* bias,
            const void* mask, const void* weight, void* out, int G, int Tq,
            int Tk, int H, const Layout& L, cudaStream_t stream) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, H, G);
  window_attention_kernel<D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(weight),
      static_cast<float*>(out), Tq, Tk, H, L);
}


// Picks the kernel for (D, dtype).  Returns the launch's cudaError_t.
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* bias, const void* mask, const void* weight,
                     void* out, float* stats, int G, int Tq, int Tk, int H,
                     int D, int is_bf16, int head_major, const Layout& L,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (G <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || G > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (D != 16 && D != 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_wgmma(q, k, v, bias, mask, weight, out, stats, G, Tq, Tk,
                          H, D, head_major, L, device, s);
  if (stats != nullptr) return cudaErrorInvalidValue;   // bf16 only
  if (D == 32)
    launch<32>(q, k, v, bias, mask, weight, out, G, Tq, Tk, H, L, s);
  else
    launch<16>(q, k, v, bias, mask, weight, out, G, Tq, Tk, H, L, s);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  bias, mask and weight may be
// null; every bf16 pointer is 16-byte aligned.  Each returns the
// cudaError_t of the set-up and launch (0 on success).

// K1: packed layout, q (G, Tq, H*D), bias (Tq, H*Tk).  stats: null, or (bf16
// without weight, for K5) an f32 (3, G, H, Tq) scratch that receives the row
// maximum times log2(e) and the inverse of the sum of the exp rounded to
// bf16 in its first two planes.
extern "C" int cobevt_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* mask, const void* weight,
                                       void* out, void* stats, int G, int Tq,
                                       int Tk, int H, int D, int is_bf16,
                                       int device, void* stream) {
  return (int)dispatch(q, k, v, bias, mask, weight, out,
                       static_cast<float*>(stats), G, Tq, Tk, H, D, is_bf16,
                       0, packed_layout(Tq, Tk, H, D), device, stream);
}

// K8: head-major layout, q (G, H, Tq, D), bias (H, Tq, Tk), no weight.
extern "C" int cobevt_window_attention_hm(const void* q, const void* k,
                                          const void* v, const void* bias,
                                          const void* mask, void* out, int G,
                                          int Tq, int Tk, int H, int D,
                                          int is_bf16, int device,
                                          void* stream) {
  return (int)dispatch(q, k, v, bias, mask, nullptr, out, nullptr, G, Tq, Tk,
                       H, D, is_bf16, 1, head_major_layout(Tq, Tk, H, D),
                       device, stream);
}
