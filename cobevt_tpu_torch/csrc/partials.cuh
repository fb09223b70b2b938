// The fixed-order addition of per-block partial sums, shared by K5
// (window_attention_bwd.cu: dbias over chunks of windows), K12
// (ffd_fused.cu: the weight and vector gradients over blocks) and K9/K10
// (bn_stats.cu: the per-channel sums over blocks of rows).  Blocks of a
// grid run in no order, so a kernel that sums across blocks writes one
// partial per block (or per chunk a block owns) and this launch adds them,
// partial 0 first: two runs give the same bits, which f32 atomics from many
// blocks into one address do not.
#pragma once

#include <cuda_runtime.h>

#include "hopper.cuh"

// Internal linkage: each library that includes this header has its own copy.
namespace {
namespace partials {

// out[i] = sum over p of part[p][i] in a fixed order: the P rows are cut
// into G = blockDim.y interleaved groups, group y sums rows y, y + G, ...
// in order, and the G group sums are added in group order.  A block covers
// 32 float4 columns (coalesced rows of 512 bytes); G = min(P, 32) keeps a
// tall stack of partials (K12's per-warpgroup rows) from serializing on one
// thread.  The partials are read once and dead after: their L2 lines are
// read with an evict_first policy, so they do not crowd the next kernel's
// lines out of L2.
// n % 4 == 0 and 16-byte aligned bases.  kPdl: launched programmatically
// (add with pdl, K9/K10 only), its blocks may be resident before the kernel
// that writes the partials has finished: they wait for it, then let the
// next such launch start.
template <bool kPdl>
__global__ void add_partials_kernel(const float4* __restrict__ part, int P,
                                    long long n4, float4* __restrict__ out) {
  extern __shared__ float4 group_sum[];   // (G, 32)
  if constexpr (kPdl) {
    hopper::pdl_wait();
    hopper::pdl_launch_dependents();
  }
  const int G = blockDim.y;
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) {
    const uint64_t policy = hopper::l2_policy_evict_first();
#pragma unroll 4
    for (int p = threadIdx.y; p < P; p += G) {
      const float4 v = hopper::ld_v4_hint(part + (size_t)p * n4 + i, policy);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  group_sum[threadIdx.y * 32 + threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= n4) return;
  for (int y = 1; y < G; ++y) {
    const float4 v = group_sum[y * 32 + threadIdx.x];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

// part (P, n) f32 -> out (n); n a multiple of 4.  pdl: a programmatic
// launch (hopper_host::launch_pdl) after the kernel that writes part.
inline cudaError_t add(const float* part, int P, long long n, float* out,
                       cudaStream_t s, bool pdl = false) {
  if (P < 1 || n % 4) return cudaErrorInvalidValue;
  const long long n4 = n / 4;
  if (n4 == 0) return cudaSuccess;
  const int G = P < 32 ? P : 32;
  const dim3 grid((unsigned)((n4 + 31) / 32)), block(32, G);
  const int smem = G * 32 * sizeof(float4);
  const float4* part4 = reinterpret_cast<const float4*>(part);
  float4* out4 = reinterpret_cast<float4*>(out);
  if (pdl)
    return hopper_host::launch_pdl(true, add_partials_kernel<true>, grid,
                                   block, smem, s, part4, P, n4, out4);
  add_partials_kernel<false><<<grid, block, smem, s>>>(part4, P, n4, out4);
  return cudaGetLastError();
}

}  // namespace partials
}  // namespace
