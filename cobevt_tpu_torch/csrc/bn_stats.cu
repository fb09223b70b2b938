// K9 and K10, the BatchNorm-statistics reductions, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of cobevt_tpu/tools/micro_bn_stats.py:
//   * K9  pallas_fwd (:55; its pallas_call :58, body _fwd_kernel :41):
//         (sum_r xb, sum_r xb^2), xb = f32(max(x, s));
//   * K10 pallas_bwd (:97; its pallas_call :99, body _bwd_kernel :82):
//         (sum_r dyb, sum_r dyb * f32(x)), dyb = f32(max(dy, s));
// over x (and dy) of shape (R, C), f32 or bf16, contiguous, with s in the
// activations' dtype; two f32 sums of shape (C,).  `max` propagates NaN, as
// jnp.maximum and torch.maximum do (fmaxf would hide a NaN behind s).
//
// What bounds it on the H100: bytes.  Each input is read once, R * C * elt
// bytes for K9 and 2 * R * C * elt for K10 (372 MB and 744 MB at the tool's
// largest shape), against a few f32 operations an element, far below the 67
// TFLOP/s f32 line: the kernel has to keep device memory busy, about 25 KB in
// flight an SM at 3.35 TB/s.
//
// What the design does about it.  The TPU bodies carry the sums in a
// resident output block across a sequential grid; here a persistent grid
// (one block an SM) splits the rows into tiles of whole rows, each a
// contiguous run of tile_rows * C * elt bytes, and gives each block a
// contiguous, balanced run of tiles.  Warp 0's first thread copies each tile
// (for K10 the dy tile and the x tile) with one 1-D bulk copy
// (cp.async.bulk, no tensor map: C = 336 would exceed a 2-D box's 256
// columns) into a ring of `stages` shared-memory stages of up to 32 KB, so
// three stages are in flight while one is summed.  Each consumer thread owns
// one 16-byte column vector of a row (8 bf16 or 4 f32 channels) and a fixed
// set of row lanes: the consumers number a multiple of the C * elt / 16
// vectors of a row, so none idles and no column is masked, and consecutive
// threads read consecutive 16 bytes of shared memory (no bank conflicts).
// The sums stay in registers (16 f32 for bf16) until the block folds its
// lanes in a fixed order through shared memory and writes one partial row
// of 2C f32; partials.cuh then adds the blocks' rows in a fixed order.  No
// float atomics: two calls give the same bits.
//
// One C entry a wrapper call (ops/bn_stats.py), two launches: the
// reduction and the ordered addition, both programmatic
// (hopper_host::launch_pdl), so that each one's launch overlaps the kernel
// before it; each waits (pdl_wait) before it touches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"
#include "partials.cuh"

namespace {

constexpr int kProducer = 32;        // warp 0: its first thread copies tiles
constexpr int kMaxConsumers = 512;   // one 16-byte vector a thread
constexpr int kMaxStages = 8;
constexpr uint32_t kMaxTx = (1u << 20) - 1;   // an mbarrier's byte count
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the 16 bytes of a vector as f32 (exact for bf16: its bits are the high
// half of an f32's)
template <typename T>
__device__ __forceinline__ void to_f32(const uint4& v, float* f);

template <>
__device__ __forceinline__ void to_f32<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void to_f32<__nv_bfloat16>(const uint4& v,
                                                      float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared memory: the ring (stages x inputs x tile_rows rows), which the
// fold of the lanes' sums (lanes x 2C f32) reuses at the end, then the full
// and empty barriers of each stage.
__host__ __device__ inline long long ring_bytes(int inputs, int C, int elt,
                                                int lanes, int tile_rows,
                                                int stages) {
  const long long ring =
      (long long)stages * inputs * tile_rows * (long long)C * elt;
  const long long fold = (long long)lanes * 2 * C * 4;
  return ring > fold ? ring : fold;
}

// One block: the tiles [t0, t1) of tile_rows rows each (the last tile of
// the tensor may be shorter).  `a` is x (K9) or dy (K10), `b` x (K10).
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kProducer + kMaxConsumers, 1)
    bn_stats_kernel(const unsigned char* __restrict__ a,
                    const unsigned char* __restrict__ b,
                    const T* __restrict__ s_ptr, float s_val,
                    float* __restrict__ part, long long R, int C,
                    int tile_rows, int stages) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kInputs = kBwd ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int V = C / E;
  const int nc = blockDim.x - kProducer;
  const int lanes = nc / V;
  const long long row_bytes = (long long)C * sizeof(T);
  const uint32_t tile_in = (uint32_t)(tile_rows * row_bytes);
  const uint32_t stage_bytes = kInputs * tile_in;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + ring_bytes(kInputs, C, sizeof(T), lanes, tile_rows, stages));
  uint64_t* empty = full + stages;
  const long long tiles = (R + tile_rows - 1) / tile_rows;
  const long long t0 = tiles * blockIdx.x / gridDim.x;
  const int n = (int)(tiles * (blockIdx.x + 1) / gridDim.x - t0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], (nc + 31) / 32);   // a consumer warp each
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // a programmatic launch: the kernel before this one on the stream (the
  // last call's ordered addition, or what wrote the inputs) has completed
  // and its writes are visible; the ordered addition may take its place
  hopper::pdl_wait();
  hopper::pdl_launch_dependents();

  float sum[E], sq[E];
#pragma unroll
  for (int e = 0; e < E; ++e) sum[e] = sq[e] = 0.f;
  const int c = threadIdx.x - kProducer;
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) {
      const int st = i % stages;
      hopper::mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
      const long long row0 = (t0 + i) * tile_rows;
      const long long rows = R - row0 < tile_rows ? R - row0 : tile_rows;
      const uint32_t bytes = (uint32_t)(rows * row_bytes);
      unsigned char* dst = smem + (size_t)st * stage_bytes;
      hopper::mbar_arrive_expect_tx(&full[st], kInputs * bytes);
      hopper::bulk_load(dst, a + row0 * row_bytes, bytes, &full[st]);
      if (kBwd)
        hopper::bulk_load(dst + tile_in, b + row0 * row_bytes, bytes,
                          &full[st]);
    }
  } else if (c >= 0) {
    const float s = s_ptr != nullptr ? as_f32(*s_ptr) : s_val;
    // the lanes of this thread's warp that exist (nc need not be a
    // multiple of 32)
    const int warp0 = c & ~31;
    const unsigned mask =
        nc - warp0 >= 32 ? 0xffffffffu : (1u << (nc - warp0)) - 1u;
    for (int i = 0; i < n; ++i) {
      const int st = i % stages;
      const long long row0 = (t0 + i) * tile_rows;
      const int rows =
          (int)(R - row0 < tile_rows ? R - row0 : (long long)tile_rows);
      const int nv = rows * V;
      const uint4* va =
          reinterpret_cast<const uint4*>(smem + (size_t)st * stage_bytes);
      const uint4* vb = va + tile_in / 16;
      hopper::mbar_wait(&full[st], (i / stages) & 1);
#pragma unroll 4
      for (int v = c; v < nv; v += nc) {
        float f[E];
        to_f32<T>(va[v], f);
        if (kBwd) {
          float g[E];
          to_f32<T>(vb[v], g);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float d = max_nan(f[e], s);
            sum[e] += d;
            sq[e] = fmaf(d, g[e], sq[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float d = max_nan(f[e], s);
            sum[e] += d;
            sq[e] = fmaf(d, d, sq[e]);
          }
        }
      }
      __syncwarp(mask);
      if ((c & 31) == 0) hopper::mbar_arrive(&empty[st]);
    }
  }
  // every copy was waited on and every consumer is past the ring: the fold
  // takes its place, (lanes, 2C) f32, lane l at row l
  __syncthreads();
  float* fold = reinterpret_cast<float*>(smem);
  if (c >= 0) {
    float* row = fold + (size_t)(c / V) * 2 * C + (c % V) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      row[e] = sum[e];
      row[C + e] = sq[e];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * C; o += blockDim.x) {
    float acc = 0.f;
    for (int l = 0; l < lanes; ++l) acc += fold[(size_t)l * 2 * C + o];
    part[(size_t)blockIdx.x * 2 * C + o] = acc;
  }
}

template <typename T, bool kBwd>
cudaError_t launch(const void* a, const void* b, const void* s_ptr,
                   float s_val, float* out, float* part, long long R, int C,
                   int blocks, int consumers, int tile_rows, int stages,
                   int smem, int device, cudaStream_t stream) {
  auto kernel = bn_stats_kernel<T, kBwd>;
  // the shared-memory limit is set once a device for each instantiation
  static int limit_set[64] = {};
  if (device < 0 || device >= 64 || limit_set[device] < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) limit_set[device] = smem;
  }
  const cudaError_t err = hopper_host::launch_pdl(
      true, kernel, dim3(blocks), dim3(kProducer + consumers), smem, stream,
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(b), static_cast<const T*>(s_ptr),
      s_val, part, R, C, tile_rows, stages);
  if (err != cudaSuccess) return err;
  return partials::add(part, blocks, 2LL * C, out, stream, true);
}

}  // namespace

// K9 (b == nullptr) or K10 (a = dy, b = x) of (R, C) tensors, f32 or bf16:
// out (2, C) f32 receives the two sums; part (blocks, 2C) f32 is the
// caller's scratch for the blocks' partial rows.  s_ptr: the threshold as a
// one-element device tensor of the activations' dtype, or nullptr to take
// s_val (already rounded to that dtype).  The plan (blocks, consumers,
// tile_rows, stages, smem) is ops/bn_stats.py:cuda_plan's; an entry that
// does not match its layout is refused with cudaErrorInvalidValue.
extern "C" int cobevt_bn_stats(const void* a, const void* b,
                               const void* s_ptr, float s_val, float* out,
                               float* part, long long R, int C, int is_bf16,
                               int blocks, int consumers, int tile_rows,
                               int stages, int smem, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int elt = is_bf16 ? 2 : 4;
  const int inputs = b != nullptr ? 2 : 1;
  const long long row_bytes = (long long)C * elt;
  if (R < 1 || C < 1 || row_bytes % 16 || tile_rows < 1 || stages < 2 ||
      stages > kMaxStages || consumers < 1 || consumers > kMaxConsumers)
    return (int)cudaErrorInvalidValue;
  const int V = (int)(row_bytes / 16);
  const long long tiles = (R + tile_rows - 1) / tile_rows;
  if (consumers % V || blocks < 1 || blocks > tiles ||
      (long long)inputs * tile_rows * row_bytes > kMaxTx ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  const long long want =
      ring_bytes(inputs, C, elt, consumers / V, tile_rows, stages) +
      16LL * stages;
  if (smem != want || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    err = inputs == 2
              ? launch<__nv_bfloat16, true>(a, b, s_ptr, s_val, out, part, R,
                                            C, blocks, consumers, tile_rows,
                                            stages, smem, device, s)
              : launch<__nv_bfloat16, false>(a, b, s_ptr, s_val, out, part,
                                             R, C, blocks, consumers,
                                             tile_rows, stages, smem, device,
                                             s);
  else
    err = inputs == 2
              ? launch<float, true>(a, b, s_ptr, s_val, out, part, R, C,
                                    blocks, consumers, tile_rows, stages,
                                    smem, device, s)
              : launch<float, false>(a, b, s_ptr, s_val, out, part, R, C,
                                     blocks, consumers, tile_rows, stages,
                                     smem, device, s);
  return (int)err;
}
