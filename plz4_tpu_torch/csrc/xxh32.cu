// K7: xxHash-32 of each row of a batch, four threads per row.
//
// Replaces plz4_tpu/ops/xxh32_jax.py:xxh32_batch, which is XLA and not
// Pallas: the device side of block checksums (parallel/batch.py hashes the
// compressed candidates and the raw rows after an encode, and the staged
// compressed rows before a decode). The row body is xxh32.cuh; unlike the
// JAX version it reads only [0, lens[r]), so rows of any width need no
// padding copy.
//
// What bounds it on this card: each lane's stripe fold is a serial chain
// (multiply, rotate, multiply per 16-byte stripe), so a row costs about
// len / 16 dependent steps, far more than the batch's bytes take to read
// (128 x 64 KiB = 8.4 MB, ~2.5 us of HBM time).
// What the design does about it: the four lanes of a row run on four
// neighbouring threads (their words are neighbouring, so the loads
// coalesce) and combine with warp shuffles; rows run in parallel, 32 per
// block of 128 threads. Splitting a row's stripes further is not possible:
// the fold does not associate.
#include <cuda_runtime.h>

#include "xxh32.cuh"

namespace {

constexpr int kThreads = 128;  // 32 rows of 4 lanes

__global__ void __launch_bounds__(kThreads)
    lz4t_xxh32_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      int64_t* __restrict__ out, int B, int W, uint32_t seed) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int r = t >> 2, lane = t & 3;
  const bool live = r < B;
  const uint8_t* p = data + (size_t)(live ? r : 0) * W;
  const int len = live ? lens[r] : 0;
  const uint32_t acc = lz4t_xxh32_lane(p, len, seed, lane);
  uint32_t a[4];
#pragma unroll
  for (int k = 0; k < 4; k++) a[k] = __shfl_sync(0xffffffffu, acc, k, 4);
  if (live && lane == 0) out[r] = lz4t_xxh32_finish(a, p, len, seed);
}

}  // namespace

// data (B, W) u8, lens (B,) i32 with 0 <= lens[r] <= W -> out (B,) i64
// holding the u32 hashes. Returns a cudaError_t.
extern "C" int lz4t_launch(const void* data, const void* lens, void* out,
                           int B, int W, int seed, void* stream) {
  const int blocks = (4 * B + kThreads - 1) / kThreads;
  lz4t_xxh32_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int64_t*)out, B, W,
      (uint32_t)seed);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
