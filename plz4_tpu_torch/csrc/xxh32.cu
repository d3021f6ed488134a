// K7: xxHash-32 of each row of a batch, one thread block per row.
//
// Replaces plz4_tpu/ops/xxh32_jax.py:xxh32_batch, which is XLA and not
// Pallas: the device side of block checksums (parallel/batch.py hashes the
// compressed candidates and the raw rows after an encode, and the staged
// compressed rows before a decode). The row body is xxh32.cuh; unlike the
// JAX version it reads only [0, lens[r]), so rows of any width and
// alignment need no padding copy.
//
// What bounds it on this card: the stripe fold is a serial chain per
// accumulator (a multiply-add, a rotate and a multiply per 16-byte
// stripe), and the fold does not associate, so a row costs len / 16
// dependent steps of the four chains side by side, far more than its
// bytes take to read (128 x 64 KiB = 8.4 MB, ~2.5 us of HBM time): the
// chain bound is stripes x the cycles of one step.
// What the design does about it: one block per row, so a batch of 128 rows
// runs on 128 SMs; one thread folds, holding all four accumulators (four
// independent chains, one 16-byte shared-memory load per stripe), while
// warps 1-3 stage the row's next chunk of LZ4T_XXH_CHUNK bytes into the
// other half of a two-chunk ring in shared memory with 16-byte loads
// (lz4t_xxh32_stage: unaligned row starts by funnel shifts, the row's
// first and last 16-byte units byte by byte). One barrier per chunk.
#include <cuda_runtime.h>

#include "xxh32.cuh"

namespace {

constexpr int kThreads = 128;  // warp 0: the fold; warps 1-3: staging
constexpr int kChunkWords = LZ4T_XXH_CHUNK / 4;

__global__ void __launch_bounds__(kThreads)
    lz4t_xxh32_kernel(const uint8_t* __restrict__ data,
                      const int32_t* __restrict__ lens,
                      int64_t* __restrict__ out, int W, uint32_t seed) {
  __shared__ __align__(16) uint32_t ring[2][kChunkWords];
  const int r = blockIdx.x, t = threadIdx.x;
  const uint8_t* p = data + (size_t)r * W;
  const int len = lens[r];
  const int nc = (len + LZ4T_XXH_CHUNK - 1) / LZ4T_XXH_CHUNK;
  if (nc) lz4t_xxh32_stage(p, len, 0, min(len, LZ4T_XXH_CHUNK), ring[0], t,
                           kThreads);
  __syncthreads();
  uint32_t acc[4];
  lz4t_xxh32_init(acc, seed);
  for (int c = 0; c < nc; c++) {
    const int b0 = c * LZ4T_XXH_CHUNK;
    if (t >= 32) {
      const int b1 = b0 + LZ4T_XXH_CHUNK;
      if (b1 < len)
        lz4t_xxh32_stage(p, len, b1, min(len, b1 + LZ4T_XXH_CHUNK),
                         ring[(c + 1) & 1], t - 32, kThreads - 32);
    } else if (t == 0) {
      lz4t_xxh32_stripes(acc, ring[c & 1],
                         (min(len, b0 + LZ4T_XXH_CHUNK) - b0) >> 4);
    }
    __syncthreads();
  }
  if (t == 0) {
    // the tail lies in the last chunk: its bytes from len / 16 * 16
    const int b0 = nc ? (nc - 1) * LZ4T_XXH_CHUNK : 0;
    const uint8_t* last =
        reinterpret_cast<const uint8_t*>(ring[nc ? (nc - 1) & 1 : 0]);
    out[r] = lz4t_xxh32_finish(acc, last + (len / 16 * 16 - b0), len, seed);
  }
}

}  // namespace

// data (B, W) u8, lens (B,) i32 with 0 <= lens[r] <= W -> out (B,) i64
// holding the u32 hashes. Returns a cudaError_t.
extern "C" int lz4t_launch(const void* data, const void* lens, void* out,
                           int B, int W, int seed, void* stream) {
  lz4t_xxh32_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (int64_t*)out, W,
      (uint32_t)seed);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
