// K1: LZ4 block decode, one thread block per row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/decode_pallas.py:
// _decode_kernel_bw (reached through decode_block_pallas and
// decode_batch_pallas). The row body is lz4t_decode_row (lz4_decode.cuh),
// which returns that kernel's ok, n_out and bytes [0, n_out), corrupt
// input included.
//
// What bounds it on this card: the sequence loop is serial and data
// dependent (token, lengths, offset, then copies that may read their own
// output), so it is bound by the latency of one thread's dependent
// shared-memory accesses, not by bytes (~12 MB per 128-row batch, ~3.5 us
// of HBM time) nor by arithmetic.
// What the design does about it: the block's 256 threads stage the
// compressed row into shared memory, thread 0 decodes into an output row
// that also lives in shared memory (match copies read it back), and then
// all threads write the n_out decoded bytes to global memory together.
// One block per row, ~128 KiB of shared memory at 64 KiB rows. Wider
// copies per sequence and several rows per SM are later work.
#include <cuda_runtime.h>

#include "lz4_decode.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lz4t_decode_kernel(const uint8_t* __restrict__ comp,
                       const int32_t* __restrict__ clens,
                       uint8_t* __restrict__ out, int32_t* __restrict__ n_out,
                       bool* __restrict__ ok, int C, int out_cap) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_n;
  uint32_t* cw = smem;
  uint32_t* ow = smem + C / 4;
  const int b = blockIdx.x;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(comp + (size_t)b * C);
  for (int i = threadIdx.x; i < C / 4; i += blockDim.x) cw[i] = src[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int n, okv;
    lz4t_decode_row(reinterpret_cast<const uint8_t*>(cw), C, clens[b],
                    reinterpret_cast<uint8_t*>(ow), out_cap, &n, &okv);
    n_out[b] = n;
    ok[b] = okv != 0;
    s_n = n;
  }
  __syncthreads();
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)b * out_cap);
  const int words = (s_n + 3) / 4;  // s_n <= out_cap, out_cap % 4 == 0
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = ow[i];
}

}  // namespace

// comp (B, C) u8 with C % 4 == 0, clens (B,) i32 -> out (B, out_cap) u8
// (bytes past n_out undefined), n_out (B,) i32, ok (B,) bool.
// Returns a cudaError_t (ops/_build.py holds each library's C
// signature).
extern "C" int lz4t_launch(const void* comp, const void* clens, void* out,
                           void* n_out, void* ok, int B, int C, int out_cap,
                           void* stream) {
  const int smem = C + out_cap;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_decode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)clens, (uint8_t*)out,
      (int32_t*)n_out, (bool*)ok, C, out_cap);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
