// K2a: greedy LZ4 block encode, one thread block per row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel_bw in greedy mode without a window (reached through
// _encode_call_bw, encode_block_pallas and encode_batch_pallas). The row
// body is lz4t_encode_row (lz4_encode.cuh, base = first = 0, with the
// value table), byte-exact with that kernel.
//
// What bounds it on this card: the parse is one serial, data-dependent
// chain (hash, table probe, compare, extend) per row, so it is bound by the
// latency of one thread's dependent shared-memory loads, not by bytes
// (a batch moves ~12 MB, ~3.5 us of HBM time) nor by arithmetic.
// What the design does about it: every load of the serial thread hits
// shared memory. The block's 256 threads zero the two 2^14 x 4 B tables
// (128 KiB) and stage the row (N + 8 bytes) into shared memory together,
// then thread 0 runs the parse and writes the stream to global memory
// (stores do not stall it). Rows run in parallel, one block per SM (196 KiB
// of shared memory each at N = 64 KiB). Several rows per SM, u16 tables
// and warp-cooperative copies are later work.
#include <cuda_runtime.h>

#include "lz4_encode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 1 << LZ4T_HASH_LOG;

__global__ void __launch_bounds__(kThreads)
    lz4t_encode_kernel(const uint8_t* __restrict__ data,
                       const int32_t* __restrict__ lens,
                       uint8_t* __restrict__ out,
                       int32_t* __restrict__ totals, bool* __restrict__ ok,
                       int N, int CAP) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tab = smem;
  uint32_t* vtab = smem + kTab;
  uint32_t* roww = smem + 2 * kTab;
  const int b = blockIdx.x;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(data + (size_t)b * N);
  for (int i = threadIdx.x; i < 2 * kTab; i += blockDim.x) smem[i] = 0;
  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) roww[i] = src[i];
  if (threadIdx.x < 2) roww[N / 4 + threadIdx.x] = 0;  // 8 zero tail bytes
  __syncthreads();
  if (threadIdx.x == 0) {
    int total, okv;
    lz4t_encode_row<true>(reinterpret_cast<const uint8_t*>(roww), N + 8, 0, 0,
                          lens[b], out + (size_t)b * CAP, CAP, tab, vtab,
                          &total, &okv);
    totals[b] = total;
    ok[b] = okv != 0;
  }
}

}  // namespace

// data (B, N) u8 with N % 4 == 0, lens (B,) i32 -> out (B, CAP) u8,
// totals (B,) i32, ok (B,) bool. Returns a cudaError_t (ops/_build.py
// holds each library's C signature).
extern "C" int lz4t_launch(const void* data, const void* lens, void* out,
                           void* totals, void* ok, int B, int N, int CAP,
                           void* stream) {
  const int smem = 2 * kTab * 4 + N + 8;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (uint8_t*)out,
      (int32_t*)totals, (bool*)ok, N, CAP);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
