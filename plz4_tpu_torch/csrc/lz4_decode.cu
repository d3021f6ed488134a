// K1: LZ4 block decode, one thread block per row, one launch per batch.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/decode_pallas.py:
// _decode_kernel_bw (reached through decode_block_pallas and
// decode_batch_pallas): the same ok, n_out and bytes [0, n_out) as its
// byte-serial careful tier, corrupt input included (the rules are in
// lz4_decode_ring.cuh).
//
// What bounds it on this card: the sequence loop is serial and data
// dependent (each token's position follows from the sequence before it),
// so a row's parse is one dependent chain of shared-memory reads, not
// bytes (~12 MB per 128-row batch, ~3.5 us of HBM time) nor arithmetic.
// What the design does about it: the chain does nothing but parse.
// lz4t_ring_row (lz4_decode_ring.cuh) stages the compressed row, padded
// with its last byte, into shared memory; warp 0's lane 0 parses, one
// round of shared-memory reads per sequence (the five bytes where its
// literals end: offset, match length, next token) and, on the common
// path, no branch but the loop's, and hands each sequence (ip, n_lit, off, m) through a ring
// of 64 slots of 32 sequences, guarded by full/empty mbarriers, to warps
// 1-7, which write 224 output bytes per step byte-parallel into the output
// row (also in shared memory: matches read it back) while the parse goes
// on. Then all 256 threads write the n_out bytes out. Shared memory: the
// ring (34,064 B), C + 16 and out_cap: 165,168 B at 64 KiB rows, so one
// row per SM.
#include <cuda_runtime.h>

#include "lz4_decode_ring.cuh"

namespace {

constexpr int kThreads = 32 * (1 + LZ4T_RING_WARPS);

__global__ void __launch_bounds__(kThreads)
    lz4t_decode_kernel(const uint8_t* __restrict__ comp,
                       const int32_t* __restrict__ clens,
                       uint8_t* __restrict__ out, int32_t* __restrict__ n_out,
                       bool* __restrict__ ok, int C, int out_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;
  lz4t_ring_row<true>(comp + (size_t)b * C, C, clens[b], nullptr, 0, 0,
                      out + (size_t)b * out_cap, n_out + b, ok + b, out_cap,
                      smem);
}

}  // namespace

// comp (B, C) u8 with C % 4 == 0, clens (B,) i32 -> out (B, out_cap) u8
// (bytes past n_out undefined), n_out (B,) i32, ok (B,) bool.
// Returns a cudaError_t (ops/_build.py holds each library's C
// signature).
extern "C" int lz4t_launch(const void* comp, const void* clens, void* out,
                           void* n_out, void* ok, int B, int C, int out_cap,
                           void* stream) {
  const int smem = LZ4T_RING_SMEM + C + LZ4T_RING_PAD + out_cap;
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
