// K6a: LZ4 block decode of rows too wide for shared memory, one thread per
// row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/decode_pallas.py:
// _decode_kernel, the packed-word kernel that decode_block_pallas takes
// when out_cap > 96 KiB (decode_batch_pallas over whole blocks of 256 KiB
// to 4 MiB). The row body is lz4t_decode_wide_row (lz4_decode_wide.cuh),
// which returns that kernel's ok and n_out, and its bytes [0, n_out) where
// ok holds, corrupt input included.
//
// What bounds it on this card: the sequence loop is serial and data
// dependent (token, lengths, offset, then copies that read their own
// output back), so it is bound by the latency of one thread's dependent
// loads. The compressed row and the output (up to 4 MiB each) do not fit
// shared memory: token reads hit L1 as the stream advances, match sources
// come back from L1 or L2. A 64 x 4 MiB batch moves ~380 MB, ~0.11 ms of
// HBM time.
// What the design does about it: copies move 16 bytes per step with all
// loads issued before the stores (a short offset doubles its source
// distance as the match grows), so a copy waits for one load latency per
// 16 bytes rather than per byte. Nothing is staged: there is no output
// bound to copy out, and a row's decode writes its bytes in place. One
// thread per block, one block per row (64 of the 132 SMs at 64 rows).
#include <cuda_runtime.h>

#include "lz4_decode_wide.cuh"

namespace {

__global__ void __launch_bounds__(32)
    lz4t_decode_wide_kernel(const uint8_t* __restrict__ comp,
                            const int32_t* __restrict__ clens, uint8_t* out,
                            int32_t* __restrict__ n_out,
                            bool* __restrict__ ok, int C, int out_cap) {
  if (threadIdx.x) return;
  const int b = blockIdx.x;
  int n, okv;
  lz4t_decode_wide_row(comp + (size_t)b * C, C, clens[b],
                       out + (size_t)b * out_cap, out_cap, &n, &okv);
  n_out[b] = n;
  ok[b] = okv != 0;
}

}  // namespace

// comp (B, C) u8, clens (B,) i32 -> out (B, out_cap) u8 (bytes past the
// written stream undefined), n_out (B,) i32, ok (B,) bool. Returns a
// cudaError_t.
extern "C" int lz4t_launch(const void* comp, const void* clens, void* out,
                           void* n_out, void* ok, int B, int C, int out_cap,
                           void* stream) {
  lz4t_decode_wide_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)clens, (uint8_t*)out,
      (int32_t*)n_out, (bool*)ok, C, out_cap);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
