// K6a: LZ4 block decode of rows too wide for shared memory, one thread
// block of 256 threads per row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/decode_pallas.py:
// _decode_kernel, the packed-word kernel that decode_block_pallas takes
// when out_cap > 96 KiB (decode_batch_pallas over whole blocks of 256 KiB
// to 4 MiB). It returns that kernel's ok and n_out, and its bytes
// [0, n_out) where ok holds, corrupt input included (the rules are in
// lz4_decode_ring.cuh).
//
// What bounds it on this card: the sequence loop is serial and data
// dependent (each token's position follows from the sequence before it),
// so a row's parse is one dependent chain of loads, not bytes (a 64 x
// 4 MiB batch moves ~380 MB, ~0.11 ms of HBM time) nor arithmetic.
// What the design does about it: K1's (lz4_decode_ring.cuh), with the row
// and the output in device memory, since a 4 MiB output does not fit in
// shared memory. Warp 0's lane 0 runs the strict parse (K6a's rules:
// kCountBad, zero reads past C) over the row in place, read through the
// read-only path, one round of reads per sequence and no branch but the
// loop's on the common path. It hands each sequence (ip, n_lit, off, m)
// through the ring of 64 slots of 32 sequences in shared memory (34,064 B,
// full/empty mbarriers) to warps 1-7, which write 224 output bytes per step
// byte-parallel straight into the output row, reading a match's source
// back with plain loads after the step barrier. Nothing is copied out: the
// copies write only the bytes the sequences copy, so a corrupt row whose
// n_out passes out_cap writes nothing past it. One block per row: 64 rows
// occupy 64 of the 132 SMs.
// A read at or past C must return 0, not the next row's bytes. Where the
// row ends in 8 zero bytes that its stream does not reach (the wrappers'
// rows: a stream and 8 or more zeros) no read reaches C and none is
// guarded (lz4t_tail_row); any other row's reads are (lz4t_dev_row), which
// cost the parse ~30 cycles a sequence more on an H100
// (tools/decode_wide_stamps_torch.py). Each reader's body is a function of
// its own: inlined side by side into one kernel the two ran ~18% slower on
// the same card (the same tool).
#include <cuda_runtime.h>

#include "lz4_decode_ring.cuh"

namespace {

constexpr int kThreads = 32 * (1 + LZ4T_RING_WARPS);

// one row through the ring, the row read through Row; out is read back by
// the copy warps (a match's source), so no pointer into it carries
// __restrict__: its loads must stay plain global loads
template <class Row>
__device__ __noinline__ void lz4t_wide_row(const uint8_t* c, int C, int clen,
                                           uint8_t* o, int out_cap,
                                           uint8_t* smem, int32_t* n_out,
                                           bool* ok) {
  lz4t_ring_decode<false, true>(Row{c, C}, clen, 0, out_cap, o, nullptr, 0,
                                smem, [&](int n, int okv) {
                                  *n_out = n;
                                  *ok = okv != 0;
                                });
}

__global__ void __launch_bounds__(kThreads)
    lz4t_decode_wide_kernel(const uint8_t* __restrict__ comp,
                            const int32_t* __restrict__ clens, uint8_t* out,
                            int32_t* __restrict__ n_out,
                            bool* __restrict__ ok, int C, int out_cap) {
  __shared__ __align__(16) uint8_t smem[LZ4T_RING_SMEM];
  __shared__ bool s_tail;
  const int b = blockIdx.x, clen = clens[b];
  const uint8_t* c = comp + (size_t)b * C;
  if (threadIdx.x == 0) s_tail = lz4t_tail_fits(c, C, clen);
  lz4t_ring_init(smem);
  __syncthreads();
  uint8_t* o = out + (size_t)b * out_cap;
  if (s_tail)
    lz4t_wide_row<lz4t_tail_row>(c, C, clen, o, out_cap, smem, n_out + b,
                                 ok + b);
  else
    lz4t_wide_row<lz4t_dev_row>(c, C, clen, o, out_cap, smem, n_out + b,
                                ok + b);
}

}  // namespace

// comp (B, C) u8, clens (B,) i32 -> out (B, out_cap) u8 (bytes past the
// written stream undefined), n_out (B,) i32, ok (B,) bool. Returns a
// cudaError_t.
extern "C" int lz4t_launch(const void* comp, const void* clens, void* out,
                           void* n_out, void* ok, int B, int C, int out_cap,
                           void* stream) {
  lz4t_decode_wide_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)clens, (uint8_t*)out,
      (int32_t*)n_out, (bool*)ok, C, out_cap);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
