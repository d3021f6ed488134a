// K4: deep hash-chain LZ4 block encode with lazy matching (device levels
// 9-12, walk budgets 2/8/16/32), one thread block per row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel_deep (reached through _encode_call_deep,
// encode_block_pallas_deep, encode_block_pallas_deep_dict and their batch
// wrappers), both its i32-chain and its u16-delta-chain variant: plain
// rows, linked and dictionary blocks and the 64 KiB chunks of large blocks.
// The row body is lz4t_encode_deep_row (lz4_encode_deep.cuh), byte-exact
// with that kernel; why the chain can be built before the parse, why one
// u16-delta chain serves both variants, why a ring of 65,536 slots holds
// every link a walk reads, why a table of walks computed in parallel gives
// the serial walks' results, and why the lanes' steps give the serial
// parse's result is said there.
//
// Rows come in groups of K as in K2b: row r takes row r - 1 as its window
// when r % K > 0 (read in place), win[r / K] when r % K == 0. The wrapper
// routes each launch as the Pallas wrappers do (ops/encode_deep.py): a row
// reads the last Dc bytes of its D-byte window (Dc = 32 KiB for the 64 KiB
// windows of the batch layer, which take hash_log 14; plain rows D = Dc = 0
// and hash_log 15).
//
// What bounds it on this card: the parse is serial and data dependent,
// so each row is bound by the latency of dependent steps (a chain link,
// then byte probes), far from the batch's ~12-25 MB of bytes (~4-8 us of
// HBM time).
// What the design does about it: the chain and every walk leave the
// serial path. The block stages the row [last Dc window bytes | block | 8
// zero bytes] and zeroes the head table; warp 0 builds the row's chain (u16
// deltas, (Dc + N + 8) x 2 B per row in a device scratch the wrapper
// allocates unzeroed, 16.8 MB for 128 plain 64 KiB rows) with its head
// table in the region that then holds the ring; the block copies the
// deltas of positions 0 .. 65535 into the ring; all 256 threads fill the
// walk table (N x 4 B per row in device memory, one entry per block
// position; rows past 65,536 positions take a second pass after the ring
// takes the rest of the row); warp 0 parses with its 32 lanes together,
// looking walks up in the table. Shared memory: 2^16 x 2 B ring (131,072 B,
// the 2^15 x 4 B or 2^14 x 4 B head table during the build) + the row:
// 131,072 + 65,544 = 196,616 B for a plain 64 KiB row, 131,072 + 98,312 =
// 229,384 B for a 64 KiB block after a 32 KiB window, at most 232,448 B on
// every route.
#include <cuda_runtime.h>

#include "lz4_encode_deep.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lz4t_encode_deep_kernel(const uint8_t* __restrict__ data,
                            const int32_t* __restrict__ lens,
                            const uint8_t* __restrict__ win,
                            const int32_t* __restrict__ wlens,
                            uint8_t* __restrict__ out,
                            int32_t* __restrict__ totals,
                            bool* __restrict__ ok, uint16_t* delta,
                            uint32_t* tab, int N, int D, int K, int Dc,
                            int CAP, int tries, int hash_log) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* head = smem;  // the build's head table, then the ring
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint32_t* roww = smem + LZ4T_DEEP_RING / 2;  // [window | block | 8 zero]
  const uint8_t* c = reinterpret_cast<const uint8_t*>(roww);
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int DT = Dc + N + 8;
  uint16_t* dr = delta + (size_t)r * DT;
  uint32_t* tr = tab + (size_t)r * N;
  for (int i = t; i < (1 << hash_log); i += kThreads) head[i] = 0;
  lz4t_stage_row(roww, data, win, r, N, D, K, Dc);
  __syncthreads();
  const int first = lz4t_window_first(wlens, r, Dc);
  const int n = lens[r];
  const int mflimit = Dc + n - 12, matchlimit = Dc + n - 5;
  if (t < 32) lz4t_deep_build(c, first, mflimit, hash_log, head, dr);
  __syncthreads();
  for (int i = t; i < lz4t_min(LZ4T_DEEP_RING, DT); i += kThreads)
    ring[i] = dr[i];
  __syncthreads();
  lz4t_ring rg = {ring, dr, LZ4T_DEEP_RING};
  lz4t_walk_table(c, Dc, Dc, lz4t_min(mflimit, LZ4T_DEEP_RING - 1), first,
                  matchlimit, tries, rg, tr, t, kThreads);
  if (mflimit >= LZ4T_DEEP_RING) {
    // the rest of the row: its links take the slots of the first 64 KiB
    __syncthreads();
    for (int i = LZ4T_DEEP_RING + t; i < DT; i += kThreads)
      ring[i & (LZ4T_DEEP_RING - 1)] = dr[i];
    __syncthreads();
    rg.loaded = DT;
    lz4t_walk_table(c, Dc, LZ4T_DEEP_RING, mflimit, first, matchlimit, tries,
                    rg, tr, t, kThreads);
  }
  __syncthreads();
  if (t < 32) {
    int total, okv;
    lz4t_encode_deep_row(c, Dc, first, n, out + (size_t)r * CAP, CAP, tries,
                         rg, tr, &total, &okv);
    if (t == 0) {
      totals[r] = total;
      ok[r] = okv != 0;
    }
  }
}

}  // namespace

// data (R, N) u8, lens (R,) i32, win (R / K, D) u8 right-aligned windows
// (unused when Dc == 0), wlens (R,) i32 usable window bytes per row, delta
// (R, Dc + N + 8) u16 and tab (R, N) u32 scratch -> out (R, CAP) u8,
// totals (R,) i32, ok (R,) bool. Each row's window is the last Dc <= D
// bytes of its window row. N % 4 == D % 4 == Dc % 4 == 0, R % K == 0, D == N
// when K > 1, 2^16 x 2 + Dc + N + 8 <= 232,448. Returns a cudaError_t.
extern "C" int lz4t_launch(const void* data, const void* lens, const void* win,
                           const void* wlens, void* out, void* totals,
                           void* ok, void* delta, void* tab, int R, int N,
                           int D, int K, int Dc, int CAP, int tries,
                           int hash_log, void* stream) {
  const int smem = LZ4T_DEEP_RING * 2 + Dc + N + 8;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_deep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_deep_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint8_t*)win,
      (const int32_t*)wlens, (uint8_t*)out, (int32_t*)totals, (bool*)ok,
      (uint16_t*)delta, (uint32_t*)tab, N, D, K, Dc, CAP, tries, hash_log);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
