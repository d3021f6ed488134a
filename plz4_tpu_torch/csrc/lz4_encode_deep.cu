// K4: deep hash-chain LZ4 block encode with lazy matching (device levels
// 9-12, walk budgets 2/8/16/32), one thread block per row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel_deep (reached through _encode_call_deep,
// encode_block_pallas_deep, encode_block_pallas_deep_dict and their batch
// wrappers), both its i32-chain and its u16-delta-chain variant: plain
// rows, linked and dictionary blocks and the 64 KiB chunks of large blocks.
// The row body is lz4t_encode_deep_row (lz4_encode_deep.cuh), byte-exact
// with that kernel; why one chain serves both variants is said there.
//
// Rows come in groups of K as in K2b: row r takes row r - 1 as its window
// when r % K > 0 (read in place), win[r / K] when r % K == 0. The wrapper
// routes each launch as the Pallas wrappers do (ops/encode_deep.py): a row
// reads the last Dc bytes of its D-byte window (Dc = 32 KiB for the 64 KiB
// windows of the batch layer, which take hash_log 14; plain rows D = Dc = 0
// and hash_log 15).
//
// What bounds it on this card: one thread walks each row serially, and
// every position it scans costs an insert and a walk of up to `tries`
// dependent chain links, each a device-memory load followed by byte probes
// in shared memory: it is bound by the latency of those dependent loads,
// far from the batch's ~12-25 MB of bytes (~4-8 us of HBM time).
// What the design does about it: the row [last Dc window bytes | block |
// 8 zero bytes] and the head table live in shared memory (65,544 B +
// 2^15 x 4 B = 196,616 B for a plain 64 KiB row; 98,312 B + 2^14 x 4 B =
// 163,848 B for a 64 KiB block after a 32 KiB window). The chain, one u32
// link per row position, does not fit beside them: it lives in device
// memory, a scratch of (Dc + N + 8) x 4 B per row that the wrapper
// allocates unzeroed (33.6 MB for 128 rows, within the 50 MB L2). The
// window preload (up to 32 Ki inserts, each a chain store) is serial on
// thread 0: each insert reads the head it replaces, so in-order insertion
// is what builds the chain.
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
                            bool* __restrict__ ok, uint32_t* chain, int N,
                            int D, int K, int Dc, int CAP, int tries,
                            int hash_log) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = 1 << hash_log;
  uint32_t* head = smem;
  uint32_t* roww = smem + T;  // [window Dc | block N | 8 zero bytes]
  const int r = blockIdx.x;
  const int DT = Dc + N + 8;
  for (int i = threadIdx.x; i < T; i += blockDim.x) head[i] = 0;
  lz4t_stage_row(roww, data, win, r, N, D, K, Dc);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total, okv;
    lz4t_encode_deep_row(reinterpret_cast<const uint8_t*>(roww), Dc,
                         lz4t_window_first(wlens, r, Dc),
                         lens[r], out + (size_t)r * CAP, CAP, tries, hash_log,
                         head, chain + (size_t)r * DT, &total, &okv);
    totals[r] = total;
    ok[r] = okv != 0;
  }
}

}  // namespace

// data (R, N) u8, lens (R,) i32, win (R / K, D) u8 right-aligned windows
// (unused when Dc == 0), wlens (R,) i32 usable window bytes per row, chain
// (R, Dc + N + 8) u32 scratch -> out (R, CAP) u8, totals (R,) i32, ok (R,)
// bool. Each row's window is the last Dc <= D bytes of its window row.
// N % 4 == D % 4 == Dc % 4 == 0, R % K == 0, D == N when K > 1.
// Returns a cudaError_t.
extern "C" int lz4t_launch(const void* data, const void* lens, const void* win,
                           const void* wlens, void* out, void* totals,
                           void* ok, void* chain, int R, int N, int D, int K,
                           int Dc, int CAP, int tries, int hash_log,
                           void* stream) {
  const int smem = (1 << hash_log) * 4 + Dc + N + 8;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_deep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_deep_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint8_t*)win,
      (const int32_t*)wlens, (uint8_t*)out, (int32_t*)totals, (bool*)ok,
      (uint32_t*)chain, N, D, K, Dc, CAP, tries, hash_log);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
