// K2a: greedy LZ4 block encode, one thread block per row, parsed by one
// warp.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel_bw in greedy mode without a window (reached through
// _encode_call_bw, encode_block_pallas and encode_batch_pallas). The row
// body is lz4t_encode_row_lanes (lz4_encode.cuh, base = first = 0),
// byte-exact with that kernel; why the lanes' steps give the serial
// parse's bytes is said there.
//
// What bounds it on this card: not bytes (a batch moves ~12 MB, ~3.5 us of
// HBM time) nor arithmetic, but the parse's dependent steps. Each search
// inserts every position it scans before the next one reads the table,
// and a match is extended before the next search may start, so a row is
// one chain of dependent steps, ~6.7 K sequences for a 64 KiB row of mixed
// text; a launch of 128 rows on 132 SMs, one row each, lasts as long as
// its slowest row.
// What the design does about it: the parse is one warp's, its 32 lanes in
// step, so a long search costs one warp step per 32 attempts instead of
// one thread's walk over every attempt and byte. Lane i takes attempt
// cnt0 + i of the skip schedule (closed form, lz4t_skip_offset), its
// candidate from the table or from the lower lanes of its bucket, and a
// ballot picks the first match; the lanes also read the match's first
// extension bytes, and only longer extensions take a step of 32 byte pairs
// backward or 128 bytes forward. A search's first three attempts, which
// end most searches, run as scalar code on every lane (no cross-lane
// step), and a step calls __match_any_sync (~340 cycles for 32 distinct
// keys) only when a byte table of lane numbers shows two lanes in one
// bucket. The parse writes no output: it stores each sequence with its
// output position (16 B, in a device scratch of N / 4 + 2 per row that the
// wrapper allocates), and after it all 256 threads of the block write the
// sequences, wherever total < CAP. The row (N + 8 bytes), the position
// table (2^14 x 4 B) and the byte table (2^14 B) live in shared memory,
// the row first (a word read at its last position reads one word past it,
// into the table): 147,464 B at N = 64 KiB. The slot's stored word is
// re-read at its position (lz4_encode.cuh), so there is no value table.
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
                       int* __restrict__ seqs, int N, int CAP) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int DT = N + 8;
  uint32_t* roww = smem;  // [block N | 8 zero bytes], the table, own
  uint32_t* tab = smem + DT / 4;
  uint8_t* own = reinterpret_cast<uint8_t*>(tab + kTab);
  const int b = blockIdx.x;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(data + (size_t)b * N);
  for (int i = threadIdx.x; i < kTab; i += blockDim.x) tab[i] = 0;
  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) roww[i] = src[i];
  if (threadIdx.x < 2) roww[N / 4 + threadIdx.x] = 0;  // 8 zero tail bytes
  __syncthreads();
  // warp 0 parses into the row's sequences, then the block writes them.
  // The count goes to the scratch's last record, which no sequence takes
  // (a row holds at most N / 4 of them), for every thread to read after
  // the barrier; 0 at the overflow sentinel, whose bytes no caller reads.
  int* seq = seqs + (size_t)b * 4 * (N / 4 + 2);
  int* count = seq + 4 * (N / 4 + 1);
  if (threadIdx.x < 32) {
    int total, okv;
    lz4t_seq_store sink = {seq};
    const int k = lz4t_encode_row_lanes(roww, DT, 0, 0, lens[b], CAP, tab,
                                        own, sink, &total, &okv);
    if (threadIdx.x == 0) {
      *count = total < CAP ? k : 0;
      totals[b] = total;
      ok[b] = okv != 0;
    }
  }
  __syncthreads();
  lz4t_seq_emit(reinterpret_cast<const uint8_t*>(roww),
                out + (size_t)b * CAP, CAP, 0, seq, *count, threadIdx.x,
                kThreads);
}

}  // namespace

// data (B, N) u8 with N % 4 == 0, lens (B,) i32, seqs (B, N / 4 + 2, 4) i32
// scratch -> out (B, CAP) u8 (the stream wherever total < CAP), totals (B,)
// i32, ok (B,) bool. Returns a cudaError_t (ops/_build.py holds each
// library's C signature).
extern "C" int lz4t_launch(const void* data, const void* lens, void* out,
                           void* totals, void* ok, void* seqs, int B, int N,
                           int CAP, void* stream) {
  const int smem = kTab * 5 + N + 8;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (uint8_t*)out,
      (int32_t*)totals, (bool*)ok, (int*)seqs, N, CAP);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
