// K2b: greedy LZ4 block encode after a window prefix, one thread block per
// row, parsed by one warp.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel_bw in window-prefix mode (reached through
// encode_block_pallas_dict and encode_batch_pallas_dict): linked and
// dictionary blocks (wstride 1) and the 64 KiB chunks of large blocks
// (wstride 2). The row body is lz4t_encode_row_lanes (lz4_encode.cuh),
// byte-exact with that kernel; why the lanes' steps give the serial
// parse's bytes is said there.
//
// Rows come in groups of K: row r takes as its window row r - 1 when
// r % K > 0 (the previous chunk of the same large block, read in place:
// no second copy of the batch), and win[r / K] when r % K == 0 (a frame
// dictionary, the linked predecessor's tail, or nothing). K = 1 gives
// every row its own window.
//
// What bounds it on this card: as K2a (lz4_encode.cu), the parse's
// dependent steps, one chain per row; a batch of 128 chunk rows moves ~25
// MB (~7.5 us of HBM time).
// What the design does about it: K2a's warp-cooperative parse and block-
// wide emit. The row [window | block | 8 zero bytes], the position table
// and the step's byte table live in shared memory, the row first (a word
// read at its last position reads one word past it, into the table): 2^14
// x 5 B + 131,080 B = 213,000 B at D = N = 64 KiB. The window preload, the
// reference's dominant fixed cost per chunk, is spread over the block's 256
// threads: in-order insertion leaves each slot holding its largest
// position, so atomicMax gives the same table. Warp 0 then parses, and the
// block writes the sequences.
#include <cuda_runtime.h>

#include "lz4_encode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 1 << LZ4T_HASH_LOG;

__global__ void __launch_bounds__(kThreads)
    lz4t_encode_window_kernel(const uint8_t* __restrict__ data,
                              const int32_t* __restrict__ lens,
                              const uint8_t* __restrict__ win,
                              const int32_t* __restrict__ wlens,
                              uint8_t* __restrict__ out,
                              int32_t* __restrict__ totals,
                              bool* __restrict__ ok, int* __restrict__ seqs,
                              int N, int D, int K, int wstride, int CAP) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int DT = D + N + 8;
  uint32_t* roww = smem;  // [window D | block N | 8 zero], the table, own
  uint32_t* tab = smem + DT / 4;
  uint8_t* own = reinterpret_cast<uint8_t*>(tab + kTab);
  const int r = blockIdx.x;
  for (int i = threadIdx.x; i < kTab; i += blockDim.x) tab[i] = 0;
  lz4t_stage_row(roww, data, win, r, N, D, K, D);
  __syncthreads();
  const uint8_t* c = reinterpret_cast<const uint8_t*>(roww);
  const int first = lz4t_window_first(wlens, r, D);
  for (int p = first + threadIdx.x * wstride; p < D;
       p += kThreads * wstride)
    atomicMax(&tab[lz4t_hash(lz4t_rd32(c, p))], (uint32_t)(p + 1));
  __syncthreads();
  // warp 0 parses, then the block writes the sequences (the count in the
  // scratch's spare last record, as in K2a)
  int* seq = seqs + (size_t)r * 4 * (N / 4 + 2);
  int* count = seq + 4 * (N / 4 + 1);
  if (threadIdx.x < 32) {
    int total, okv;
    lz4t_seq_store sink = {seq};
    const int k = lz4t_encode_row_lanes(roww, DT, D, first, lens[r], CAP,
                                        tab, own, sink, &total, &okv);
    if (threadIdx.x == 0) {
      *count = total < CAP ? k : 0;
      totals[r] = total;
      ok[r] = okv != 0;
    }
  }
  __syncthreads();
  lz4t_seq_emit(c, out + (size_t)r * CAP, CAP, D, seq, *count, threadIdx.x,
                kThreads);
}

}  // namespace

// data (R, N) u8, lens (R,) i32, win (R / K, D) u8 right-aligned windows,
// wlens (R,) i32 usable window bytes per row, seqs (R, N / 4 + 2, 4) i32
// scratch -> out (R, CAP) u8 (the stream wherever total < CAP), totals
// (R,) i32, ok (R,) bool. N % 4 == D % 4 == 0, R % K == 0, D == N when
// K > 1, wstride >= 1. Returns a cudaError_t.
extern "C" int lz4t_launch(const void* data, const void* lens, const void* win,
                           const void* wlens, void* out, void* totals,
                           void* ok, void* seqs, int R, int N, int D, int K,
                           int wstride, int CAP, void* stream) {
  const int smem = kTab * 5 + D + N + 8;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_window_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_window_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint8_t*)win,
      (const int32_t*)wlens, (uint8_t*)out, (int32_t*)totals, (bool*)ok,
      (int*)seqs, N, D, K, wstride, CAP);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
