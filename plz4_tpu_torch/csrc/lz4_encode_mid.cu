// K2c (depth 2, device levels 3-7) and K2d (depth 4, level 8): chain LZ4
// block encode, one thread block per row, parsed by one warp.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel_bw in mid mode (reached through encode_block_pallas_mid,
// encode_block_pallas_mid_dict and their batch wrappers): plain rows,
// linked and dictionary blocks (wstride 1) and the 64 KiB chunks of large
// blocks (wstride 2). The row body is lz4t_encode_mid_row_lanes
// (lz4_encode_mid.cuh), byte-exact with that kernel; why the lanes' steps
// give the serial parse's bytes is said there.
//
// Rows come in groups of K as in K2b (lz4_encode_window.cu): row r takes
// row r - 1 as its window when r % K > 0 (read in place), win[r / K] when
// r % K == 0. D = 0 is a plain row (no window).
//
// What bounds it on this card: not bytes (a batch of 128 rows moves
// ~12-25 MB, ~4-8 us of HBM time) but the parse's dependent steps. Each
// sequence is found by a scan that inserts every position before the next
// one reads the tables, and extended before the next scan may start, so a
// row is one chain of dependent steps, ~6.4 K sequences for a 64 KiB row of
// text; a launch of 128 rows on 132 SMs, one row each, lasts as long as
// its slowest row, and one warp per SM hides no latency.
// What the design does about it: the parse is one warp's, its 32 lanes in
// step, so each sequence costs a few dependent warp steps instead of one
// thread's walk over every position, candidate and byte. A scan step
// scores 16 positions (depth 2) or 8 (depth 4), one lane per candidate
// (from the tables and from the positions below it in the step that share
// its bucket, __match_any_sync), and a ballot picks the first match; the
// scoring lanes also read the match's first extension bytes, and only
// longer extensions take a step of 32 byte pairs backward or 128 bytes
// forward. The parse writes no output: it stores each sequence with its
// output position (16 B, in a device scratch of N / 4 + 2 per row that the
// wrapper allocates), and after it all 256 threads of the block write the
// sequences at once, one thread each. Words are read from the u32-aligned
// row by aligned loads and funnel shifts.
// The row [window | block | 8 zero bytes] and the tables live in shared
// memory where they fit, the row first (a word read at its last position
// reads one word past it, into the tables): 2 x 2^13 x 4 B + 131,080 B =
// 196,616 B at depth 2 with a 64 KiB window, 4 x 2^13 x 4 B + 65,544 B =
// 196,616 B at depth 4 on a plain row. Depth 4 after a 64 KiB window needs
// 262,152 B, over the 232,448 B a block may use: there the two oldest
// tables (t2, t3) go to device memory, a scratch of 2 x 32 KiB per row that
// the wrapper allocates (L2-resident for a 128-row batch), and the row and
// the two newest tables stay in shared memory.
// The window preload: inserting positions in order leaves each slot holding
// the kDepth largest positions of its bucket, newest first. The block's 256
// threads build that in kDepth passes: pass 0 takes the largest position of
// each bucket with atomicMax, pass j the largest below pass j-1's.
#include <cuda_runtime.h>

#include "lz4_encode_mid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 1 << LZ4T_MID_HASH_LOG;
constexpr int kMaxSmem = 232448;  // dynamic shared memory per block

template <int kDepth>
__global__ void __launch_bounds__(kThreads)
    lz4t_encode_mid_kernel(const uint8_t* __restrict__ data,
                           const int32_t* __restrict__ lens,
                           const uint8_t* __restrict__ win,
                           const int32_t* __restrict__ wlens,
                           uint8_t* __restrict__ out,
                           int32_t* __restrict__ totals,
                           bool* __restrict__ ok, uint32_t* scratch,
                           int* __restrict__ seqs, int N, int D, int K,
                           int wstride, int CAP, int spill) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int r = blockIdx.x;
  const int DT = D + N + 8;
  uint32_t* roww = smem;  // [window D | block N | 8 zero], then the tables
  uint32_t* near = smem + DT / 4;
  uint32_t* far = kDepth == 4
                      ? (spill ? scratch + (size_t)r * 2 * kTab
                               : near + 2 * kTab)
                      : nullptr;
  const lz4t_mid_tabs t = {near, near + kTab, far,
                           far ? far + kTab : nullptr};
  for (int i = threadIdx.x; i < 2 * kTab; i += blockDim.x) {
    near[i] = 0;
    if (kDepth == 4) far[i] = 0;
  }
  lz4t_stage_row(roww, data, win, r, N, D, K, D);
  __syncthreads();
  const uint8_t* c = reinterpret_cast<const uint8_t*>(roww);
  const int first = lz4t_window_first(wlens, r, D);
  uint32_t* tabs[4] = {t.t0, t.t1, t.t2, t.t3};
#pragma unroll
  for (int j = 0; j < kDepth; j++) {
    for (int p = first + threadIdx.x * wstride; p < D;
         p += kThreads * wstride) {
      const uint32_t h = lz4t_hash_mid(lz4t_rd32(c, p));
      const uint32_t v = (uint32_t)(p + 1);
      if (j == 0 || v < tabs[j - 1][h]) atomicMax(&tabs[j][h], v);
    }
    __syncthreads();
  }
  // warp 0 parses into the row's sequences, then the block writes them.
  // The count goes to the scratch's last record, which no sequence takes
  // (a row holds at most N / 4 of them), for every thread to read after
  // the barrier; 0 at the overflow sentinel, whose bytes no caller reads.
  int* seq = seqs + (size_t)r * 4 * (N / 4 + 2);
  int* count = seq + 4 * (N / 4 + 1);
  if (threadIdx.x < 32) {
    int total, okv;
    lz4t_seq_store sink = {seq};
    const int k = lz4t_encode_mid_row_lanes<kDepth>(
        roww, DT, D, first, lens[r], CAP, t, sink, &total, &okv);
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

template <int kDepth>
cudaError_t launch(const void* data, const void* lens, const void* win,
                   const void* wlens, void* out, void* totals, void* ok,
                   void* scratch, void* seqs, int R, int N, int D, int K,
                   int wstride, int CAP, cudaStream_t stream) {
  const int spill = kDepth * kTab * 4 + D + N + 8 > kMaxSmem;
  if (spill && scratch == nullptr) return cudaErrorInvalidValue;
  const int smem = (spill ? 2 : kDepth) * kTab * 4 + D + N + 8;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_mid_kernel<kDepth>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_mid_kernel<kDepth><<<R, kThreads, smem, stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint8_t*)win,
      (const int32_t*)wlens, (uint8_t*)out, (int32_t*)totals, (bool*)ok,
      (uint32_t*)scratch, (int*)seqs, N, D, K, wstride, CAP, spill);
  return cudaGetLastError();
}

}  // namespace

// data (R, N) u8, lens (R,) i32, win (R / K, D) u8 right-aligned windows
// (unused when D == 0), wlens (R,) i32 usable window bytes per row, scratch
// (R, 2 * 2^13) u32 when depth 4 with the window does not fit shared memory
// (else unused), seqs (R, N / 4 + 2, 4) i32 scratch -> out (R, CAP) u8 (the
// stream wherever total < CAP), totals (R,) i32, ok (R,) bool.
// N % 4 == D % 4 == 0, R % K == 0, D == N when K > 1, wstride >= 1.
// Returns a cudaError_t.
extern "C" int lz4t_launch(const void* data, const void* lens, const void* win,
                           const void* wlens, void* out, void* totals,
                           void* ok, void* scratch, void* seqs, int R, int N,
                           int D, int K, int wstride, int CAP, int depth4,
                           void* stream) {
  return depth4 ? launch<4>(data, lens, win, wlens, out, totals, ok, scratch,
                            seqs, R, N, D, K, wstride, CAP,
                            (cudaStream_t)stream)
                : launch<2>(data, lens, win, wlens, out, totals, ok, scratch,
                            seqs, R, N, D, K, wstride, CAP,
                            (cudaStream_t)stream);
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
