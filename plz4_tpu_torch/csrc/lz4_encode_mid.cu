// K2c (depth 2, device levels 3-7) and K2d (depth 4, level 8): chain LZ4
// block encode, one thread block per row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel_bw in mid mode (reached through encode_block_pallas_mid,
// encode_block_pallas_mid_dict and their batch wrappers): plain rows,
// linked and dictionary blocks (wstride 1) and the 64 KiB chunks of large
// blocks (wstride 2). The row body is lz4t_encode_mid_row
// (lz4_encode_mid.cuh), byte-exact with that kernel.
//
// Rows come in groups of K as in K2b (lz4_encode_window.cu): row r takes
// row r - 1 as its window when r % K > 0 (read in place), win[r / K] when
// r % K == 0. D = 0 is a plain row (no window).
//
// What bounds it on this card: as K2a, the parse is one serial,
// data-dependent chain per row (hash, 2 or 4 table probes, word compares,
// extend), bound by the latency of one thread's dependent loads; a batch
// of 128 rows moves ~12-25 MB (~4-8 us of HBM time). It does more work per
// position than K2a: no skip acceleration, and 2 or 4 candidates scored.
// What the design does about it: the row [window | block | 8 zero bytes]
// and the tables live in shared memory where they fit: 2 x 2^13 x 4 B +
// 131,080 B = 196,616 B at depth 2 with a 64 KiB window, 4 x 2^13 x 4 B +
// 65,544 B = 196,616 B at depth 4 on a plain row. Depth 4 after a 64 KiB
// window needs 262,152 B, over the 232,448 B a block may use: there the two
// oldest tables (t2, t3) go to device memory, a scratch of 2 x 32 KiB per
// row that the wrapper allocates (L2-resident for a 128-row batch), and the
// row and the two newest tables stay in shared memory.
// The window preload: inserting positions in order leaves each slot holding
// the kDepth largest positions of its bucket, newest first. The block's 256
// threads build that in kDepth passes: pass 0 takes the largest position of
// each bucket with atomicMax, pass j the largest below pass j-1's. Thread 0
// then runs the parse.
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
                           bool* __restrict__ ok, uint32_t* scratch, int N,
                           int D, int K, int wstride, int CAP, int spill) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int r = blockIdx.x;
  const int n_shared = spill ? 2 : kDepth;  // tables in shared memory
  uint32_t* roww = smem + n_shared * kTab;  // [window D | block N | 8 zero]
  uint32_t* far = kDepth == 4
                      ? (spill ? scratch + (size_t)r * 2 * kTab
                               : smem + 2 * kTab)
                      : nullptr;
  const lz4t_mid_tabs t = {smem, smem + kTab, far,
                           far ? far + kTab : nullptr};
  for (int i = threadIdx.x; i < 2 * kTab; i += blockDim.x) {
    smem[i] = 0;
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
  if (threadIdx.x == 0) {
    int total, okv;
    lz4t_encode_mid_row<kDepth>(c, D + N + 8, D, first, lens[r],
                                out + (size_t)r * CAP, CAP, t, &total, &okv);
    totals[r] = total;
    ok[r] = okv != 0;
  }
}

template <int kDepth>
cudaError_t launch(const void* data, const void* lens, const void* win,
                   const void* wlens, void* out, void* totals, void* ok,
                   void* scratch, int R, int N, int D, int K, int wstride,
                   int CAP, cudaStream_t stream) {
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
      (uint32_t*)scratch, N, D, K, wstride, CAP, spill);
  return cudaGetLastError();
}

}  // namespace

// data (R, N) u8, lens (R,) i32, win (R / K, D) u8 right-aligned windows
// (unused when D == 0), wlens (R,) i32 usable window bytes per row, scratch
// (R, 2 * 2^13) u32 when depth 4 with the window does not fit shared memory
// (else unused) -> out (R, CAP) u8, totals (R,) i32, ok (R,) bool.
// N % 4 == D % 4 == 0, R % K == 0, D == N when K > 1, wstride >= 1.
// Returns a cudaError_t.
extern "C" int lz4t_launch(const void* data, const void* lens, const void* win,
                           const void* wlens, void* out, void* totals,
                           void* ok, void* scratch, int R, int N, int D, int K,
                           int wstride, int CAP, int depth4, void* stream) {
  return depth4 ? launch<4>(data, lens, win, wlens, out, totals, ok, scratch,
                            R, N, D, K, wstride, CAP, (cudaStream_t)stream)
                : launch<2>(data, lens, win, wlens, out, totals, ok, scratch,
                            R, N, D, K, wstride, CAP, (cudaStream_t)stream);
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
