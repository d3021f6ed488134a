// K6b: LZ4 block encode of rows too wide for shared memory (greedy, or the
// depth-2 chain), one thread block per row.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel, the packed-word kernel that encode_block_pallas, _dict,
// _mid and _mid_dict take when the byte-wide kernel's budget (_bw_fits)
// refuses the row: blocks over about 96 KiB plain, 67-75 KiB after a
// 64 KiB window, up to the 4 MiB LZ4 block. The row bodies are
// lz4t_encode_row<true, false> (greedy, with the value table) and
// lz4t_encode_mid_row<2, false> (mid mode, which has no depth-4 tables at
// this width): the byte-wide kernel's parse with _encode_kernel's emit,
// byte-exact with that kernel (lz4_encode.cuh says where the two differ).
//
// Each row is [window D | block N | 8 zero bytes] in device memory, built
// by the wrapper (ops/encode_wide.py); the window preload inserts every
// usable window position (no stride), as _encode_kernel does.
//
// What bounds it on this card: one thread parses each row serially, and
// each position costs a hash-table probe and, where a candidate is scored
// or a match extended, loads from the row. The row (up to 64 KiB + 4 MiB +
// 8 bytes) does not fit shared memory, so those loads go to device memory:
// near the scan position they hit L1, at a candidate they miss to L2 or
// HBM. It is bound by the latency of that serial chain; a 64 x 4 MiB batch
// moves ~400 MB, ~0.12 ms of HBM time.
// What the design does about it: the hash tables stay in shared memory
// (greedy 2 x 2^14 x 4 B: positions and the value table, so a greedy probe
// never reads the row at the candidate; mid 2 x 2^13 x 4 B), the block's
// 256 threads zero them and run the window preload with atomicMax as K2b
// and K2c do, and literals are copied 16 bytes at a time. At 4 MiB rows a
// launch of 64 rows busies 64 of the 132 SMs; staging parts of the row in
// shared memory is later work.
#include <cuda_runtime.h>

#include "lz4_encode_mid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTab = 1 << LZ4T_HASH_LOG;
constexpr int kMidTab = 1 << LZ4T_MID_HASH_LOG;

template <bool kMid>
__global__ void __launch_bounds__(kThreads)
    lz4t_encode_wide_kernel(const uint8_t* __restrict__ rows,
                            const int32_t* __restrict__ lens,
                            const int32_t* __restrict__ wlens,
                            uint8_t* __restrict__ out,
                            int32_t* __restrict__ totals,
                            bool* __restrict__ ok, int DT, int D, int CAP) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int T = kMid ? kMidTab : kTab;
  const int r = blockIdx.x;
  const uint8_t* c = rows + (size_t)r * DT;
  for (int i = threadIdx.x; i < 2 * T; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  const int first = lz4t_window_first(wlens, r, D);
  int total, okv;
  if constexpr (kMid) {
    // in-order insertion leaves each slot's two largest positions, newest
    // first: pass 0 takes the largest, pass 1 the largest below it
    uint32_t* tabs[2] = {smem, smem + T};
#pragma unroll
    for (int j = 0; j < 2; j++) {
      for (int p = first + threadIdx.x; p < D; p += kThreads) {
        const uint32_t h = lz4t_hash_mid(lz4t_rd32(c, p));
        const uint32_t v = (uint32_t)(p + 1);
        if (j == 0 || v < tabs[0][h]) atomicMax(&tabs[j][h], v);
      }
      __syncthreads();
    }
    if (threadIdx.x) return;
    const lz4t_mid_tabs t = {tabs[0], tabs[1], nullptr, nullptr};
    lz4t_encode_mid_row<2, false>(c, DT, D, first, lens[r],
                                  out + (size_t)r * CAP, CAP, t, &total,
                                  &okv);
  } else {
    uint32_t* tab = smem;
    uint32_t* vtab = smem + T;
    for (int p = first + threadIdx.x; p < D; p += kThreads)
      atomicMax(&tab[lz4t_hash(lz4t_rd32(c, p))], (uint32_t)(p + 1));
    __syncthreads();
    // the value table: the word at each slot's position (0 when empty)
    for (int h = threadIdx.x; D && h < T; h += kThreads)
      vtab[h] = tab[h] ? lz4t_rd32(c, (int)tab[h] - 1) : 0;
    __syncthreads();
    if (threadIdx.x) return;
    lz4t_encode_row<true, false>(c, DT, D, first, lens[r],
                                 out + (size_t)r * CAP, CAP, tab, vtab,
                                 &total, &okv);
  }
  totals[r] = total;
  ok[r] = okv != 0;
}

template <bool kMid>
cudaError_t launch(const void* rows, const void* lens, const void* wlens,
                   void* out, void* totals, void* ok, int R, int DT, int D,
                   int CAP, cudaStream_t stream) {
  const int smem = 2 * (kMid ? kMidTab : kTab) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_wide_kernel<kMid>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_wide_kernel<kMid><<<R, kThreads, smem, stream>>>(
      (const uint8_t*)rows, (const int32_t*)lens, (const int32_t*)wlens,
      (uint8_t*)out, (int32_t*)totals, (bool*)ok, DT, D, CAP);
  return cudaGetLastError();
}

}  // namespace

// rows (R, DT) u8, each [window D | block N | 8 zero bytes] with DT = D + N
// + 8, lens (R,) i32, wlens (R,) i32 usable window bytes per row (unused
// when D == 0) -> out (R, CAP) u8, totals (R,) i32, ok (R,) bool. mid
// selects the depth-2 chain. Returns a cudaError_t.
extern "C" int lz4t_launch(const void* rows, const void* lens,
                           const void* wlens, void* out, void* totals,
                           void* ok, int R, int DT, int D, int CAP, int mid,
                           void* stream) {
  return mid ? launch<true>(rows, lens, wlens, out, totals, ok, R, DT, D, CAP,
                            (cudaStream_t)stream)
             : launch<false>(rows, lens, wlens, out, totals, ok, R, DT, D,
                             CAP, (cudaStream_t)stream);
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
