// K6b: LZ4 block encode of rows too wide for shared memory (greedy, or the
// depth-2 chain), one thread block per row: one warp parses, seven write.
//
// Replaces the Pallas TPU kernel plz4_tpu/ops/encode_pallas.py:
// _encode_kernel, the packed-word kernel that encode_block_pallas, _dict,
// _mid and _mid_dict take when the byte-wide kernel's budget (_bw_fits)
// refuses the row: blocks over about 96 KiB plain, 67-75 KiB after a
// 64 KiB window, up to the 4 MiB LZ4 block. The row body is
// lz4_encode_wide.cuh: the warp-cooperative parse of K2a/K2b
// (lz4t_encode_row_lanes) or of K2c (lz4t_encode_mid_row_lanes<2>; mid mode
// has no depth-4 tables at this width) with _encode_kernel's emit
// (kGuard = false), byte-exact with that kernel (lz4_encode.cuh says where
// the two emits differ).
//
// Each row is [window D | block N | 8 zero bytes] in device memory, built
// by the wrapper (ops/encode_wide.py) with 16 spare bytes after the last
// row, since the parse reads one word past its row; the window preload
// inserts every usable window position (no stride), as _encode_kernel
// does.
//
// What bounds it on this card: a row's parse is one dependent chain (each
// search inserts every position it scans before the next one reads the
// table, a match is extended before the next search starts), and the row
// (up to 64 KiB + 4 MiB + 8 bytes) does not fit shared memory, so the
// parse's loads at the scan position and at candidates up to 64 KiB back
// go to device memory through L1. A 64 x 4 MiB batch moves ~400 MB, ~0.12
// ms of HBM time; a launch of 64 rows busies 64 of the 132 SMs, one chain
// each.
// What the design does about it: the parse runs on the 32 lanes of warp 0
// (a search's later attempts 32 per step, 32-lane extensions, K2a's and
// K2c's bodies), with the tables in shared memory (greedy: the 2^14
// positions and the 2^14-byte lane table, no value table; mid: 2 x 2^13)
// and the row read in place through the read-only path. It writes no
// output: it hands each sequence with its output position through a ring
// of 16 slots of 32 in shared memory to warps 1-7, which write the
// sequences' bytes, 32 lanes each, while the parse goes on (a flat
// sequence scratch would take 1.07 GB at 64 x 4 MiB). Shared memory:
// 90,496 B greedy, 74,112 B mid.
#include <cuda_runtime.h>

#include "lz4_encode_wide.cuh"

namespace {

constexpr int kThreads = 32 * (1 + LZ4T_WRING_WARPS);
constexpr int kTab = 1 << LZ4T_HASH_LOG;
constexpr int kMidTab = 1 << LZ4T_MID_HASH_LOG;
// the tables ahead of the ring: greedy positions and lane table, or the
// two mid tables
__host__ __device__ constexpr int tables_bytes(bool mid) {
  return mid ? 2 * kMidTab * 4 : kTab * 5;
}

// the row's parse: greedy (tab: the 2^14 positions, then the 2^14-byte
// lane table) or depth 2 (tab: the two 2^13 tables); returns the count of
// sequences handed to the sink
template <bool kMid>
__device__ __forceinline__ int parse(const uint32_t* w, int DT, int base,
                                     int first, int n, int CAP,
                                     uint32_t* tab, lz4t_wring_sink& sink,
                                     int* total, int* okv) {
  if constexpr (kMid) {
    const lz4t_mid_tabs mt = {tab, tab + kMidTab, nullptr, nullptr};
    return lz4t_encode_mid_row_lanes<2, false>(w, DT, base, first, n, CAP,
                                               mt, sink, total, okv);
  } else {
    return lz4t_encode_row_lanes<false>(w, DT, base, first, n, CAP, tab,
                                        reinterpret_cast<uint8_t*>(tab + kTab),
                                        sink, total, okv);
  }
}

template <bool kMid>
__global__ void __launch_bounds__(kThreads)
    lz4t_encode_wide_kernel(const uint8_t* __restrict__ rows,
                            const int32_t* __restrict__ lens,
                            const int32_t* __restrict__ wlens,
                            uint8_t* __restrict__ out,
                            int32_t* __restrict__ totals,
                            bool* __restrict__ ok, int DT, int D, int CAP) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NB = LZ4T_WRING_BATCHES;
  constexpr int T = kMid ? kMidTab : kTab;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  int4* ring = reinterpret_cast<int4*>(smem + tables_bytes(kMid));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 32 * NB);
  uint64_t* empty = full + NB;
  int* cnt = reinterpret_cast<int*>(empty + NB);
  int* anc = cnt + NB;
  const int r = blockIdx.x, t = threadIdx.x, warp = t >> 5;
  const uint8_t* c = rows + (size_t)r * DT;
  for (int i = t; i < (kMid ? 2 * T : T); i += kThreads) tab[i] = 0;
  if (t == 0) {
    for (int s = 0; s < NB; s++) {
      lz4t_mbar_init(&full[s], 1);
      lz4t_mbar_init(&empty[s], LZ4T_WRING_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int first = lz4t_window_first(wlens, r, D);
  if constexpr (kMid) {
    const lz4t_mid_tabs mt = {tab, tab + kMidTab, nullptr, nullptr};
    // in-order insertion leaves each slot's two largest positions, newest
    // first: pass 0 takes the largest, pass 1 the largest below it
#pragma unroll
    for (int j = 0; j < 2; j++) {
      for (int p = first + t; p < D; p += kThreads) {
        const uint32_t h = lz4t_hash_mid(lz4t_rd32(c, p));
        const uint32_t v = (uint32_t)(p + 1);
        if (j == 0 || v < mt.t0[h]) atomicMax(j ? &mt.t1[h] : &mt.t0[h], v);
      }
      __syncthreads();
    }
  } else {
    for (int p = first + t; p < D; p += kThreads)
      atomicMax(&tab[lz4t_hash(lz4t_rd32(c, p))], (uint32_t)(p + 1));
    __syncthreads();
  }
  uint8_t* o = out + (size_t)r * CAP;
  if (warp == 0) {
    lz4t_wring_sink sink = {ring, cnt, anc, full, empty, D};
    const uint32_t* w = reinterpret_cast<const uint32_t*>(c);
    int total, okv;
    // the body inlined twice: without a window (base = first = 0 known to
    // the compiler, which drops their tests from the chain) and with one
    sink.finish(D ? parse<kMid>(w, DT, D, first, lens[r], CAP, tab, sink,
                                &total, &okv)
                  : parse<kMid>(w, DT, 0, 0, lens[r], CAP, tab, sink, &total,
                                &okv));
    if (t == 0) {
      totals[r] = total;
      ok[r] = okv != 0;
    }
  } else {
    lz4t_wring_emit(c, o, CAP, ring, cnt, anc, full, empty, warp - 1);
  }
}

template <bool kMid>
cudaError_t launch(const void* rows, const void* lens, const void* wlens,
                   void* out, void* totals, void* ok, int R, int DT, int D,
                   int CAP, cudaStream_t stream) {
  const int smem = tables_bytes(kMid) + LZ4T_WRING_SMEM;
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
// + 8 a multiple of 4, and 16 readable bytes after the last row; lens (R,)
// i32, wlens (R,) i32 usable window bytes per row (unused when D == 0) ->
// out (R, CAP) u8, totals (R,) i32, ok (R,) bool. mid selects the depth-2
// chain. Returns a cudaError_t.
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
