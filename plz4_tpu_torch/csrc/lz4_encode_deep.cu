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
// 131,072 + 65,544 = 196,616 B for a 64 KiB row, 131,072 + 98,312 =
// 229,384 B for a 64 KiB block after a 32 KiB window, at most 232,448 B on
// every route.
//
// Plain rows (no window, at most 65,536 bytes: the ring then holds every
// link of the row) take lz4t_encode_deep_plain_kernel, which keeps the
// key match and the walk table off the serial path. Its build is split
// (lz4t_deep_build_split): the block's other LZ4T_DEEP_PIPE_WARPS warps
// compute each build step's keys and peers (__match_any_sync) as one word
// a position into a ring of LZ4T_DEEP_PEER_SLOTS chunks in the table
// ring's memory, chunk by chunk ahead of warp 0, whose step keeps the head
// table's read and write and the delta store. After the ring load, warp 0
// parses while the other warps fill the walk table into a ring of
// LZ4T_DEEP_PIPE_SLOTS chunks of LZ4T_DEEP_PIPE_CHUNK entries in shared
// memory (lz4t_pipe_fill), chunk by chunk in position order, handing each
// over with mbarriers; the parse waits for a chunk before it reads it and
// hands it back once its scan has passed it (lz4t_pipe_tab). So a row
// takes the build and then the longer of the table and the parse, not
// their sum, and the parse reads its entries from shared memory. Shared
// memory: 131,072 (ring) + 33,024 (table ring, the barriers of both rings)
// + 65,544 (the row) = 229,640 B for a 64 KiB row. 19 table warps (640
// threads) gave the shortest launches over the frame cell's rows at walk
// budgets 2 and 32 among 11-23 (tools/encode_deep_stamps_torch.py,
// PERF.md): fewer leave the parse waiting for chunks on rows of long
// chains, more slow it.
#include <cuda_runtime.h>

#include "lz4_encode_deep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlainThreads = 32 * (1 + LZ4T_DEEP_PIPE_WARPS);

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
    lz4t_dev_tab tab = {tr, Dc};
    lz4t_encode_deep_row(c, Dc, first, n, out + (size_t)r * CAP, CAP, tries,
                         rg, tab, &total, &okv);
    if (t == 0) {
      totals[r] = total;
      ok[r] = okv != 0;
    }
  }
}

// The plain kernel's shared memory: the ring (the build's head table
// before it), the table ring (the peer ring before it), the barriers of
// both, then the row.
struct lz4t_plain_smem {
  uint32_t* head;
  uint16_t* ring;
  uint32_t* slot;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* peer_full;
  uint64_t* peer_empty;
  uint32_t* roww;
};

__device__ __forceinline__ lz4t_plain_smem lz4t_plain_layout() {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* slot = smem + LZ4T_DEEP_RING / 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      slot + LZ4T_DEEP_PIPE_SLOTS * LZ4T_DEEP_PIPE_CHUNK);
  uint64_t* empty = full + LZ4T_DEEP_PIPE_SLOTS;
  uint64_t* peer_full = empty + LZ4T_DEEP_PIPE_SLOTS;
  uint64_t* peer_empty = peer_full + LZ4T_DEEP_PEER_SLOTS;
  return {smem,      reinterpret_cast<uint16_t*>(smem),
          slot,      full,
          empty,     peer_full,
          peer_empty, reinterpret_cast<uint32_t*>(peer_empty +
                                                  LZ4T_DEEP_PEER_SLOTS)};
}

// The build warp's part of the chain build runs in the kernel's body; the
// peer warps' part is compiled apart, as the parse's and table's parts.
__device__ __forceinline__ void lz4t_plain_build(int n, uint16_t* dr) {
  const lz4t_plain_smem m = lz4t_plain_layout();
  lz4t_peer_ring<lz4t_peer_bars> pr = {m.slot, {m.peer_full, m.peer_empty}};
  lz4t_deep_build_split(n - 12, m.head, dr, pr);
}

__device__ __noinline__ void lz4t_plain_peers(int n, int hash_log, int w) {
  const lz4t_plain_smem m = lz4t_plain_layout();
  lz4t_peer_fill<LZ4T_DEEP_PIPE_WARPS>(
      reinterpret_cast<const uint8_t*>(m.roww), n - 12, hash_log, m.slot,
      m.peer_full, m.peer_empty, w);
}

// The parse warp's and the table warps' parts of a plain row are functions
// of their own, each compiled apart from the other: inlined into the
// kernel together they ran 13-22% slower (ptxas's one allocation for
// both; tools/encode_deep_stamps_torch.py, PERF.md). Both take the chain
// from the ring alone (the row has at most LZ4T_DEEP_RING positions).
__device__ __noinline__ void lz4t_plain_parse(int n, uint8_t* o, int CAP,
                                              int tries, int* total,
                                              int* okv) {
  const lz4t_plain_smem m = lz4t_plain_layout();
  const lz4t_ring rg = {m.ring, nullptr, LZ4T_DEEP_RING};
  lz4t_pipe_tab<lz4t_pipe_bars> tab = {
      m.slot, 0, lz4t_pipe_chunks(0, n - 12), {m.full, m.empty}, 0, 0, 0, 0};
  lz4t_encode_deep_row(reinterpret_cast<const uint8_t*>(m.roww), 0, 0, n, o,
                       CAP, tries, rg, tab, total, okv);
}

__device__ __noinline__ void lz4t_plain_fill(int n, int tries, int w) {
  const lz4t_plain_smem m = lz4t_plain_layout();
  const lz4t_ring rg = {m.ring, nullptr, LZ4T_DEEP_RING};
  lz4t_pipe_fill<LZ4T_DEEP_PIPE_WARPS>(
      reinterpret_cast<const uint8_t*>(m.roww), 0, n - 12, 0, n - 5, tries,
      rg, m.slot, m.full, m.empty, w);
}

// A plain row (D = Dc = 0, N <= LZ4T_DEEP_RING).
__global__ void __launch_bounds__(kPlainThreads, 1)
    lz4t_encode_deep_plain_kernel(const uint8_t* __restrict__ data,
                                  const int32_t* __restrict__ lens,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ totals,
                                  bool* __restrict__ ok, uint16_t* delta,
                                  int N, int CAP, int tries, int hash_log) {
  const lz4t_plain_smem m = lz4t_plain_layout();
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int DT = N + 8;
  uint16_t* dr = delta + (size_t)r * DT;
  for (int i = t; i < (1 << hash_log); i += kPlainThreads) m.head[i] = 0;
  lz4t_stage_row(m.roww, data, nullptr, r, N, 0, 1, 0);
  lz4t_pipe_init<LZ4T_DEEP_PIPE_WARPS>(m.full, m.empty, m.peer_full,
                                       m.peer_empty);
  __syncthreads();
  const int n = lens[r];
  if (t < 32)
    lz4t_plain_build(n, dr);
  else
    lz4t_plain_peers(n, hash_log, (t >> 5) - 1);
  __syncthreads();
  for (int i = t; i < lz4t_min(LZ4T_DEEP_RING, DT); i += kPlainThreads)
    m.ring[i] = dr[i];
  __syncthreads();
  if (t < 32) {
    int total, okv;
    lz4t_plain_parse(n, out + (size_t)r * CAP, CAP, tries, &total, &okv);
    if (t == 0) {
      totals[r] = total;
      ok[r] = okv != 0;
    }
  } else {
    lz4t_plain_fill(n, tries, (t >> 5) - 1);
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

// Plain rows: data (R, N) u8, lens (R,) i32, delta (R, N + 8) u16 scratch
// -> out (R, CAP) u8, totals (R,) i32, ok (R,) bool. N % 4 == 0, N <=
// LZ4T_DEEP_RING. Returns a cudaError_t.
extern "C" int lz4t_launch_plain(const void* data, const void* lens,
                                 void* out, void* totals, void* ok,
                                 void* delta, int R, int N, int CAP,
                                 int tries, int hash_log, void* stream) {
  const int smem = LZ4T_DEEP_RING * 2 + LZ4T_DEEP_PIPE_SMEM + N + 8;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_encode_deep_plain_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_encode_deep_plain_kernel<<<R, kPlainThreads, smem,
                                  (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (uint8_t*)out,
      (int32_t*)totals, (bool*)ok, (uint16_t*)delta, N, CAP, tries,
      hash_log);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
