// K3 and K5: LZ4 decode against a right-aligned window, one thread block
// per row (K3) or per large block (K5). The row bodies are in
// lz4_decode_ring.cuh (K3: lz4t_ring_row, a parse warp feeding seven copy
// warps) and lz4_decode_window.cuh (K5: lz4t_decode_record, one thread per
// record, and lz4t_copy_record_lanes, eight warps per large block); both
// copy with lz4t_copy_batch_lanes.
//
// K3 replaces the Pallas TPU kernel plz4_tpu/ops/decode_pallas.py:
// _decode_dict_kernel with strict=True (decode_block_pallas_dict, batched
// by plz4_tpu/parallel/batch.py:_decode_batch_dict_pallas): whole blocks of
// a dictionary frame against the frame's dictionary. Its rules are in
// lz4_decode_window.cuh (strict mode). It is K1's design with a
// window (lz4_decode.cu says why): the parse is one dependent chain, so
// warp 0's lane 0 only parses and hands each sequence through a ring of
// 64 slots of 32 sequences (full/empty mbarriers) to warps 1-7, which
// write 224 output bytes per step, a match reading the dictionary where
// its source lies before the block. One launch per batch. Shared memory:
// the ring (34,064 B), the compressed row padded with zeros (65,568), the
// dictionary (65,536) and the output row (65,536): 230,704 B at 64 KiB
// blocks, of the 232,448 a block can use.
//
// K5 replaces _decode_kernel_bw_rec (_decode_record, scanned over a block's
// records by decode_chunks_pallas / decode_chunks_batch_pallas), and with
// it _decode_dict_kernel with strict=False (K6c), the same function that
// _decode_record falls back to for shapes over the TPU's SMEM budget: the
// records of a large block, in order, each against the previous record's
// output (the first against the frame dictionary).
//
// What bounds K5 on this card: a record's parse is serial and data
// dependent (each token's position follows from the sequence before it),
// and a block's copies are serial too (record k's window is record k-1's
// output), so K5 is bound by the latency of dependent steps, not by bytes:
// a Reader batch has 16 blocks of 4 MiB (~383 K sequences each) for the
// 132 SMs.
// What the design does about it: two launches. The first parses every
// record of the batch at once, one thread per record (a record's parse
// reads only its slice and meta, never the window), and stores each
// sequence as (ip, n_lit, off, m) in a device scratch of W / 4 + 2
// entries per record. The second copies, one thread block per large
// block and its records in order: the eight warps write 256 output bytes
// per step, byte-parallel (the argument that the steps give the
// byte-serial bytes is in the .cuh). Shared memory, CIN + 2 W = 83,968 +
// 2 x 65,536 = 215,040 B on the frame path: the record's input slice and
// two output buffers used in turn. The buffer that holds record k-1's
// output is record k's window, read-only while record k is copied, so it
// is written out to device memory while record k's slice is staged, and no
// window is ever copied. Each record has two barriers: after the staging
// (and the zeroing of its output buffer, which gives the zeros past
// n_out), and after its copies.
#include <cuda_runtime.h>

#include "lz4_decode_ring.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lz4t_decode_dict_kernel(const uint8_t* __restrict__ comp,
                            const int32_t* __restrict__ clens,
                            const uint8_t* __restrict__ dict,
                            uint8_t* __restrict__ out,
                            int32_t* __restrict__ n_out,
                            bool* __restrict__ ok, int C, int D, int dlen,
                            int out_cap) {
  extern __shared__ __align__(16) uint32_t smem[];  // as K5's kernel's
  const int b = blockIdx.x;
  lz4t_ring_row<false>(comp + (size_t)b * C, C, clens[b], dict, D, dlen,
                       out + (size_t)b * out_cap, n_out + b, ok + b, out_cap,
                       reinterpret_cast<uint8_t*>(smem));
}
static_assert(32 * (1 + LZ4T_RING_WARPS) == kThreads,
              "K3: one parse warp and the copy warps");

// n words from src to dst by `threads` threads from thread t
__device__ __forceinline__ void lz4t_copy_words(
    uint32_t* __restrict__ dst, const uint32_t* __restrict__ src, int n, int t,
    int threads) {
#pragma unroll 8
  for (int i = t; i < n; i += threads) dst[i] = src[i];
}

// K5's emitter on the card: the parse kernel stores each sequence's
// copies as (ip, n_lit, off, m) for the copy kernel.
struct lz4t_seq_store {
  int4* e;
  int n;
  __host__ __device__ void operator()(int ip, int n_lit, int off, int m) {
#if defined(__CUDA_ARCH__)
    e[n++] = make_int4(ip, n_lit, off, m);
#endif
  }
};

// K5, launch 1: the parse of every record of the batch at once, one thread
// per record (a record's parse reads only its slice and meta), its slice
// read from device memory through L1.
__global__ void __launch_bounds__(32)
    lz4t_parse_records_kernel(const uint8_t* __restrict__ rows,
                              const int32_t* __restrict__ metas,
                              int4* __restrict__ seqs,
                              int32_t* __restrict__ n_seqs,
                              int32_t* __restrict__ n_outs,
                              bool* __restrict__ oks, int R, int CIN, int W,
                              int E) {
  const int rec = blockIdx.x * 32 + threadIdx.x;
  if (rec >= R) return;
  lz4t_seq_store st = {seqs + (size_t)rec * E, 0};
  int n, okv;
  lz4t_decode_record(rows + (size_t)rec * CIN, CIN, metas + (size_t)rec * 7,
                     W, st, &n, &okv);
  n_seqs[rec] = st.n;
  n_outs[rec] = n;
  oks[rec] = okv != 0;
}

// K5, launch 2: the copies, one thread block per large block, its records
// in order, all eight warps copying (lz4t_copy_record_lanes).
static_assert(LZ4T_COPY_WARPS * 32 == kThreads, "every warp copies");

__global__ void __launch_bounds__(kThreads)
    lz4t_copy_records_kernel(const uint8_t* __restrict__ rows,
                             const uint8_t* __restrict__ win0s,
                             const int4* __restrict__ seqs,
                             const int32_t* __restrict__ n_seqs,
                             uint8_t* __restrict__ outs, int K, int CIN,
                             int W, int E) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* cw = smem;
  // the two output buffers, buf(0) and buf(1), taken from smem directly so
  // that every access compiles to a shared-memory one
  auto buf = [&](int j) { return smem + CIN / 4 + j * (W / 4); };
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* c = reinterpret_cast<const uint8_t*>(cw);
  lz4t_copy_words(buf(0),
                  reinterpret_cast<const uint32_t*>(win0s + (size_t)b * W),
                  W / 4, t, kThreads);
  for (int k = 0; k < K; k++) {
    const size_t rec = (size_t)b * K + k;
    // stage the slice and zero the output buffer: it held record k-2's
    // output, written out while record k-1 was staged and read as its
    // window, both before the last barrier
    lz4t_copy_words(cw, reinterpret_cast<const uint32_t*>(rows + rec * CIN),
                    CIN / 4, t, kThreads);
    for (int i = t; i < W / 4; i += kThreads) buf((k + 1) & 1)[i] = 0;
    // record k-1's output, record k's window, read-only from here on
    if (k > 0)
      lz4t_copy_words(reinterpret_cast<uint32_t*>(outs + (rec - 1) * W),
                      buf(k & 1), W / 4, t, kThreads);
    __syncthreads();
    lz4t_copy_record_lanes(
        c, CIN, reinterpret_cast<uint8_t*>(buf((k + 1) & 1)),
        reinterpret_cast<const uint8_t*>(buf(k & 1)), W,
        reinterpret_cast<const int32_t*>(seqs + rec * E), n_seqs[rec], t >> 5);
    __syncthreads();
  }
  if (K > 0) {
    const size_t last = (size_t)b * K + K - 1;
    lz4t_copy_words(reinterpret_cast<uint32_t*>(outs + last * W), buf(K & 1),
                    W / 4, t, kThreads);
  }
}

}  // namespace

// comp (B, C) u8, clens (B,) i32, dict (D,) u8 right-aligned window with
// dlen usable bytes -> out (B, out_cap) u8 (bytes past n_out undefined),
// n_out (B,) i32, ok (B,) bool. C, D, out_cap multiples of 4. Returns a
// cudaError_t.
extern "C" int lz4t_launch_dict(const void* comp, const void* clens,
                                const void* dict, void* out, void* n_out,
                                void* ok, int B, int C, int D, int dlen,
                                int out_cap, void* stream) {
  const int smem = LZ4T_RING_SMEM + C + LZ4T_RING_PAD + D + out_cap;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_decode_dict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  lz4t_decode_dict_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)comp, (const int32_t*)clens, (const uint8_t*)dict,
      (uint8_t*)out, (int32_t*)n_out, (bool*)ok, C, D, dlen, out_cap);
  return cudaGetLastError();
}

// rows (B, K, CIN) u8 record input slices, metas (B, K, 7) i32, win0s
// (B, W) u8 right-aligned windows of record 0, seqs (B, K, W / 4 + 2) int4
// and n_seqs (B, K) i32 scratch -> outs (B, K, W) u8 (zero past n_out),
// n_outs (B, K) i32, oks (B, K) bool. CIN, W multiples of 4. Two launches,
// the parse and the copies. Returns a cudaError_t.
extern "C" int lz4t_launch_records(const void* rows, const void* metas,
                                   const void* win0s, void* outs,
                                   void* n_outs, void* oks, void* seqs,
                                   void* n_seqs, int B, int K, int CIN,
                                   int W, void* stream) {
  const int R = B * K, E = W / 4 + 2;
  cudaStream_t st = (cudaStream_t)stream;
  lz4t_parse_records_kernel<<<(R + 31) / 32, 32, 0, st>>>(
      (const uint8_t*)rows, (const int32_t*)metas, (int4*)seqs,
      (int32_t*)n_seqs, (int32_t*)n_outs, (bool*)oks, R, CIN, W, E);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = CIN + 2 * W;
  e = cudaFuncSetAttribute(lz4t_copy_records_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_copy_records_kernel<<<B, kThreads, smem, st>>>(
      (const uint8_t*)rows, (const uint8_t*)win0s, (const int4*)seqs,
      (const int32_t*)n_seqs, (uint8_t*)outs, K, CIN, W, E);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
