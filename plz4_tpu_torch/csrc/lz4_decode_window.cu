// K3 and K5: LZ4 decode against a right-aligned window, one thread block
// per row (K3) or per large block (K5). The row body is
// lz4t_decode_window_row (lz4_decode_window.cuh).
//
// K3 replaces the Pallas TPU kernel plz4_tpu/ops/decode_pallas.py:
// _decode_dict_kernel with strict=True (decode_block_pallas_dict, batched
// by plz4_tpu/parallel/batch.py:_decode_batch_dict_pallas): whole blocks of
// a dictionary frame against the frame's dictionary.
// K5 replaces _decode_kernel_bw_rec (_decode_record, scanned over a block's
// records by decode_chunks_pallas / decode_chunks_batch_pallas), and with
// it _decode_dict_kernel with strict=False (K6c), the same function that
// _decode_record falls back to for shapes over the TPU's SMEM budget: the
// records of a large block, in order, each against the previous record's
// output (the first against the frame dictionary).
//
// What bounds them on this card: the sequence loop is serial and data
// dependent, so both are bound by the latency of one thread's dependent
// shared-memory accesses, not by bytes. K5 is also serial across a block's
// records (record k's window is record k-1's output), so a batch runs only
// as many thread blocks as it has large blocks.
// What the design does about it: everything the loop touches lives in
// shared memory. K3 stages the compressed row, the dictionary and the
// output row (65,552 + 65,536 + 65,536 B at 64 KiB blocks); thread 0
// decodes and then all 256 threads write the n_out bytes out. K5 keeps the
// record's input slice and two output buffers used in turn (83,968 +
// 2 x 65,536 B): the buffer that holds record k-1's output is record k's
// window, so no window is ever copied. While thread 0 decodes nothing else
// runs; between records the block's threads write the finished record out,
// stage the next slice and zero the next output buffer together.
#include <cuda_runtime.h>

#include "lz4_decode_window.cuh"

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
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_n;
  uint32_t* cw = smem;
  uint32_t* dw = smem + C / 4;
  uint32_t* ow = dw + D / 4;
  const int b = blockIdx.x;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(comp + (size_t)b * C);
  const uint32_t* dsrc = reinterpret_cast<const uint32_t*>(dict);
  for (int i = threadIdx.x; i < C / 4; i += blockDim.x) cw[i] = src[i];
  for (int i = threadIdx.x; i < D / 4; i += blockDim.x) dw[i] = dsrc[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    const int32_t meta[7] = {clens[b], dlen, 0, 0, 0, 0, out_cap};
    int n, okv;
    lz4t_decode_window_row<true>(
        reinterpret_cast<const uint8_t*>(cw), C, meta,
        reinterpret_cast<const uint8_t*>(dw), D,
        reinterpret_cast<uint8_t*>(ow), out_cap, &n, &okv);
    n_out[b] = n;
    ok[b] = okv != 0;
    s_n = n;
  }
  __syncthreads();
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)b * out_cap);
  const int words = (s_n + 3) / 4;  // s_n <= out_cap, out_cap % 4 == 0
  for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = ow[i];
}

__global__ void __launch_bounds__(kThreads)
    lz4t_decode_records_kernel(const uint8_t* __restrict__ rows,
                               const int32_t* __restrict__ metas,
                               const uint8_t* __restrict__ win0s,
                               uint8_t* __restrict__ outs,
                               int32_t* __restrict__ n_outs,
                               bool* __restrict__ oks, int K, int CIN,
                               int W) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* cw = smem;
  uint32_t* buf[2] = {smem + CIN / 4, smem + CIN / 4 + W / 4};
  const int b = blockIdx.x;
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(win0s + (size_t)b * W);
  for (int i = threadIdx.x; i < W / 4; i += blockDim.x) buf[0][i] = w0[i];
  for (int k = 0; k < K; k++) {
    const size_t rec = (size_t)b * K + k;
    uint32_t* win = buf[k & 1];
    uint32_t* ob = buf[(k + 1) & 1];
    // stage the slice and zero the output buffer: it held record k-2's
    // output, written out and then read as record k-1's window, both
    // before the last barrier
    const uint32_t* src = reinterpret_cast<const uint32_t*>(rows + rec * CIN);
    for (int i = threadIdx.x; i < CIN / 4; i += blockDim.x) cw[i] = src[i];
    for (int i = threadIdx.x; i < W / 4; i += blockDim.x) ob[i] = 0;
    __syncthreads();
    if (threadIdx.x == 0) {
      int n, okv;
      lz4t_decode_window_row<false>(
          reinterpret_cast<const uint8_t*>(cw), CIN, metas + rec * 7,
          reinterpret_cast<const uint8_t*>(win), W,
          reinterpret_cast<uint8_t*>(ob), W, &n, &okv);
      n_outs[rec] = n;
      oks[rec] = okv != 0;
    }
    __syncthreads();
    // the next iteration only rewrites cw and win, never ob
    uint32_t* dst = reinterpret_cast<uint32_t*>(outs + rec * W);
    for (int i = threadIdx.x; i < W / 4; i += blockDim.x) dst[i] = ob[i];
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
  const int smem = C + D + out_cap;
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
// (B, W) u8 right-aligned windows of record 0 -> outs (B, K, W) u8 (zero
// past n_out), n_outs (B, K) i32, oks (B, K) bool. CIN, W multiples of 4.
// Returns a cudaError_t.
extern "C" int lz4t_launch_records(const void* rows, const void* metas,
                                   const void* win0s, void* outs,
                                   void* n_outs, void* oks, int B, int K,
                                   int CIN, int W, void* stream) {
  const int smem = CIN + 2 * W;
  cudaError_t e = cudaFuncSetAttribute(
      lz4t_decode_records_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  lz4t_decode_records_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)rows, (const int32_t*)metas, (const uint8_t*)win0s,
      (uint8_t*)outs, (int32_t*)n_outs, (bool*)oks, K, CIN, W);
  return cudaGetLastError();
}

extern "C" const char* lz4t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
