// K6b's row body: the warp-cooperative parse of K2a/K2b
// (lz4t_encode_row_lanes) or K2c (lz4t_encode_mid_row_lanes<2>), with
// the packed-word kernel's emit (kGuard = false: no room guard, every
// write clipped at OT - 1), feeding emit warps through a ring of sequences
// in shared memory.
//
// The parse warp hands each sequence (op, mip, mlen, off) to
// lz4t_wring_sink, which fills slot (k / 32) % LZ4T_WRING_BATCHES with
// sequences k of batch k / 32 and stores, per slot, the anchor of the
// batch's first sequence (the end of the sequence before it), so a batch
// can be written without its predecessor. On the card (lz4t_wring_emit)
// each slot has a full mbarrier (the parse's lane 0 arrives once the slot
// holds 32 sequences, or the row's last ones: fewer than 32, maybe 0,
// which ends the row) and an empty one (each of the LZ4T_WRING_WARPS emit
// warps arrives once it has written its sequences of the slot); the parse
// waits on a slot's empty barrier before it refills the slot. Emit warp wi
// writes the batch's sequences wi, wi + LZ4T_WRING_WARPS, ..., each with
// all 32 lanes over its output bytes (lz4t_wseq_lanes). The host build
// (lz4_host.cpp) runs the same parse, sink and emit, writing the oldest
// batch when the parse finds the ring full.
//
// Where the bytes agree with an emit that writes the sequences one after
// another (the Pallas kernel's, the plain version's): sequences tile the
// output, [op, op + lz4t_seq_bytes) each, so the order of the writes
// changes no byte below the clip. Where ok holds, total < n <= OT - 1 and no write
// was clipped; elsewhere only the clipped byte OT - 1 may differ, which no
// caller reads (total >= OT there).
#pragma once

#include "lz4_encode_mid.cuh"

#define LZ4T_WRING_BATCHES 16  // ring slots (a power of 2) of 32 sequences
#define LZ4T_WRING_WARPS 7     // emit warps: the block's other warps
// shared memory of the ring: 32 entries of 16 B, two mbarriers, a count
// and an anchor per slot
#define LZ4T_WRING_SMEM (LZ4T_WRING_BATCHES * (32 * 16 + 8 + 8 + 4 + 4))

// One sequence through the clipped emit (lz4t_emit_sequence's bytes, every
// write clipped at OT - 1), written by the 32 lanes of a warp, lane i
// taking output bytes op + i, op + i + 32, ...: its literals c[anchor,
// mip), then a match of mlen at offset off (mlen == 0: final literals).
LZ4T_HD void lz4t_wseq_lanes(const uint8_t* c, uint8_t* o, int OT,
                             int anchor, int op, int mip, int mlen, int off) {
  const int lit = mip - anchor;
  const int e1 = (int)((unsigned)(lit + 240) / 255u);  // literal length bytes
  const int e2 = mlen ? (int)((unsigned)(mlen + 236) / 255u) : 0;
  const int l0 = 1 + e1, m0 = l0 + lit;  // first literal, the offset
  const int nb = mlen ? m0 + 2 + e2 : m0;
  const int tok = lz4t_min(lit, 15) << 4 | (mlen ? lz4t_min(mlen - 4, 15) : 0);
  lz4t_lanes_out([&](int i) {
    for (int k = i; k < nb; k += LZ4T_LANES) {
      int v;
      if (k == 0)
        v = tok;
      else if (k < l0)
        v = k < e1 ? 255 : lit - 15 - 255 * (e1 - 1);
      else if (k < m0)
        v = c[anchor + k - l0];
      else if (k == m0)
        v = off & 255;
      else if (k == m0 + 1)
        v = off >> 8;
      else
        v = k < nb - 1 ? 255 : mlen - 19 - 255 * (e2 - 1);
      o[lz4t_min(op + k, OT - 1)] = (uint8_t)v;
    }
  });
}

// Warp wi's share of a batch: sequences wi, wi + NW, ... of the n entries
// e (four ints each: op, mip, mlen, off), the first one's anchor a0.
template <int NW>
LZ4T_HD void lz4t_wseq_batch(const uint8_t* c, uint8_t* o, int OT,
                             const int* e, int n, int a0, int wi) {
  for (int j = wi; j < n; j += NW) {
    const int* q = e + 4 * j;
    lz4t_wseq_lanes(c, o, OT, j ? q[-3] + q[-2] : a0, q[0], q[1], q[2], q[3]);
  }
}

#if defined(__CUDACC__)

// The parse's side of the ring (every lane of the parse warp calls it, as
// all of them wait for a free slot; lane 0 writes): sequence k goes to
// ring[k % (32 LZ4T_WRING_BATCHES)].
struct lz4t_wring_sink {
  static constexpr bool kAllLanes = true;
  int4* ring;
  int* cnt;
  int* anc;
  uint64_t* full;
  uint64_t* empty;
  int anchor;  // where the next sequence's literals start
  // batch b opens: wait until the emit warps have written the slot's last
  // round, and store the batch's first anchor
  __device__ void open(int b) {
    constexpr int NB = LZ4T_WRING_BATCHES;
    const int s = b & (NB - 1);
    if (b >= NB) lz4t_mbar_wait(&empty[s], (b / NB - 1) & 1);
    if (lz4t_lead()) anc[s] = anchor;
  }
  __device__ void publish(int b, int n) {
    const int s = b & (LZ4T_WRING_BATCHES - 1);
    if (lz4t_lead()) {
      cnt[s] = n;
      lz4t_mbar_arrive(&full[s]);
    }
  }
  LZ4T_HDM void operator()(int k, int op, int mip, int mlen, int mpos) {
#if defined(__CUDA_ARCH__)
    if (!(k & 31)) open(k >> 5);
    if (lz4t_lead())
      ring[k & (32 * LZ4T_WRING_BATCHES - 1)] =
          make_int4(op, mip, mlen, mip - mpos);
    anchor = mip + mlen;
    if ((k & 31) == 31) publish(k >> 5, 32);
#endif
  }
  // the row's last batch, after its k sequences: fewer than 32, maybe none
  __device__ void finish(int k) {
    if (!(k & 31)) open(k >> 5);
    publish(k >> 5, k & 31);
  }
};

// Emit warp wi (of LZ4T_WRING_WARPS) of a row: the batches in order, until
// one holds fewer than 32 sequences.
__device__ __forceinline__ void lz4t_wring_emit(
    const uint8_t* c, uint8_t* o, int OT, const int4* ring, const int* cnt,
    const int* anc, uint64_t* full, uint64_t* empty, int wi) {
  constexpr int NB = LZ4T_WRING_BATCHES;
  for (int b = 0;; b++) {
    const int s = b & (NB - 1);
    lz4t_mbar_wait(&full[s], (b / NB) & 1);
    const int n = cnt[s];
    lz4t_wseq_batch<LZ4T_WRING_WARPS>(
        c, o, OT, reinterpret_cast<const int*>(ring + 32 * s), n, anc[s], wi);
    __syncwarp();
    if (lz4t_lead()) lz4t_mbar_arrive(&empty[s]);
    if (n < 32) break;
  }
}

#endif  // __CUDACC__
