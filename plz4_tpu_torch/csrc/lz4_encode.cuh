// Greedy LZ4 block encode of one row: the semantics of the Pallas kernel
// plz4_tpu/ops/encode_pallas.py:_encode_kernel_bw in greedy mode
// (mid=False). The row is [window | block | 8 zero bytes]: the block is
// [base, base + n) and the usable window [first, base), meta = [n, base,
// first] in the Pallas kernel. K2a (plain blocks) is base = first = 0; K2b
// (linked and dictionary blocks, large-block chunks) has a window of D
// bytes, base = D and first = D - dlen. Every decision that shapes the
// output bytes follows that kernel:
//   * hash (u32 * 2654435761) >> 18 and a 2^14 position table
//     tab[h] = pos+1; a candidate is valid when it exists, lies at or above
//     first and within 65535 bytes, and its stored word equals the current
//     one (the bytes themselves are not compared again);
//   * the window preload (lz4t_window_preload) seeds every wstride-th
//     window position before the parse;
//   * skip step cnt >> 6, cnt restarting at 0 for every search;
//   * backward extension while ip > anchor, cand > first and the bytes
//     agree, forward extension from 4 + back up to matchlimit = end - 5;
//   * after each match only position nip - 2 is inserted;
//   * the room guard op + lit + (lit>>8) + (mlen>>8) + 32 <= OT (else the
//     emit is skipped and op = OT), overflow at op > OT - 16, the final
//     literals guard, and ok = (op < n) && !overflow.
// OT is the output row width CAP, computed from the block width N alone.
// The TPU kernel's 8-wide wild literal copies only write bytes past the
// stream that later emits overwrite; the copies here are exact, which
// gives the same bytes [0, total).
//
// kGuard = false is the emit of the packed-word Pallas kernel
// encode_pallas.py:_encode_kernel (K6b, rows too wide for the byte-wide
// kernel): no room guard before a sequence, every write clipped at OT - 1,
// and the same overflow test after it. The two emits agree on ok: a
// sequence that trips the room guard (op + lit + (lit >> 8) + (mlen >> 8)
// + 32 > OT) still writes at least lit + (lit >> 8) + (mlen >> 8) + 1
// bytes, so it ends at op > OT - 32 > n and ok is false either way; total
// may then differ.
//
// The stored word of a slot. The Pallas kernel keeps it in a second table
// (vtab[h] = u beside tab[h] = p + 1). Every stored p lies below the clip
// (p <= mflimit, p <= nip - 2 or p < base) and the row never changes, so
// vtab[h] always equals the word at tab[h] - 1: kVtab = false re-reads it
// there instead, which halves the tables' shared memory (K2b needs that).
#pragma once

#include "lz4_common.cuh"

// little-endian word at byte p of the row
LZ4T_HD uint32_t lz4t_rd32(const uint8_t* c, int p) {
  return (uint32_t)c[p] | ((uint32_t)c[p + 1] << 8) |
         ((uint32_t)c[p + 2] << 16) | ((uint32_t)c[p + 3] << 24);
}

LZ4T_HD uint32_t lz4t_hash(uint32_t u) {
  return (u * LZ4T_HASH_MUL) >> (32 - LZ4T_HASH_LOG);
}

// The window preload (the reference's LZ4_loadDict analog): positions
// first, first + wstride, ... below base enter the table in order, so each
// slot ends up holding the largest of its positions. The CUDA kernel
// computes the same table with atomicMax over parallel threads.
LZ4T_HD void lz4t_window_preload(const uint8_t* c, int base, int first,
                                 int wstride, uint32_t* tab) {
  for (int p = first; p < base; p += wstride)
    tab[lz4t_hash(lz4t_rd32(c, p))] = (uint32_t)(p + 1);
}

// The first usable window byte of row r of a window launch whose rows hold
// the last Dc bytes of their windows (0 without a window).
LZ4T_HD int lz4t_window_first(const int32_t* wlens, int r, int Dc) {
  return Dc ? Dc - lz4t_min(lz4t_max(wlens[r], 0), Dc) : 0;
}

#if defined(__CUDACC__)
// The thread block stages row r of a window launch into shared memory as
// [the last Dc bytes of its D-byte window | block N | 8 zero bytes]: row r
// takes row r - 1 as its window when r % K > 0 (the previous chunk of the
// same large block, read in place), else win[r / K]. The caller
// synchronises.
__device__ __forceinline__ void lz4t_stage_row(uint32_t* roww,
                                               const uint8_t* data,
                                               const uint8_t* win, int r,
                                               int N, int D, int K, int Dc) {
  if (Dc) {
    const uint8_t* w =
        r % K ? data + (size_t)(r - 1) * N : win + (size_t)(r / K) * D;
    const uint32_t* wsrc = reinterpret_cast<const uint32_t*>(w + (D - Dc));
    for (int i = threadIdx.x; i < Dc / 4; i += blockDim.x) roww[i] = wsrc[i];
  }
  const uint32_t* bsrc =
      reinterpret_cast<const uint32_t*>(data + (size_t)r * N);
  for (int i = threadIdx.x; i < N / 4; i += blockDim.x)
    roww[Dc / 4 + i] = bsrc[i];
  if (threadIdx.x < 2) roww[(Dc + N) / 4 + threadIdx.x] = 0;
}
#endif

LZ4T_HD int lz4t_emit_len_ext(uint8_t* o, int p, int v) {
  while (v >= 255) {
    o[p++] = 255;
    v -= 255;
  }
  o[p++] = (uint8_t)v;
  return p;
}

// Literals [anchor, ip) then a match (mpos, mlen); mlen == 0 emits final
// literals. Returns the new output position, or OT when the room guard
// refuses the sequence.
LZ4T_HD int lz4t_emit_sequence(const uint8_t* c, uint8_t* o, int OT, int op,
                               int anchor, int ip, int mpos, int mlen) {
  const int lit = ip - anchor;
  if (op + lit + (lit >> 8) + (mlen >> 8) + 32 > OT) return OT;
  const int tok = op;
  int q = op + 1;
  if (lit >= 15) q = lz4t_emit_len_ext(o, q, lit - 15);
  for (int i = 0; i < lit; i++) o[q + i] = c[anchor + i];
  q += lit;
  if (mlen > 0) {
    const int off = ip - mpos;
    o[q] = (uint8_t)(off & 255);
    o[q + 1] = (uint8_t)(off >> 8);
    q += 2;
    const int mv = mlen - 4;
    if (mv >= 15) q = lz4t_emit_len_ext(o, q, mv - 15);
    o[tok] = (uint8_t)((lz4t_min(lit, 15) << 4) | lz4t_min(mv, 15));
    return q;
  }
  o[tok] = (uint8_t)(lz4t_min(lit, 15) << 4);
  return q;
}

LZ4T_HD void lz4t_put(uint8_t* o, int OT, int p, int v) {
  o[lz4t_min(p, OT - 1)] = (uint8_t)v;
}

LZ4T_HD int lz4t_emit_len_ext_clipped(uint8_t* o, int OT, int p, int v) {
  for (; v >= 255; v -= 255) lz4t_put(o, OT, p++, 255);
  lz4t_put(o, OT, p++, v);
  return p;
}

// K6b's emit (see the file comment): the sequence of lz4t_emit_sequence
// without the room guard, every write clipped at OT - 1. The literals move
// 16 bytes at a time, loads before stores, since the wide kernel's row and
// output live in device memory.
LZ4T_HD int lz4t_emit_sequence_clipped(const uint8_t* c, uint8_t* o, int OT,
                                       int op, int anchor, int ip, int mpos,
                                       int mlen) {
  const int lit = ip - anchor;
  int q = op + 1;
  if (lit >= 15) q = lz4t_emit_len_ext_clipped(o, OT, q, lit - 15);
  for (int i = 0; i < lit; i += 16) {
    uint8_t t[16];
#pragma unroll
    for (int j = 0; j < 16; j++) t[j] = i + j < lit ? c[anchor + i + j] : 0;
#pragma unroll
    for (int j = 0; j < 16; j++)
      if (i + j < lit) lz4t_put(o, OT, q + i + j, t[j]);
  }
  q += lit;
  int tok = lz4t_min(lit, 15) << 4;
  if (mlen > 0) {
    const int off = ip - mpos;
    lz4t_put(o, OT, q, off & 255);
    lz4t_put(o, OT, q + 1, off >> 8);
    q += 2;
    const int mv = mlen - 4;
    if (mv >= 15) q = lz4t_emit_len_ext_clipped(o, OT, q, mv - 15);
    tok |= lz4t_min(mv, 15);
  }
  lz4t_put(o, OT, op, tok);
  return q;
}

template <bool kGuard>
LZ4T_HD int lz4t_emit(const uint8_t* c, uint8_t* o, int OT, int op,
                      int anchor, int ip, int mpos, int mlen) {
  if constexpr (kGuard)
    return lz4t_emit_sequence(c, o, OT, op, anchor, ip, mpos, mlen);
  else
    return lz4t_emit_sequence_clipped(c, o, OT, op, anchor, ip, mpos, mlen);
}

// c: the row, DT = base + N + 8 bytes (n block bytes at base, zero after
// the block's N); o: OT = CAP output bytes; tab (and vtab when kVtab):
// 2^14 entries, zeroed and then preloaded with the window by the caller.
template <bool kVtab, bool kGuard = true>
LZ4T_HD void lz4t_encode_row(const uint8_t* c, int DT, int base, int first,
                             int n, uint8_t* o, int OT, uint32_t* tab,
                             uint32_t* vtab, int* total_out, int* ok_out) {
  const int end = base + n;
  const int mflimit = end - 12;
  const int matchlimit = end - 5;
  const int out_limit = OT - 16;
  const int clip = DT - 4;
  int ip = base, anchor = base, op = 0;
  int overflow = n < 0;
  while (ip <= mflimit && !overflow) {
    // search: the next position whose hash slot holds a valid candidate
    int sip = ip, cnt = 0, found = 0, cand = 0;
    uint32_t u = lz4t_rd32(c, lz4t_min(sip, clip));
    while (!found && sip <= mflimit) {
      const uint32_t h = lz4t_hash(u);
      const int cd = (int)tab[h] - 1;
      const int live = cd >= first;
      uint32_t cval = 0;
      if (kVtab) {
        cval = vtab[h];
        vtab[h] = u;
      } else if (live) {
        cval = lz4t_rd32(c, cd);
      }
      tab[h] = (uint32_t)(sip + 1);
      found = live && sip - cd <= LZ4T_MAX_DISTANCE && cval == u;
      cand = cd;
      if (!found) {
        sip += 1 + (cnt >> LZ4T_SKIP_STRENGTH);
        u = lz4t_rd32(c, lz4t_min(sip, clip));
      }
      cnt++;
    }
    if (!found) {
      ip = sip;
      continue;
    }
    int mip = sip, mpos = cand, back = 0;
    while (mip > anchor && mpos > first && c[mip - 1] == c[mpos - 1]) {
      mip--;
      mpos--;
      back++;
    }
    int mlen = 4 + back;
    while (mip + mlen < matchlimit && c[mip + mlen] == c[mpos + mlen]) mlen++;
    const int op2 =
        lz4t_emit<kGuard>(c, o, OT, op, anchor, mip, mpos, mlen);
    const int nip = mip + mlen;
    const uint32_t u2 = lz4t_rd32(c, lz4t_min(nip - 2, clip));
    const uint32_t h2 = lz4t_hash(u2);
    if (kVtab) vtab[h2] = u2;
    tab[h2] = (uint32_t)(nip - 1);
    ip = nip;
    anchor = nip;
    op = op2;
    overflow = op2 > out_limit;
  }
  const int rest = end - anchor;
  if (overflow || op + rest + rest / 255 + 16 > OT)
    op = OT;
  else
    op = lz4t_emit<kGuard>(c, o, OT, op, anchor, end, 0, 0);
  *total_out = op;
  *ok_out = (op < n) && !overflow;
}
