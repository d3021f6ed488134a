// Chain ("mid") LZ4 block encode of one row: the semantics of the Pallas
// kernel plz4_tpu/ops/encode_pallas.py:_encode_kernel_bw in mid mode
// (mid=True), depth 2 (device levels 3-7) or depth 4 (level 8, depth4=True).
// The row is [window | block | 8 zero bytes] as in lz4_encode.cuh: the block
// is [base, base + n), the usable window [first, base). Every decision that
// shapes the output bytes follows that kernel:
//   * hash (u32 * 2654435761) >> (32 - 13) and kDepth tables of 2^13 slots
//     holding position + 1 (0 = empty); an insert shifts the slot down
//     (t3 <- t2 <- t1 <- t0 <- p + 1), so a slot holds the kDepth most
//     recent positions of its bucket, newest first;
//   * the window preload inserts first, first + wstride, ... below base in
//     order (lz4t_mid_preload; the CUDA kernel builds the same tables in
//     kDepth parallel passes);
//   * the scan advances one byte at a time (no skip acceleration). At each
//     position it reads the kDepth candidates, shifts the slot and inserts
//     the position. A candidate c is valid when first <= c < sip,
//     sip - c <= 65535 and the word at c equals the word at sip; its score
//     is 1 + the equal words at +4 and +8 (the second only if the first
//     agrees). B replaces A when its score is higher, C when it beats both,
//     D when it beats the best so far: ties keep the more recent candidate;
//   * backward extension while mip > anchor, mpos > first and the bytes
//     agree, forward extension from 4 + back up to matchlimit = end - 5;
//   * after each match only position nip - 2 is inserted (with the shift);
//   * emit, room guard, overflow and ok exactly as lz4t_encode_row; with
//     kGuard = false the emit of the packed-word kernel _encode_kernel in mid
//     mode (K6b: depth 2 only, no room guard, writes clipped at OT - 1).
#pragma once

#include "lz4_encode.cuh"

#define LZ4T_MID_HASH_LOG 13

LZ4T_HD uint32_t lz4t_hash_mid(uint32_t u) {
  return (u * LZ4T_HASH_MUL) >> (32 - LZ4T_MID_HASH_LOG);
}

// The kDepth tables of one row; t2 and t3 are unused at depth 2. The CUDA
// kernel may hand over tables in shared or in global memory.
struct lz4t_mid_tabs {
  uint32_t* t0;
  uint32_t* t1;
  uint32_t* t2;
  uint32_t* t3;
};

template <int kDepth>
LZ4T_HD void lz4t_mid_insert(const lz4t_mid_tabs& t, uint32_t h, uint32_t v) {
  if (kDepth == 4) {
    t.t3[h] = t.t2[h];
    t.t2[h] = t.t1[h];
  }
  t.t1[h] = t.t0[h];
  t.t0[h] = v;
}

// The window preload, in order (the host build's; see the file comment).
template <int kDepth>
LZ4T_HD void lz4t_mid_preload(const uint8_t* c, int base, int first,
                              int wstride, const lz4t_mid_tabs& t) {
  for (int p = first; p < base; p += wstride)
    lz4t_mid_insert<kDepth>(t, lz4t_hash_mid(lz4t_rd32(c, p)),
                            (uint32_t)(p + 1));
}

// Score of candidate cd for the word u at sip: 0 when invalid, else 1 plus
// the equal words at +4 and +8 (reads clipped at clip = DT - 4).
LZ4T_HD int lz4t_mid_score(const uint8_t* c, int clip, int first, int sip,
                           uint32_t u, int cd) {
  if (cd < first || cd >= sip || sip - cd > LZ4T_MAX_DISTANCE ||
      lz4t_rd32(c, lz4t_min(cd, clip)) != u)
    return 0;
  if (lz4t_rd32(c, lz4t_min(cd + 4, clip)) !=
      lz4t_rd32(c, lz4t_min(sip + 4, clip)))
    return 1;
  if (lz4t_rd32(c, lz4t_min(cd + 8, clip)) !=
      lz4t_rd32(c, lz4t_min(sip + 8, clip)))
    return 2;
  return 3;
}

// c: the row, DT = base + N + 8 bytes (n block bytes at base, zero after
// the block's N); o: OT = CAP output bytes; t: kDepth 2^13-entry tables,
// zeroed and then preloaded with the window by the caller.
template <int kDepth, bool kGuard = true>
LZ4T_HD void lz4t_encode_mid_row(const uint8_t* c, int DT, int base,
                                 int first, int n, uint8_t* o, int OT,
                                 const lz4t_mid_tabs& t, int* total_out,
                                 int* ok_out) {
  const int end = base + n;
  const int mflimit = end - 12;
  const int matchlimit = end - 5;
  const int out_limit = OT - 16;
  const int clip = DT - 4;
  int ip = base, anchor = base, op = 0;
  int overflow = n < 0;
  while (ip <= mflimit && !overflow) {
    // search: the next position with a valid candidate (sip <= mflimit, so
    // no read of the scan clips)
    int sip = ip, found = 0, cand = 0;
    while (!found && sip <= mflimit) {
      const uint32_t u = lz4t_rd32(c, sip);
      const uint32_t h = lz4t_hash_mid(u);
      const int ca = (int)t.t0[h] - 1;
      const int cb = (int)t.t1[h] - 1;
      int cc = -1, cd = -1;
      if (kDepth == 4) {
        cc = (int)t.t2[h] - 1;
        cd = (int)t.t3[h] - 1;
      }
      lz4t_mid_insert<kDepth>(t, h, (uint32_t)(sip + 1));
      const int la = lz4t_mid_score(c, clip, first, sip, u, ca);
      const int lb = lz4t_mid_score(c, clip, first, sip, u, cb);
      int best = la, pick = ca;
      if (lb > la) {
        best = lb;
        pick = cb;
      }
      if (kDepth == 4) {
        const int lc = lz4t_mid_score(c, clip, first, sip, u, cc);
        if (lc > best) {
          best = lc;
          pick = cc;
        }
        const int ld = lz4t_mid_score(c, clip, first, sip, u, cd);
        if (ld > best) {
          best = ld;
          pick = cd;
        }
      }
      found = best > 0;
      cand = pick;
      if (!found) sip++;
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
    lz4t_mid_insert<kDepth>(
        t, lz4t_hash_mid(lz4t_rd32(c, lz4t_min(nip - 2, clip))),
        (uint32_t)(nip - 1));
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
