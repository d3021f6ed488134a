// Deep hash-chain LZ4 block encode of one row with lazy matching (device
// levels 9-12): the semantics of the Pallas kernel
// plz4_tpu/ops/encode_pallas.py:_encode_kernel_deep at its defaults
// (suff 0, ins_step 1, no second probe byte, lazy_cap 64). The row is
// [window | block | 8 zero bytes] as in lz4_encode.cuh. Every decision
// that shapes the output bytes follows that kernel:
//   * hash (u32 * 2654435761) >> (32 - hash_log), a zeroed head table of
//     2^hash_log slots holding the newest position + 1 of each bucket, and
//     a chain with one link per row position: chain[p] = the head of p's
//     bucket when p was inserted;
//   * the window preload inserts EVERY position first .. base - 1 in order
//     (the deep tier has no preload stride);
//   * the scan inserts each position, then walks its chain for a match
//     longer than 3 and stops at the first position that has one;
//   * a walk from p starts at chain[p], follows at most `tries` links while
//     the candidate lies at or above lo = max(first, p - 65535), probes one
//     byte at the current best length, and only on a hit extends from byte
//     0 while p + l < matchlimit; a candidate is taken when l > best;
//   * lazy matching: while mip + 1 <= mflimit and the best length is below
//     64, insert mip + 1 and walk it for a strictly longer match; move
//     there if it has one, else stop. hi is the last probed position + 1;
//   * backward extension after the lazy loop (mlen grows by the same);
//   * after the emit, positions [hi, min(nip, mflimit + 1)) are inserted;
//   * emit, room guard, overflow and ok exactly as lz4t_encode_row.
//
// The Pallas kernel has a second chain storage for window rows: u16 deltas
// to the previous position, 0 ending the chain (a delta over 65535, or no
// previous position). It follows the same links: where a delta would
// overflow, the previous position lies below cand - 65535 < p - 65535 <= lo
// and the i32 walk stops there too. So one chain of u32 links serves both
// variants; only hash_log differs. The chain needs no zeroing: a walk only
// follows positions that were inserted, and inserting p writes chain[p].
#pragma once

#include "lz4_encode.cuh"

#define LZ4T_DEEP_LAZY_CAP 64
#define LZ4T_DEEP_MIN_MATCH 4

LZ4T_HD void lz4t_deep_insert(const uint8_t* c, int p, int hash_log,
                              uint32_t* head, uint32_t* chain) {
  const uint32_t h = (lz4t_rd32(c, p) * LZ4T_HASH_MUL) >> (32 - hash_log);
  chain[p] = head[h];
  head[h] = (uint32_t)(p + 1);
}

// Walk p's chain (p already inserted) for a match longer than min_len that
// ends before matchlimit. Returns the best length (min_len when none was
// found) and sets *best_pos (-1 when none).
LZ4T_HD int lz4t_deep_walk(const uint8_t* c, int p, int min_len, int first,
                           int matchlimit, int tries, const uint32_t* chain,
                           int* best_pos) {
  const int lo = lz4t_max(first, p - LZ4T_MAX_DISTANCE);
  int cand = (int)chain[p] - 1, bl = min_len, bp = -1;
  for (int t = 0; cand >= lo && t < tries; t++) {
    if (c[cand + bl] == c[p + bl]) {
      int l = 0;
      while (p + l < matchlimit && c[cand + l] == c[p + l]) l++;
      if (l > bl) {
        bl = l;
        bp = cand;
      }
    }
    cand = (int)chain[cand] - 1;
  }
  *best_pos = bp;
  return bl;
}

// c: the row, base + N + 8 bytes (n block bytes at base, zero after the
// block's N); o: OT = CAP output bytes; head: 2^hash_log entries, zeroed by
// the caller; chain: one entry per row byte (unzeroed). The window preload
// runs here.
LZ4T_HD void lz4t_encode_deep_row(const uint8_t* c, int base, int first,
                                  int n, uint8_t* o, int OT, int tries,
                                  int hash_log, uint32_t* head,
                                  uint32_t* chain, int* total_out,
                                  int* ok_out) {
  const int end = base + n;
  const int mflimit = end - 12;
  const int matchlimit = end - 5;
  const int out_limit = OT - 16;
  for (int p = first; p < base; p++)
    lz4t_deep_insert(c, p, hash_log, head, chain);
  int ip = base, anchor = base, op = 0;
  int overflow = n < 0;
  while (ip <= mflimit && !overflow) {
    int sip = ip, found = 0, bl = 0, bp = -1;
    while (!found && sip <= mflimit) {
      lz4t_deep_insert(c, sip, hash_log, head, chain);
      bl = lz4t_deep_walk(c, sip, LZ4T_DEEP_MIN_MATCH - 1, first, matchlimit,
                          tries, chain, &bp);
      found = bl >= LZ4T_DEEP_MIN_MATCH;
      if (!found) sip++;
    }
    if (!found) {
      ip = sip;
      continue;
    }
    // lazy: absorb a byte into the literals while the next position holds
    // a strictly longer match
    int mip = sip, mlen = bl, mpos = bp, hi = sip + 1;
    while (mip + 1 <= mflimit && mlen < LZ4T_DEEP_LAZY_CAP) {
      const int p2 = mip + 1;
      lz4t_deep_insert(c, p2, hash_log, head, chain);
      int q2;
      const int l2 = lz4t_deep_walk(c, p2, mlen, first, matchlimit, tries,
                                    chain, &q2);
      hi = p2 + 1;
      if (l2 <= mlen) break;
      mip = p2;
      mlen = l2;
      mpos = q2;
    }
    while (mip > anchor && mpos > first && c[mip - 1] == c[mpos - 1]) {
      mip--;
      mpos--;
      mlen++;
    }
    const int op2 = lz4t_emit_sequence(c, o, OT, op, anchor, mip, mpos, mlen);
    const int nip = mip + mlen;
    const int ins_lim = lz4t_min(nip, mflimit + 1);
    for (int p = hi; p < ins_lim; p++)
      lz4t_deep_insert(c, p, hash_log, head, chain);
    ip = nip;
    anchor = nip;
    op = op2;
    overflow = op2 > out_limit;
  }
  const int rest = end - anchor;
  if (overflow || op + rest + rest / 255 + 16 > OT)
    op = OT;
  else
    op = lz4t_emit_sequence(c, o, OT, op, anchor, end, 0, 0);
  *total_out = op;
  *ok_out = (op < n) && !overflow;
}
