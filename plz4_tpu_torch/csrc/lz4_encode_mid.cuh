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
//   * emit, room guard, overflow and ok exactly as K2a's (lz4_encode.cuh);
//     with kGuard = false the emit of the packed-word kernel _encode_kernel
//     in mid mode (K6b: depth 2 only, no room guard, writes clipped at
//     OT - 1).
//
// K2c, K2d and K6b run the parse on the 32 lanes of one warp
// (lz4t_encode_mid_row_lanes). The plain version, encode_row_mid_plain
// (plz4_tpu_torch/ops/encode_mid.py), is the serial scan over Python
// bytes, one position at a time; the CPU tests hold the host build of the
// lanes' body to it. The lanes' body gives the serial scan's bytes
// because, in mid mode, positions enter the tables
// exactly once each and in increasing order: the window preload inserts
// first, first + wstride, ... below base; the scan inserts each scanned
// sip before it scores it; after a match only nip - 2 is inserted, where
// nip - 2 >= sip + 2 for the sip that found the match (mlen >= 4 + back),
// and the next scan starts at nip. So at sip the candidates are the
// kDepth newest inserted positions of sip's bucket below sip, newest
// first.
//
// A scan step takes kPos = 32 / kDepth positions ip .. ip + kPos - 1
// (those past mflimit sit out), kDepth lanes each. If positions 0 .. k - 1
// find nothing, the serial scan has inserted all of them when it reaches
// position k, so k's candidates are the positions below it in the step
// that share its bucket (__match_any_sync on the hash), newest first, and
// then its slot's entries as they stood at the step's start, kDepth in
// all. Lane j of position k takes entry j of that list and scores it by
// the rules above; the position's best is its highest score, a tie
// going to the lowest j (the newer candidate), and the first position with
// a valid entry (a ballot) is the sip the serial scan stops at, with the
// same candidate. The step inserts positions 0 .. f, f that position, or
// all of them when none found one: for each bucket its newest inserted
// position writes the slot as itself followed by its list's first kDepth
// - 1 entries, lane j writing table j, after every lane has read
// (__syncwarp). The post-match insert of nip - 2 is lane 0's, before the
// next step reads.
//
// Each lane also reads what its entry's words say of the extension: one
// byte backward, and the forward length from sip + 4 where the words at +4
// and +8 show a mismatch. Past those, backward extension compares 32 byte
// pairs per step and forward extension 32 word pairs (128 bytes), each
// taking the ballot's first mismatch, matchlimit or anchor / first: the
// serial loops' lengths. The parse emits nothing: it keeps the output
// position op by the emit's arithmetic (room guard, overflow and the
// final literals as set out above) and hands each
// sequence with its op to a sink: K2c and K2d store them and
// lz4t_seq_emit (lz4_encode.cuh) writes them afterwards, all at once,
// wherever the row's total is below the overflow sentinel OT (ok or not:
// the large-block path stitches a chunk that did not shrink); K6b's emit
// warps write them from a ring while the parse goes on. The
// words come from the u32-aligned row by aligned loads and funnel shifts;
// a word read at DT - 4 reads one word past the row, which its shift
// drops.
#pragma once

#include "lz4_encode.cuh"

#define LZ4T_MID_HASH_LOG 13
#define LZ4T_MID_TAB (1 << LZ4T_MID_HASH_LOG)

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

// ---------------------------------------------------------------------------
// the parse on the 32 lanes of a warp (K2c, K2d; see the file comment)
// ---------------------------------------------------------------------------

// slot entry j's table (j < kDepth)
template <int kDepth>
LZ4T_HD uint32_t* lz4t_mid_tab(const lz4t_mid_tabs& t, int j) {
  return j == 0 ? t.t0 : j == 1 || kDepth == 2 ? t.t1 : j == 2 ? t.t2 : t.t3;
}

// entry j of bucket h's slot: its position, -1 when empty
template <int kDepth>
LZ4T_HD void lz4t_mid_slot(const lz4t_mid_tabs& t, uint32_t h, int* s) {
  for (int j = 0; j < kDepth; j++)
    s[j] = (int)lz4t_mid_tab<kDepth>(t, j)[h] - 1;
}

// bucket h's slot after inserting p in front of the entries e
template <int kDepth>
LZ4T_HD void lz4t_mid_put(const lz4t_mid_tabs& t, uint32_t h, int p,
                          const int* e) {
  for (int j = kDepth - 1; j > 0; j--)
    lz4t_mid_tab<kDepth>(t, j)[h] = (uint32_t)(e[j - 1] + 1);
  t.t0[h] = (uint32_t)(p + 1);
}

// The score of candidate cd for the words u at sip (0 when invalid, else 1
// plus the equal words at +4 and +8, the second only if the first agrees),
// from one read of the three words x at cd. A live lane's words and a
// valid candidate's lie below the clip (cd < sip <= mflimit = end - 12 and
// clip >= end + 4), so no read that decides a score clips; other reads are
// moved below the clip and decide nothing.
LZ4T_HD int lz4t_mid_score3(const uint32_t* w, int clip, int first, int sip,
                            const uint32_t* u, int cd, uint32_t* x) {
  lz4t_rd32w3(w, lz4t_min(lz4t_max(cd, 0), clip - 8), x);
  const int valid = (cd >= first) & (cd < sip) &
                    (sip - cd <= LZ4T_MAX_DISTANCE) & (x[0] == u[0]);
  const int m4 = x[1] == u[1];
  return valid ? 1 + m4 + (m4 & (x[2] == u[2])) : 0;
}

// the lane's key: its hash, or one no other lane has when it sits out
LZ4T_HD uint32_t lz4t_mid_key(uint32_t u, int live, int lane) {
  return live ? lz4t_hash_mid(u) : 0x80000000u | (uint32_t)lane;
}

// The parse of one row by the 32 lanes of a warp: w, the row as u32
// words, DT = base + N + 8 bytes plus the word after them (n block bytes
// at base, zero after the block's N); OT = CAP output bytes; t: kDepth
// 2^13-entry tables, zeroed and preloaded with the window. The sink gets
// each sequence k that the emit writes (kGuard = false: every one) as
// sink(k, op, mip, mlen, mpos), in order, op the output position where
// the emit writes it, the final literals last as (op, end, 0, end), from
// lane 0 (from every lane where Sink::kAllLanes). Returns their count.
template <int kDepth, bool kGuard = true, class Sink>
LZ4T_HD int lz4t_encode_mid_row_lanes(const uint32_t* w, int DT, int base,
                                      int first, int n, int OT,
                                      const lz4t_mid_tabs& t, Sink& sink,
                                      int* total_out, int* ok_out) {
  const uint8_t* c = reinterpret_cast<const uint8_t*>(w);
  const int end = base + n;
  const int mflimit = end - 12;
  const int matchlimit = end - 5;
  const int out_limit = OT - 16;
  const int clip = DT - 4;
  const bool put = Sink::kAllLanes || lz4t_lead();
  int ip = base, anchor = base, op = 0, nseq = 0;
  int overflow = n < 0;
  // a scan step takes kPos positions, kDepth lanes each: lane i scores
  // entry i % kDepth of position i / kDepth's candidate list
  constexpr int kPos = LZ4T_LANES / kDepth;
  constexpr uint32_t kLead = kDepth == 2 ? 0x55555555u : 0x11111111u;
  while (ip <= mflimit && !overflow) {
    uint32_t u[LZ4T_NL][3], key[LZ4T_NL], peers[LZ4T_NL];
    int sl[LZ4T_NL], pe[LZ4T_NL], src[LZ4T_NL], e[LZ4T_NL], rank[LZ4T_NL],
        more[LZ4T_NL], tmp[LZ4T_NL], pick[LZ4T_NL];
    // the position's words and hash, and the lane's slot entry
    lz4t_lanes([&](int i) {
      const int l = lz4t_li(i), q = i / kDepth, p = ip + q;
      lz4t_rd32w3(w, lz4t_min(p, clip - 8), u[l]);
      key[l] = lz4t_mid_key(u[l][0], p <= mflimit, q);
      sl[l] = (int)lz4t_mid_tab<kDepth>(t, i % kDepth)[key[l] &
                                                       (LZ4T_MID_TAB - 1)] -
              1;
    });
    lz4t_match_any(key, peers);
    // list entry j: the j-th newest lower position of the bucket, else
    // slot entry j - np (read by lane q * kDepth + j - np)
    lz4t_lanes_out([&](int i) {
      const int l = lz4t_li(i), q = i / kDepth, j = i % kDepth;
      uint32_t m = peers[l] & ((1u << (q * kDepth)) - 1) & kLead;
      const int np = lz4t_popc(m);
#pragma unroll
      for (int k = 0; k < kDepth - 1; k++)
        m = k < j ? m & ~(1u << lz4t_fls(m | 1)) : m;
      pe[l] = j < np ? ip + lz4t_fls(m | 1) / kDepth : -1;
      src[l] = q * kDepth + lz4t_max(j - np, 0);
    });
    lz4t_gather(sl, e, [&](int i) { return src[lz4t_li(i)]; });
    // the entry's score, as rank = score * kDepth + kDepth - 1 - j (the
    // group's largest is its best, a tie going to the newer entry), and
    // its first extension bytes: backward one byte, forward the words'
    // length capped at matchlimit (more to come when the words agree)
    lz4t_lanes_out([&](int i) {
      const int l = lz4t_li(i), p = ip + i / kDepth, j = i % kDepth;
      e[l] = pe[l] >= 0 ? pe[l] : e[l];
      uint32_t x[3];
      const int sc = lz4t_mid_score3(w, clip, first, p, u[l], e[l], x);
      rank[l] = sc * kDepth + kDepth - 1 - j;
      const uint32_t d4 = x[1] ^ u[l][1], d8 = x[2] ^ u[l][2];
      const int fw = d4 ? lz4t_ffs(d4) >> 3 : d8 ? 4 + (lz4t_ffs(d8) >> 3) : 8;
      const int lim = matchlimit - (p + 4);
      const int b1 = (p > anchor) & (e[l] > first) &
                     (c[lz4t_max(p - 1, 0)] == c[lz4t_max(e[l] - 1, 0)]);
      more[l] = lz4t_min(fw, lim) | (fw >= 8) << 16 | b1 << 17;
    });
    for (int o = 1; o < kDepth; o <<= 1) {
      lz4t_gather(rank, tmp, [&](int i) { return i ^ o; });
      lz4t_lanes_out([&](int i) {
        const int l = lz4t_li(i);
        rank[l] = lz4t_max(rank[l], tmp[l]);
      });
    }
    lz4t_lanes_out([&](int i) {
      src[lz4t_li(i)] = i - i % kDepth + kDepth - 1 -
                        rank[lz4t_li(i)] % kDepth;
    });
    lz4t_gather(e, pick, [&](int i) { return src[lz4t_li(i)]; });
    lz4t_gather(more, more, [&](int i) { return src[lz4t_li(i)]; });
    const uint32_t hit = lz4t_ballot([&](int i) {
      return i % kDepth == 0 && ip + i / kDepth <= mflimit &&
             rank[lz4t_li(i)] >= kDepth;
    });
    // inserted: positions 0 .. f, or every live one when none found; the
    // newest inserted position of each bucket writes its slot as itself
    // and its list's first kDepth - 1 entries
    const int f = hit ? lz4t_ffs(hit) / kDepth : kPos - 1;
    const uint32_t ins = f == kPos - 1 ? ~0u : (1u << (f + 1) * kDepth) - 1;
    lz4t_gather(e, tmp, [&](int i) { return i - (i % kDepth > 0); });
    lz4t_lanes_store([&](int i) {
      const int l = lz4t_li(i), q = i / kDepth, j = i % kDepth, p = ip + q;
      if (p <= mflimit && (ins >> i & 1) &&
          !((peers[l] & ins) >> (q * kDepth) >> kDepth))
        lz4t_mid_tab<kDepth>(t, j)[key[l]] = (uint32_t)((j ? tmp[l] : p) + 1);
    });
    if (!hit) {
      ip += kPos;
      continue;
    }
    const int sip = ip + f;
    const int cand = lz4t_lane_get(pick, f * kDepth);
    const int fm = lz4t_lane_get(more, f * kDepth);
    // backward extension past its first byte, 32 byte pairs per step
    int back = 0;
    for (int go = fm >> 17 & 1; go; back += LZ4T_LANES) {
      const uint32_t m = lz4t_ballot([&](int i) {
        const int k = back + i + 2;
        return !(sip - k >= anchor && cand - k >= first &&
                 c[sip - k] == c[cand - k]);
      });
      if (m) {
        back += 1 + lz4t_ffs(m);
        break;
      }
    }
    // forward extension past the words' bytes, 32 word pairs per step
    int fwd = fm & 0xFFFF;
    for (int go = fm >> 16 & 1; go; fwd += 4 * LZ4T_LANES) {
      int eq[LZ4T_NL];
      const uint32_t m = lz4t_ballot([&](int i) {
        const int a = sip + 4 + fwd + 4 * i;
        const int lim = matchlimit - a;
        int k = 0;
        if (lim > 0) {
          const uint32_t x =
              lz4t_rd32w(w, a) ^ lz4t_rd32w(w, cand + 4 + fwd + 4 * i);
          k = lz4t_min(x ? lz4t_ffs(x) >> 3 : 4, lim);
        }
        eq[lz4t_li(i)] = k;
        return k < 4;
      });
      if (m) {
        const int g = lz4t_ffs(m);
        fwd += 4 * g + lz4t_lane_get(eq, g);
        break;
      }
    }
    const int mip = sip - back, mlen = 4 + back + fwd;
    const int nip = mip + mlen;
    const int lit = mip - anchor;
    // the emit's output position, and the room guard (kGuard)
    if (kGuard && op + lit + (lit >> 8) + (mlen >> 8) + 32 > OT) {
      op = OT;
    } else {
      if (put) sink(nseq, op, mip, mlen, cand - back);
      nseq++;
      op += lz4t_seq_bytes(lit, mlen);
    }
    // insert nip - 2
    lz4t_lanes_store([&](int i) {
      if (i > 0) return;
      const uint32_t h2 =
          lz4t_hash_mid(lz4t_rd32w(w, lz4t_min(nip - 2, clip)));
      int s2[kDepth];
      lz4t_mid_slot<kDepth>(t, h2, s2);
      lz4t_mid_put<kDepth>(t, h2, nip - 2, s2);
    });
    ip = nip;
    anchor = nip;
    overflow = op > out_limit;
  }
  const int rest = end - anchor;
  if (overflow || op + rest + rest / 255 + 16 > OT ||
      (kGuard && op + rest + (rest >> 8) + 32 > OT)) {
    op = OT;
  } else {
    if (put) sink(nseq, op, end, 0, end);
    nseq++;
    op += lz4t_seq_bytes(rest, 0);
  }
  *total_out = op;
  *ok_out = (op < n) && !overflow;
  return nseq;
}
