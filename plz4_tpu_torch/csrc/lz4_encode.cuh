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
// vtab[h] always equals the word at tab[h] - 1: the parse re-reads it
// there instead, which halves the tables' shared memory.
//
// lz4t_encode_row_lanes gives these bytes for K2a, K2b and K6b: one warp
// parses and hands each sequence to a sink, K2a's and K2b's a stored list
// (lz4t_seq_store) that lz4t_seq_emit writes, K6b's a ring in shared
// memory that emit warps write from while the parse goes on
// (lz4_encode_wide.cuh). The plain version, encode_row_plain
// (plz4_tpu_torch/ops/encode.py), is the serial scan over Python bytes,
// one attempt at a time; the CPU tests hold the host build of the lanes'
// body to it.
#pragma once

#include "lz4_common.cuh"
#include "lz4_lanes.cuh"

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

// ---------------------------------------------------------------------------
// the parse on the 32 lanes of a warp, and the sequences it stores (K2a,
// K2b; K2c and K2d store and write theirs the same way)
// ---------------------------------------------------------------------------

// the little-endian words at bytes p, p + 4 and p + 8 of the u32-aligned
// row w: four aligned loads and three funnel shifts (w holds the words up
// to (p + 15) >> 2)
LZ4T_HD void lz4t_rd32w3(const uint32_t* w, int p, uint32_t* x) {
  const uint32_t* q = w + (p >> 2);
  const uint32_t a = q[0], b = q[1], c = q[2], d = q[3];
  const int sh = (p & 3) * 8;
#if defined(__CUDA_ARCH__)
  x[0] = __funnelshift_r(a, b, sh);
  x[1] = __funnelshift_r(b, c, sh);
  x[2] = __funnelshift_r(c, d, sh);
#else
  x[0] = (uint32_t)((((uint64_t)b << 32) | a) >> sh);
  x[1] = (uint32_t)((((uint64_t)c << 32) | b) >> sh);
  x[2] = (uint32_t)((((uint64_t)d << 32) | c) >> sh);
#endif
}

// the little-endian word at byte p of w (w holds the word after p >> 2)
LZ4T_HD uint32_t lz4t_rd32w(const uint32_t* w, int p) {
  const uint32_t lo = w[p >> 2], hi = w[(p >> 2) + 1];
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, (p & 3) * 8);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> ((p & 3) * 8));
#endif
}

// The output bytes of a sequence that the room guard lets through:
// lz4t_emit_sequence's count, literals lit, match mlen (0: final
// literals) (lit >= 15 adds (lit - 15) / 255 + 1 = (lit + 240) / 255 length
// bytes, which is 0 below 15; mlen >= 19 likewise (mlen + 236) / 255).
LZ4T_HD int lz4t_seq_bytes(int lit, int mlen) {
  return 1 + lit + (int)((unsigned)(lit + 240) / 255u) +
         (mlen ? 2 + (int)((unsigned)(mlen + 236) / 255u) : 0);
}

// sequence k of seq: (op, mip, mlen, mip - mpos)
LZ4T_HD void lz4t_seq_put(int* seq, int k, int op, int mip, int mlen,
                          int mpos) {
#if defined(__CUDA_ARCH__)
  reinterpret_cast<int4*>(seq)[k] = make_int4(op, mip, mlen, mip - mpos);
#else
  int* q = seq + 4 * k;
  q[0] = op;
  q[1] = mip;
  q[2] = mlen;
  q[3] = mip - mpos;
#endif
}

// The lanes' bodies' sink of K2a-K2d: the parse's lane 0 hands it
// sequence k (op, mip, mlen, mpos), in order, and it stores it as sequence k
// of seq. (A sink with kAllLanes, K6b's ring, is called by every lane.)
struct lz4t_seq_store {
  static constexpr bool kAllLanes = false;
  int* seq;
  LZ4T_HDM void operator()(int k, int op, int mip, int mlen, int mpos) {
    lz4t_seq_put(seq, k, op, mip, mlen, mpos);
  }
};

// Write the k sequences of seq (stored by a lanes' parse) into o, thread t
// of nt taking sequences t, t + nt, ...: sequence i's literals start where
// sequence i - 1's match ends (at base for the first), and each writes
// lz4t_emit_sequence's bytes at its own op.
LZ4T_HD void lz4t_seq_emit(const uint8_t* c, uint8_t* o, int OT, int base,
                           const int* seq, int k, int t, int nt) {
  for (int i = t; i < k; i += nt) {
    const int* q = seq + 4 * i;
    const int anchor = i ? q[-3] + q[-2] : base;
    lz4t_emit_sequence(c, o, OT, q[0], anchor, q[1], q[1] - q[3], q[2]);
  }
}

// Offset from the search's start of its attempt cnt: the sum of the skip
// steps 1 + (k >> 6) over k < cnt, which for cnt = 64a + b is
// cnt + 32a(a - 1) + ab.
LZ4T_HD int lz4t_skip_offset(int cnt) {
  const int a = cnt >> LZ4T_SKIP_STRENGTH, b = cnt & 63;
  return cnt + 32 * a * (a - 1) + a * b;
}

// The forward match length past sip + 4 that the words at +4 and +8 show
// (u at sip, x at the candidate), capped at lim; bit 16 set when all eight
// bytes agree (the extension goes on past them).
LZ4T_HD int lz4t_fwd_words(const uint32_t* u, const uint32_t* x, int lim) {
  const int f4 = lz4t_ctz(x[1] ^ u[1]) >> 3;  // 4 when the words agree
  const int fw = f4 + (f4 == 4 ? lz4t_ctz(x[2] ^ u[2]) >> 3 : 0);
  return lz4t_min(fw, lim) | (fw == 8) << 16;
}

// The greedy parse of one row by the 32 lanes of a warp (K2a, K2b, K6b):
// the bytes the file comment sets out. w is the row as u32 words,
// DT = base + N + 8 bytes plus the word after them (n block bytes at base,
// zero after the block's N); OT = CAP output bytes; tab: the 2^14-entry
// position table, zeroed and preloaded with the window; own: 2^14 bytes of
// scratch (any contents). The sink gets each sequence k that the emit
// writes as sink(k, op, mip, mlen, mpos), in order, op the output position
// where the emit writes it, the final literals last as (op, end, 0, end),
// from lane 0 (from every lane where Sink::kAllLanes). Returns their
// count.
//
// Why the lanes give the serial scan's bytes: positions enter the table
// exactly once each and in increasing order. The window preload inserts
// first, first + wstride, ... below base; a search inserts each position
// it scans; after a match only nip - 2 is inserted, where nip - 2 >= sip +
// 2 for the sip that found the match (mlen >= 4 + back), and the next
// search starts at nip. So the serial scan's candidate at sip is the
// newest inserted position of sip's bucket below sip.
//
// Most searches end at their first attempts: a sequence of text or
// records usually starts where the last one ended (on the main path's 64
// KiB rows ~74% of the searches match at attempt 0, ~12% at attempt 1,
// ~4% at attempt 2). The warp runs attempts 0 .. LZ4T_SCALAR_TRIES - 1 as
// scalar code, every lane on the same broadcast words, so each costs one
// thread's chain and no cross-lane step; every lane stores the same slot
// value, so each lane's own later loads see it without a __syncwarp. Only
// when they fail do the lanes scan: a step takes the 32 attempts cnt0 ..
// cnt0 + 31 (cnt restarts at 0 for every search), lane i attempt cnt0 + i
// at ip + lz4t_skip_offset(cnt0 + i); lanes past mflimit sit out. If
// attempts 0 .. k - 1 find nothing, the serial scan has inserted all of
// them when it reaches attempt k, so k's candidate is the newest lower
// lane of the step in its bucket (__match_any_sync on the hash, when a
// byte table shows two live lanes in one bucket), else the slot as the
// step found it. Validity is the serial scan's (cd >= first,
// sip - cd <= 65535, the word at cd equals the word at sip), and the first
// valid lane (a ballot) is the serial scan's stop, with the same
// candidate. The step inserts lanes 0 .. f, f that lane, or every live
// lane when none found one: each bucket's newest inserted lane writes its
// slot, after every lane has read (__syncwarp). The post-match insert of
// nip - 2 is again scalar, before the next search reads; the next
// search's first words are read beside it.
//
// The words at +4 and +8 of the match and its candidate give the forward
// length inline, and one byte pair the first backward byte. Past those,
// backward extension compares 32 byte pairs per step and forward
// extension 32 word pairs (128 bytes), each taking the ballot's first
// mismatch, matchlimit or anchor / first: the serial loops' lengths. The
// parse emits nothing: it keeps the output position op by the emit's
// arithmetic (the room guard, overflow and the final literals' two guards)
// and hands each sequence with its op to the sink. kGuard = false keeps
// op as K6b's clipped emit advances it (no room guard: every sequence is
// handed over, op grows by its bytes); kGuard = true as
// lz4t_emit_sequence (a refused sequence is not handed over and sets op =
// OT). Words come from the u32-aligned row by aligned loads and funnel
// shifts: a position at most mflimit, or a
// stored one (at most nip - 2 <= end - 7, or below base), reads words
// inside the row or the one word after it, which the shift drops; a lane
// past mflimit, whose reads decide nothing, reads at DT - 12 at most.
#define LZ4T_SCALAR_TRIES 3

template <bool kGuard = true, class Sink>
LZ4T_HD int lz4t_encode_row_lanes(const uint32_t* w, int DT, int base,
                                  int first, int n, int OT, uint32_t* tab,
                                  uint8_t* own, Sink& sink, int* total_out,
                                  int* ok_out) {
  const uint8_t* c = reinterpret_cast<const uint8_t*>(w);
  const int end = base + n;
  const int mflimit = end - 12;
  const int matchlimit = end - 5;
  const int out_limit = OT - 16;
  const int clip = DT - 4;
  const bool put = Sink::kAllLanes || lz4t_lead();
  int ip = base, anchor = base, op = 0, nseq = 0;
  int overflow = n < 0;
  uint32_t u0[3];  // the words at sip, sip + 4 and sip + 8
  lz4t_rd32w3(w, lz4t_min(ip, clip - 8), u0);
  while (ip <= mflimit && !overflow) {
    // the scalar attempts (cnt < 64: one byte apart)
    int sip = ip, cand, found, cnt = 0;
    uint32_t x0[3];
    for (;;) {
      const uint32_t h = lz4t_hash(u0[0]);
      cand = (int)tab[h] - 1;
      lz4t_rd32w3(w, lz4t_max(cand, 0), x0);
      tab[h] = (uint32_t)(sip + 1);
      found = (cand >= first) & (sip - cand <= LZ4T_MAX_DISTANCE) &
              (x0[0] == u0[0]);
      if (found | (++cnt == LZ4T_SCALAR_TRIES) | (sip == mflimit)) break;
      lz4t_rd32w3(w, ++sip, u0);
    }
    int fm;
    if (found) {
      fm = lz4t_fwd_words(u0, x0, matchlimit - (sip + 4)) |
           ((sip > anchor) & (cand > first) &
            (c[lz4t_max(sip - 1, 0)] == c[lz4t_max(cand - 1, 0)])) << 17;
    } else {
      if (sip == mflimit) break;  // the search ends past mflimit
      uint32_t key[LZ4T_NL], peers[LZ4T_NL];
      int pos[LZ4T_NL], cd[LZ4T_NL], more[LZ4T_NL], hit[LZ4T_NL];
      int cnt0 = LZ4T_SCALAR_TRIES, f = -1;
      for (;;) {
        uint32_t u[LZ4T_NL][3];
        // the attempt's position, words and hash, and its slot; a lane
        // past mflimit takes a key no other lane has
        lz4t_lanes_out([&](int i) {
          const int l = lz4t_li(i), p = ip + lz4t_skip_offset(cnt0 + i);
          pos[l] = p;
          lz4t_rd32w3(w, lz4t_min(p, clip - 8), u[l]);
          key[l] =
              p <= mflimit ? lz4t_hash(u[l][0]) : 0x80000000u | (uint32_t)i;
          cd[l] = (int)tab[key[l] & ((1u << LZ4T_HASH_LOG) - 1)] - 1;
        });
        // the lanes that share a live lane's bucket: __match_any_sync costs
        // ~10 cycles per distinct key of the warp (~340 for 32, PERF.md), so
        // each live lane first writes its number into the byte table own at
        // its bucket; a lane that reads back another's shares its bucket,
        // and only then does the warp match its keys
        lz4t_lanes_store([&](int i) {
          const int l = lz4t_li(i);
          if (pos[l] <= mflimit) own[key[l]] = (uint8_t)i;
        });
        if (lz4t_ballot([&](int i) {
              const int l = lz4t_li(i);
              return pos[l] <= mflimit && own[key[l]] != i;
            }))
          lz4t_match_any(key, peers);
        else
          lz4t_lanes_out([&](int i) { peers[lz4t_li(i)] = 1u << i; });
        // the candidate (the newest lower lane of the bucket, else the
        // slot), its validity and its first extension bytes: backward one
        // byte, forward the words' length
        lz4t_lanes_out([&](int i) {
          const int l = lz4t_li(i), p = pos[l];
          const uint32_t m = peers[l] & ((1u << i) - 1);
          if (m) cd[l] = ip + lz4t_skip_offset(cnt0 + lz4t_fls(m));
          uint32_t x[3];
          lz4t_rd32w3(w, lz4t_max(cd[l], 0), x);
          hit[l] = (p <= mflimit) & (cd[l] >= first) &
                   (p - cd[l] <= LZ4T_MAX_DISTANCE) & (x[0] == u[l][0]);
          const int b1 =
              (p > anchor) & (cd[l] > first) &
              (c[lz4t_max(lz4t_min(p, clip - 8) - 1, 0)] ==
               c[lz4t_max(cd[l] - 1, 0)]);
          more[l] = lz4t_fwd_words(u[l], x, matchlimit - (p + 4)) | b1 << 17;
        });
        const uint32_t hits =
            lz4t_ballot([&](int i) { return hit[lz4t_li(i)]; });
        // inserted: lanes 0 .. f, or every live one when none found; the
        // newest inserted lane of each bucket writes its slot
        const uint32_t ins = hits ? (2u << lz4t_ffs(hits)) - 1 : ~0u;
        lz4t_lanes_store([&](int i) {
          const int l = lz4t_li(i);
          if (pos[l] <= mflimit && (ins >> i & 1) &&
              !((peers[l] & ins) >> i >> 1))
            tab[key[l]] = (uint32_t)(pos[l] + 1);
        });
        if (hits) {
          f = lz4t_ffs(hits);
          break;
        }
        // the search goes on, or ends past mflimit as the serial scan's
        if (ip + lz4t_skip_offset(cnt0 + LZ4T_LANES - 1) > mflimit) break;
        cnt0 += LZ4T_LANES;
      }
      if (f < 0) break;
      sip = ip + lz4t_skip_offset(cnt0 + f);
      cand = lz4t_lane_get(cd, f);
      fm = lz4t_lane_get(more, f);
    }
    int back = fm >> 17 & 1, fwd = fm & 0xFFFF;
    if (fm >> 16) {
      // backward extension past its first byte, 32 byte pairs per step
      for (int go = back; go; back += LZ4T_LANES) {
        const uint32_t m = lz4t_ballot([&](int i) {
          const int k = back + i + 1;
          return !(sip - k >= anchor && cand - k >= first &&
                   c[sip - k] == c[cand - k]);
        });
        if (m) {
          back += lz4t_ffs(m);
          break;
        }
      }
      // forward extension past the words' bytes, 32 word pairs per step
      for (int go = fm >> 16 & 1; go; fwd += 4 * LZ4T_LANES) {
        int eq[LZ4T_NL];
        const uint32_t m = lz4t_ballot([&](int i) {
          const int a = sip + 4 + fwd + 4 * i;
          const int lim = matchlimit - a;
          int k = 0;
          if (lim > 0)
            k = lz4t_min(lz4t_ctz(lz4t_rd32w(w, a) ^
                                  lz4t_rd32w(w, cand + 4 + fwd + 4 * i)) >>
                             3,
                         lim);
          eq[lz4t_li(i)] = k;
          return k < 4;
        });
        if (m) {
          const int g = lz4t_ffs(m);
          fwd += 4 * g + lz4t_lane_get(eq, g);
          break;
        }
      }
    }
    const int mip = sip - back, mlen = 4 + back + fwd;
    const int nip = mip + mlen;
    const int lit = mip - anchor;
    // the emit's output position; the room guard (kGuard) refuses the
    // sequence with op = OT
    const int refused =
        kGuard && op + lit + (lit >> 8) + (mlen >> 8) + 32 > OT;
    if (put && !refused) sink(nseq, op, mip, mlen, cand - back);
    const int nb = lz4t_seq_bytes(lit, mlen);
    nseq += !refused;
    op = refused ? OT : op + nb;
    // the next search's first words, and the insert of nip - 2 (scalar, as
    // the attempts' inserts)
    lz4t_rd32w3(w, lz4t_min(nip, clip - 8), u0);
    tab[lz4t_hash(lz4t_rd32w(w, nip - 2))] = (uint32_t)(nip - 1);
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
