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
//   * emit, room guard, overflow and ok exactly as K2a's (lz4_encode.cuh).
//
// The chain is a pure function of the row, so it is built before the
// parse and the parse inserts nothing. The parse inserts every position of
// [first, mflimit] exactly once and in increasing order: the preload
// [first, base), then each scanned sip, the lazy positions mip + 1 .. hi -
// 1, and after the emit [hi, min(nip, mflimit + 1)), where nip >= hi
// (a lazy loop that stops at p2 leaves mip = p2 - 1 and nip >= mip + 4 >
// hi; one that moves or never runs leaves hi = mip + 1 <= nip; backward
// extension keeps nip), and the next scan starts at nip. No position past
// mflimit is inserted, and a walk from p reads the links of p and of
// candidates below p. So every link a walk reads is chain[p] = 1 +
// max{q in [first, p) : hash(q) = hash(p)}, or 0 without such a q:
// lz4t_deep_build computes exactly that for [first, mflimit], one warp,
// 32 positions per step (__match_any_sync gives a lane its predecessor
// inside the step, the head table the one before it). Plain rows of the
// pipelined kernel take lz4t_deep_build_split, the same steps with the
// keys and the match computed ahead by other warps.
//
// The links are stored as u16 deltas to the previous position, 0 ending
// the chain (a delta over 65535, or no previous position), which is the
// Pallas kernel's own storage for window rows. They follow the same links
// as i32 positions: where a delta would overflow, the previous position
// lies below cand - 65535 <= p - 65535 <= lo, and the walk stops there
// too. So one chain serves both of the Pallas kernel's variants; only
// hash_log differs.
//
// Walks read the deltas from a ring of 65,536 u16 slots (position q in
// slot q & 65535) and, for positions whose slot was reused, from the whole
// row's deltas (lz4t_ring_link). A walk from p reads links of positions in
// [p - 65535, p] only, 65,536 consecutive positions, one per slot. The
// ring holds positions 0 .. 65535 first and then, where the row is longer,
// the rest of the row: the slot of q holds q unless q + 65536 < loaded.
//
// The walks themselves leave the serial path. A walk's result depends only
// on its position p and its starting length: a candidate is taken when its
// length l beats the best so far, and the probe byte at the best length
// only skips candidates that could not (l > best means byte best agrees).
// So walk(p, min_len) = (max(min_len, L), the first candidate reaching L)
// when L > min_len, else (min_len, none), where L is the best length among
// p's first `tries` candidates at or above lo. The walk table holds, for
// every position of the block, L capped at 64 and that first candidate
// (lz4t_walk_entry), computed by all the block's threads at once. The
// parse looks walks up there; a capped entry (L >= 64) is walked again in
// full, since L is then unknown and ties at the cap may hide the right
// candidate. Capping at 64 keeps the lazy test exact: the lazy loop only
// runs while the best length is below 64, and a capped L beats it. The
// scan looks for the first entry with a match, 32 per step.
//
// The parse runs on the 32 lanes of a warp together (lz4_lanes.cuh): the
// lazy loop, backward extension and emit are the same scalar code on
// every lane, and the rest is split among the lanes with the same result
// as the serial loops: the scan's 32 entries, the literals of a sequence
// (32 bytes per step), and a full walk's extension (32 byte pairs per
// step, the first mismatch or matchlimit by __ballot_sync: the same l).
//
// The parse reads the table through an accessor (Tab): the whole table in
// device memory (lz4t_dev_tab, rows after a window), or a ring of table
// chunks in shared memory that other warps fill while the parse runs
// (lz4t_pipe_tab, plain rows). Positions [base, mflimit] form chunks of
// LZ4T_DEEP_PIPE_CHUNK entries, chunk k in slot k % LZ4T_DEEP_PIPE_SLOTS.
// The parse reads entries only at positions at or above ip and in the scan
// at or above sip, both of which only grow, and at most 32 + 64 positions
// past them (a scan step, then the lazy moves, each one position and one
// byte of match length below the cap): so before it reads an entry it
// waits for that entry's chunk (wait), and it hands back every chunk that
// lies wholly below sip (release), in order, having waited for each; at
// its end it hands back the rest (finish). A table chunk is a pure
// function of the row and the chain, so where and in what order the
// entries are computed changes no byte of the output.
#pragma once

#include "lz4_encode.cuh"
#include "lz4_lanes.cuh"

#define LZ4T_DEEP_LAZY_CAP 64
#define LZ4T_DEEP_MIN_MATCH 4
#define LZ4T_DEEP_RING 65536  // chain ring slots, u16 deltas
#define LZ4T_DEEP_LCAP 64     // walk-table lengths are capped here
// the table ring of plain rows: slots (a power of 2) of table chunks (a
// power of 2 of u32 entries, a multiple of 32), and the table warps that
// fill them beside the parse warp
#define LZ4T_DEEP_PIPE_SLOTS 8
#define LZ4T_DEEP_PIPE_CHUNK 1024
#define LZ4T_DEEP_PIPE_WARPS 19
// the peer ring of a plain row's chain build, in the table ring's entries
// before the table needs them: slots (a power of 2) of chunks of build
// positions (a power of 2, a multiple of 32), one u32 word a position
#define LZ4T_DEEP_PEER_SLOTS 8
#define LZ4T_DEEP_PEER_CHUNK 1024
// shared memory of the two rings: the table's entries, a full and an
// empty mbarrier per slot of each ring
#define LZ4T_DEEP_PIPE_SMEM                                    \
  (LZ4T_DEEP_PIPE_SLOTS * (LZ4T_DEEP_PIPE_CHUNK * 4 + 16) + \
   LZ4T_DEEP_PEER_SLOTS * 16)

// Build key of the lane at position p: its hash, or a key no other lane
// has past the last position.
LZ4T_HD uint32_t lz4t_build_key(const uint8_t* c, int p, int last, int lane,
                                int hash_log) {
  return p <= last ? (lz4t_rd32(c, p) * LZ4T_HASH_MUL) >> (32 - hash_log)
                   : 0x80000000u | (uint32_t)lane;
}

// The previous position of the lane's bucket: the highest lower lane of
// its group in the step starting at t0, else the bucket's head (-1 when
// empty or past the last position).
LZ4T_HD int lz4t_build_prev(int t0, int lane, uint32_t peers,
                            const uint32_t* head, uint32_t key) {
  if (key & 0x80000000u) return -1;
  const uint32_t lower = peers & ((1u << lane) - 1);
  return lower ? t0 + lz4t_fls(lower) : (int)head[key] - 1;
}

// the u16 delta of p to its previous position, 0 ending the chain
LZ4T_HD uint16_t lz4t_build_delta(int p, int prev) {
  return (uint16_t)(prev >= 0 && p - prev <= LZ4T_MAX_DISTANCE ? p - prev
                                                                : 0);
}

// The chain of positions [first, last] into delta (see the file comment):
// head is 2^hash_log entries, zeroed by the caller.
LZ4T_HD void lz4t_deep_build(const uint8_t* c, int first, int last,
                             int hash_log, uint32_t* head, uint16_t* delta) {
  for (int t0 = first; t0 <= last; t0 += LZ4T_LANES) {
    uint32_t key[LZ4T_NL], peers[LZ4T_NL];
    int prev[LZ4T_NL];
    lz4t_lanes_out([&](int i) {
      key[lz4t_li(i)] = lz4t_build_key(c, t0 + i, last, i, hash_log);
    });
    lz4t_match_any(key, peers);
    // every lane reads the head before any lane writes it
    lz4t_lanes([&](int i) {
      const int l = lz4t_li(i);
      prev[l] = lz4t_build_prev(t0, i, peers[l], head, key[l]);
    });
    lz4t_lanes_store([&](int i) {
      const int l = lz4t_li(i), p = t0 + i;
      if (p > last) return;
      if ((peers[l] >> i) == 1) head[key[l]] = (uint32_t)(p + 1);
      delta[p] = lz4t_build_delta(p, prev[l]);
    });
  }
}

// The split build of a plain row (first 0): the same chain as
// lz4t_deep_build, with everything but the head table off the build warp.
// A step's keys and peer sets depend only on the row's bytes; only the
// head table carries from one step to the next. So other warps compute
// each step ahead of it (lz4t_peer_step) as one word a position, into a
// ring of chunks of LZ4T_DEEP_PEER_CHUNK positions (chunk k in slot k %
// LZ4T_DEEP_PEER_SLOTS) handed over as the table ring's chunks are, and
// the build warp's step keeps the head read, the head write of a group's
// highest lane and the delta store.

// A lane's peer word (0 past the last position): its key in bits 0-15
// (hash_log <= 16), bit 31 where it is the highest lane of its group (it
// writes the head), bit 30 where a lower lane has its key, bits 16-20 the
// distance to the highest such lane.
#define LZ4T_PEER_HEAD 0x80000000u
#define LZ4T_PEER_LOWER 0x40000000u

LZ4T_HD uint32_t lz4t_peer_word(uint32_t key, uint32_t peers, int lane) {
  if (key & 0x80000000u) return 0;
  const uint32_t lower = peers & ((1u << lane) - 1);
  return ((peers >> lane) == 1 ? LZ4T_PEER_HEAD : 0u) |
         (lower ? LZ4T_PEER_LOWER | (uint32_t)(lane - lz4t_fls(lower)) << 16
                : 0u) |
         key;
}

// the number of peer chunks of build positions [0, last]
LZ4T_HD int lz4t_peer_chunks(int last) {
  return last >= 0 ? last / LZ4T_DEEP_PEER_CHUNK + 1 : 0;
}

// The peer words of the build step from t0 into pw[0 .. 31] (a warp's
// lanes together).
LZ4T_HD void lz4t_peer_step(const uint8_t* c, int t0, int last, int hash_log,
                            uint32_t* pw) {
  uint32_t key[LZ4T_NL], peers[LZ4T_NL];
  lz4t_lanes_out([&](int i) {
    key[lz4t_li(i)] = lz4t_build_key(c, t0 + i, last, i, hash_log);
  });
  lz4t_match_any(key, peers);
  lz4t_lanes_out([&](int i) {
    const int l = lz4t_li(i);
    pw[i] = lz4t_peer_word(key[l], peers[l], i);
  });
}

// The build warp's view of the peer ring: step(t0) returns the words of
// the step from t0, having waited for its chunk and handed back the chunk
// before it (sync.wait_full(k), sync.hand_back(k) as in lz4t_pipe_tab);
// steps come in order.
template <class Sync>
struct lz4t_peer_ring {
  const uint32_t* slot;  // LZ4T_DEEP_PEER_SLOTS x LZ4T_DEEP_PEER_CHUNK
  Sync sync;
  LZ4T_HDM const uint32_t* step(int t0) {
    if (__builtin_expect(!(t0 & (LZ4T_DEEP_PEER_CHUNK - 1)), 0)) {
      const int k = t0 / LZ4T_DEEP_PEER_CHUNK;
      if (k) sync.hand_back(k - 1);
      sync.wait_full(k);
    }
    return slot + (t0 & (LZ4T_DEEP_PEER_SLOTS * LZ4T_DEEP_PEER_CHUNK - 1));
  }
  // the build has ended: its last chunk goes back
  LZ4T_HDM void finish(int last) {
    if (last >= 0) sync.hand_back(last / LZ4T_DEEP_PEER_CHUNK);
  }
};

// The build warp's part of the split build: the chain of positions [0,
// last] into delta, head as lz4t_deep_build's. A step's words are read
// before the step before it stores, which they do not depend on. Every
// lane reads its bucket's head, also where a lower lane has its key (the
// lower lane's address: one broadcast) or past the last position (bucket
// 0's, unused), so the step takes no branch on the words.
template <class Peers>
LZ4T_HD void lz4t_deep_build_split(int last, uint32_t* head, uint16_t* delta,
                                   Peers& pr) {
  uint32_t w[LZ4T_NL], x[LZ4T_NL];
  int prev[LZ4T_NL];
  const auto load = [&](int t0) {
    const uint32_t* b = pr.step(t0);
    lz4t_lanes_out([&](int i) { w[lz4t_li(i)] = b[i]; });
  };
  if (last >= 0) load(0);
  for (int t0 = 0; t0 <= last; t0 += LZ4T_LANES) {
    // every lane reads the head before any lane writes it
    lz4t_lanes([&](int i) {
      const int l = lz4t_li(i), p = t0 + i;
      x[l] = w[l];
      const int h = (int)head[x[l] & 0xFFFF] - 1;
      prev[l] = x[l] & LZ4T_PEER_LOWER ? p - (int)(x[l] >> 16 & 31) : h;
    });
    if (t0 + LZ4T_LANES <= last) load(t0 + LZ4T_LANES);
    lz4t_lanes_store([&](int i) {
      const int l = lz4t_li(i), p = t0 + i;
      if (p > last) return;
      if (x[l] & LZ4T_PEER_HEAD) head[x[l] & 0xFFFF] = (uint32_t)(p + 1);
      delta[p] = lz4t_build_delta(p, prev[l]);
    });
  }
  pr.finish(last);
}

// The chain as the walks read it (see the file comment).
struct lz4t_ring {
  const uint16_t* slot;   // LZ4T_DEEP_RING slots (shared memory)
  const uint16_t* delta;  // the row's deltas (device memory)
  int loaded;             // the slots hold positions below it
};

// the candidate q links to, or -1 at the chain's end
LZ4T_HD int lz4t_ring_link(const lz4t_ring& r, int q) {
  const int d = q + LZ4T_DEEP_RING < r.loaded
                    ? r.delta[q]
                    : r.slot[q & (LZ4T_DEEP_RING - 1)];
  return d ? q - d : -1;
}

// the serial loop's l: bytes of c[a..) equal to c[p..) while p + l <
// matchlimit, 32 compared per step
LZ4T_HD int lz4t_common_lanes(const uint8_t* c, int a, int p,
                              int matchlimit) {
  for (int s = 0;; s += LZ4T_LANES) {
    const uint32_t m = lz4t_ballot([&](int i) {
      const int k = s + i;
      return p + k >= matchlimit || c[a + k] != c[p + k];
    });
    if (m) return s + lz4t_ffs(m);
  }
}

// Walk p's chain for a match longer than min_len that ends before
// matchlimit. Returns the best length (min_len when none was found) and
// sets *best_pos (-1 when none).
LZ4T_HD int lz4t_deep_walk(const uint8_t* c, int p, int min_len, int first,
                           int matchlimit, int tries, const lz4t_ring& r,
                           int* best_pos) {
  const int lo = lz4t_max(first, p - LZ4T_MAX_DISTANCE);
  int cand = lz4t_ring_link(r, p), bl = min_len, bp = -1;
  for (int t = 0; cand >= lo && t < tries; t++) {
    if (c[cand + bl] == c[p + bl]) {
      const int l = lz4t_common_lanes(c, cand, p, matchlimit);
      if (l > bl) {
        bl = l;
        bp = cand;
      }
    }
    cand = lz4t_ring_link(r, cand);
  }
  *best_pos = bp;
  return bl;
}

// the serial loop's l, capped at lim: four byte pairs per step
LZ4T_HD int lz4t_common_capped(const uint8_t* c, int a, int p, int lim) {
  for (int l = 0; l < lim; l += 4) {
    const uint32_t x = lz4t_rd32(c, a + l) ^ lz4t_rd32(c, p + l);
    if (x) return lz4t_min(l + (lz4t_ffs(x) >> 3), lim);
  }
  return lim;
}

// Walk-table entry of p <= mflimit (one thread's part of the table; see
// the file comment): (L << 16) | (p - candidate) for the best length L >
// 3, capped at LZ4T_DEEP_LCAP, and the first candidate that reaches it;
// 0 when no candidate has 4 bytes.
LZ4T_HD uint32_t lz4t_walk_entry(const uint8_t* c, int p, int first,
                                 int matchlimit, int tries,
                                 const lz4t_ring& r) {
  const int lo = lz4t_max(first, p - LZ4T_MAX_DISTANCE);
  const int lim = lz4t_min(LZ4T_DEEP_LCAP, matchlimit - p);
  int cand = lz4t_ring_link(r, p), bl = LZ4T_DEEP_MIN_MATCH - 1, bp = -1;
  for (int t = 0; cand >= lo && t < tries && bl < lim; t++) {
    const int l = lz4t_common_capped(c, cand, p, lim);
    if (l > bl) {
      bl = l;
      bp = cand;
    }
    cand = lz4t_ring_link(r, cand);
  }
  return bp < 0 ? 0u : (uint32_t)bl << 16 | (uint32_t)(p - bp);
}

// walk(p, min_len) from p's table entry e, walking again where e's length
// reached the cap
LZ4T_HD int lz4t_deep_take(const uint8_t* c, int p, uint32_t e, int min_len,
                           int first, int matchlimit, int tries,
                           const lz4t_ring& r, int* best_pos) {
  if ((int)(e >> 16) >= LZ4T_DEEP_LCAP)
    return lz4t_deep_walk(c, p, min_len, first, matchlimit, tries, r,
                          best_pos);
  *best_pos = p - (int)(e & 0xFFFF);
  return (int)(e >> 16);
}

// The walk-table entries of positions [from, to], thread t of nt.
LZ4T_HD void lz4t_walk_table(const uint8_t* c, int base, int from, int to,
                             int first, int matchlimit, int tries,
                             const lz4t_ring& r, uint32_t* tab, int t,
                             int nt) {
  for (int p = from + t; p <= to; p += nt)
    tab[p - base] = lz4t_walk_entry(c, p, first, matchlimit, tries, r);
}

// The parse's view of a walk table in device memory that is whole before
// the parse starts: entry p at tab[p - base].
struct lz4t_dev_tab {
  const uint32_t* tab;
  int base;
  LZ4T_HDM uint32_t operator[](int p) const { return tab[p - base]; }
  LZ4T_HDM void wait(int) {}
  LZ4T_HDM void release(int) {}
  LZ4T_HDM void finish() {}
};

// the number of table chunks of positions [base, mflimit]
LZ4T_HD int lz4t_pipe_chunks(int base, int mflimit) {
  return mflimit >= base ? (mflimit - base) / LZ4T_DEEP_PIPE_CHUNK + 1 : 0;
}

// The parse's view of the table ring (see the file comment): entry p in
// slot[(p - base) % (slots x chunk)]. Sync hands the chunks over:
// sync.wait_full(k) returns once chunk k is written, sync.hand_back(k)
// hands chunk k back to the table warps (after its wait_full). The card's
// Sync is lz4t_pipe_bars; the host build's fills the chunks on demand and
// poisons the chunks handed back (lz4_host.cpp).
template <class Sync>
struct lz4t_pipe_tab {
  const uint32_t* slot;
  int base;
  int nchunks;
  Sync sync;
  int waited;  // chunks [0, waited) have been written
  int freed;   // chunks [0, freed) have been handed back
  // the scan's fast path, one compare each: entries below ready can be
  // read, and a scan at or past edge hands a chunk back (0 to start with,
  // which only sends the first calls the slow way)
  int ready;
  int edge;
  LZ4T_HDM uint32_t operator[](int p) const {
    return slot[(p - base) &
                (LZ4T_DEEP_PIPE_SLOTS * LZ4T_DEEP_PIPE_CHUNK - 1)];
  }
  LZ4T_HDM void wait_chunks(int k) {
    for (; waited < k; waited++) sync.wait_full(waited);
    ready = base + waited * LZ4T_DEEP_PIPE_CHUNK;
  }
  // the entry of q (base <= q <= mflimit) can be read
  LZ4T_HDM void wait(int q) {
    if (q >= ready) wait_chunks((q - base) / LZ4T_DEEP_PIPE_CHUNK + 1);
  }
  // chunks [freed, k) go back one by one, each once it is written: the
  // table warps may need the first of them to write the last
  LZ4T_HDM void release_chunks(int k) {
    for (; freed < k; freed++) {
      wait_chunks(freed + 1);
      sync.hand_back(freed);
    }
    edge = base + (freed + 1) * LZ4T_DEEP_PIPE_CHUNK;
  }
  // no entry below p (p >= base) is read again
  LZ4T_HDM void release(int p) {
    if (p >= edge)
      release_chunks(lz4t_min((p - base) / LZ4T_DEEP_PIPE_CHUNK, nchunks));
  }
  // the parse has ended: every chunk goes back
  LZ4T_HDM void finish() { release_chunks(nchunks); }
};

// lz4t_emit_sequence with the literals copied 32 bytes per step
LZ4T_HD int lz4t_emit_sequence_lanes(const uint8_t* c, uint8_t* o, int OT,
                                     int op, int anchor, int ip, int mpos,
                                     int mlen) {
  const int lit = ip - anchor;
  if (op + lit + (lit >> 8) + (mlen >> 8) + 32 > OT) return OT;
  const int tok = op;
  int q = op + 1;
  if (lit >= 15) q = lz4t_emit_len_ext(o, q, lit - 15);
  for (int s = 0; s < lit; s += LZ4T_LANES)
    lz4t_lanes([&](int i) {
      if (s + i < lit) o[q + s + i] = c[anchor + s + i];
    });
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

// c: the row, base + N + 8 bytes (n block bytes at base, zero after the
// block's N); o: OT = CAP output bytes; r: the row's chain; tab: the walk
// table's accessor, tab[p] for p in [base, base + n - 12], every chunk of
// it handed back on return. Run by all 32 lanes of a warp together.
template <class Tab>
LZ4T_HD void lz4t_encode_deep_row(const uint8_t* c, int base, int first,
                                  int n, uint8_t* o, int OT, int tries,
                                  const lz4t_ring& r, Tab& tab,
                                  int* total_out, int* ok_out) {
  const int end = base + n;
  const int mflimit = end - 12;
  const int matchlimit = end - 5;
  const int out_limit = OT - 16;
  int ip = base, anchor = base, op = 0;
  int overflow = n < 0;
  while (ip <= mflimit && !overflow) {
    // scan: the first position from ip with a match, 32 per step
    int sip = ip;
    uint32_t hit = 0;
    while (sip <= mflimit) {
      tab.release(sip);
      tab.wait(lz4t_min(sip + LZ4T_LANES - 1, mflimit));
      hit = lz4t_ballot([&](int i) {
        return sip + i <= mflimit && tab[sip + i] != 0;
      });
      if (hit) break;
      sip += LZ4T_LANES;
    }
    if (!hit) {
      ip = sip;
      continue;
    }
    int mip = sip + lz4t_ffs(hit), mpos;
    int mlen = lz4t_deep_take(c, mip, tab[mip],
                              LZ4T_DEEP_MIN_MATCH - 1, first, matchlimit,
                              tries, r, &mpos);
    // lazy: absorb a byte into the literals while the next position holds
    // a strictly longer match
    while (mip + 1 <= mflimit && mlen < LZ4T_DEEP_LAZY_CAP) {
      tab.wait(mip + 1);
      const uint32_t e = tab[mip + 1];
      if ((int)(e >> 16) <= mlen) break;
      mip++;
      mlen = lz4t_deep_take(c, mip, e, mlen, first, matchlimit, tries, r,
                            &mpos);
    }
    while (mip > anchor && mpos > first && c[mip - 1] == c[mpos - 1]) {
      mip--;
      mpos--;
      mlen++;
    }
    const int op2 =
        lz4t_emit_sequence_lanes(c, o, OT, op, anchor, mip, mpos, mlen);
    const int nip = mip + mlen;
    ip = nip;
    anchor = nip;
    op = op2;
    overflow = op2 > out_limit;
  }
  const int rest = end - anchor;
  if (overflow || op + rest + rest / 255 + 16 > OT)
    op = OT;
  else
    op = lz4t_emit_sequence_lanes(c, o, OT, op, anchor, end, 0, 0);
  tab.finish();
  *total_out = op;
  *ok_out = (op < n) && !overflow;
}

#if defined(__CUDACC__)

// The card's hand-over of a ring of kSlots chunks: per slot a full
// mbarrier (one arrival per producing warp once it has written its part of
// the chunk) and an empty one (the consumer's lane 0 arrives once its warp
// is done with the chunk). Every lane of the consuming warp waits.
template <int kSlots>
struct lz4t_ring_bars {
  uint64_t* full;
  uint64_t* empty;
  __host__ __device__ void wait_full(int k) {
#if defined(__CUDA_ARCH__)
    lz4t_mbar_wait(&full[k & (kSlots - 1)], (k / kSlots) & 1);
#endif
  }
  __host__ __device__ void hand_back(int k) {
#if defined(__CUDA_ARCH__)
    __syncwarp();  // every lane's reads of the chunk come first
    if (lz4t_lead()) lz4t_mbar_arrive(&empty[k & (kSlots - 1)]);
#endif
  }
};

// the table ring's (the parse consumes) and the peer ring's (the build
// warp consumes)
using lz4t_pipe_bars = lz4t_ring_bars<LZ4T_DEEP_PIPE_SLOTS>;
using lz4t_peer_bars = lz4t_ring_bars<LZ4T_DEEP_PEER_SLOTS>;

// The two rings' barriers, set up by thread 0 before the block syncs: full
// counts the kWarps producing warps, empty the consumer.
template <int kWarps>
__device__ __forceinline__ void lz4t_pipe_init(uint64_t* full,
                                               uint64_t* empty,
                                               uint64_t* peer_full,
                                               uint64_t* peer_empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < LZ4T_DEEP_PIPE_SLOTS; s++) {
      lz4t_mbar_init(&full[s], kWarps);
      lz4t_mbar_init(&empty[s], 1);
    }
    for (int s = 0; s < LZ4T_DEEP_PEER_SLOTS; s++) {
      lz4t_mbar_init(&peer_full[s], kWarps);
      lz4t_mbar_init(&peer_empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Peer warp w of kWarps: the peer words of build positions [0, last] into
// the peer ring, chunk by chunk, steps to the warps in turn as in
// lz4t_pipe_fill.
template <int kWarps>
__device__ __forceinline__ void lz4t_peer_fill(const uint8_t* c, int last,
                                               int hash_log, uint32_t* slot,
                                               uint64_t* full,
                                               uint64_t* empty, int w) {
  constexpr int S = LZ4T_DEEP_PEER_SLOTS, E = LZ4T_DEEP_PEER_CHUNK;
  const int nchunks = lz4t_peer_chunks(last);
  int g = w;
  for (int k = 0; k < nchunks; k++) {
    if (k >= S) lz4t_mbar_wait(&empty[k & (S - 1)], (k / S - 1) & 1);
    for (; g < (k + 1) * (E / 32) && 32 * g <= last; g += kWarps)
      lz4t_peer_step(c, 32 * g, last, hash_log,
                     slot + ((32 * g) & (S * E - 1)));
    __syncwarp();
    if (lz4t_lead()) lz4t_mbar_arrive(&full[k & (S - 1)]);
  }
}

// Table warp w of kWarps: the walk-table entries of positions [base,
// mflimit] into the ring, chunk by chunk. Steps of 32 positions go to the
// warps in turn across chunk edges (step g, positions base + 32 g .. + 31,
// to warp g % kWarps), so every warp takes the same share of each row. A
// warp waits for a slot's previous chunk to be handed back before it
// writes there, and arrives on the slot's full barrier once its entries
// of the chunk are written.
template <int kWarps>
__device__ __forceinline__ void lz4t_pipe_fill(
    const uint8_t* c, int base, int mflimit, int first, int matchlimit,
    int tries, const lz4t_ring& r, uint32_t* slot, uint64_t* full,
    uint64_t* empty, int w) {
  constexpr int S = LZ4T_DEEP_PIPE_SLOTS, E = LZ4T_DEEP_PIPE_CHUNK;
  const int lane = threadIdx.x & 31;
  const int nchunks = lz4t_pipe_chunks(base, mflimit);
  int g = w;
  for (int k = 0; k < nchunks; k++) {
    if (k >= S) lz4t_mbar_wait(&empty[k & (S - 1)], (k / S - 1) & 1);
    for (; g < (k + 1) * (E / 32); g += kWarps) {
      const int p = base + 32 * g + lane;
      if (p <= mflimit)
        slot[(p - base) & (S * E - 1)] =
            lz4t_walk_entry(c, p, first, matchlimit, tries, r);
    }
    __syncwarp();
    if (lz4t_lead()) lz4t_mbar_arrive(&full[k & (S - 1)]);
  }
}

#endif  // __CUDACC__
