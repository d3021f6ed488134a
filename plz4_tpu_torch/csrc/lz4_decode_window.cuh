// LZ4 decode against a right-aligned window: the function that the Pallas
// kernels plz4_tpu/ops/decode_pallas.py:_decode_dict_kernel (strict and
// record mode) and _decode_kernel_bw_rec (record mode) compute. Their word
// copies, 8-wide wild copies and straight-line fast tiers return the same
// (ip, op, ok) and the same bytes [0, op) as their byte-serial careful
// path, so one exact loop stands for all of them. Two row bodies run the
// rules below: lz4t_parse_strict in lz4_decode_ring.cuh, strict mode (K3),
// and lz4t_decode_record, record mode (K5 and K6c); each hands its
// sequences to warps that copy byte-parallel (lz4t_copy_batch_lanes, K1's
// and K6a's copies too). The plain version is decode_window_row_plain
// (plz4_tpu_torch/ops/decode.py).
//
// meta = [clen, dlen, pre_lit, pre_skip, pre_moff, pre_mlen, out_len]
// (the native lz4r_chunk_split record layout, dlen in meta[1]); win holds W
// window bytes right-aligned: a match source j bytes before the row's
// first output byte is win[W - j]. A match may read up to op + dlen back,
// so a match that ends exactly at the window/output boundary reads the
// window's last byte.
//
// Strict (K3, whole-block decode against a frame dictionary): the carry
// fields are zero, ok starts as clen > 0, and a sequence that would write
// past out_len is bad (nothing of it is copied).
// Record mode (K5, and K6c which computes the same function): the
// prologue copies pre_lit literal bytes from the slice start, skips
// pre_skip header bytes and runs the carried match (pre_moff, pre_mlen);
// the prologue is bad when pre_lit > clen, pre_lit + pre_mlen > out_len,
// the carried match reaches past the window, or a length is negative.
// Literal and match copies then clamp at out_len, and a clamped copy ends
// the record, as does a match that fills it exactly. The Pallas kernels
// parse on after such a match, find no input and refuse the record; the
// native splitter makes such records for blocks that other encoders
// wrote (a match that ends on a 64 KiB boundary), so the port ends the
// record there and follows them everywhere else.
// Both modes: per sequence bad = ip >= clen; after the literal length
// (strict) bad |= ip+lit > clen | op+lit > out_len, (record) lit_n =
// min(lit, out_len-op), bad |= lit_n < 0 | ip+lit_n > clen; the record
// stops when ip >= clen after the literals; after the 2-byte offset
// bad |= ip > clen | off == 0; after the match length bad |= off > op +
// dlen (strict also op+ml > out_len). A bad sequence copies nothing. At the
// end ok &= ip == clen and n_out = op.
// Reads of the input past its C bytes return 0 (the Pallas wrappers append
// 8 zero bytes and clip there), so a length run of 255s always ends.
// out_len is clamped to the output buffer's cap and window reads to the
// window; neither clamp changes a result the host's records can produce.
// A carried offset below 1 copies as offset 1, as _decode_kernel_bw_rec's
// in-record copier does.
//
// The copies (lz4t_copy_batch_lanes) are byte-parallel: with NW copy warps (8
// in K5, 7 in K1 and K3) a step writes 32 NW consecutive output bytes [S, S +
// 32 NW), lane i of copy warp w the byte x = S + 32 w + i. In the byte-serial
// copy a literal byte is an input byte, and a match byte at offset off is the
// output byte off before it, which for a match starting at om equals (by
// induction over a match that overlaps itself) the byte at om - off + ((x -
// om) mod off). So each byte resolves to an input byte, a window byte (index y
// < 0: win[W + y], 0 before the window) or an output byte y < x, taken as x -
// off when off >= 32 and in the periodic form when off < 32. Where y lies in
// the same step (y >= S) the lane resolves y in turn; y belongs to an earlier
// sequence or to the same sequence's literals, so the rounds end. Every lane
// then loads its resolved source, input, window or output before S, and stores
// its byte: no lane reads what the step writes, and the steps, ordered by a
// barrier among the copy warps, give the byte-serial bytes.
#pragma once

#include "lz4_lanes.cuh"

#define LZ4T_COPY_WARPS 8  // K5's copy warps
#define LZ4T_COPY_BAR 1    // named barrier of the copy steps (0 is
                           // __syncthreads')

// The copies of one batch of sequences (K5, and K1 and K3 through
// lz4_decode_ring.cuh): its n <= 32 sequences e[4 k ..] = (ip, n_lit, off,
// m) in order, each writing n_lit literals lit(ip ..) and then m match
// bytes at offset off (below 1 copied as 1) where the one before ended,
// the first at output position bop, to o against the window win (see the
// file comment). Run by NW warps together, warp w (on the card; the host
// runs them all in turn, the last first) writing bytes S + 32 w .. + 31
// of each step S of 32 NW bytes; the steps are ordered by named barrier
// LZ4T_COPY_BAR over the NW warps. done() runs once e has been read (on
// the card in every lane, after a __syncwarp): the caller may reuse e
// from then on. Returns the batch's end, the next batch's bop.
template <int NW, class Lit, class Done>
LZ4T_HD int lz4t_copy_batch_lanes(Lit lit, uint8_t* o, const uint8_t* win,
                                  int W, const int32_t* e, int n, int bop,
                                  int w, Done done) {
#if defined(__CUDA_ARCH__)
  const int w0 = w, w1 = w + 1;
#else
  const int w0 = 0 * w, w1 = NW;
#endif
  const int span = NW * LZ4T_LANES;
  // lane j's sequence j, starting at op and ending at end
  int ip[LZ4T_NL], nl[LZ4T_NL], off[LZ4T_NL], m[LZ4T_NL], op[LZ4T_NL],
      end[LZ4T_NL];
  // a step's lanes: the byte x each resolves, and its state: 0 pending,
  // 1 input byte src, 2 output byte src (window below 0), 3 idle
  int x[LZ4T_NL], st[LZ4T_NL], src[LZ4T_NL];
  lz4t_lanes([&](int i) {
    const int l = lz4t_li(i);
    const int32_t* q = e + 4 * i;
    ip[l] = i < n ? q[0] : 0;
    nl[l] = i < n ? q[1] : 0;
    off[l] = i < n ? lz4t_max(q[2], 1) : 1;
    m[l] = i < n ? q[3] : 0;
    end[l] = nl[l] + m[l];
  });
  done();
  lz4t_lane_scan(end);
  lz4t_lanes([&](int i) {
    const int l = lz4t_li(i);
    end[l] += bop;
    op[l] = end[l] - nl[l] - m[l];
  });
  const int bend = lz4t_lane_get(end, LZ4T_LANES - 1);
  for (int S = bop; S < bend; S += span) {
    for (int ww = w1 - 1; ww >= w0; ww--) {
      const int s = S + ww * LZ4T_LANES;
      lz4t_lanes([&](int i) {
        const int l = lz4t_li(i);
        x[l] = s + i;
        st[l] = s + i < bend ? 0 : 3;
      });
      // resolve: a match byte whose source lies in this step takes that
      // source's place (its sequence is an earlier one, or the same
      // sequence's literals), until every source is input or an earlier
      // step's output
      while (lz4t_ballot([&](int i) { return st[lz4t_li(i)] == 0; })) {
        lz4t_lanes([&](int i) {
          const int l = lz4t_li(i);
          // k: the last sequence starting at or before x (ops rise over
          // the batch, every sequence writes a byte, and lanes past n
          // start at bend), by binary search over the lanes
          int k = 0;
          for (int d = LZ4T_LANES / 2; d; d >>= 1)
            if (lz4t_lane_get(op, k + d) <= x[l]) k += d;
          const int kop = lz4t_lane_get(op, k), knl = lz4t_lane_get(nl, k);
          const int kip = lz4t_lane_get(ip, k), koff = lz4t_lane_get(off, k);
          if (st[l] != 0) return;
          const int om = kop + knl;
          if (x[l] < om) {
            st[l] = 1;
            src[l] = kip + x[l] - kop;
            return;
          }
          const int y = koff >= LZ4T_LANES ? x[l] - koff
                                           : om - koff + (x[l] - om) % koff;
          if (y < S) {
            st[l] = 2;
            src[l] = y;
          } else {
            x[l] = y;
          }
        });
      }
      lz4t_lanes_copy(
          [&](int i) {
            const int l = lz4t_li(i), y = src[l];
            if (st[l] == 1) return lit(y);
            if (st[l] == 3) return -1;
            if (y >= 0) return (int)o[y];
            return W + y >= 0 ? (int)win[W + y] : 0;
          },
          [&](int i, int v) { o[s + i] = (uint8_t)v; });
    }
#if defined(__CUDA_ARCH__)
    // the step's bytes are written before any copy warp reads them (the
    // clobber keeps the compiler from moving a load of o across it: the
    // output may lie in device memory)
    asm volatile("bar.sync %0, %1;" ::"n"(LZ4T_COPY_BAR), "r"(span)
                 : "memory");
#endif
  }
  return bend;
}

// The copies of one record (K5): its n sequences seq[4 k ..] in order
// from output position 0, in batches of 32, by LZ4T_COPY_WARPS warps (see
// lz4t_copy_batch_lanes); input reads past C return 0.
LZ4T_HD void lz4t_copy_record_lanes(const uint8_t* c, int C, uint8_t* o,
                                    const uint8_t* win, int W,
                                    const int32_t* seq, int n, int w) {
  const auto lit = [c, C](int p) { return lz4t_rdz(c, C, p); };
  int bop = 0;
  for (int b = 0; b < n; b += LZ4T_LANES)
    bop = lz4t_copy_batch_lanes<LZ4T_COPY_WARPS>(
        lit, o, win, W, seq + 4 * (size_t)b, lz4t_min(n - b, LZ4T_LANES),
        bop, w, [] {});
}

// The parse of one record, record mode (K5). It is scalar and hands each
// sequence's copies to emit(ip, n_lit, off, m) in order, each writing at
// the output position where the one before ended (the prologue at 0), for
// lz4t_copy_record_lanes. c: the record's input slice, C
// bytes; out_len is clamped to cap. A sequence that copies nothing is not
// handed over, and every one but the record's first and last copies 4 or
// more match bytes, so a record hands over at most cap / 4 + 2.
template <class Emit>
LZ4T_HD void lz4t_decode_record(const uint8_t* c, int C, const int32_t* meta,
                                int cap, Emit& emit, int* n_out,
                                int* ok_out) {
  const int clen = meta[0];
  const int dlen = meta[1];
  const int out_len = lz4t_min(meta[6], cap);
  const int pre_lit = meta[2], pre_skip = meta[3];
  const int pre_moff = meta[4], pre_mlen = meta[5];
  int bad = (pre_lit > clen) | (pre_lit + pre_mlen > out_len) |
            ((pre_mlen > 0) & (pre_moff > pre_lit + dlen)) | (pre_lit < 0) |
            (pre_mlen < 0);
  const int p_lit = bad ? 0 : pre_lit;
  const int p_m = bad ? 0 : pre_mlen;
  if (p_lit | p_m) emit(0, p_lit, pre_moff, p_m);
  int ip = p_lit + pre_skip;
  int op = p_lit + p_m;
  bad |= ip > clen;
  int ok = !bad;
  int done = bad | (ip >= clen);
  while (!done) {
    bad = ip >= clen;
    const int token = lz4t_rdz(c, C, ip);
    ip++;
    int lit = token >> 4;
    if (lit == 15) ip = lz4t_varint_z(c, C, ip, &lit);
    int lit_n = lz4t_min(lit, out_len - op);
    bad |= (lit_n < 0) | (ip + lit_n > clen);
    if (bad) lit_n = 0;
    int clip = !bad && lit_n < lit;
    const int lit_ip = ip;
    ip += lit_n;
    op += lit_n;
    const int fin = (ip >= clen) | bad | clip;
    int off = 1, m_n = 0;
    if (!fin) {
      off = lz4t_rdz(c, C, ip) | (lz4t_rdz(c, C, ip + 1) << 8);
      ip += 2;
      bad |= (ip > clen) | (off == 0);
      int ml = token & 15;
      if (ml == 15) ip = lz4t_varint_z(c, C, ip, &ml);
      ml += 4;
      bad |= off > op + dlen;
      m_n = bad ? 0 : lz4t_min(ml, out_len - op);
      clip = !bad && (m_n < ml || op + m_n == out_len);
      op += m_n;
    }
    if (lit_n | m_n) emit(lit_ip, lit_n, off, m_n);
    ok = ok && !bad;
    done = fin | bad | clip;
  }
  *n_out = op;
  *ok_out = ok && ip == clen;
}
