// LZ4 decode against a right-aligned window, one row: the function that
// the Pallas kernels plz4_tpu/ops/decode_pallas.py:_decode_dict_kernel
// (strict and record mode) and _decode_kernel_bw_rec (record mode)
// compute. Their word copies, 8-wide wild copies and straight-line fast
// tiers return the same (ip, op, ok) and the same bytes [0, op) as their
// byte-serial careful path, so one exact loop stands for all of them.
//
// meta = [clen, dlen, pre_lit, pre_skip, pre_moff, pre_mlen, out_len]
// (the native lz4r_chunk_split record layout, dlen in meta[1]); win holds W
// window bytes right-aligned: a match source j bytes before the row's
// first output byte is win[W - j]. A match may read up to op + dlen back,
// so a match that ends exactly at the window/output boundary reads the
// window's last byte.
//
// kStrict (K3, whole-block decode against a frame dictionary): the carry
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
#pragma once

#include "lz4_common.cuh"

// m match bytes to o[op..) from op - off: sources before the row's first
// output byte come from the window, the rest from the output itself
// (overlapping copies repeat the period, byte by byte).
LZ4T_HD void lz4t_copy_match_w(uint8_t* o, int op, int off, int m,
                               const uint8_t* win, int W) {
  if (off < 1) off = 1;
  int i = 0;
  for (; i < m && op + i < off; i++) {
    const int w = W - off + op + i;
    o[op + i] = w >= 0 ? win[w] : 0;
  }
  for (; i < m; i++) o[op + i] = o[op + i - off];
}

// c: the compressed row, C bytes; win: W window bytes; o: cap output bytes.
template <bool kStrict>
LZ4T_HD void lz4t_decode_window_row(const uint8_t* c, int C,
                                    const int32_t* meta, const uint8_t* win,
                                    int W, uint8_t* o, int cap, int* n_out,
                                    int* ok_out) {
  const int clen = meta[0];
  const int dlen = meta[1];
  const int out_len = lz4t_min(meta[6], cap);
  int ip, op, ok, done;
  if (kStrict) {
    ip = 0;
    op = 0;
    ok = clen > 0;
    done = clen <= 0;
  } else {
    const int pre_lit = meta[2], pre_skip = meta[3];
    const int pre_moff = meta[4], pre_mlen = meta[5];
    int bad = (pre_lit > clen) | (pre_lit + pre_mlen > out_len) |
              ((pre_mlen > 0) & (pre_moff > pre_lit + dlen)) |
              (pre_lit < 0) | (pre_mlen < 0);
    const int p_lit = bad ? 0 : pre_lit;
    for (int i = 0; i < p_lit; i++) o[i] = (uint8_t)lz4t_rdz(c, C, i);
    const int p_m = bad ? 0 : pre_mlen;
    lz4t_copy_match_w(o, p_lit, pre_moff, p_m, win, W);
    ip = p_lit + pre_skip;
    op = p_lit + p_m;
    bad |= ip > clen;
    ok = !bad;
    done = bad | (ip >= clen);
  }
  while (!done) {
    int bad = ip >= clen;
    const int token = lz4t_rdz(c, C, ip);
    ip++;
    int lit = token >> 4;
    if (lit == 15) ip = lz4t_varint_z(c, C, ip, &lit);
    int lit_n, clip = 0;
    if (kStrict) {
      bad |= (ip + lit > clen) | (op + lit > out_len);
      lit_n = bad ? 0 : lit;
    } else {
      lit_n = lz4t_min(lit, out_len - op);
      bad |= (lit_n < 0) | (ip + lit_n > clen);
      if (bad) lit_n = 0;
      clip = !bad && lit_n < lit;
    }
    for (int i = 0; i < lit_n; i++)
      o[op + i] = (uint8_t)lz4t_rdz(c, C, ip + i);
    ip += lit_n;
    op += lit_n;
    const int fin = (ip >= clen) | bad | clip;
    if (!fin) {
      const int off = lz4t_rdz(c, C, ip) | (lz4t_rdz(c, C, ip + 1) << 8);
      ip += 2;
      bad |= (ip > clen) | (off == 0);
      int ml = token & 15;
      if (ml == 15) ip = lz4t_varint_z(c, C, ip, &ml);
      ml += 4;
      bad |= off > op + dlen;
      int m_n;
      if (kStrict) {
        bad |= op + ml > out_len;
        m_n = bad ? 0 : ml;
      } else {
        m_n = bad ? 0 : lz4t_min(ml, out_len - op);
        clip = !bad && (m_n < ml || op + m_n == out_len);
      }
      lz4t_copy_match_w(o, op, off, m_n, win, W);
      op += m_n;
    }
    ok = ok && !bad;
    done = fin | bad | clip;
  }
  *n_out = op;
  *ok_out = ok && ip == clen;
}
