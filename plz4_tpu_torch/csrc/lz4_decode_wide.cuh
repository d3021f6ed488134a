// LZ4 block decode of one wide row: the semantics of the Pallas kernel
// plz4_tpu/ops/decode_pallas.py:_decode_kernel, the packed-word kernel
// that decode_block_pallas takes when out_cap > 96 KiB (up to the 4 MiB
// LZ4 block). Its wrapper appends 8 zero bytes to the compressed row and
// clips every read there, so a read at or past the row's C bytes returns
// 0. The sequence loop is K1's (lz4_decode.cuh) with one difference:
//   * a literal run that fails its checks (ip + lit > clen or op + lit >
//     out_cap) copies nothing, but ip and op still advance by its full
//     length before the loop stops (decode_pallas.py:248-249), so n_out on
//     a corrupt stream can exceed out_cap; bytes [0, n_out) are then not
//     all written. K1 advances by 0 there.
// Everything else is shared: bad = ip >= clen at each token, a stop when
// ip >= clen after the literals, bad |= ip > clen | off == 0 after the
// offset, bad |= op + ml > out_cap | off > op after the match length (no
// match bytes then), and at the end ok &= ip == clen. Match copies follow
// the LZ4 semantics (a byte-serial forward copy).
// lz4t_decode_wide_row is the serial body: K6a runs the same rules on the
// card as a parse thread feeding copy warps (lz4_decode_ring.cuh,
// lz4t_parse_strict with kCountBad), and the host build keeps this body as
// the reference that the CPU tests hold the new one to.
#pragma once

#include "lz4_common.cuh"

// Literals: n bytes from row byte s to o, 16 at a time, loads before
// stores (the row and the output live in device memory on the GPU).
LZ4T_HD void lz4t_copy_literals_z(uint8_t* o, const uint8_t* c, int C, int s,
                                  int n) {
  for (int i = 0; i < n; i += 16) {
    uint8_t t[16];
#pragma unroll
    for (int j = 0; j < 16; j++)
      t[j] = i + j < n ? (uint8_t)lz4t_rdz(c, C, s + i + j) : 0;
#pragma unroll
    for (int j = 0; j < 16; j++)
      if (i + j < n) o[i + j] = t[j];
  }
}

// A match of ml bytes at output position op from off bytes back, with the
// result of a byte-serial forward copy. Each step copies k <= 16 bytes from
// d bytes back, loads before stores: d is a multiple of off no larger than
// i + off (the match's output repeats with period off from op - off on), so
// the source is final, and k <= d. Short offsets double d as the copy
// grows.
LZ4T_HD void lz4t_copy_match_wide(uint8_t* o, int op, int off, int ml) {
  for (int i = 0; i < ml;) {
    const int d = off >= 16 ? off : (i + off) / off * off;
    const int k = lz4t_min(lz4t_min(d, 16), ml - i);
    uint8_t t[16];
#pragma unroll
    for (int j = 0; j < 16; j++) t[j] = j < k ? o[op + i - d + j] : 0;
#pragma unroll
    for (int j = 0; j < 16; j++)
      if (j < k) o[op + i + j] = t[j];
    i += k;
  }
}

// c: the compressed row, C bytes, clen of them the stream; o: out_cap
// bytes.
LZ4T_HD void lz4t_decode_wide_row(const uint8_t* c, int C, int clen,
                                  uint8_t* o, int out_cap, int* n_out,
                                  int* ok_out) {
  int ip = 0, op = 0;
  int ok = clen > 0;
  int done = clen <= 0;
  while (!done) {
    int bad = ip >= clen;
    const int token = lz4t_rdz(c, C, ip++);
    int lit = token >> 4;
    if (lit == 15) ip = lz4t_varint_z(c, C, ip, &lit);
    bad |= (ip + lit > clen) | (op + lit > out_cap);
    if (!bad) lz4t_copy_literals_z(o + op, c, C, ip, lit);
    ip += lit;
    op += lit;
    const int fin = (ip >= clen) | bad;
    if (!fin) {
      const int off = lz4t_rdz(c, C, ip) | (lz4t_rdz(c, C, ip + 1) << 8);
      ip += 2;
      bad |= (ip > clen) | (off == 0);
      int ml = token & 15;
      if (ml == 15) ip = lz4t_varint_z(c, C, ip, &ml);
      ml += 4;
      bad |= (op + ml > out_cap) | (off > op);
      if (!bad) {
        lz4t_copy_match_wide(o, op, off, ml);
        op += ml;
      }
    }
    ok = ok && !bad;
    done = fin | bad;
  }
  *n_out = op;
  *ok_out = ok && ip == clen;
}
