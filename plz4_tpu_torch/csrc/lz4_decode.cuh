// LZ4 block decode of one row: the semantics of the Pallas kernel
// plz4_tpu/ops/decode_pallas.py:_decode_kernel_bw. Its byte-serial
// "careful" tier defines the result; its two straight-line fast tiers are
// a TPU optimisation that returns the same (ip, op, ok) and the same bytes
// [0, op) on every input, so one exact loop stands for all three:
//   * ok starts as clen > 0;
//   * per sequence: bad = ip >= clen; after the literal length,
//     bad |= ip+lit > clen | op+lit > out_cap (no literals copied then);
//     stop when ip >= clen after the literals; after the 2-byte offset,
//     bad |= ip > clen | off == 0; after the match length,
//     bad |= op+ml > out_cap | off > op (no match bytes copied then);
//   * at the end ok &= ip == clen and n_out = op.
// Every read of the input clips at C - 1, as the kernel's do, so rows need
// zero padding past clen. Match-length extensions are not checked against
// clen, and the LZ4 end-of-block rules are not enforced: neither is by the
// reference kernel. lz4t_decode_row is the serial body: K1 runs the same
// rules on the card as a parse thread feeding copy warps
// (lz4_decode_ring.cuh), and the host build keeps this body as the
// reference that the CPU tests hold the new one to.
#pragma once

#include "lz4_common.cuh"

// LZ4 length extension starting at p: adds bytes until one is not 255.
// A run of 255s that reaches the clipped last byte never ends in the
// reference kernel; here it ends with a length no bounds check accepts.
LZ4T_HD int lz4t_read_varint(const uint8_t* c, int C, int p, int* len) {
  int t = *len;
  int b;
  do {
    b = c[lz4t_min(p, C - 1)];
    t += b;
    p++;
    if (p > C && b == 255) {
      t = 0x3fffffff;
      break;
    }
  } while (b == 255);
  *len = t;
  return p;
}

// c: the compressed row, C bytes, clen of them the stream; o: out_cap bytes.
LZ4T_HD void lz4t_decode_row(const uint8_t* c, int C, int clen, uint8_t* o,
                             int out_cap, int* n_out, int* ok_out) {
  int ip = 0, op = 0;
  int ok = clen > 0;
  int done = clen <= 0;
  while (!done) {
    int bad = ip >= clen;
    const int token = c[lz4t_min(ip, C - 1)];
    ip++;
    int lit = token >> 4;
    if (lit == 15) ip = lz4t_read_varint(c, C, ip, &lit);
    bad |= (ip + lit > clen) | (op + lit > out_cap);
    const int lit_n = bad ? 0 : lit;
    for (int i = 0; i < lit_n; i++) o[op + i] = c[lz4t_min(ip + i, C - 1)];
    ip += lit_n;
    op += lit_n;
    const int fin = (ip >= clen) | bad;
    if (!fin) {
      const int off =
          c[lz4t_min(ip, C - 1)] | (c[lz4t_min(ip + 1, C - 1)] << 8);
      ip += 2;
      bad |= (ip > clen) | (off == 0);
      int ml = token & 15;
      if (ml == 15) ip = lz4t_read_varint(c, C, ip, &ml);
      ml += 4;
      bad |= (op + ml > out_cap) | (off > op);
      const int m_n = bad ? 0 : ml;
      for (int i = 0; i < m_n; i++) o[op + i] = o[op + i - off];
      op += m_n;
    }
    ok = ok && !bad;
    done = fin | bad;
  }
  *n_out = op;
  *ok_out = ok && ip == clen;
}
