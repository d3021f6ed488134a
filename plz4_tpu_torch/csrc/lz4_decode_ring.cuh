// K1, K3 and K6a's row body: a parse thread feeding byte-parallel copy
// warps through a ring of sequences in shared memory.
//
// The rules. Each kernel returns what a Pallas TPU kernel of
// plz4_tpu/ops/decode_pallas.py returns: K1 _decode_kernel_bw's, K3
// _decode_dict_kernel's in strict mode (its rules are in
// lz4_decode_window.cuh), K6a _decode_kernel's, the packed-word kernel that
// decode_block_pallas takes when out_cap > 96 KiB (up to the 4 MiB LZ4
// block). Their byte-serial "careful" tier defines the result; their
// straight-line fast tiers and word copies are a TPU optimisation that
// returns the same (ip, op, ok) and the same bytes [0, op) on every input,
// so one exact sequence loop stands for all of them. K1's:
//   * ok starts as clen > 0;
//   * per sequence: bad = ip >= clen; after the literal length,
//     bad |= ip+lit > clen | op+lit > out_cap (no literals copied then);
//     stop when ip >= clen after the literals; after the 2-byte offset,
//     bad |= ip > clen | off == 0; after the match length,
//     bad |= op+ml > out_cap | off > op (no match bytes copied then);
//   * at the end ok &= ip == clen and n_out = op.
// Every read of the input clips at C - 1, as the kernel's do, so rows need
// zero padding past clen; a run of 255s that reaches the clipped last byte
// never ends in the Pallas kernel, and here ends with a length no bounds
// check accepts. Match-length extensions are not checked against clen, and
// the LZ4 end-of-block rules are not enforced: neither is by the Pallas
// kernel. K6a's loop is K1's with two differences: its wrapper appends 8
// zero bytes to the row and clips every read there, so a read at or past C
// returns 0; and a literal run that fails its checks copies nothing, but ip
// and op still advance by its full length before the loop stops
// (decode_pallas.py:248-249), so n_out on a corrupt stream can exceed
// out_cap, and bytes [0, n_out) are then not all written (K1 advances by 0
// there). Match copies follow the LZ4 semantics (a byte-serial forward
// copy). The plain versions in plz4_tpu_torch/ops/decode.py
// (decode_row_plain, decode_window_row_plain, decode_row_wide_plain) run
// this loop over Python bytes.
//
// lz4t_parse_strict runs the loop of K1 (kClip), of K3 (reads past C
// return 0, offsets may reach dlen bytes into the window) or of K6a
// (kCountBad) in emit form: it copies nothing itself and hands each
// sequence, (ip, n_lit, off, m), to emit in order with exactly the bytes
// the loop copies: a sequence whose literals fail its checks copies
// nothing and ends the row, one whose match fails copies its literals
// only. lz4t_copy_batch_lanes (lz4_decode_window.cuh) then writes the bytes
// [0, n_out) the loop writes (K6a: the bytes it writes), 32 sequences at a
// time.
//
// The parse and the copies read the row through a Row: lz4t_pad_row, a
// padded copy in shared memory (K1, K3) whose C bytes are followed by
// LZ4T_RING_PAD more that hold what every read past C returns (c[C-1] for
// K1, 0 for K3), so a read at p reads min(p, C) and needs no branch; or
// the row in place in device memory (K6a), whose reads at or past C return
// 0 (the bytes there are the next row's, or lie past the allocation):
// lz4t_tail_row where the row ends in zeros that its stream does not reach,
// as the wrappers' rows do (no read reaches C there, so none is guarded),
// else lz4t_dev_row (a guard on each read).
//
// On the card (lz4t_ring_decode): warp 0's lane 0 parses and fills a ring
// of LZ4T_RING_BATCHES slots of 32 sequences; warps 1-7 copy the slots in
// order into the output row, in shared memory (K1, K3, which then copy it
// out) or in device memory (K6a, no copy-out: a match's source is read
// back from device memory with plain loads, ordered by the copy steps'
// barrier). Each slot has a full and an empty mbarrier: the parse waits on
// a slot's empty barrier (one arrival per copy warp, once it has read the
// slot) before it refills it, and arrives on its full barrier when the
// slot holds 32 sequences or the row's last ones (fewer than 32, maybe 0,
// which tells the copy warps that the row has ended). The host build runs
// the same parse and copies through the same ring, copying the oldest
// batch whenever the parse finds the ring full.
#pragma once

#include "lz4_decode_window.cuh"

#define LZ4T_RING_BATCHES 64  // ring slots (a power of 2), 32 sequences
                              // of 16 B each
#define LZ4T_RING_PAD 16      // bytes staged past the input row
#define LZ4T_RING_WARPS 7     // copy warps: the block's other warps
// shared memory ahead of the staged rows: the ring, two mbarriers and a
// count per slot, and the row's n_out (ops/decode.py: RING_SMEM)
#define LZ4T_RING_SMEM (LZ4T_RING_BATCHES * (32 * 16 + 8 + 8 + 4) + 16)

// a row staged in shared memory with its pad (K1, K3): byte p is
// cb[min(p, C)]
struct lz4t_pad_row {
  const uint8_t* cb;
  int C;
  LZ4T_HDM int operator()(int p) const { return cb[lz4t_min(p, C)]; }
  // bytes p .. p + 4 into b (past C the pad holds what every read there
  // returns)
  LZ4T_HDM void five(int p, int* b) const {
    const uint8_t* w = cb + lz4t_min(p, C);
#pragma unroll
    for (int i = 0; i < 5; i++) b[i] = w[i];
  }
};

// byte *p of a row in device memory, through the read-only path on the card
LZ4T_HD int lz4t_ldg(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// A row read in place in device memory (K6a): bytes at or past C read 0.
// lz4t_dev_row guards each read. lz4t_tail_row reads without a guard, for
// a row that ends in LZ4T_TAIL_ZEROS zero bytes and whose stream ends
// before them (lz4t_tail_fits), as the wrappers' rows do: then no read of
// the parse or the copies reaches C. A length run stops at the first zero,
// at or before C - Z (Z = LZ4T_TAIL_ZEROS), since a 255 or a token with a
// length nibble of 15 lies below it; a match is taken only where its
// offset ends by clen <= C - Z, so the next token lies at or before
// C - Z + 1, and a pass that starts there reads a zero token and its five
// bytes from C - Z + 2, the last at C - Z + 6 < C. The copies read only
// literals below clen.
#define LZ4T_TAIL_ZEROS 8
struct lz4t_dev_row {
  const uint8_t* c;
  int C;
  LZ4T_HDM int operator()(int p) const {
    return (unsigned)p < (unsigned)C ? lz4t_ldg(c + p) : 0;
  }
  LZ4T_HDM void five(int p, int* b) const {
#pragma unroll
    for (int i = 0; i < 5; i++) b[i] = (*this)(p + i);
  }
};

struct lz4t_tail_row {
  const uint8_t* c;
  int C;
  LZ4T_HDM int operator()(int p) const { return lz4t_ldg(c + p); }
  LZ4T_HDM void five(int p, int* b) const {
#pragma unroll
    for (int i = 0; i < 5; i++) b[i] = lz4t_ldg(c + p + i);
  }
};

// whether row c of C bytes, its stream clen bytes, may be read through
// lz4t_tail_row: it ends in LZ4T_TAIL_ZEROS zero bytes that the stream
// does not reach
LZ4T_HD bool lz4t_tail_fits(const uint8_t* c, int C, int clen) {
  if (C < LZ4T_TAIL_ZEROS || clen > C - LZ4T_TAIL_ZEROS) return false;
  int t = 0;
  for (int i = C - LZ4T_TAIL_ZEROS; i < C; i++) t |= lz4t_ldg(c + i);
  return t == 0;
}

// byte p of a padded row of C bytes (cw: (C + LZ4T_RING_PAD) / 4 words);
// this, lz4t_pad_varint and the word-pointer form of lz4t_parse_strict
// below are the padded row's interface that tools/decode_stamps_torch.py
// builds its probes against
LZ4T_HD int lz4t_pad_rd(const uint32_t* cw, int C, int p) {
  return reinterpret_cast<const uint8_t*>(cw)[lz4t_min(p, C)];
}

// LZ4 length extension from p over a row (kClip: K1's rule, a run of 255s
// that reaches the clipped last byte ends with a length no check accepts;
// else the zeros read past C end it)
template <bool kClip, class Row>
LZ4T_HD int lz4t_row_varint(const Row& row, int p, int* len) {
  int t = *len, b;
  do {
    b = row(p++);
    t += b;
    if (kClip && p > row.C && b == 255) {
      t = 0x3fffffff;
      break;
    }
  } while (b == 255);
  *len = t;
  return p;
}

// the same over a padded row
template <bool kClip>
LZ4T_HD int lz4t_pad_varint(const uint32_t* cw, int C, int p, int* len) {
  const lz4t_pad_row row = {reinterpret_cast<const uint8_t*>(cw), C};
  return lz4t_row_varint<kClip>(row, p, len);
}

// Strict parse of one row (K1: kClip, dlen 0; K3: dlen window bytes; K6a:
// kCountBad, dlen 0), read through row, handing its sequences to emit in
// order: emit.open() before each batch of 32 (emit.k, the count so far, is
// then a multiple of 32), then emit(ip, n_lit, off, m) for each sequence,
// with the literals and match bytes that the rules' loop copies (the last
// one may copy nothing). out_len is the output cap. kCountBad: n_out
// counts the full length of a literal run that fails its checks, as K6a's
// loop advances past it uncopied (so n_out may exceed out_len on a
// corrupt stream, with ok false).
//
// Written for one thread's dependent chain, whose links are row reads and
// branches: once a sequence's literal length is known, the five bytes
// where its literals end are read at once (the offset, a match length
// extension byte, and the next token and the byte after it, with or
// without that extension byte), and a length with one extension byte is
// taken from them without a branch. Only a length of two or more
// extension bytes branches (its 255s, then the loop). The match is emitted
// before its checks are known, which hold on every valid stream: where
// they fail, the next pass takes the match back (emit.drop_last) and
// stops, as the rules' loop stops after copying the literals only. A batch
// is published by the next open(), or by finish(), so drop_last may still
// change its last sequence.
template <bool kClip, bool kCountBad, class Row, class Emit>
LZ4T_HD void lz4t_parse_strict(const Row& row, int clen, int dlen,
                               int out_len, Emit& emit, int* n_out,
                               int* ok_out) {
  int ip = 0, op = 0, ok = clen > 0, done = clen <= 0;
  int token = row(0), e1 = row(1);  // the token, the byte after
  // the last sequence: its match failed its checks, its match length
  int last_bad = 0, last_m = 0;
  while (!done) {
    emit.open();
    const int kend = emit.k + 32;
    do {
      if (__builtin_expect(last_bad, 0)) break;
      int lit = token >> 4;
      const int x15 = lit == 15;
      int p = ip + 1 + x15;
      lit += x15 ? e1 : 0;
      if (__builtin_expect(x15 & (e1 == 255), 0)) {
        lit = 15;
        p = lz4t_row_varint<kClip>(row, ip + 1, &lit);
      }
      const int bad = (ip >= clen) | (p + lit > clen) | (op + lit > out_len);
      const int lit_n = bad ? 0 : lit;
      const int lit_ip = p;
      p += lit_n;
      op += kCountBad ? lit : lit_n;
      const int fin = (p >= clen) | bad;
      int b[5];
      row.five(p, b);
      const int off = b[0] | b[1] << 8;
      int ml = token & 15;
      const int m15 = ml == 15;
      int q = p + 2 + m15;
      ml += m15 ? b[2] : 0;
      token = m15 ? b[3] : b[2];
      e1 = m15 ? b[4] : b[3];
      if (__builtin_expect(m15 & (b[2] == 255) & !fin, 0)) {
        ml = 15;
        q = lz4t_row_varint<kClip>(row, p + 2, &ml);
        token = row(q);
        e1 = row(q + 1);
      }
      ml += 4;
      const int m = fin ? 0 : ml;
      last_bad = (!fin) & ((p + 2 > clen) | (off == 0) | (off > op + dlen) |
                         (op + ml > out_len));
      last_m = m;
      emit(lit_ip, lit_n, off, m);
      op += m;
      ok = ok && !bad;
      done = fin;
      ip = fin ? p : q;
    } while (!done & (emit.k < kend));
    if (last_bad) {
      op -= last_m;
      emit.drop_last();
      ok = 0;
      break;
    }
  }
  *n_out = op;
  *ok_out = ok && ip == clen;
}

// The same over a padded row of C bytes (cw: (C + LZ4T_RING_PAD) / 4
// words)
template <bool kClip, class Emit>
LZ4T_HD void lz4t_parse_strict(const uint32_t* cw, int C, int clen, int dlen,
                               int out_len, Emit& emit, int* n_out,
                               int* ok_out) {
  const lz4t_pad_row row = {reinterpret_cast<const uint8_t*>(cw), C};
  lz4t_parse_strict<kClip, false>(row, clen, dlen, out_len, emit, n_out,
                                  ok_out);
}

#if defined(__CUDACC__)

// The parse's side of the ring: sequence k goes to entry k % 32 of slot
// (k / 32) % LZ4T_RING_BATCHES (a power of 2), that is to ring[k % (32
// LZ4T_RING_BATCHES)].
struct lz4t_ring_emit {
  int4* ring;
  int* cnt;
  uint64_t* full;
  uint64_t* empty;
  int k;    // sequences emitted
  int pub;  // batches published
  __device__ void publish(int n) {
    const int s = pub++ & (LZ4T_RING_BATCHES - 1);
    cnt[s] = n;
    lz4t_mbar_arrive(&full[s]);
  }
  // at k = 32 b: publish batch b - 1, and wait until the copy warps have
  // read the last round of batch b's slot
  __host__ __device__ void open() {
#if defined(__CUDA_ARCH__)
    const int b = k >> 5;
    if (pub < b) publish(32);
    if (b >= LZ4T_RING_BATCHES)
      lz4t_mbar_wait(&empty[b & (LZ4T_RING_BATCHES - 1)],
                     (b / LZ4T_RING_BATCHES - 1) & 1);
#endif
  }
  __host__ __device__ void operator()(int ip, int n_lit, int off, int m) {
#if defined(__CUDA_ARCH__)
    ring[k++ & (32 * LZ4T_RING_BATCHES - 1)] = make_int4(ip, n_lit, off, m);
#endif
  }
  // the last sequence copies its literals only
  __host__ __device__ void drop_last() {
#if defined(__CUDA_ARCH__)
    ring[(k - 1) & (32 * LZ4T_RING_BATCHES - 1)].w = 0;
#endif
  }
  // the row's last batch: fewer than 32 sequences
  __device__ void finish() {
    if ((k & 31) == 0) open();
    publish(k & 31);
  }
};

// The ring's barriers, set up by thread 0 in smem (LZ4T_RING_SMEM bytes)
// before the block syncs
__device__ __forceinline__ void lz4t_ring_init(uint8_t* smem) {
  constexpr int NB = LZ4T_RING_BATCHES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NB * 32 * 16);
  uint64_t* empty = full + NB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NB; s++) {
      lz4t_mbar_init(&full[s], 1);
      lz4t_mbar_init(&empty[s], LZ4T_RING_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// One row through the ring in smem, by the block's 256 threads, after
// lz4t_ring_init and a block sync: warp 0's lane 0 parses row (the strict
// parse with kClip and kCountBad, against dlen bytes of the window win of
// D bytes) and calls done(n_out, ok) once the last batch is published;
// warps 1-7 write the bytes the sequences copy to o, literals read through
// row. Returns when this thread's part is done (no block sync).
template <bool kClip, bool kCountBad, class Row, class Done>
__device__ __forceinline__ void lz4t_ring_decode(const Row& row, int clen,
                                                 int dlen, int out_cap,
                                                 uint8_t* o,
                                                 const uint8_t* win, int D,
                                                 uint8_t* smem, Done done) {
  constexpr int NB = LZ4T_RING_BATCHES;
  int4* ring = reinterpret_cast<int4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NB * 32 * 16);
  uint64_t* empty = full + NB;
  int* cnt = reinterpret_cast<int*>(empty + NB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    if (lane == 0) {
      lz4t_ring_emit em = {ring, cnt, full, empty, 0, 0};
      int n, okv;
      lz4t_parse_strict<kClip, kCountBad>(row, clen, dlen, out_cap, em, &n,
                                          &okv);
      em.finish();
      done(n, okv);
    }
    __syncwarp();
  } else {
    int bop = 0;
    for (int b = 0;; b++) {
      const int s = b % NB;
      lz4t_mbar_wait(&full[s], (b / NB) & 1);
      __syncwarp();
      const int n = cnt[s];
      bop = lz4t_copy_batch_lanes<LZ4T_RING_WARPS>(
          row, o, win, D, reinterpret_cast<const int32_t*>(ring + s * 32), n,
          bop, warp - 1, [&] {
            if (lane == 0) lz4t_mbar_arrive(&empty[s]);
          });
      if (n < 32) break;
    }
  }
}

// One row of K1 (kClip; dict null, D = dlen = 0) or K3 (against the
// right-aligned window dict of D bytes, dlen usable) by the block's 256
// threads, staged in shared memory. smem: LZ4T_RING_SMEM + C +
// LZ4T_RING_PAD + D + out_cap bytes. Writes out[0, n_out) (the rest
// undefined), *n_out and *ok.
template <bool kClip>
__device__ __forceinline__ void lz4t_ring_row(
    const uint8_t* __restrict__ row, int C, int clen,
    const uint8_t* __restrict__ dict, int D, int dlen,
    uint8_t* __restrict__ out, int32_t* __restrict__ n_out,
    bool* __restrict__ ok, int out_cap, uint8_t* smem) {
  constexpr int NB = LZ4T_RING_BATCHES;
  // the row's n_out, after the ring, its barriers and counts
  int* s_n = reinterpret_cast<int*>(smem + NB * (32 * 16 + 8 + 8)) + NB;
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem + LZ4T_RING_SMEM);
  uint32_t* dw = cw + (C + LZ4T_RING_PAD) / 4;
  uint32_t* ow = dw + D / 4;
  const int t = threadIdx.x;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(row);
  const uint32_t* dsrc = reinterpret_cast<const uint32_t*>(dict);
  const int nw = C / 4;
  for (int i = t; i < nw; i += blockDim.x) cw[i] = src[i];
  if (t < LZ4T_RING_PAD / 4)
    cw[nw + t] = kClip && nw ? (src[nw - 1] >> 24) * 0x01010101u : 0u;
  for (int i = t; i < D / 4; i += blockDim.x) dw[i] = dsrc[i];
  lz4t_ring_init(smem);
  __syncthreads();
  const lz4t_pad_row prow = {reinterpret_cast<const uint8_t*>(cw), C};
  lz4t_ring_decode<kClip, false>(prow, clen, dlen, out_cap,
                                 reinterpret_cast<uint8_t*>(ow),
                                 reinterpret_cast<const uint8_t*>(dw), D,
                                 smem, [&](int n, int okv) {
                                   *n_out = n;
                                   *ok = okv != 0;
                                   *s_n = n;
                                 });
  __syncthreads();
  uint32_t* dst = reinterpret_cast<uint32_t*>(out);
  const int words = (*s_n + 3) / 4;  // n_out <= out_cap, out_cap % 4 == 0
  for (int i = t; i < words; i += blockDim.x) dst[i] = ow[i];
}

#endif  // __CUDACC__
