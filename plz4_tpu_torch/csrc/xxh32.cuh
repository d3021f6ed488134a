// xxHash-32 of one row: the semantics of plz4_tpu/ops/xxh32_jax.py:
// xxh32_batch, which is the standard xxh32 of the row's first len bytes.
// Four accumulators fold the full 16-byte stripes (accumulator k takes the
// stripe's word k); a row under 16 bytes starts from seed + P5 instead;
// then len is added, up to three 4-byte words and three bytes of tail fold
// in, and the avalanche mixes the result. All arithmetic wraps mod 2^32.
//
// K7 (xxh32.cu) and the host build (lz4_host.cpp) run the same three
// steps over a row: lz4t_xxh32_stage copies the row, a chunk of
// LZ4T_XXH_CHUNK bytes at a time, into a 16-byte-aligned buffer;
// lz4t_xxh32_stripes folds the chunk's stripes from it in one thread, its
// four accumulators four independent chains; lz4t_xxh32_finish hashes the
// tail from the last chunk's buffer. Only bytes [0, len) of the row are
// read, whatever its alignment, so a row needs no padding.
#pragma once

#include "lz4_common.cuh"

#if !defined(__CUDA_ARCH__)
#include <string.h>
#endif

#define LZ4T_XXH_P1 2654435761u
#define LZ4T_XXH_P2 2246822519u
#define LZ4T_XXH_P3 3266489917u
#define LZ4T_XXH_P4 668265263u
#define LZ4T_XXH_P5 374761393u
// bytes staged per chunk (a multiple of 16)
#define LZ4T_XXH_CHUNK 4096

LZ4T_HD uint32_t lz4t_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

LZ4T_HD uint32_t lz4t_xxh_word(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// the accumulators before the first stripe
LZ4T_HD void lz4t_xxh32_init(uint32_t* acc, uint32_t seed) {
  acc[0] = seed + LZ4T_XXH_P1 + LZ4T_XXH_P2;
  acc[1] = seed + LZ4T_XXH_P2;
  acc[2] = seed;
  acc[3] = seed - LZ4T_XXH_P1;
}

LZ4T_HD uint32_t lz4t_xxh32_round(uint32_t acc, uint32_t w) {
  return lz4t_rotl(acc + w * LZ4T_XXH_P2, 13) * LZ4T_XXH_P1;
}

// Fold the ns stripes of the 16-byte-aligned words w into acc: one
// thread, the four accumulators four independent chains, one 16-byte load
// per stripe. Unrolled 32 times, so that the loads of 32 stripes issue
// ahead of their rounds and the loop's own steps leave the chains.
LZ4T_HD void lz4t_xxh32_stripes(uint32_t* acc, const uint32_t* w, int ns) {
  uint32_t a0 = acc[0], a1 = acc[1], a2 = acc[2], a3 = acc[3];
#pragma unroll 32
  for (int s = 0; s < ns; s++) {
#if defined(__CUDA_ARCH__)
    const uint4 v = reinterpret_cast<const uint4*>(w)[s];
#else
    const struct { uint32_t x, y, z, w; } v = {w[4 * s], w[4 * s + 1],
                                               w[4 * s + 2], w[4 * s + 3]};
#endif
    a0 = lz4t_xxh32_round(a0, v.x);
    a1 = lz4t_xxh32_round(a1, v.y);
    a2 = lz4t_xxh32_round(a2, v.z);
    a3 = lz4t_xxh32_round(a3, v.w);
  }
  acc[0] = a0;
  acc[1] = a1;
  acc[2] = a2;
  acc[3] = a3;
}

// The hash of a row of len bytes from its accumulators (after every full
// stripe) and its tail t: the bytes [len / 16 * 16, len).
LZ4T_HD uint32_t lz4t_xxh32_finish(const uint32_t* acc, const uint8_t* t,
                                   int len, uint32_t seed) {
  uint32_t h = len >= 16 ? lz4t_rotl(acc[0], 1) + lz4t_rotl(acc[1], 7) +
                               lz4t_rotl(acc[2], 12) + lz4t_rotl(acc[3], 18)
                         : seed + LZ4T_XXH_P5;
  h += (uint32_t)len;
  const int rest = len & 15;
  int i = 0;
  for (; i + 4 <= rest; i += 4)
    h = lz4t_rotl(h + lz4t_xxh_word(t + i) * LZ4T_XXH_P3, 17) * LZ4T_XXH_P4;
  for (; i < rest; i++)
    h = lz4t_rotl(h + t[i] * LZ4T_XXH_P5, 11) * LZ4T_XXH_P1;
  h ^= h >> 15;
  h *= LZ4T_XXH_P2;
  h ^= h >> 13;
  h *= LZ4T_XXH_P3;
  h ^= h >> 16;
  return h;
}

// the 16 bytes at the 16-byte-aligned address a
LZ4T_HD void lz4t_xxh_load16(const uint8_t* a, uint32_t* x) {
#if defined(__CUDA_ARCH__)
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
#else
  memcpy(x, a, 16);
#endif
}

// x[0..3] to the 16-byte-aligned words d
LZ4T_HD void lz4t_xxh_store16(uint32_t* d, const uint32_t* x) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(d) = make_uint4(x[0], x[1], x[2], x[3]);
#else
  memcpy(d, x, 16);
#endif
}

LZ4T_HD uint32_t lz4t_xxh_funnel(uint32_t lo, uint32_t hi, int sh) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(lo, hi, sh);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> sh);
#endif
}

// Copy the row bytes [b0, b1) of p (0 <= b0 < b1 <= len, b0 % 16 == 0)
// into the 16-byte-aligned words dst, dst's granule j holding row bytes
// b0 + 16 j .. + 15; thread t of nt takes granules t, t + nt, ... A row
// start need not be aligned: a granule whose bytes lie in two aligned
// 16-byte units of the row takes two 16-byte loads and funnel shifts; one
// that would need a unit reaching outside p[0, len) (the row's first and
// last units) is read byte by byte, and its bytes past len are zero.
LZ4T_HD void lz4t_xxh32_stage(const uint8_t* p, int len, int b0, int b1,
                              uint32_t* dst, int t, int nt) {
  const int sh = (int)((uintptr_t)p & 15);  // the row start's misalignment
  const int q = sh >> 2, bs = (sh & 3) * 8;
  const int ng = (b1 - b0 + 15) >> 4;
  for (int j = t; j < ng; j += nt) {
    const int x0 = b0 + 16 * j;  // the granule's first row byte
    uint32_t v[4];
    if (x0 - sh >= 0 && x0 - sh + (sh ? 32 : 16) <= len) {
      uint32_t u[8];  // the one or two units
      lz4t_xxh_load16(p + x0 - sh, u);
      if (sh) {
        lz4t_xxh_load16(p + x0 - sh + 16, u + 4);
        // words q .. q + 4 of the units, selected without a local array
        // (q is the same for every granule of the row)
#pragma unroll
        for (int k = 0; k < 4; k++) {
          const uint32_t lo = q == 0 ? u[k] : q == 1 ? u[k + 1]
                            : q == 2 ? u[k + 2] : u[k + 3];
          const uint32_t hi = q == 0 ? u[k + 1] : q == 1 ? u[k + 2]
                            : q == 2 ? u[k + 3] : u[k + 4];
          u[k] = bs ? lz4t_xxh_funnel(lo, hi, bs) : lo;
        }
      }
      for (int k = 0; k < 4; k++) v[k] = u[k];
    } else {
      for (int k = 0; k < 4; k++) {
        v[k] = 0;
        for (int b = 0; b < 4; b++) {
          const int x = x0 + 4 * k + b;
          v[k] |= (uint32_t)(x < len ? p[x] : 0) << (8 * b);
        }
      }
    }
    lz4t_xxh_store16(dst + 4 * j, v);
  }
}
