// xxHash-32 of one row: the semantics of plz4_tpu/ops/xxh32_jax.py:
// xxh32_batch, which is the standard xxh32 of the row's first len bytes.
// Four lane accumulators fold the full 16-byte stripes (lane k takes the
// stripe's word k); a row under 16 bytes starts from seed + P5 instead;
// then len is added, up to three 4-byte words and three bytes of tail fold
// in, and the avalanche mixes the result. All arithmetic wraps mod 2^32.
// Only bytes [0, len) are read, so a row needs no padding.
#pragma once

#include "lz4_common.cuh"

#define LZ4T_XXH_P1 2654435761u
#define LZ4T_XXH_P2 2246822519u
#define LZ4T_XXH_P3 3266489917u
#define LZ4T_XXH_P4 668265263u
#define LZ4T_XXH_P5 374761393u

LZ4T_HD uint32_t lz4t_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

LZ4T_HD uint32_t lz4t_xxh_word(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// Lane `lane` (0-3) of the stripe fold over the full stripes of p[0, len).
LZ4T_HD uint32_t lz4t_xxh32_lane(const uint8_t* p, int len, uint32_t seed,
                                 int lane) {
  uint32_t acc = seed + (lane == 0   ? LZ4T_XXH_P1 + LZ4T_XXH_P2
                         : lane == 1 ? LZ4T_XXH_P2
                         : lane == 2 ? 0u
                                     : 0u - LZ4T_XXH_P1);
  for (int s = 0; s + 16 <= len; s += 16)
    acc = lz4t_rotl(acc + lz4t_xxh_word(p + s + 4 * lane) * LZ4T_XXH_P2, 13) *
          LZ4T_XXH_P1;
  return acc;
}

// The hash of p[0, len) from its four lane accumulators.
LZ4T_HD uint32_t lz4t_xxh32_finish(const uint32_t* acc, const uint8_t* p,
                                   int len, uint32_t seed) {
  uint32_t h = len >= 16 ? lz4t_rotl(acc[0], 1) + lz4t_rotl(acc[1], 7) +
                               lz4t_rotl(acc[2], 12) + lz4t_rotl(acc[3], 18)
                         : seed + LZ4T_XXH_P5;
  h += (uint32_t)len;
  int i = len / 16 * 16;
  for (; i + 4 <= len; i += 4)
    h = lz4t_rotl(h + lz4t_xxh_word(p + i) * LZ4T_XXH_P3, 17) * LZ4T_XXH_P4;
  for (; i < len; i++) h = lz4t_rotl(h + p[i] * LZ4T_XXH_P5, 11) * LZ4T_XXH_P1;
  h ^= h >> 15;
  h *= LZ4T_XXH_P2;
  h ^= h >> 13;
  h *= LZ4T_XXH_P3;
  h ^= h >> 16;
  return h;
}
