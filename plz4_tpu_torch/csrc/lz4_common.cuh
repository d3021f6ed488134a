// Shared definitions of the kernels. The per-row bodies in the .cuh files
// (lz4_encode*.cuh, lz4_decode*.cuh, xxh32.cuh) are __host__ __device__: nvcc builds them into the CUDA kernels (csrc/*.cu)
// and g++ builds the same source into a host library (lz4_host.cpp) that
// the CPU tests hold against the JAX package's Pallas kernels in interpret
// mode.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define LZ4T_HD __host__ __device__ __forceinline__
#else
#define LZ4T_HD static inline
#endif

// Parse constants of the greedy encoder (ops/encode.py keeps the Python
// copies; a test pins both against the Pallas module's values).
#define LZ4T_HASH_LOG 14
#define LZ4T_HASH_MUL 2654435761u
#define LZ4T_MAX_DISTANCE 65535
#define LZ4T_SKIP_STRENGTH 6

LZ4T_HD int lz4t_min(int a, int b) { return a < b ? a : b; }
LZ4T_HD int lz4t_max(int a, int b) { return a > b ? a : b; }

// byte p of a row of C bytes, zero outside it (the decoders' zero-extended
// reads)
LZ4T_HD int lz4t_rdz(const uint8_t* c, int C, int p) {
  return (unsigned)p < (unsigned)C ? c[p] : 0;
}

// LZ4 length extension starting at p over zero-extended reads: adds bytes
// until one is not 255.
LZ4T_HD int lz4t_varint_z(const uint8_t* c, int C, int p, int* len) {
  int t = *len, b;
  do {
    b = lz4t_rdz(c, C, p++);
    t += b;
  } while (b == 255);
  *len = t;
  return p;
}
