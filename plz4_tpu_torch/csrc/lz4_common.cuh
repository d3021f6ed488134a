// Shared definitions of the kernels. The per-row bodies in the .cuh files
// (lz4_encode*.cuh, lz4_decode*.cuh, xxh32.cuh) are __host__ __device__: nvcc builds them into the CUDA kernels (csrc/*.cu)
// and g++ builds the same source into a host library (lz4_host.cpp) that
// the CPU tests hold against the JAX package's Pallas kernels in interpret
// mode.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define LZ4T_HD __host__ __device__ __forceinline__
#define LZ4T_HDM __host__ __device__ __forceinline__  // member functions
#else
#define LZ4T_HD static inline
#define LZ4T_HDM inline
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

#if defined(__CUDACC__)
// mbarriers in shared memory: the full/empty hand-over of the rings
// (lz4_decode_ring.cuh, lz4_encode_wide.cuh)

__device__ __forceinline__ uint32_t lz4t_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void lz4t_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   lz4t_smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void lz4t_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   lz4t_smem_addr(bar))
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void lz4t_mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(lz4t_smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
#endif  // __CUDACC__
