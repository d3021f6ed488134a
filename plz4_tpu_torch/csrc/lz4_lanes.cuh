// Warp-cooperative steps of the row bodies that one warp runs together
// (K2a-K2d's parse, K4's parse and chain build, K5's record decode). All 32 lanes of the
// warp run the caller's scalar control flow in step, reading the same
// shared-memory words as broadcasts, and split only the steps below among
// themselves, lane i taking element i of each group of 32. The g++ build
// of the same source (lz4_host.cpp) runs each step as a loop over lanes
// 0-31, so the CPU tests exercise the lanes' own arithmetic. A step whose
// lanes read what other lanes of the same step write would be a race on
// the card: lz4t_lanes_copy's host loop does every lane's load before any
// lane's store, so such a step gives other bytes than the byte-serial
// loop it replaces and fails the parity tests.
#pragma once

#include "lz4_common.cuh"

#define LZ4T_LANES 32

// bit i set where f(i) holds, for lanes i = 0..31
template <class F>
LZ4T_HD uint32_t lz4t_ballot(F f) {
#if defined(__CUDA_ARCH__)
  return __ballot_sync(0xFFFFFFFFu, f((int)(threadIdx.x & 31)));
#else
  uint32_t m = 0;
  for (int i = 0; i < LZ4T_LANES; i++) m |= (uint32_t)(f(i) ? 1 : 0) << i;
  return m;
#endif
}

// index of the lowest set bit of a non-zero mask
LZ4T_HD int lz4t_ffs(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// index of the lowest set bit, 32 for 0
LZ4T_HD int lz4t_ctz(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __clz(__brev(m));
#else
  return m ? __builtin_ctz(m) : 32;
#endif
}

// index of the highest set bit of a non-zero mask
LZ4T_HD int lz4t_fls(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return 31 - __clz(m);
#else
  return 31 - __builtin_clz(m);
#endif
}

// number of set bits
LZ4T_HD int lz4t_popc(uint32_t m) {
#if defined(__CUDA_ARCH__)
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// f(i) for every lane i, then the warp's writes are visible to all lanes
template <class F>
LZ4T_HD void lz4t_lanes(F f) {
#if defined(__CUDA_ARCH__)
  f((int)(threadIdx.x & 31));
  __syncwarp();
#else
  for (int i = 0; i < LZ4T_LANES; i++) f(i);
#endif
}

// f(i) for every lane, for a step whose stores no lane reads: no
// __syncwarp after it
template <class F>
LZ4T_HD void lz4t_lanes_out(F f) {
#if defined(__CUDA_ARCH__)
  f((int)(threadIdx.x & 31));
#else
  for (int i = 0; i < LZ4T_LANES; i++) f(i);
#endif
}

// f(i) for every lane as lz4t_lanes, for a step whose lanes store to
// shared addresses: on the card two lanes storing to one address in one
// step leave either value, so the host build runs the lanes last first
// and a body that lets a lower lane's store stand in for a higher one's
// fails its tests
template <class F>
LZ4T_HD void lz4t_lanes_store(F f) {
#if defined(__CUDA_ARCH__)
  f((int)(threadIdx.x & 31));
  __syncwarp();
#else
  for (int i = LZ4T_LANES - 1; i >= 0; i--) f(i);
#endif
}

// one copy step: v = load(i) for every lane, then store(i, v); load
// returns -1 for a lane with nothing to copy
template <class L, class S>
LZ4T_HD void lz4t_lanes_copy(L load, S store) {
#if defined(__CUDA_ARCH__)
  const int i = (int)(threadIdx.x & 31);
  const int v = load(i);
  if (v >= 0) store(i, v);
  __syncwarp();
#else
  int v[LZ4T_LANES];
  for (int i = 0; i < LZ4T_LANES; i++) v[i] = load(i);
  for (int i = 0; i < LZ4T_LANES; i++)
    if (v[i] >= 0) store(i, v[i]);
#endif
}

// whether this thread runs the warp's lane 0 (on the host, where a lane
// loop runs the scalar code once, always)
LZ4T_HD bool lz4t_lead() {
#if defined(__CUDA_ARCH__)
  return (threadIdx.x & 31) == 0;
#else
  return true;
#endif
}

// Per-lane values in the bodies that one warp runs: an array of LZ4T_NL,
// indexed by lz4t_li(lane), holds every lane's value on the host and the
// lane's own on the card.
#if defined(__CUDA_ARCH__)
#define LZ4T_NL 1
#else
#define LZ4T_NL LZ4T_LANES
#endif
LZ4T_HD int lz4t_li(int lane) {
#if defined(__CUDA_ARCH__)
  return 0 * lane;
#else
  return lane;
#endif
}

// lane q's value of the per-lane array v (every lane calls it)
LZ4T_HD int lz4t_lane_get(const int* v, int q) {
#if defined(__CUDA_ARCH__)
  return __shfl_sync(0xFFFFFFFFu, v[0], q);
#else
  return v[q];
#endif
}

// peers[lane] = the lanes whose key equals the lane's own, from the
// per-lane array key (every lane calls it)
LZ4T_HD void lz4t_match_any(const uint32_t* key, uint32_t* peers) {
#if defined(__CUDA_ARCH__)
  peers[0] = __match_any_sync(0xFFFFFFFFu, key[0]);
#else
  for (int i = 0; i < LZ4T_LANES; i++) {
    peers[i] = 0;
    for (int j = 0; j < LZ4T_LANES; j++)
      peers[i] |= (uint32_t)(key[j] == key[i]) << j;
  }
#endif
}

// out[lane] = v[src(lane)] for every lane, from the per-lane arrays v and
// out (a __shfl_sync; v and out may be one array)
template <class F>
LZ4T_HD void lz4t_gather(const int* v, int* out, F src) {
#if defined(__CUDA_ARCH__)
  out[0] = __shfl_sync(0xFFFFFFFFu, v[0], src((int)(threadIdx.x & 31)));
#else
  int t[LZ4T_LANES];
  for (int i = 0; i < LZ4T_LANES; i++) t[i] = v[src(i)];
  for (int i = 0; i < LZ4T_LANES; i++) out[i] = t[i];
#endif
}

// inclusive prefix sums of the per-lane array v over lanes 0-31
LZ4T_HD void lz4t_lane_scan(int* v) {
#if defined(__CUDA_ARCH__)
  const int i = threadIdx.x & 31;
  for (int d = 1; d < LZ4T_LANES; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, v[0], d);
    if (i >= d) v[0] += y;
  }
#else
  for (int i = 1; i < LZ4T_LANES; i++) v[i] += v[i - 1];
#endif
}

