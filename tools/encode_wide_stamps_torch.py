#!/usr/bin/env python3
"""Where K6b's time goes, on one CUDA GPU: clock stamps in instrumented
copies of its kernel (csrc/lz4_encode_wide.cu), built from the kept
headers, over the whole-block cell's batch: 64 rows of 4 MiB of
corpus.silesia_like (chip_smoke.py's 256 MiB), greedy and depth 2; and
over the main path's 128 rows of 64 KiB read from device memory, beside
K2a and K2c, which parse the same rows from shared memory.

Per mode it prints the kept kernel's ms per launch (CUDA events) and, from
a stamped copy (its output checked against the kept kernel's), summed over
the rows: the parse warp's cycles per sequence with its waits for a free
ring slot taken out, those waits, and the seven emit warps' busy and
waiting cycles per sequence. A second copy stamps every word load of the
row by the parse's lane 0 (lz4t_rd32w3 and lz4t_rd32w, patched in a copy
of lz4_encode.cuh: ld.global.nc between two clock reads) and sorts them by
latency: under 120 cycles (an L1 hit), under 450 (L2), or more (device
memory); the byte loads of the extensions are not stamped. Stamping
serialises each load, so that copy's time is not the kernel's.

    python3 tools/encode_wide_stamps_torch.py

Builds its libraries with nvcc into plz4_tpu_torch/_build/.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the kept word reads of lz4_encode.cuh and their stamped forms
PATCHES = [
    ("const uint32_t a = q[0], b = q[1], c = q[2], d = q[3];",
     "const uint32_t a = LZ4T_LOAD(q), b = LZ4T_LOAD(q + 1), "
     "c = LZ4T_LOAD(q + 2), d = LZ4T_LOAD(q + 3);"),
    ("const uint32_t lo = w[p >> 2], hi = w[(p >> 2) + 1];",
     "const uint32_t lo = LZ4T_LOAD(w + (p >> 2)), "
     "hi = LZ4T_LOAD(w + (p >> 2) + 1);"),
]

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// lane 0's row loads by latency, per row: L1, L2, device memory
__device__ unsigned long long* g_hist;

__host__ __device__ __forceinline__ uint32_t stamp_load(const uint32_t* p) {
#if STAMP_LOADS && defined(__CUDA_ARCH__)
  const long long t0 = clock64();
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  asm volatile("add.u32 %0, %0, 0;" : "+r"(v));
  const long long dt = clock64() - t0;
  if (threadIdx.x == 0)
    atomicAdd(&g_hist[blockIdx.x * 3 + (dt < 120 ? 0 : dt < 450 ? 1 : 2)],
              1ull);
  return v;
#else
  return *p;
#endif
}
#define LZ4T_LOAD(p) stamp_load(p)

#include "lz4_encode_wide.cuh"

namespace {

constexpr int NB = LZ4T_WRING_BATCHES;
constexpr int kThreads = 32 * (1 + LZ4T_WRING_WARPS);
constexpr int kTab = 1 << LZ4T_HASH_LOG;
constexpr int kMidTab = 1 << LZ4T_MID_HASH_LOG;
__host__ __device__ constexpr int tables_bytes(bool mid) {
  return mid ? 2 * kMidTab * 4 : kTab * 5;
}

// stats per row: parse cycles, parse waits for a slot, emit busy cycles,
// emit waits (both summed over the emit warps), sequences, block cycles
constexpr int kStats = 6;

// lz4t_wring_sink with its waits stamped
struct stamp_sink {
  static constexpr bool kAllLanes = true;
  int4* ring;
  int* cnt;
  int* anc;
  uint64_t* full;
  uint64_t* empty;
  int anchor;
  long long wait;
  __device__ void open(int b) {
    const int s = b & (NB - 1);
    const long long t = clock64();
    if (b >= NB) lz4t_mbar_wait(&empty[s], (b / NB - 1) & 1);
    wait += clock64() - t;
    if (lz4t_lead()) anc[s] = anchor;
  }
  __device__ void publish(int b, int n) {
    const int s = b & (NB - 1);
    if (lz4t_lead()) {
      cnt[s] = n;
      lz4t_mbar_arrive(&full[s]);
    }
  }
  __host__ __device__ void operator()(int k, int op, int mip, int mlen,
                                      int mpos) {
#if defined(__CUDA_ARCH__)
    if (!(k & 31)) open(k >> 5);
    if (lz4t_lead())
      ring[k & (32 * NB - 1)] = make_int4(op, mip, mlen, mip - mpos);
    anchor = mip + mlen;
    if ((k & 31) == 31) publish(k >> 5, 32);
#endif
  }
  __device__ void finish(int k) {
    if (!(k & 31)) open(k >> 5);
    publish(k >> 5, k & 31);
  }
};

// lz4t_encode_wide_kernel with clock stamps
template <bool kMid>
__global__ void __launch_bounds__(kThreads)
    stamped(const uint8_t* __restrict__ rows, const int32_t* __restrict__ lens,
            uint8_t* __restrict__ out, int32_t* __restrict__ totals,
            bool* __restrict__ ok, long long* __restrict__ stats, int DT,
            int CAP) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long s_emit[2];
  const long long t_start = clock64();
  constexpr int T = kMid ? kMidTab : kTab;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  int4* ring = reinterpret_cast<int4*>(smem + tables_bytes(kMid));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 32 * NB);
  uint64_t* empty = full + NB;
  int* cnt = reinterpret_cast<int*>(empty + NB);
  int* anc = cnt + NB;
  const int r = blockIdx.x, t = threadIdx.x, warp = t >> 5;
  const uint8_t* c = rows + (size_t)r * DT;
  for (int i = t; i < (kMid ? 2 * T : T); i += kThreads) tab[i] = 0;
  if (t == 0) {
    for (int s = 0; s < NB; s++) {
      lz4t_mbar_init(&full[s], 1);
      lz4t_mbar_init(&empty[s], LZ4T_WRING_WARPS);
    }
    s_emit[0] = s_emit[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  long long* st = stats + (size_t)r * kStats;
  uint8_t* o = out + (size_t)r * CAP;
  if (warp == 0) {
    stamp_sink sink = {ring, cnt, anc, full, empty, 0, 0};
    const uint32_t* w = reinterpret_cast<const uint32_t*>(c);
    int total, okv, k;
    const long long t0 = clock64();
    if constexpr (kMid) {
      const lz4t_mid_tabs mt = {tab, tab + kMidTab, nullptr, nullptr};
      k = lz4t_encode_mid_row_lanes<2, false>(w, DT, 0, 0, lens[r], CAP, mt,
                                              sink, &total, &okv);
    } else {
      k = lz4t_encode_row_lanes<false>(w, DT, 0, 0, lens[r], CAP, tab,
                                       reinterpret_cast<uint8_t*>(tab + kTab),
                                       sink, &total, &okv);
    }
    sink.finish(k);
    if (t == 0) {
      totals[r] = total;
      ok[r] = okv != 0;
      st[0] = clock64() - t0;
      st[1] = sink.wait;
      st[4] = k;
    }
  } else {
    long long busy = 0, wait = 0;
    for (int b = 0;; b++) {
      const int s = b & (NB - 1);
      const long long a = clock64();
      lz4t_mbar_wait(&full[s], (b / NB) & 1);
      const long long m = clock64();
      const int n = cnt[s];
      lz4t_wseq_batch<LZ4T_WRING_WARPS>(
          c, o, CAP, reinterpret_cast<const int*>(ring + 32 * s), n, anc[s],
          warp - 1);
      __syncwarp();
      if (lz4t_lead()) lz4t_mbar_arrive(&empty[s]);
      wait += m - a;
      busy += clock64() - m;
      if (n < 32) break;
    }
    if (lz4t_lead()) {
      atomicAdd(&s_emit[0], (unsigned long long)busy);
      atomicAdd(&s_emit[1], (unsigned long long)wait);
    }
  }
  __syncthreads();
  if (t == 0) {
    st[2] = (long long)s_emit[0];
    st[3] = (long long)s_emit[1];
    st[5] = clock64() - t_start;
  }
}

}  // namespace

extern "C" int stamp_launch(const void* rows, const void* lens, void* out,
                            void* totals, void* ok, void* stats, void* hist,
                            int R, int DT, int CAP, int mid) {
  cudaMemcpyToSymbol(g_hist, &hist, sizeof(hist));
  const int smem = tables_bytes(mid) + LZ4T_WRING_SMEM;
  const auto go = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<R, kThreads, smem>>>((const uint8_t*)rows, (const int32_t*)lens,
                                (uint8_t*)out, (int32_t*)totals, (bool*)ok,
                                (long long*)stats, DT, CAP);
    return (int)cudaGetLastError();
  };
  return mid ? go(stamped<true>) : go(stamped<false>);
}
"""


def _build_lib(name: str, stamp_loads: int):
    from plz4_tpu_torch.ops import _build

    inc = os.path.join(_build.BUILD_DIR, f"{name}_include")
    os.makedirs(inc, exist_ok=True)
    for h in glob.glob(os.path.join(_build.CSRC, "*.cuh")):
        shutil.copy(h, inc)
    p = os.path.join(inc, "lz4_encode.cuh")
    with open(p) as f:
        text = f.read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"lz4_encode.cuh: no unique {old!r}")
        text = text.replace(old, new)
    with open(p, "w") as f:
        f.write(text.replace('#include "lz4_lanes.cuh"\n',
                             '#include "lz4_lanes.cuh"\n#ifndef LZ4T_LOAD\n'
                             "#define LZ4T_LOAD(p) (*(p))\n#endif\n", 1))
    src = os.path.join(_build.BUILD_DIR, f"{name}.cu")
    so = os.path.join(_build.BUILD_DIR, f"lib{name}.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", inc,
                    f"-DSTAMP_LOADS={stamp_loads}", "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.stamp_launch.restype = ctypes.c_int
    lib.stamp_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    return lib


def main() -> int:
    import numpy as np
    import torch

    from plz4_tpu_torch import corpus
    from plz4_tpu_torch.ops import _build, encode, encode_mid, encode_wide

    if not torch.cuda.is_available():
        print("encode_wide_stamps_torch: no CUDA GPU visible",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = {0: _build_lib("encode_wide_stamps", 0),
            1: _build_lib("encode_wide_stamps_loads", 1)}
    print(card)

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    dev = torch.device("cuda", 0)
    data = corpus.silesia_like(32 << 20) * 8
    cells = []
    for N, R, reps in ((4 << 20, 64, 1), (65536, 128, 10)):
        a = np.frombuffer(data[:R * N], np.uint8).reshape(R, N)
        cells.append((N, R, reps, torch.from_numpy(a.copy()).to(dev)))
    for N, R, reps, d in cells:
        lens = torch.full((R,), N, dtype=torch.int32, device=dev)
        DT = N + 8
        flat = torch.zeros(R * DT + 16, dtype=torch.uint8, device=dev)
        rows = flat[:R * DT].view(R, DT)
        rows[:, :N] = d
        CAP = encode.out_width(N)
        for mid in (False, True):
            name = "depth 2" if mid else "greedy"
            kept = encode_wide.encode_batch_wide(d, lens, mid=mid)
            kept_ms = events_ms(lambda: encode_wide.encode_batch_wide(
                d, lens, mid=mid), reps)
            line = (f"K6b {name}, {R} x {N >> 10} KiB rows: kept "
                    f"{kept_ms:.3f} ms per launch")
            if N == 65536:
                shared = (encode_mid.encode_batch_mid if mid
                          else encode.encode_batch)
                shared_ms = events_ms(lambda: shared(d, lens), reps)
                line += (f"; {'K2c' if mid else 'K2a'} (the rows in shared "
                         f"memory) {shared_ms:.3f}")
            print(line)
            for loads, lib in libs.items():
                out = torch.empty((R, CAP), dtype=torch.uint8, device=dev)
                tot = torch.empty((R,), dtype=torch.int32, device=dev)
                okv = torch.empty((R,), dtype=torch.bool, device=dev)
                stats = torch.zeros((R, 6), dtype=torch.int64, device=dev)
                hist = torch.zeros((R, 3), dtype=torch.int64, device=dev)

                def run():
                    rc = lib.stamp_launch(
                        rows.data_ptr(), lens.data_ptr(), out.data_ptr(),
                        tot.data_ptr(), okv.data_ptr(), stats.data_ptr(),
                        hist.data_ptr(), R, DT, CAP, int(mid))
                    if rc:
                        raise RuntimeError(f"stamp_launch: cudaError {rc}")

                ms = events_ms(run, 1)
                hist.zero_()
                run()
                torch.cuda.synchronize()
                same = (torch.equal(tot, kept[1]) and torch.equal(okv, kept[2])
                        and all(torch.equal(out[i, :tot[i]],
                                            kept[0][i, :tot[i]])
                                for i in range(R)))
                if not same:
                    print("the stamped copy differs from K6b", file=sys.stderr)
                    return 1
                st = stats.cpu().numpy().astype(np.float64)
                seqs = st[:, 4].sum()
                if not loads:
                    print(f"  stamped: {ms:.3f} ms; per sequence ("
                          f"{seqs / R:.0f} a row): parse "
                          f"{(st[:, 0] - st[:, 1]).sum() / seqs:.1f} cycles "
                          f"+ wait for a slot {st[:, 1].sum() / seqs:.1f}; "
                          f"emit warps busy {st[:, 2].sum() / seqs:.1f}, "
                          f"waiting {st[:, 3].sum() / seqs:.1f}; block "
                          f"{st[:, 5].mean():.0f} cycles a row (max "
                          f"{st[:, 5].max():.0f})")
                else:
                    h = hist.cpu().numpy().sum(axis=0).astype(np.float64)
                    print(f"  load stamps: {ms:.3f} ms; lane 0's row word "
                          f"loads {h.sum() / seqs:.1f} a sequence: "
                          f"{100 * h[0] / h.sum():.1f}% under 120 cycles "
                          f"(L1), {100 * h[1] / h.sum():.1f}% under 450 "
                          f"(L2), {100 * h[2] / h.sum():.1f}% more; parse "
                          f"{(st[:, 0] - st[:, 1]).sum() / seqs:.1f} "
                          f"cycles a sequence with the loads serialised")
    return 0


if __name__ == "__main__":
    sys.exit(main())
