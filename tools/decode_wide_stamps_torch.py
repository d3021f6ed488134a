#!/usr/bin/env python3
"""K6a's time, and where it goes, on one CUDA GPU, for comparing a parent
and a change in turns inside one chip call.

    python3 tools/decode_wide_stamps_torch.py [TREE] [--stamps]

imports plz4_tpu_torch from TREE (default: this checkout; e.g. a parent
unpacked with `git archive <commit> | tar -x -C build/parent`), builds its
kernels and prints, by CUDA events, K6a's ms per launch over the
whole-block cell's batch (chip_smoke.py phase 17: the 256 MiB of
corpus.silesia_like as 64 rows of 4 MiB, encoded by one K6b launch, then
decoded and checked), over one of those rows alone (decode_block_host's
batch of 1) and over two native 4 MiB streams; K6a's peak device memory
over the 64-row launch; and, because K1 and K3 share K6a's row body
(csrc/lz4_decode_ring.cuh), K1's ms over the main path's 128 rows of
64 KiB encoded by K2a and K3's over the same blocks encoded by the native
codec against a 64 KiB dictionary.

--stamps (TREE's headers must hold the parse-thread K6a, lz4t_tail_row)
also builds instrumented copies of K6a's kernel from TREE's headers and
prints for each, over the 64 rows (its output checked against the kept
kernel's): the ms per launch, and summed over the rows the parse thread's
cycles per sequence with its waits for a free ring slot taken out, those
waits, and the seven copy warps' busy and waiting cycles per sequence
(each warp's, averaged). The copies (VARIANTS): the kept kernel (these
rows end in zeros that their streams do not reach, so it reads them
without a guard, lz4t_tail_row); copy warps that only release their slots
(the parse alone); the parse's row reads guarded at C as for other rows
(lz4t_dev_row), at min(p, C - 5), guarded by one branch, guarded plain
loads (ld.global), a clamped address and a select; the kept reads
prefetching ahead into L1 or L2; and a probe that times each guarded
group of five reads (serialised: where the bytes come from, not the
kernel's time). Then unstamped copies of the kernel in other shapes
(SHAPES: the readers apart or inlined, alone or side by side). Then the
kept kernel's registers and spills (nvcc -Xptxas -v) and its global loads
and stores by kind (cuobjdump -sass): the output row must be read with
plain loads (LDG.E), never through the read-only path (LDG.E.CONSTANT).

Builds its library with nvcc into TREE's plz4_tpu_torch/_build/.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import subprocess
import sys

SRC = r"""
#include <cuda_runtime.h>
#include "lz4_decode_ring.cuh"

namespace {

// stats per row: parse cycles, parse waits for a slot, copy cycles and
// copy waits (both summed over the copy warps), sequences, block cycles
constexpr int kStats = 6;

struct stamp_ring_emit : lz4t_ring_emit {
  long long wait;
  __host__ __device__ void open() {
#if defined(__CUDA_ARCH__)
    const long long t = clock64();
    lz4t_ring_emit::open();
    wait += clock64() - t;
#endif
  }
};

// the kept reader of these rows, its reads of p .. p + 4 also prefetching
// the line DIST bytes ahead into L1 (L2 false) or L2
template <int DIST, bool L2>
struct prefetch_row : lz4t_tail_row {
  __host__ __device__ void five(int p, int* b) const {
#if defined(__CUDA_ARCH__)
    if (p + DIST < C) {
      if (L2)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(c + p + DIST));
      else
        asm volatile("prefetch.global.L1 [%0];" ::"l"(c + p + DIST));
    }
#endif
    lz4t_tail_row::five(p, b);
  }
};

// the first reader of rows that end in zeros: bytes min(p, C - 5) .. + 4
// (right for a row whose last 5 bytes are zero), one min on the address
struct min_row : lz4t_dev_row {
  __host__ __device__ int operator()(int p) const {
    return lz4t_ldg(c + lz4t_min(p, C - 5));
  }
  __host__ __device__ void five(int p, int* b) const {
    const uint8_t* w = c + lz4t_min(p, C - 5);
#pragma unroll
    for (int i = 0; i < 5; i++) b[i] = lz4t_ldg(w + i);
  }
};

// the guard as one branch: the five bytes unguarded where p + 5 <= C
struct branch_row : lz4t_dev_row {
  __host__ __device__ void five(int p, int* b) const {
    if (__builtin_expect(p + 5 <= C, 1)) {
#pragma unroll
      for (int i = 0; i < 5; i++) b[i] = lz4t_ldg(c + p + i);
    } else {
      lz4t_dev_row::five(p, b);
    }
  }
};

// plain global loads (ld.global, not the read-only path), guarded
struct plain_row : lz4t_dev_row {
  __host__ __device__ int operator()(int p) const {
#if defined(__CUDA_ARCH__)
    uint32_t v = 0;
    if ((unsigned)p < (unsigned)C)
      asm volatile("ld.global.u8 %0, [%1];" : "=r"(v) : "l"(c + p));
    return (int)v;
#else
    return (unsigned)p < (unsigned)C ? c[p] : 0;
#endif
  }
  __host__ __device__ void five(int p, int* b) const {
#pragma unroll
    for (int i = 0; i < 5; i++) b[i] = (*this)(p + i);
  }
};

// the guard as a clamped address and a select after the load
struct clamp_row : lz4t_dev_row {
  __host__ __device__ int operator()(int p) const {
#if defined(__CUDA_ARCH__)
    const int v = __ldg(c + lz4t_min(p, C - 1));
#else
    const int v = c[lz4t_min(p, C - 1)];
#endif
    return p < C ? v : 0;
  }
  __host__ __device__ void five(int p, int* b) const {
#pragma unroll
    for (int i = 0; i < 5; i++) b[i] = (*this)(p + i);
  }
};

// per row: the parse's five-byte reads by latency (under 120 cycles: L1,
// under 450: L2, more: device memory) and their summed cycles
__device__ unsigned long long g_hist[256 * 4];

// the kept reads, each group of five timed (serialised: a probe of where
// the row's bytes come from, not of the kernel's time)
struct timed_row : lz4t_dev_row {
  __host__ __device__ void five(int p, int* b) const {
#if defined(__CUDA_ARCH__)
    const long long t0 = clock64();
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < 5; i++) {
      uint32_t v = 0;
      if ((unsigned)(p + i) < (unsigned)C)
        asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(c + p + i));
      b[i] = (int)v;
      s += v;
    }
    asm volatile("add.u32 %0, %0, 0;" : "+r"(s));
    const long long dt = clock64() - t0;
    unsigned long long* h = g_hist + 4 * blockIdx.x;
    atomicAdd(h + (dt < 120 ? 0 : dt < 450 ? 1 : 2), 1ull);
    atomicAdd(h + 3, (unsigned long long)dt);
#else
    lz4t_dev_row::five(p, b);
#endif
  }
};

// lz4t_decode_wide_kernel with clock stamps; kCopy false: the copy warps
// release each slot without copying
template <class Row, bool kCopy>
__global__ void __launch_bounds__(256)
    stamped(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
            uint8_t* outs, int32_t* __restrict__ n_outs,
            bool* __restrict__ oks, long long* __restrict__ stats, int C,
            int out_cap) {
  __shared__ __align__(16) uint8_t smem[LZ4T_RING_SMEM];
  const long long t_start = clock64();
  constexpr int NB = LZ4T_RING_BATCHES;
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int4* ring = reinterpret_cast<int4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NB * 32 * 16);
  uint64_t* empty = full + NB;
  int* cnt = reinterpret_cast<int*>(empty + NB);
  long long* st = stats + (size_t)b * kStats;
  lz4t_ring_init(smem);
  __syncthreads();
  Row row;
  row.c = comp + (size_t)b * C;
  row.C = C;
  uint8_t* o = outs + (size_t)b * out_cap;
  if (warp == 0) {
    if (lane == 0) {
      const long long t0 = clock64();
      stamp_ring_emit em = {{ring, cnt, full, empty, 0, 0}, 0};
      int n, okv;
      lz4t_parse_strict<false, true>(row, clens[b], 0, out_cap, em, &n,
                                     &okv);
      em.finish();
      st[0] = clock64() - t0;
      st[1] = em.wait;
      st[4] = em.k;
      n_outs[b] = n;
      oks[b] = okv != 0;
    }
    __syncwarp();
  } else {
    const long long t0 = clock64();
    long long wait = 0;
    int bop = 0;
    for (int k = 0;; k++) {
      const int s = k % NB;
      const long long tw = clock64();
      lz4t_mbar_wait(&full[s], (k / NB) & 1);
      __syncwarp();
      wait += clock64() - tw;
      const int n = cnt[s];
      const auto release = [&] {
        if (lane == 0) lz4t_mbar_arrive(&empty[s]);
      };
      if (kCopy) {
        bop = lz4t_copy_batch_lanes<LZ4T_RING_WARPS>(
            row, o, nullptr, 0, reinterpret_cast<const int32_t*>(ring + s * 32),
            n, bop, warp - 1, release);
      } else {
        __syncwarp();
        release();
      }
      if (n < 32) break;
    }
    if (lane == 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&st[2]),
                (unsigned long long)(clock64() - t0));
      atomicAdd(reinterpret_cast<unsigned long long*>(&st[3]),
                (unsigned long long)wait);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) st[5] = clock64() - t_start;
}

// one row through the ring, not inlined into the kernel that calls it
template <class Row>
__device__ __noinline__ void row_apart(const uint8_t* c, int C, int clen,
                                       uint8_t* o, int out_cap, uint8_t* smem,
                                       int32_t* n_out, bool* ok) {
  Row row;
  row.c = c;
  row.C = C;
  lz4t_ring_decode<false, true>(row, clen, 0, out_cap, o, nullptr, 0, smem,
                                [&](int n, int okv) {
                                  *n_out = n;
                                  *ok = okv != 0;
                                });
}

template <class Row>
__device__ __forceinline__ void row_inline(const uint8_t* c, int C, int clen,
                                           uint8_t* o, int out_cap,
                                           uint8_t* smem, int32_t* n_out,
                                           bool* ok) {
  Row row;
  row.c = c;
  row.C = C;
  lz4t_ring_decode<false, true>(row, clen, 0, out_cap, o, nullptr, 0, smem,
                                [&](int n, int okv) {
                                  *n_out = n;
                                  *ok = okv != 0;
                                });
}

// K6a's kernel, unstamped, in other shapes: MODE 0 both readers in
// functions of their own, chosen by the row (the kept kernel's shape); 1
// both inlined side by side; 2 the unguarded reader alone, inlined; 3 the
// same apart; 4 the guarded reader alone, inlined; 5 the min reader alone,
// inlined
template <int MODE>
__global__ void __launch_bounds__(256)
    shaped(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
           uint8_t* out, int32_t* __restrict__ n_out, bool* __restrict__ ok,
           int C, int out_cap) {
  __shared__ __align__(16) uint8_t smem[LZ4T_RING_SMEM];
  __shared__ bool s_tail;
  const int b = blockIdx.x;
  const uint8_t* c = comp + (size_t)b * C;
  const int clen = clens[b];
  if (threadIdx.x == 0) s_tail = lz4t_tail_fits(c, C, clen);
  lz4t_ring_init(smem);
  __syncthreads();
  uint8_t* o = out + (size_t)b * out_cap;
  int32_t* n = n_out + b;
  bool* k = ok + b;
  if (MODE == 0) {
    if (s_tail)
      row_apart<lz4t_tail_row>(c, C, clen, o, out_cap, smem, n, k);
    else
      row_apart<lz4t_dev_row>(c, C, clen, o, out_cap, smem, n, k);
  } else if (MODE == 1) {
    if (s_tail)
      row_inline<lz4t_tail_row>(c, C, clen, o, out_cap, smem, n, k);
    else
      row_inline<lz4t_dev_row>(c, C, clen, o, out_cap, smem, n, k);
  } else if (MODE == 2) {
    row_inline<lz4t_tail_row>(c, C, clen, o, out_cap, smem, n, k);
  } else if (MODE == 3) {
    row_apart<lz4t_tail_row>(c, C, clen, o, out_cap, smem, n, k);
  } else if (MODE == 4) {
    row_inline<lz4t_dev_row>(c, C, clen, o, out_cap, smem, n, k);
  } else {
    row_inline<min_row>(c, C, clen, o, out_cap, smem, n, k);
  }
}

}  // namespace

extern "C" int shaped_launch(const void* comp, const void* clens, void* out,
                             void* n_out, void* ok, int B, int C, int out_cap,
                             int mode) {
  auto go = [&](auto kern) {
    kern<<<B, 256>>>((const uint8_t*)comp, (const int32_t*)clens,
                     (uint8_t*)out, (int32_t*)n_out, (bool*)ok, C, out_cap);
    return (int)cudaGetLastError();
  };
  switch (mode) {
    case 0: return go(shaped<0>);
    case 1: return go(shaped<1>);
    case 2: return go(shaped<2>);
    case 3: return go(shaped<3>);
    case 4: return go(shaped<4>);
    case 5: return go(shaped<5>);
  }
  return -1;
}

extern "C" int hist_io(void* dst) {
  if (dst) return (int)cudaMemcpyFromSymbol(dst, g_hist, sizeof(g_hist));
  static const unsigned long long zero[256 * 4] = {};
  return (int)cudaMemcpyToSymbol(g_hist, zero, sizeof(g_hist));
}

// variant 0: the kept kernel stamped (these rows end in zeros: the
// unguarded reader); 1: no copies; 2: the guarded reader; 3: the min
// reader; 4: the guard as one branch; 5: guarded plain loads; 6: clamp and
// select; 7: prefetch into L1 by 1 KiB; 8: into L2 by 4 KiB; 9: timed reads
extern "C" int stamp_launch(const void* comp, const void* clens, void* outs,
                            void* n_outs, void* oks, void* stats, int B,
                            int C, int out_cap, int variant) {
  auto go = [&](auto kern) {
    kern<<<B, 256>>>((const uint8_t*)comp, (const int32_t*)clens,
                     (uint8_t*)outs, (int32_t*)n_outs, (bool*)oks,
                     (long long*)stats, C, out_cap);
    return (int)cudaGetLastError();
  };
  switch (variant) {
    case 0: return go(stamped<lz4t_tail_row, true>);
    case 1: return go(stamped<lz4t_tail_row, false>);
    case 2: return go(stamped<lz4t_dev_row, true>);
    case 3: return go(stamped<min_row, true>);
    case 4: return go(stamped<branch_row, true>);
    case 5: return go(stamped<plain_row, true>);
    case 6: return go(stamped<clamp_row, true>);
    case 7: return go(stamped<prefetch_row<1024, false>, true>);
    case 8: return go(stamped<prefetch_row<4096, true>, true>);
    case 9: return go(stamped<timed_row, true>);
  }
  return -1;
}
"""

TIMED = 9
VARIANTS = [(0, "the kept kernel (these rows end in zeros their streams do "
                "not reach: reads without a guard)"),
            (1, "copy warps that only release their slots (the parse "
                "alone)"),
            (2, "the guarded reads of other rows"),
            (3, "reads at min(p, C - 5) (one min on the address)"),
            (4, "the guard as one branch, p + 5 <= C"),
            (5, "guarded plain loads (ld.global) instead of the read-only "
                "path"),
            (6, "the guard as a clamped address and a select"),
            (7, "the kept reads prefetching 1 KiB ahead into L1"),
            (8, "the kept reads prefetching 4 KiB ahead into L2"),
            (9, "each group of five guarded row reads timed (serialised)")]
SHAPES = [(0, "both readers in functions of their own, chosen by the row "
              "(the kept kernel's shape)"),
          (1, "both readers inlined side by side"),
          (2, "the unguarded reader alone, inlined"),
          (3, "the unguarded reader alone, apart"),
          (4, "the guarded reader alone, inlined"),
          (5, "the min reader alone, inlined")]


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    stamps = "--stamps" in sys.argv[1:]
    tree = os.path.abspath(args[0] if args else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import plz4_tpu_torch
    from plz4_tpu_torch import corpus, native
    from plz4_tpu_torch.ops import _build, decode, encode

    if not plz4_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {plz4_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        print("decode_wide_stamps_torch: no CUDA GPU visible",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()

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
    BIG, N, B = 4 << 20, 65536, 128
    data = corpus.silesia_like(32 << 20) * 8
    n_wide = len(data) // BIG
    wd = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(
        n_wide, BIG).copy()).to(dev)
    wl = torch.full((n_wide,), BIG, dtype=torch.int32, device=dev)
    wout, wtot, wok = encode.encode_batch(wd, wl)
    assert bool(wok.all())
    C_w = (int(wtot.max()) + 16 + 3) & ~3
    comp = (wout[:, :C_w] * (torch.arange(C_w, device=dev)[None]
                             < wtot[:, None])).contiguous()
    del wout
    res = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dout, dn, dok = decode.decode_batch(comp, wtot, BIG)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if not (bool(dok.all()) and bool((dn == BIG).all())
            and torch.equal(dout, wd)):
        raise RuntimeError("K6a did not rebuild the 64 rows of 4 MiB")
    del dout
    res["K6a 64 x 4 MiB K6b streams"] = events_ms(
        lambda: decode.decode_batch(comp, wtot, BIG), 3)
    res["K6a 1 x 4 MiB K6b stream"] = events_ms(
        lambda: decode.decode_batch(comp[:1], wtot[:1], BIG), 3)
    s4 = [native.compress(data[i * BIG:(i + 1) * BIG], level=1)
          for i in range(2)]
    C4 = (max(map(len, s4)) + 16 + 3) & ~3
    r4 = np.zeros((2, C4), np.uint8)
    for i, s in enumerate(s4):
        r4[i, :len(s)] = np.frombuffer(s, np.uint8)
    r4 = torch.from_numpy(r4).to(dev)
    l4 = torch.tensor([len(s) for s in s4], dtype=torch.int32, device=dev)
    o4, n4, k4 = decode.decode_batch(r4, l4, BIG)
    if not (bool(k4.all()) and torch.equal(o4, wd[:2])):
        raise RuntimeError("K6a did not rebuild the native 4 MiB streams")
    res["K6a 2 x 4 MiB native streams"] = events_ms(
        lambda: decode.decode_batch(r4, l4, BIG), 5)
    # K1 and K3 at the main path's batch
    rows = wd.reshape(-1, N)[:B].contiguous()
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    out1, tot1, ok1 = encode.encode_batch(rows, lens)
    C = N + decode.ROW_SLACK
    c1 = torch.zeros((B, C), dtype=torch.uint8, device=dev)
    w1 = min(C, out1.shape[1])
    c1[:, :w1] = out1[:, :w1] * (torch.arange(w1, device=dev)[None]
                                 < tot1[:, None])
    o1, n1, k1 = decode.decode_batch(c1, tot1, N)
    if not (bool(k1.all()) and torch.equal(o1, rows)):
        raise RuntimeError("K1 did not rebuild the 128 rows")
    res["K1 128 x 64 KiB"] = events_ms(
        lambda: decode.decode_batch(c1, tot1, N), 20)
    dict_ = corpus.silesia_like(N, seed=77)
    rows_h = rows.cpu().numpy()
    s3 = [native.compress(rows_h[i].tobytes(), level=1, dict_=dict_)
          for i in range(B)]
    c3 = np.zeros((B, C), np.uint8)
    for i, s in enumerate(s3):
        c3[i, :len(s)] = np.frombuffer(s, np.uint8)
    c3 = torch.from_numpy(c3).to(dev)
    l3 = torch.tensor([len(s) for s in s3], dtype=torch.int32, device=dev)
    dbuf = torch.from_numpy(np.frombuffer(dict_, np.uint8).copy()).to(dev)
    o3, n3, k3 = decode.decode_batch_dict(c3, l3, dbuf, N, N)
    if not (bool(k3.all()) and torch.equal(o3, rows)):
        raise RuntimeError("K3 did not rebuild the 128 rows")
    res["K3 128 x 64 KiB"] = events_ms(
        lambda: decode.decode_batch_dict(c3, l3, dbuf, N, N), 20)
    print(f"[{card}] {tree}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in res.items())
        + f"; K6a peak device memory over the 64-row launch "
          f"{peak / 2**20:.1f} MiB (outputs and scratch)")
    if stamps:
        return stamp(tree, card, comp, wtot, BIG, events_ms, res)
    return 0


def stamp(tree, card, comp, clens, cap, events_ms, res) -> int:
    import numpy as np
    import torch

    from plz4_tpu_torch.ops import _build, decode

    csrc = os.path.join(tree, "plz4_tpu_torch", "csrc")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "decode_wide_stamps_torch.cu")
    so = os.path.join(_build.BUILD_DIR, "libdecode_wide_stamps_torch.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so,
                    src], check=True)
    lib = ctypes.CDLL(so)
    lib.stamp_launch.restype = ctypes.c_int
    lib.stamp_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    lib.hist_io.restype = ctypes.c_int
    lib.hist_io.argtypes = [ctypes.c_void_p]
    B, C = comp.shape
    dev = comp.device
    ref = decode.decode_batch(comp, clens, cap)
    ref_n = ref[1].cpu()
    o = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    okv = torch.empty((B,), dtype=torch.bool, device=dev)
    stats = torch.zeros((B, 6), dtype=torch.int64, device=dev)
    for v, what in VARIANTS:
        def run():
            stats.zero_()
            rc = lib.stamp_launch(comp.data_ptr(), clens.data_ptr(),
                                  o.data_ptr(), n.data_ptr(), okv.data_ptr(),
                                  stats.data_ptr(), B, C, cap, v)
            if rc:
                raise RuntimeError(f"stamp_launch: cudaError {rc}")

        if v == TIMED:
            lib.hist_io(None)
            run()
            torch.cuda.synchronize()
            ms = float("nan")
        else:
            ms = events_ms(run, 2)
        st = stats.cpu().numpy().astype(np.float64)
        same = bool(torch.equal(n.cpu(), ref_n)
                    and torch.equal(okv.cpu(), ref[2].cpu()))
        if v != 1:
            same = same and torch.equal(o, ref[0])
        seqs = st[:, 4].sum()
        w = 7  # copy warps
        print(f"K6a stamped, {what} [{card}]: {ms:.3f} ms per {B}-row "
              f"launch; per sequence ({seqs / B:.0f} a row): parse "
              f"{(st[:, 0] - st[:, 1]).sum() / seqs:.1f} cycles + wait for a "
              f"slot {st[:, 1].sum() / seqs:.1f}; each copy warp busy "
              f"{(st[:, 2] - st[:, 3]).sum() / w / seqs:.1f} + waiting "
              f"{st[:, 3].sum() / w / seqs:.1f}; block {st[:, 5].mean():.0f} "
              f"cycles a row (max {st[:, 5].max():.0f}); equal to the kept "
              f"kernel: {same}")
        if v == TIMED:
            h = np.zeros((256, 4), np.uint64)
            lib.hist_io(ctypes.c_void_p(h.ctypes.data))
            h = h[:B].astype(np.float64).sum(0)
            reads = h[:3].sum()
            print(f"K6a parse's five-byte row reads [{card}]: "
                  f"{reads / seqs:.2f} a sequence; under 120 cycles (L1) "
                  f"{100 * h[0] / reads:.2f}%, under 450 (L2) "
                  f"{100 * h[1] / reads:.2f}%, more (device memory) "
                  f"{100 * h[2] / reads:.2f}%; mean {h[3] / reads:.1f} "
                  f"cycles")
        if not same:
            return 1
    lib.shaped_launch.restype = ctypes.c_int
    lib.shaped_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    for mode, what in SHAPES:
        def run():
            rc = lib.shaped_launch(comp.data_ptr(), clens.data_ptr(),
                                   o.data_ptr(), n.data_ptr(),
                                   okv.data_ptr(), B, C, cap, mode)
            if rc:
                raise RuntimeError(f"shaped_launch: cudaError {rc}")

        ms = events_ms(run, 3)
        same = bool(torch.equal(n.cpu(), ref_n)
                    and torch.equal(okv.cpu(), ref[2].cpu())
                    and torch.equal(o, ref[0]))
        print(f"K6a unstamped, {what} [{card}]: {ms:.3f} ms per {B}-row "
              f"launch; equal to the kept kernel: {same}")
        if not same:
            return 1
    # the kept kernel as compiled: registers, spills, memory instructions
    so_kept = _build._so_path("lz4_decode_wide")
    ptxas = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(_build.BUILD_DIR, "k6a_ptxas.so"),
         os.path.join(csrc, "lz4_decode_wide.cu")], capture_output=True,
        text=True, check=True)
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"K6a ptxas: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_kept], capture_output=True,
                          text=True, check=True).stdout
    ops = collections.Counter(
        m.group(1) for m in re.finditer(r"\b((?:LDG|STG|LDS|STS|LD|ST)"
                                        r"(?:\.[A-Z0-9_]+)*)\b", sass))
    print("K6a SASS memory instructions: " + ", ".join(
        f"{k} {v}" for k, v in sorted(ops.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
