#!/usr/bin/env python3
"""Where K1's and K3's time goes, on one CUDA GPU: clock stamps in
instrumented copies of their kernel (csrc/lz4_decode_ring.cuh's
lz4t_ring_row), built from the kept headers, over the main path's batch:
128 rows of 64 KiB of corpus.silesia_like encoded by K2a (K1), and the
same blocks encoded by the native codec against a 64 KiB dictionary (K3).

Two hand-overs from the parse thread to the copy warps are stamped:
  * ring: the kept design, a ring of 64 slots of 32 sequences in shared
    memory with full/empty mbarriers;
  * global: the sequences stored in a per-row device scratch (W / 4 + 2
    entries, as K2a-K2d's), with a progress count in shared memory that the
    copy warps follow (no slot is reused, so the parse never waits).
Per variant and kernel it prints the ms per 128-row launch (CUDA events)
and, summed over the rows, the parse's and the copies' cycles per
sequence with their waits taken out, and the waits; each variant's output
is checked against the kept kernel's. Then, for K1, probes of the parse
alone (one warp a row, its sequences written to a sink: the kept parse,
and a chain of tokens and lengths only), and the kept kernel with two to
seven copy warps, with copy warps that sleep between polls or ask
try_wait to suspend, and with no copies at all.

    python3 tools/decode_stamps_torch.py

Builds its library with nvcc into plz4_tpu_torch/_build/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SRC = r"""
#include <cuda_runtime.h>
#include "lz4_decode_ring.cuh"

namespace {

// stats per row: parse cycles, parse waits, copy cycles, copy waits,
// sequences, block cycles
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

// the global scratch: a batch of 32 sequences is published (the count in
// shared memory raised past it) by the next open(), the last one by
// finish()
struct stamp_global_emit {
  int4* seq;
  volatile int* prog;
  volatile int* fin;
  int k;
  __host__ __device__ void open() {
#if defined(__CUDA_ARCH__)
    __threadfence_block();
    *prog = k;
#endif
  }
  __host__ __device__ void operator()(int ip, int n_lit, int off, int m) {
#if defined(__CUDA_ARCH__)
    seq[k++] = make_int4(ip, n_lit, off, m);
#endif
  }
  __host__ __device__ void drop_last() {
#if defined(__CUDA_ARCH__)
    seq[k - 1].w = 0;
#endif
  }
  __device__ void finish() {
    __threadfence_block();
    *prog = k;
    __threadfence_block();
    *fin = 1;
  }
};

template <bool kClip, bool kGlobal>
__global__ void __launch_bounds__(256)
    stamped(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
            const uint8_t* __restrict__ dict, uint8_t* __restrict__ outs,
            int32_t* __restrict__ n_outs, bool* __restrict__ oks,
            int4* __restrict__ gseq, long long* __restrict__ stats, int C,
            int D, int dlen, int out_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long t_start = clock64();
  constexpr int NB = LZ4T_RING_BATCHES;
  const int row = blockIdx.x;
  int4* ring = reinterpret_cast<int4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NB * 32 * 16);
  uint64_t* empty = full + NB;
  int* cnt = reinterpret_cast<int*>(empty + NB);
  int* s_n = cnt + NB;  // n_out, progress, done
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem + LZ4T_RING_SMEM);
  uint32_t* dw = cw + (C + LZ4T_RING_PAD) / 4;
  uint32_t* ow = dw + D / 4;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(comp + (size_t)row * C);
  const uint32_t* dsrc = reinterpret_cast<const uint32_t*>(dict);
  const int nw = C / 4;
  for (int i = t; i < nw; i += blockDim.x) cw[i] = src[i];
  if (t < LZ4T_RING_PAD / 4)
    cw[nw + t] = kClip && nw ? (src[nw - 1] >> 24) * 0x01010101u : 0u;
  for (int i = t; i < D / 4; i += blockDim.x) dw[i] = dsrc[i];
  if (t == 0) {
    for (int s = 0; s < NB; s++) {
      lz4t_mbar_init(&full[s], 1);
      lz4t_mbar_init(&empty[s], LZ4T_RING_WARPS);
    }
    s_n[1] = 0;
    s_n[2] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  long long* st = stats + (size_t)row * kStats;
  uint8_t* o = reinterpret_cast<uint8_t*>(ow);
  int4* gs = gseq + (size_t)row * (out_cap / 4 + 2);
  if (warp == 0) {
    if (lane == 0) {
      const long long t0 = clock64();
      int n, okv, k;
      long long wait = 0;
      if (kGlobal) {
        stamp_global_emit em = {gs, s_n + 1, s_n + 2, 0};
        lz4t_parse_strict<kClip>(cw, C, clens[row], dlen, out_cap, em, &n,
                                 &okv);
        em.finish();
        k = em.k;
      } else {
        stamp_ring_emit em = {{ring, cnt, full, empty, 0, 0}, 0};
        lz4t_parse_strict<kClip>(cw, C, clens[row], dlen, out_cap, em, &n,
                                 &okv);
        em.finish();
        k = em.k;
        wait = em.wait;
      }
      st[0] = clock64() - t0;
      st[1] = wait;
      st[4] = k;
      n_outs[row] = n;
      oks[row] = okv != 0;
      s_n[0] = n;
    }
    __syncwarp();
  } else {
    const long long t0 = clock64();
    long long wait = 0;
    const auto lit = [cw, C](int p) { return lz4t_pad_rd(cw, C, p); };
    const uint8_t* win = reinterpret_cast<const uint8_t*>(dw);
    int bop = 0;
    for (int b = 0;; b++) {
      const int s = b % NB;
      const long long tw = clock64();
      int n;
      const int32_t* e;
      if (kGlobal) {
        volatile int* prog = s_n + 1;
        volatile int* fin = s_n + 2;
        int p;
        while (true) {
          const int f = *fin;
          p = *prog;
          if (p >= 32 * (b + 1) || f) break;
        }
        __threadfence_block();
        n = lz4t_min(32, p - 32 * b);
        e = reinterpret_cast<const int32_t*>(gs + 32 * b);
      } else {
        lz4t_mbar_wait(&full[s], (b / NB) & 1);
        n = cnt[s];
        e = reinterpret_cast<const int32_t*>(ring + s * 32);
      }
      __syncwarp();
      wait += clock64() - tw;
      bop = lz4t_copy_batch_lanes<LZ4T_RING_WARPS>(
          lit, o, win, D, e, n, bop, warp - 1, [&] {
            if (!kGlobal && lane == 0) lz4t_mbar_arrive(&empty[s]);
          });
      if (n < 32) break;
    }
    if (t == 32) {
      st[2] = clock64() - t0;
      st[3] = wait;
    }
  }
  __syncthreads();
  uint32_t* dst = reinterpret_cast<uint32_t*>(outs + (size_t)row * out_cap);
  const int words = (s_n[0] + 3) / 4;
  for (int i = t; i < words; i += blockDim.x) dst[i] = ow[i];
  if (t == 0) st[5] = clock64() - t_start;
}

// the parse alone, one warp a row: the kept parse with its sequences
// written to a sink (MODE 0), or a chain of tokens and lengths only
// (MODE 1); cyc: the parse's cycles and sequences a row
struct sink_emit {
  int4* ring;
  int k;
  __host__ __device__ void open() {}
  __host__ __device__ void operator()(int ip, int n_lit, int off, int m) {
#if defined(__CUDA_ARCH__)
    ring[k++ & 2047] = make_int4(ip, n_lit, off, m);
#endif
  }
  __host__ __device__ void drop_last() {}
};

template <int MODE>
__global__ void parse_alone(const uint8_t* __restrict__ comp,
                            const int32_t* __restrict__ clens,
                            long long* __restrict__ cyc, int C,
                            int out_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  int4* ring = reinterpret_cast<int4*>(smem);
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem + LZ4T_RING_SMEM);
  const int row = blockIdx.x, t = threadIdx.x, nw = C / 4;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(comp + (size_t)row * C);
  for (int i = t; i < nw; i += blockDim.x) cw[i] = src[i];
  if (t < LZ4T_RING_PAD / 4) cw[nw + t] = (src[nw - 1] >> 24) * 0x01010101u;
  __syncthreads();
  if (t) return;
  const long long t0 = clock64();
  int k = 0, n, okv;
  if (MODE == 0) {
    sink_emit em = {ring, 0};
    lz4t_parse_strict<true>(cw, C, clens[row], 0, out_cap, em, &n, &okv);
    k = em.k;
  } else {
    int ip = 0;
    const int clen = clens[row];
    while (ip < clen) {
      const int token = lz4t_pad_rd(cw, C, ip);
      int lit = token >> 4, p = ip + 1;
      if (lit == 15) p = lz4t_pad_varint<true>(cw, C, p, &lit);
      p += lit;
      if (p >= clen) break;
      int ml = token & 15;
      p += 2;
      if (ml == 15) p = lz4t_pad_varint<true>(cw, C, p, &ml);
      ip = p;
      k++;
    }
    ring[0].x = ip;  // keeps the chain
  }
  cyc[2 * row] = clock64() - t0;
  cyc[2 * row + 1] = k;
}

// K1's kernel with NW copy warps (the block's others idle); WAIT > 1
// sleeps that many ns between polls of a full barrier, WAIT < 0 asks
// try_wait to suspend up to -WAIT ns, WAIT == 1 makes no copies
template <int NW, int WAIT>
__global__ void __launch_bounds__(256)
    copy_warps(const uint8_t* __restrict__ comp,
               const int32_t* __restrict__ clens, uint8_t* __restrict__ outs,
               int32_t* __restrict__ n_outs, bool* __restrict__ oks, int C,
               int out_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NB = LZ4T_RING_BATCHES;
  const int row = blockIdx.x;
  int4* ring = reinterpret_cast<int4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NB * 32 * 16);
  uint64_t* empty = full + NB;
  int* cnt = reinterpret_cast<int*>(empty + NB);
  int* s_n = cnt + NB;
  uint32_t* cw = reinterpret_cast<uint32_t*>(smem + LZ4T_RING_SMEM);
  uint32_t* ow = cw + (C + LZ4T_RING_PAD) / 4;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, nw = C / 4;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(comp + (size_t)row * C);
  for (int i = t; i < nw; i += blockDim.x) cw[i] = src[i];
  if (t < LZ4T_RING_PAD / 4) cw[nw + t] = (src[nw - 1] >> 24) * 0x01010101u;
  if (t == 0) {
    for (int s = 0; s < NB; s++) {
      lz4t_mbar_init(&full[s], 1);
      lz4t_mbar_init(&empty[s], NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  uint8_t* o = reinterpret_cast<uint8_t*>(ow);
  if (warp == 0) {
    if (lane == 0) {
      lz4t_ring_emit em = {ring, cnt, full, empty, 0, 0};
      int n, okv;
      lz4t_parse_strict<true>(cw, C, clens[row], 0, out_cap, em, &n, &okv);
      em.finish();
      n_outs[row] = n;
      oks[row] = okv != 0;
      *s_n = n;
    }
    __syncwarp();
  } else if (warp <= NW) {
    const auto lit = [cw, C](int p) { return lz4t_pad_rd(cw, C, p); };
    int bop = 0;
    for (int b = 0;; b++) {
      const int s = b % NB;
      const uint32_t addr = lz4t_smem_addr(&full[s]), par = (b / NB) & 1;
      uint32_t done;
      while (true) {
        if (WAIT < 0)
          asm volatile(
              "{\n\t.reg .pred p;\n\t"
              "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;"
              "\n\tselp.u32 %0, 1, 0, p;\n\t}"
              : "=r"(done)
              : "r"(addr), "r"(par), "r"(-WAIT)
              : "memory");
        else
          asm volatile(
              "{\n\t.reg .pred p;\n\t"
              "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
              "\n\tselp.u32 %0, 1, 0, p;\n\t}"
              : "=r"(done)
              : "r"(addr), "r"(par)
              : "memory");
        if (done) break;
        if (WAIT > 1) __nanosleep(WAIT > 1 ? (unsigned)WAIT : 0u);
      }
      __syncwarp();
      const int n = cnt[s];
      const auto release = [&] {
        if (lane == 0) lz4t_mbar_arrive(&empty[s]);
      };
      if (WAIT == 1) {
        release();
      } else {
        bop = lz4t_copy_batch_lanes<NW>(
            lit, o, nullptr, 0, reinterpret_cast<const int32_t*>(ring + s * 32),
            n, bop, warp - 1, release);
      }
      if (n < 32) break;
    }
  }
  __syncthreads();
  uint32_t* dst = reinterpret_cast<uint32_t*>(outs + (size_t)row * out_cap);
  for (int i = t; i < (*s_n + 3) / 4; i += blockDim.x) dst[i] = ow[i];
}

}  // namespace

extern "C" int stamp_launch(const void* comp, const void* clens,
                            const void* dict, void* outs, void* n_outs,
                            void* oks, void* gseq, void* stats, int B, int C,
                            int D, int dlen, int out_cap, int k3,
                            int global) {
  const int smem = LZ4T_RING_SMEM + C + LZ4T_RING_PAD + D + out_cap;
  auto go = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, 256, smem>>>((const uint8_t*)comp, (const int32_t*)clens,
                           (const uint8_t*)dict, (uint8_t*)outs,
                           (int32_t*)n_outs, (bool*)oks, (int4*)gseq,
                           (long long*)stats, C, D, dlen, out_cap);
    return (int)cudaGetLastError();
  };
  if (k3) return global ? go(stamped<false, true>) : go(stamped<false, false>);
  return global ? go(stamped<true, true>) : go(stamped<true, false>);
}

extern "C" int probe_parse(const void* comp, const void* clens, void* cyc,
                           int B, int C, int out_cap, int mode) {
  const int smem = LZ4T_RING_SMEM + C + LZ4T_RING_PAD;
  auto go = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, 32, smem>>>((const uint8_t*)comp, (const int32_t*)clens,
                          (long long*)cyc, C, out_cap);
    return (int)cudaGetLastError();
  };
  return mode ? go(parse_alone<1>) : go(parse_alone<0>);
}

// variant: 2-7 copy warps; 8, 9, 10 sleep 32, 128, 512 ns; 11, 12 suspend
// up to 100, 1000 ns; 13 no copies
extern "C" int probe_copy(const void* comp, const void* clens, void* outs,
                          void* n_outs, void* oks, int B, int C, int out_cap,
                          int variant) {
  const int smem = LZ4T_RING_SMEM + C + LZ4T_RING_PAD + out_cap;
  auto go = [&](auto kern) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B, 256, smem>>>((const uint8_t*)comp, (const int32_t*)clens,
                           (uint8_t*)outs, (int32_t*)n_outs, (bool*)oks, C,
                           out_cap);
    return (int)cudaGetLastError();
  };
  switch (variant) {
    case 2: return go(copy_warps<2, 0>);
    case 3: return go(copy_warps<3, 0>);
    case 4: return go(copy_warps<4, 0>);
    case 5: return go(copy_warps<5, 0>);
    case 6: return go(copy_warps<6, 0>);
    case 7: return go(copy_warps<7, 0>);
    case 8: return go(copy_warps<7, 32>);
    case 9: return go(copy_warps<7, 128>);
    case 10: return go(copy_warps<7, 512>);
    case 11: return go(copy_warps<7, -100>);
    case 12: return go(copy_warps<7, -1000>);
    case 13: return go(copy_warps<7, 1>);
  }
  return -1;
}
"""


def main() -> int:
    import numpy as np
    import torch

    from plz4_tpu_torch import corpus, native
    from plz4_tpu_torch.ops import _build, decode, encode

    if not torch.cuda.is_available():
        print("decode_stamps_torch: no CUDA GPU visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "decode_stamps_torch.cu")
    so = os.path.join(_build.BUILD_DIR, "libdecode_stamps_torch.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    lib.stamp_launch.restype = ctypes.c_int
    lib.stamp_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    print(card)

    dev = torch.device("cuda", 0)
    N, B = 65536, 128
    data = corpus.silesia_like(32 << 20)
    blocks = [data[i * N:(i + 1) * N] for i in range(B)]
    rows = np.zeros((B, N), np.uint8)
    for i, b in enumerate(blocks):
        rows[i] = np.frombuffer(b, np.uint8)
    out, tot, ok = (t.cpu().numpy() for t in encode.encode_batch(
        torch.from_numpy(rows).to(dev),
        torch.full((B,), N, dtype=torch.int32, device=dev)))
    assert ok.all()
    dict_ = corpus.silesia_like(N, seed=77)
    C = N + decode.ROW_SLACK
    batches = {}
    for kern, streams in (
            ("K1", [out[i, :tot[i]].tobytes() for i in range(B)]),
            ("K3", [native.compress(b, level=1, dict_=dict_)
                    for b in blocks])):
        comp = np.zeros((B, C), np.uint8)
        for i, s in enumerate(streams):
            comp[i, :len(s)] = np.frombuffer(s, np.uint8)
        clens = np.array([len(s) for s in streams], np.int32)
        batches[kern] = (torch.from_numpy(comp).to(dev),
                         torch.from_numpy(clens).to(dev))
    dbuf = torch.from_numpy(np.frombuffer(dict_, np.uint8).copy()).to(dev)
    gseq = torch.empty((B, N // 4 + 2, 4), dtype=torch.int32, device=dev)
    stats = torch.zeros((B, 6), dtype=torch.int64, device=dev)

    def events_ms(fn, reps=20):
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

    for kern, (comp, clens) in batches.items():
        k3 = kern == "K3"
        if k3:
            ref = decode.decode_batch_dict(comp, clens, dbuf, N, N)
            kept = events_ms(lambda: decode.decode_batch_dict(
                comp, clens, dbuf, N, N))
        else:
            ref = decode.decode_batch(comp, clens, N)
            kept = events_ms(lambda: decode.decode_batch(comp, clens, N))
        print(f"{kern} kept kernel: {kept:.3f} ms per {B}-row launch")
        ref_n = ref[1].cpu().numpy()
        for glob in (0, 1):
            o = torch.empty((B, N), dtype=torch.uint8, device=dev)
            n = torch.empty((B,), dtype=torch.int32, device=dev)
            okv = torch.empty((B,), dtype=torch.bool, device=dev)

            def run():
                rc = lib.stamp_launch(
                    comp.data_ptr(), clens.data_ptr(),
                    dbuf.data_ptr() if k3 else 0, o.data_ptr(), n.data_ptr(),
                    okv.data_ptr(), gseq.data_ptr(), stats.data_ptr(), B, C,
                    N if k3 else 0, N if k3 else 0, N, k3, glob)
                if rc:
                    raise RuntimeError(f"stamp_launch: cudaError {rc}")

            ms = events_ms(run)
            st = stats.cpu().numpy().astype(np.float64)
            same = bool((n.cpu().numpy() == ref_n).all()
                        and (okv.cpu() == ref[2].cpu()).all().item())
            ko, ro = o.cpu().numpy(), ref[0].cpu().numpy()
            same = same and all(ko[i, :ref_n[i]].tobytes()
                                == ro[i, :ref_n[i]].tobytes()
                                for i in range(B))
            seqs = st[:, 4].sum()
            name = "global" if glob else "ring"
            print(f"{kern} {name}: {ms:.3f} ms per launch; per sequence "
                  f"({seqs / B:.0f} a row): parse "
                  f"{(st[:, 0] - st[:, 1]).sum() / seqs:.1f} cycles + wait "
                  f"{st[:, 1].sum() / seqs:.1f}, copy "
                  f"{(st[:, 2] - st[:, 3]).sum() / seqs:.1f} + wait "
                  f"{st[:, 3].sum() / seqs:.1f}; block "
                  f"{st[:, 5].mean():.0f} cycles a row (max "
                  f"{st[:, 5].max():.0f}); equal to the kept kernel: {same}")
            if not same:
                return 1
    comp, clens = batches["K1"]
    lib.probe_parse.restype = lib.probe_copy.restype = ctypes.c_int
    lib.probe_parse.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    lib.probe_copy.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    cyc = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    def checked(rc):
        if rc:
            raise RuntimeError(f"probe launch: cudaError {rc}")

    for mode, what in ((0, "the kept parse"),
                       (1, "a chain of tokens and lengths only")):
        ms = events_ms(lambda: checked(lib.probe_parse(
            comp.data_ptr(), clens.data_ptr(), cyc.data_ptr(), B, C, N,
            mode)))
        c = cyc.cpu().numpy().astype(np.float64)
        print(f"K1 parse alone, {what}: {ms:.3f} ms per launch, "
              f"{c[:, 0].sum() / c[:, 1].sum():.1f} cycles per sequence")
    ref = decode.decode_batch(comp, clens, N)
    ref_n = ref[1].cpu().numpy()
    o = torch.empty((B, N), dtype=torch.uint8, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    okv = torch.empty((B,), dtype=torch.bool, device=dev)
    for v, what in [(w, f"{w} copy warps") for w in range(7, 1, -1)] + [
            (8, "copy warps sleeping 32 ns"), (9, "sleeping 128 ns"),
            (10, "sleeping 512 ns"), (11, "suspending up to 100 ns"),
            (12, "suspending up to 1000 ns"), (13, "no copies")]:
        ms = events_ms(lambda: checked(lib.probe_copy(
            comp.data_ptr(), clens.data_ptr(), o.data_ptr(), n.data_ptr(),
            okv.data_ptr(), B, C, N, v)))
        same = v == 13 or (bool((n.cpu().numpy() == ref_n).all())
                           and all(torch.equal(o[i, :ref_n[i]],
                                               ref[0][i, :ref_n[i]])
                                   for i in range(B)))
        print(f"K1 with {what}: {ms:.3f} ms per launch; equal to the kept "
              f"kernel: {same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
