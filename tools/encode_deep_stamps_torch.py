#!/usr/bin/env python3
"""Where K4's time goes, on one CUDA GPU: clock stamps in instrumented
copies of its kernels (csrc/lz4_encode_deep.cu), built from the kept
headers of a tree, over the frame cell's rows: the first 128 blocks of
64 KiB of the benchmark's base payload (benchmark/corpus.py: silesia_bulk,
seed 2003), plain rows, at walk budgets 2 and 32.

    python3 tools/encode_deep_stamps_torch.py [TREE]
        [--variants=W:S:E[:PS:PC],...] [--ptxas] [--sass=OTHER]

imports plz4_tpu_torch from TREE (default: this checkout; e.g. a parent
unpacked with `git archive <commit> | tar -x -C build/parent`) and prints
for each budget:

- the kept K4's ms per launch over the 128 rows (CUDA events);
- the table kernel (the walk table written whole to device memory, then
  the parse: every route of a tree without the table ring, and the rows
  after a window of a tree with it) stamped: cycles per row for staging,
  the chain build, the ring load, the table and the parse, mean and max
  over the rows;
- where TREE's headers have the table ring (LZ4T_DEEP_PIPE_SLOTS), the
  pipelined kernel of plain rows stamped, for each variant W:S:E[:PS:PC]
  (W table warps, S slots of E entries, and where the headers have the
  split build's peer ring, PS slots of PC positions; default the
  headers' own; a variant other than those patches the #defines in a
  copy of the headers): the same phases, the parse's cycles waiting for
  full slots, and the table warps' busy cycles, their cycles waiting for
  empty slots and the cycle the last of them finished (each counted from
  the ring load's end);
- where the headers have the split build (LZ4T_DEEP_PEER_SLOTS), its
  build warp's cycles waiting for peer chunks, the peer warps' busy
  cycles and their cycles waiting for empty peer slots (counted from the
  build's start), and the share of build steps in which some lane has a
  lower lane of the same key;
- for every stamped kernel, the parse's cycles inside
  lz4t_emit_sequence_lanes (the headers' copy wraps its two calls in
  lz4t_encode_deep_row with clock stamps).

Each stamped kernel's output is checked against the kept K4's, and each
prints the spread of its row times inside the launch (cycles from the
block's start to its end: min, median, max) and the launch's span on the
global timer. Stamps cost a few clock reads per phase and per chunk;
the kept kernels carry none (over these rows a copy without them took the
same time). --ptxas prints the registers and spills of
the kept kernels and of each stamped build (nvcc -Xptxas -v). --sass=OTHER
compares the SASS (cuobjdump -sass) of every kernel library of TREE with
that of OTHER, built there before (by this tool or chip_smoke.py), kernel
by kernel, the anonymous namespace's hash (nvcc takes it from the source
path) set aside; it prints each kernel as identical or as differing,
with its instruction counts.

Builds its libraries with nvcc into TREE's plz4_tpu_torch/_build/.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import shutil
import subprocess
import sys

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "lz4_encode_deep.cuh"

namespace {

// stats per row, in cycles: staging, build, ring load, table, parse,
// parse waits for full slots, table warps' busy cycles (summed), their
// waits for empty slots (summed), the last table warp's end, the block;
// then the build warp's waits for peer chunks, the peer warps' busy
// cycles (summed), their waits for empty peer slots (summed), the build
// steps with a lower peer, the parse's cycles in the emit
constexpr int kStats = 15;
constexpr int kHashLog = 15;

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// lz4_encode_deep.cu's table kernel on plain rows, stamped
__global__ void __launch_bounds__(256)
    stamped_table(const uint8_t* __restrict__ data,
                  const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
                  int32_t* __restrict__ totals, bool* __restrict__ ok,
                  uint16_t* delta, uint32_t* tab, long long* stats,
                  unsigned long long* span, int N, int CAP, int tries) {
  extern __shared__ __align__(16) uint32_t smem[];
  const unsigned long long g0 = gtime();
  const long long t0 = clock64();
  uint32_t* head = smem;
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint32_t* roww = smem + LZ4T_DEEP_RING / 2;
  const uint8_t* c = reinterpret_cast<const uint8_t*>(roww);
  const int r = blockIdx.x, t = threadIdx.x;
  const int DT = N + 8;
  uint16_t* dr = delta + (size_t)r * DT;
  uint32_t* tr = tab + (size_t)r * N;
  for (int i = t; i < (1 << kHashLog); i += 256) head[i] = 0;
  lz4t_stage_row(roww, data, nullptr, r, N, 0, 1, 0);
  if (t == 0) lz4t_stamp_emit[r] = 0;
  __syncthreads();
  const long long t1 = clock64();
  const int n = lens[r];
  const int mflimit = n - 12, matchlimit = n - 5;
  if (t < 32) lz4t_deep_build(c, 0, mflimit, kHashLog, head, dr);
  __syncthreads();
  const long long t2 = clock64();
  for (int i = t; i < lz4t_min(LZ4T_DEEP_RING, DT); i += 256) ring[i] = dr[i];
  __syncthreads();
  const long long t3 = clock64();
  lz4t_ring rg = {ring, dr, LZ4T_DEEP_RING};
  lz4t_walk_table(c, 0, 0, lz4t_min(mflimit, LZ4T_DEEP_RING - 1), 0,
                  matchlimit, tries, rg, tr, t, 256);
  __syncthreads();
  const long long t4 = clock64();
  if (t < 32) {
    int total, okv;
#ifdef LZ4T_DEEP_PIPE_SLOTS
    lz4t_dev_tab dt = {tr, 0};
    lz4t_encode_deep_row(c, 0, 0, n, out + (size_t)r * CAP, CAP, tries, rg,
                         dt, &total, &okv);
#else
    lz4t_encode_deep_row(c, 0, 0, n, out + (size_t)r * CAP, CAP, tries, rg,
                         tr, &total, &okv);
#endif
    if (t == 0) {
      const long long t5 = clock64();
      totals[r] = total;
      ok[r] = okv != 0;
      long long* st = stats + (size_t)r * kStats;
      st[0] = t1 - t0;
      st[1] = t2 - t1;
      st[2] = t3 - t2;
      st[3] = t4 - t3;
      st[4] = t5 - t4;
      st[5] = st[6] = st[7] = st[8] = 0;
      st[9] = t5 - t0;
      st[14] = lz4t_stamp_emit[r];
      span[2 * r] = g0;
      span[2 * r + 1] = gtime();
    }
  }
}

#ifdef LZ4T_DEEP_PIPE_SLOTS
constexpr int S = LZ4T_DEEP_PIPE_SLOTS, E = LZ4T_DEEP_PIPE_CHUNK;
constexpr int kW = LZ4T_DEEP_PIPE_WARPS;
constexpr int kThreads = 32 * (kW + 1);

// lz4t_pipe_bars with the parse's waits counted
struct stamp_bars {
  uint64_t* full;
  uint64_t* empty;
  long long wait;
  __host__ __device__ void wait_full(int k) {
#if defined(__CUDA_ARCH__)
    const long long a = clock64();
    lz4t_mbar_wait(&full[k & (S - 1)], (k / S) & 1);
    wait += clock64() - a;
#endif
  }
  __host__ __device__ void hand_back(int k) {
#if defined(__CUDA_ARCH__)
    __syncwarp();
    if (lz4t_lead()) lz4t_mbar_arrive(&empty[k & (S - 1)]);
#endif
  }
};

// lz4_encode_deep.cu's plain kernel's shared memory (lz4t_plain_layout;
// the peer ring's barriers where the headers have the split build)
struct smem_parts {
  uint32_t* head;
  uint16_t* ring;
  uint32_t* slot;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* peer_full;
  uint64_t* peer_empty;
  uint32_t* roww;
};

__device__ __forceinline__ smem_parts layout() {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* slot = smem + LZ4T_DEEP_RING / 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(slot + S * E);
  uint64_t* empty = full + S;
#ifdef LZ4T_DEEP_PEER_SLOTS
  uint64_t* peer_full = empty + S;
  uint64_t* peer_empty = peer_full + LZ4T_DEEP_PEER_SLOTS;
  uint64_t* end = peer_empty + LZ4T_DEEP_PEER_SLOTS;
#else
  uint64_t *peer_full = nullptr, *peer_empty = nullptr, *end = empty + S;
#endif
  return {smem,      reinterpret_cast<uint16_t*>(smem),
          slot,      full,
          empty,     peer_full,
          peer_empty, reinterpret_cast<uint32_t*>(end)};
}

#ifdef LZ4T_DEEP_PEER_SLOTS
constexpr int PS = LZ4T_DEEP_PEER_SLOTS, PE = LZ4T_DEEP_PEER_CHUNK;

// lz4t_peer_bars with the build warp's waits counted
struct stamp_peer_bars {
  uint64_t* full;
  uint64_t* empty;
  long long wait;
  __host__ __device__ void wait_full(int k) {
#if defined(__CUDA_ARCH__)
    const long long a = clock64();
    lz4t_mbar_wait(&full[k & (PS - 1)], (k / PS) & 1);
    wait += clock64() - a;
#endif
  }
  __host__ __device__ void hand_back(int k) {
#if defined(__CUDA_ARCH__)
    __syncwarp();
    if (lz4t_lead()) lz4t_mbar_arrive(&empty[k & (PS - 1)]);
#endif
  }
};

// lz4t_plain_build, returning its waits for peer chunks
__device__ __forceinline__ long long stamped_build(int n, uint16_t* dr) {
  const smem_parts m = layout();
  lz4t_peer_ring<stamp_peer_bars> pr = {m.slot,
                                        {m.peer_full, m.peer_empty, 0}};
  lz4t_deep_build_split(n - 12, m.head, dr, pr);
  return pr.sync.wait;
}

// lz4t_plain_peers (lz4t_peer_fill) for peer warp w, returning its waits
// for empty peer slots; *lower gets its steps with a lower peer
__device__ __noinline__ long long stamped_peers(int n, int w, int* lower) {
  const smem_parts m = layout();
  const uint8_t* c = reinterpret_cast<const uint8_t*>(m.roww);
  const int last = n - 12, nchunks = lz4t_peer_chunks(last);
  long long wait = 0;
  int g = w, low = 0;
  for (int k = 0; k < nchunks; k++) {
    const long long a = clock64();
    if (k >= PS)
      lz4t_mbar_wait(&m.peer_empty[k & (PS - 1)], (k / PS - 1) & 1);
    wait += clock64() - a;
    for (; g < (k + 1) * (PE / 32) && 32 * g <= last; g += kW) {
      uint32_t* pw = m.slot + ((32 * g) & (PS * PE - 1));
      lz4t_peer_step(c, 32 * g, last, kHashLog, pw);
      low += __any_sync(0xFFFFFFFFu, pw[threadIdx.x & 31] & LZ4T_PEER_LOWER)
                 ? 1
                 : 0;
    }
    __syncwarp();
    if (lz4t_lead()) lz4t_mbar_arrive(&m.peer_full[k & (PS - 1)]);
  }
  *lower = low;
  return wait;
}
#endif

// lz4t_plain_parse, returning its waits for full slots
__device__ __noinline__ long long stamped_parse(int n, uint8_t* o, int CAP,
                                                int tries, int* total,
                                                int* okv) {
  const smem_parts m = layout();
  const lz4t_ring rg = {m.ring, nullptr, LZ4T_DEEP_RING};
  lz4t_pipe_tab<stamp_bars> tab = {
      m.slot, 0, lz4t_pipe_chunks(0, n - 12), {m.full, m.empty, 0}, 0, 0};
  lz4t_encode_deep_row(reinterpret_cast<const uint8_t*>(m.roww), 0, 0, n, o,
                       CAP, tries, rg, tab, total, okv);
  return tab.sync.wait;
}

// lz4t_plain_fill (lz4t_pipe_fill) for table warp w, returning its waits
// for empty slots
__device__ __noinline__ long long stamped_fill(int n, int tries, int w) {
  const smem_parts m = layout();
  const lz4t_ring rg = {m.ring, nullptr, LZ4T_DEEP_RING};
  const uint8_t* c = reinterpret_cast<const uint8_t*>(m.roww);
  const int lane = threadIdx.x & 31, mflimit = n - 12;
  const int nchunks = lz4t_pipe_chunks(0, mflimit);
  long long wait = 0;
  int g = w;
  for (int k = 0; k < nchunks; k++) {
    const long long a = clock64();
    if (k >= S) lz4t_mbar_wait(&m.empty[k & (S - 1)], (k / S - 1) & 1);
    wait += clock64() - a;
    for (; g < (k + 1) * (E / 32); g += kW) {
      const int p = 32 * g + lane;
      if (p <= mflimit)
        m.slot[p & (S * E - 1)] =
            lz4t_walk_entry(c, p, 0, n - 5, tries, rg);
    }
    __syncwarp();
    if (lz4t_lead()) lz4t_mbar_arrive(&m.full[k & (S - 1)]);
  }
  return wait;
}

// lz4_encode_deep.cu's plain-row kernel, stamped
__global__ void __launch_bounds__(kThreads, 1)
    stamped_pipe(const uint8_t* __restrict__ data,
                 const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
                 int32_t* __restrict__ totals, bool* __restrict__ ok,
                 uint16_t* delta, uint32_t*, long long* stats,
                 unsigned long long* span, int N, int CAP, int tries) {
  __shared__ unsigned long long s_busy, s_wait, s_end, s_pbusy, s_pwait,
      s_low;
  const unsigned long long g0 = gtime();
  const long long t0 = clock64();
  const smem_parts m = layout();
  const int r = blockIdx.x, t = threadIdx.x;
  const int DT = N + 8;
  uint16_t* dr = delta + (size_t)r * DT;
  for (int i = t; i < (1 << kHashLog); i += kThreads) m.head[i] = 0;
  lz4t_stage_row(m.roww, data, nullptr, r, N, 0, 1, 0);
#ifdef LZ4T_DEEP_PEER_SLOTS
  lz4t_pipe_init<kW>(m.full, m.empty, m.peer_full, m.peer_empty);
#else
  lz4t_pipe_init<kW>(m.full, m.empty);
#endif
  if (t == 0) {
    s_busy = s_wait = s_end = s_pbusy = s_pwait = s_low = 0;
    lz4t_stamp_emit[r] = 0;
  }
  __syncthreads();
  const long long t1 = clock64();
  const int n = lens[r];
#ifdef LZ4T_DEEP_PEER_SLOTS
  if (t < 32) {
    const long long wait = stamped_build(n, dr);
    if (t == 0) stats[(size_t)r * kStats + 10] = wait;
  } else {
    int low;
    const long long wait = stamped_peers(n, (t >> 5) - 1, &low);
    if ((t & 31) == 0) {
      const long long end = clock64() - t1;
      atomicAdd(&s_pbusy, (unsigned long long)(end - wait));
      atomicAdd(&s_pwait, (unsigned long long)wait);
      atomicAdd(&s_low, (unsigned long long)low);
    }
  }
#else
  if (t < 32)
    lz4t_deep_build(reinterpret_cast<const uint8_t*>(m.roww), 0, n - 12,
                    kHashLog, m.head, dr);
#endif
  __syncthreads();
  const long long t2 = clock64();
  for (int i = t; i < lz4t_min(LZ4T_DEEP_RING, DT); i += kThreads)
    m.ring[i] = dr[i];
  __syncthreads();
  const long long t3 = clock64();
  if (t < 32) {
    int total, okv;
    const long long wait =
        stamped_parse(n, out + (size_t)r * CAP, CAP, tries, &total, &okv);
    if (t == 0) {
      const long long t5 = clock64();
      totals[r] = total;
      ok[r] = okv != 0;
      long long* st = stats + (size_t)r * kStats;
      st[0] = t1 - t0;
      st[1] = t2 - t1;
      st[2] = t3 - t2;
      st[4] = t5 - t3;
      st[5] = wait;
    }
  } else {
    const long long wait = stamped_fill(n, tries, (t >> 5) - 1);
    if ((t & 31) == 0) {
      const long long end = clock64() - t3;
      atomicAdd(&s_busy, (unsigned long long)(end - wait));
      atomicAdd(&s_wait, (unsigned long long)wait);
      atomicMax(&s_end, (unsigned long long)end);
    }
  }
  __syncthreads();
  if (t == 0) {
    long long* st = stats + (size_t)r * kStats;
    st[3] = 0;
    st[6] = (long long)s_busy;
    st[7] = (long long)s_wait;
    st[8] = (long long)s_end;
    st[9] = clock64() - t0;
    st[11] = (long long)s_pbusy;
    st[12] = (long long)s_pwait;
    st[13] = (long long)s_low;
    st[14] = lz4t_stamp_emit[r];
    span[2 * r] = g0;
    span[2 * r + 1] = gtime();
  }
}
#endif

}  // namespace

// the pipelined kernel's threads
extern "C" int stamp_threads() {
#ifdef LZ4T_DEEP_PIPE_SLOTS
  return kThreads;
#else
  return 0;
#endif
}

// pipe 0: the table kernel; 1: the pipelined kernel
extern "C" int stamp_launch(int pipe, const void* data, const void* lens,
                            void* out, void* totals, void* ok, void* delta,
                            void* tab, void* stats, void* span, int R, int N,
                            int CAP, int tries) {
  int smem = LZ4T_DEEP_RING * 2 + N + 8, threads = 256;
  auto kern = stamped_table;
#ifdef LZ4T_DEEP_PIPE_SLOTS
  if (pipe) {
    smem += LZ4T_DEEP_PIPE_SMEM;
    threads = kThreads;
    kern = stamped_pipe;
  }
#else
  if (pipe) return -1;
#endif
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<R, threads, smem>>>((const uint8_t*)data, (const int32_t*)lens,
                             (uint8_t*)out, (int32_t*)totals, (bool*)ok,
                             (uint16_t*)delta, (uint32_t*)tab,
                             (long long*)stats, (unsigned long long*)span, N,
                             CAP, tries);
  return (int)cudaGetLastError();
}
"""

DEFINES = ("LZ4T_DEEP_PIPE_WARPS", "LZ4T_DEEP_PIPE_SLOTS",
           "LZ4T_DEEP_PIPE_CHUNK", "LZ4T_DEEP_PEER_SLOTS",
           "LZ4T_DEEP_PEER_CHUNK")

# wraps the parse's emits in clock stamps (see _headers_variant)
EMIT_STAMP = """\
// the parse's cycles in lz4t_emit_sequence_lanes, per block (added by
// tools/encode_deep_stamps_torch.py to its copy of the headers)
__device__ long long lz4t_stamp_emit[4096];
LZ4T_HD int lz4t_emit_stamped(const uint8_t* c, uint8_t* o, int OT, int op,
                              int anchor, int ip, int mpos, int mlen) {
#if defined(__CUDA_ARCH__)
  const long long a = clock64();
  const int q =
      lz4t_emit_sequence_lanes(c, o, OT, op, anchor, ip, mpos, mlen);
  if ((threadIdx.x & 31) == 0) lz4t_stamp_emit[blockIdx.x] += clock64() - a;
  return q;
#else
  return lz4t_emit_sequence_lanes(c, o, OT, op, anchor, ip, mpos, mlen);
#endif
}

"""
ROW = "template <class Tab>\nLZ4T_HD void lz4t_encode_deep_row("


def _headers_variant(csrc: str, inc: str, variant) -> None:
    """Copy csrc's headers to inc, the parse's emits stamped and the
    rings' #defines set to variant (W, S, E[, PS, PC]) where it is
    given."""
    os.makedirs(inc, exist_ok=True)
    for h in glob.glob(os.path.join(csrc, "*.cuh")):
        shutil.copy(h, inc)
    p = os.path.join(inc, "lz4_encode_deep.cuh")
    with open(p) as f:
        text = f.read()
    head, row = text.split(ROW)
    calls = row.count("lz4t_emit_sequence_lanes(c, o, OT, op,")
    if calls != 2:
        raise RuntimeError(f"lz4_encode_deep.cuh: {calls} emits in the row")
    text = head + EMIT_STAMP + ROW + row.replace(
        "lz4t_emit_sequence_lanes(c, o, OT, op,",
        "lz4t_emit_stamped(c, o, OT, op,")
    for name, value in zip(DEFINES, variant or ()):
        text, k = re.subn(rf"#define {name} \d+\n",
                          f"#define {name} {value}\n", text)
        if k != 1:
            raise RuntimeError(f"lz4_encode_deep.cuh: no unique {name}")
    with open(p, "w") as f:
        f.write(text)


def _ptxas_lines(text: str) -> list[str]:
    """nvcc -Xptxas -v output: one line per kernel, its registers and
    spills."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m2 = re.search(r"Used (\d+) registers", line)
        if m2 and name:
            out.append(f"{name}: {m2.group(1)} registers, {spill}")
            name = None
    return out


def _sass(so: str) -> dict:
    """kernel -> its SASS instructions (cuobjdump -sass), the anonymous
    namespace's hash set aside."""
    from plz4_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-fA-F_]+", "_GLOBAL__N__", text)
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(line.split(";")[0].strip())
    return out


def _sass_diff(build_dir: str, other_dir: str) -> None:
    """Each kernel library's SASS against OTHER's, kernel by kernel."""
    def libs(d):
        out = {}
        for so in glob.glob(os.path.join(d, "lib*-*.so")):
            name = os.path.basename(so).rsplit("-", 1)[0][3:]
            if name != "lz4_host":
                out.setdefault(name, []).append(so)
        return out

    mine, theirs = libs(build_dir), libs(other_dir)
    for name in sorted(mine):
        if len(mine[name]) != 1 or len(theirs.get(name, [])) != 1:
            print(f"  sass {name}: not one library in each tree, skipped")
            continue
        a, b = _sass(mine[name][0]), _sass(theirs[name][0])
        for fn in sorted(set(a) | set(b)):
            if a.get(fn) == b.get(fn):
                print(f"  sass {name} {fn}: identical "
                      f"({len(a[fn])} instructions)")
            else:
                print(f"  sass {name} {fn}: differs "
                      f"({len(a.get(fn, []))} instructions here, "
                      f"{len(b.get(fn, []))} in OTHER)")


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    opts = [a for a in sys.argv[1:] if a.startswith("--")]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(args[0] if args else here)
    variants = [tuple(int(x) for x in v.split(":"))
                for a in opts if a.startswith("--variants=")
                for v in a.split("=", 1)[1].split(",")]
    ptxas = "--ptxas" in opts
    other = [os.path.abspath(a.split("=", 1)[1]) for a in opts
             if a.startswith("--sass=")]
    sys.path.insert(0, tree)
    sys.path.insert(1, here)
    import numpy as np
    import torch

    import plz4_tpu_torch
    from plz4_tpu_torch.ops import _build, encode, encode_deep

    from benchmark import corpus as bench_corpus

    if not plz4_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {plz4_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        print("encode_deep_stamps_torch: no CUDA GPU visible",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; tree {tree}")
    _build.build_all()
    for o in other:
        print(f"SASS of {_build.BUILD_DIR} against OTHER "
              f"{os.path.join(o, 'plz4_tpu_torch', '_build')}:")
        _sass_diff(_build.BUILD_DIR,
                   os.path.join(o, "plz4_tpu_torch", "_build"))
    with open(os.path.join(_build.CSRC, "lz4_encode_deep.cuh")) as f:
        text = f.read()
    has_pipe = "#define LZ4T_DEEP_PIPE_SLOTS" in text
    has_split = "#define LZ4T_DEEP_PEER_SLOTS" in text
    builds = [("table", None)]
    if has_pipe:
        builds += [("pipe", v) for v in variants or [None]]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "encode_deep_stamps.cu")
    with open(src, "w") as f:
        f.write(SRC)
    flags = [*_build.NVCC_FLAGS] + (["-Xptxas", "-v"] if ptxas else [])
    jobs = []
    for i, (kind, v) in enumerate(builds):
        inc = os.path.join(_build.BUILD_DIR, f"encode_deep_stamps_{i}_inc")
        _headers_variant(_build.CSRC, inc, v)
        so = os.path.join(_build.BUILD_DIR, f"libencode_deep_stamps_{i}.so")
        jobs.append((so, subprocess.Popen(
            [_build.nvcc(), *flags, "-I", inc, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    if ptxas:
        kept = subprocess.run(
            [_build.nvcc(), *flags, "-o",
             os.path.join(_build.BUILD_DIR, "libencode_deep_ptxas.so"),
             os.path.join(_build.CSRC, "lz4_encode_deep.cu")],
            capture_output=True, text=True)
        for line in _ptxas_lines(kept.stdout + kept.stderr):
            print(f"  kept: {line}")
    libs = []
    for (so, proc), (kind, v) in zip(jobs, builds):
        text, _ = proc.communicate()
        if proc.returncode:
            print(text, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {so}")
        if ptxas:
            for line in _ptxas_lines(text):
                if kind in line:
                    print(f"  {kind} {v or 'kept'}: {line}")
        lib = ctypes.CDLL(so)
        lib.stamp_launch.restype = ctypes.c_int
        lib.stamp_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                                     + [ctypes.c_int] * 4)
        lib.stamp_threads.restype = ctypes.c_int
        libs.append(lib)

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
    N, R = 65536, 128
    base = bench_corpus.silesia_bulk(R * N)
    d = torch.from_numpy(np.frombuffer(base[:R * N], np.uint8).reshape(
        R, N).copy()).to(dev)
    lens = torch.full((R,), N, dtype=torch.int32, device=dev)
    CAP = encode.out_width(N)
    for tries in (2, 32):
        kept = encode_deep.encode_batch_deep(d, lens, tries)
        kept_ms = events_ms(lambda: encode_deep.encode_batch_deep(
            d, lens, tries), 5)
        print(f"tries {tries}: kept K4 {kept_ms:.3f} ms per launch of {R} "
              f"rows; output {int(kept[1].sum())} bytes")
        for lib, (kind, v) in zip(libs, builds):
            out = torch.empty((R, CAP), dtype=torch.uint8, device=dev)
            tot = torch.empty((R,), dtype=torch.int32, device=dev)
            okv = torch.empty((R,), dtype=torch.bool, device=dev)
            delta = torch.empty((R, N + 8), dtype=torch.int16, device=dev)
            tab = torch.empty((R, N) if kind == "table" else (1,),
                              dtype=torch.int32, device=dev)
            stats = torch.zeros((R, 15), dtype=torch.int64, device=dev)
            span = torch.zeros((R, 2), dtype=torch.int64, device=dev)

            def run():
                rc = lib.stamp_launch(
                    int(kind == "pipe"), d.data_ptr(), lens.data_ptr(),
                    out.data_ptr(), tot.data_ptr(), okv.data_ptr(),
                    delta.data_ptr(), tab.data_ptr(), stats.data_ptr(),
                    span.data_ptr(), R, N, CAP, tries)
                if rc:
                    raise RuntimeError(f"stamp_launch: cudaError {rc}")

            ms = events_ms(run, 3)
            same = (torch.equal(tot, kept[1]) and torch.equal(okv, kept[2])
                    and all(torch.equal(out[i, :tot[i]], kept[0][i, :tot[i]])
                            for i in range(R)))
            if not same:
                print(f"the stamped {kind} kernel differs from K4",
                      file=sys.stderr)
                return 1
            st = stats.cpu().numpy().astype(np.float64) / 1e3
            sp = span.cpu().numpy()
            launch_us = (sp[:, 1].max() - sp[:, 0].min()) / 1e3
            blk = np.sort(st[:, 9])
            name = (f"table kernel (256 threads)" if kind == "table" else
                    f"pipelined kernel {v or 'kept'} "
                    f"({lib.stamp_threads()} threads)")

            def mm(j):
                return f"{st[:, j].mean():.0f}/{st[:, j].max():.0f}"

            line = (f"  {name}: {ms:.3f} ms; K cycles per row mean/max: "
                    f"staging {mm(0)}, build {mm(1)}, ring load {mm(2)}, ")
            if kind == "table":
                line += f"table {mm(3)}, parse {mm(4)}"
            else:
                if has_split:
                    w = lib.stamp_threads() // 32 - 1
                    steps = -(-(N - 11) // 32)
                    line += (f"build waiting for peer chunks {mm(10)}, "
                             f"peer warps busy {st[:, 11].mean() / w:.0f}, "
                             f"waiting for empty peer slots "
                             f"{st[:, 12].mean() / w:.0f} (per warp, mean), "
                             f"steps with a lower peer "
                             f"{100 * st[:, 13].mean() * 1e3 / steps:.1f}%, ")
                w = lib.stamp_threads() // 32 - 1
                line += (f"parse {mm(4)} (waiting for full slots {mm(5)}), "
                         f"table warps busy {st[:, 6].mean() / w:.0f}, "
                         f"waiting for empty slots "
                         f"{st[:, 7].mean() / w:.0f} (per warp, mean), last "
                         f"table warp done at {mm(8)}")
            print(line + f"; the parse's emits {mm(14)}")
            print(f"    row times (K cycles) min {blk[0]:.0f}, median "
                  f"{blk[R // 2]:.0f}, max {blk[-1]:.0f}; launch span "
                  f"{launch_us:.0f} us on the global timer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
