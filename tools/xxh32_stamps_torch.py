#!/usr/bin/env python3
"""Where K7's time goes, on one CUDA GPU: clock stamps in an instrumented
copy of its kernel (csrc/xxh32.cu), built from the kept header xxh32.cuh,
and probe kernels of its fold, over the main path's batch: 128 rows of
64 KiB of corpus.silesia_like (the raw rows the Writer hashes), and the
same rows at the compressed rows' width CAP = 65,860 (row starts 4 bytes
off a 16-byte boundary).

Prints:
  * K7's ms per 128-row launch (CUDA events) at both widths;
  * the stamped copy, summed over the rows: the block's cycles a row, the
    fold thread's cycles per stripe in lz4t_xxh32_stripes, its waits at
    the chunk barriers (the staging warps' lag), and the first chunk's
    staging; its hashes are checked against the kept kernel's;
  * the fold step's cycles by probe kernels, one thread on one SM: the
    kept fold over a staged chunk in shared memory, the four chains alone
    (stripe words from registers), and one chain alone;
  * the SM clock, measured as clock64 cycles over CUDA-event time;
  * copies of K7 whose fold loop is unrolled 4, 8, 16, 32 (the kept
    kernel's) and 64 times, each timed over the raw rows;
  * K7's chain bound: stripes per row x the cycles of one accumulator's
    step / the SM clock, which no design can beat (each accumulator takes
    every stripe in turn and the fold does not associate), beside its
    byte bound.

    python3 tools/xxh32_stamps_torch.py

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
#include "xxh32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunkWords = LZ4T_XXH_CHUNK / 4;

// stats per row: block cycles, fold cycles, fold thread's barrier waits,
// first chunk's staging cycles
constexpr int kStats = 4;

// K7 (xxh32.cu) with clock stamps in the fold thread
__global__ void __launch_bounds__(kThreads)
    stamped(const uint8_t* __restrict__ data, const int32_t* __restrict__ lens,
            int64_t* __restrict__ out, long long* __restrict__ stats, int W,
            uint32_t seed) {
  __shared__ __align__(16) uint32_t ring[2][kChunkWords];
  const long long t_start = clock64();
  const int r = blockIdx.x, t = threadIdx.x;
  const uint8_t* p = data + (size_t)r * W;
  const int len = lens[r];
  const int nc = (len + LZ4T_XXH_CHUNK - 1) / LZ4T_XXH_CHUNK;
  if (nc) lz4t_xxh32_stage(p, len, 0, min(len, LZ4T_XXH_CHUNK), ring[0], t,
                           kThreads);
  __syncthreads();
  const long long t_first = clock64();
  long long fold = 0, wait = 0;
  uint32_t acc[4];
  lz4t_xxh32_init(acc, seed);
  for (int c = 0; c < nc; c++) {
    const int b0 = c * LZ4T_XXH_CHUNK;
    long long b = 0;
    if (t >= 32) {
      const int b1 = b0 + LZ4T_XXH_CHUNK;
      if (b1 < len)
        lz4t_xxh32_stage(p, len, b1, min(len, b1 + LZ4T_XXH_CHUNK),
                         ring[(c + 1) & 1], t - 32, kThreads - 32);
    } else if (t == 0) {
      const long long a = clock64();
      lz4t_xxh32_stripes(acc, ring[c & 1],
                         (min(len, b0 + LZ4T_XXH_CHUNK) - b0) >> 4);
      // the fold's last result, so that the stamp follows it
      asm volatile("" ::"r"(acc[0]), "r"(acc[1]), "r"(acc[2]), "r"(acc[3]));
      b = clock64();
      fold += b - a;
    }
    __syncthreads();
    if (t == 0) wait += clock64() - b;
  }
  if (t == 0) {
    const int b0 = nc ? (nc - 1) * LZ4T_XXH_CHUNK : 0;
    const uint8_t* last =
        reinterpret_cast<const uint8_t*>(ring[nc ? (nc - 1) & 1 : 0]);
    out[r] = lz4t_xxh32_finish(acc, last + (len / 16 * 16 - b0), len, seed);
    long long* st = stats + (size_t)r * kStats;
    st[0] = clock64() - t_start;
    st[1] = fold;
    st[2] = wait;
    st[3] = t_first - t_start;
  }
}

// The fold alone, one thread: mode 0 the kept fold over a chunk staged in
// shared memory, ns stripes; mode 1 the four chains on stripe words held
// in registers; mode 2 one chain alone, whose step is the least time any
// design can spend on a stripe (each accumulator takes every stripe in
// turn).
__global__ void fold_probe(const uint32_t* __restrict__ words, int ns,
                           int mode, long long* __restrict__ cyc,
                           uint32_t* __restrict__ sink) {
  __shared__ __align__(16) uint32_t buf[kChunkWords];
  for (int i = threadIdx.x; i < kChunkWords; i += blockDim.x)
    buf[i] = words[i];
  __syncthreads();
  if (threadIdx.x) return;
  uint32_t acc[4];
  lz4t_xxh32_init(acc, 0);
  const uint32_t x0 = buf[0], x1 = buf[1], x2 = buf[2], x3 = buf[3];
  const long long t0 = clock64();
  if (mode == 0) {
    for (int left = ns; left > 0; left -= LZ4T_XXH_CHUNK / 16)
      lz4t_xxh32_stripes(acc, buf, min(left, LZ4T_XXH_CHUNK / 16));
  } else if (mode == 1) {
#pragma unroll 32
    for (int s = 0; s < ns; s++) {
      acc[0] = lz4t_xxh32_round(acc[0], x0);
      acc[1] = lz4t_xxh32_round(acc[1], x1);
      acc[2] = lz4t_xxh32_round(acc[2], x2);
      acc[3] = lz4t_xxh32_round(acc[3], x3);
    }
  } else {
#pragma unroll 32
    for (int s = 0; s < ns; s++) acc[0] = lz4t_xxh32_round(acc[0], x0);
  }
  asm volatile("" ::"r"(acc[0]), "r"(acc[1]), "r"(acc[2]), "r"(acc[3]));
  cyc[0] = clock64() - t0;
  sink[0] = acc[0] ^ acc[1] ^ acc[2] ^ acc[3];
}

// spins for n cycles of the SM clock
__global__ void spin(long long n, long long* out) {
  const long long t0 = clock64();
  long long t = t0;
  while (t - t0 < n) t = clock64();
  out[0] = t - t0;
}

}  // namespace

extern "C" int stamp_launch(const void* data, const void* lens, void* out,
                            void* stats, int B, int W, int seed) {
  stamped<<<B, kThreads>>>((const uint8_t*)data, (const int32_t*)lens,
                           (int64_t*)out, (long long*)stats, W,
                           (uint32_t)seed);
  return (int)cudaGetLastError();
}

extern "C" int probe_fold(const void* words, void* cyc, void* sink, int ns,
                          int mode) {
  fold_probe<<<1, 128>>>((const uint32_t*)words, ns, mode, (long long*)cyc,
                         (uint32_t*)sink);
  return (int)cudaGetLastError();
}

extern "C" int probe_spin(void* out, long long n) {
  spin<<<1, 1>>>(n, (long long*)out);
  return (int)cudaGetLastError();
}
"""


def _checked(rc):
    if rc:
        raise RuntimeError(f"launch failed: cudaError {rc}")


def _events_ms(fn, reps=50):
    import torch

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


def load() -> ctypes.CDLL:
    """The probes' library, built with nvcc from SRC and the kept header."""
    from plz4_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "xxh32_stamps_torch.cu")
    so = os.path.join(_build.BUILD_DIR, "libxxh32_stamps_torch.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    for fn in (lib.stamp_launch, lib.probe_fold, lib.probe_spin):
        fn.restype = ctypes.c_int
    lib.stamp_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.probe_fold.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.probe_spin.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib


def sm_clock_mhz(lib) -> float:
    """The SM clock: clock64 cycles of a spin over its CUDA-event time."""
    import torch

    spun = torch.zeros(1, dtype=torch.int64, device="cuda")
    ms = _events_ms(lambda: _checked(lib.probe_spin(spun.data_ptr(),
                                                    400_000_000)), reps=3)
    return int(spun.item()) / ms / 1e3


def fold_cycles(lib, stripes: int, mode: int) -> float:
    """Cycles per stripe of a fold probe over `stripes` stripes: mode 0 the
    kept fold from shared memory, 1 the four chains alone, 2 one chain."""
    import numpy as np
    import torch

    words = torch.from_numpy((np.arange(1024, dtype=np.uint64) * 2654435761
                              % (1 << 32)).astype(np.uint32).view(np.int32)
                             ).cuda()
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    for _ in range(2):  # the first run warms the instruction cache
        _checked(lib.probe_fold(words.data_ptr(), cyc.data_ptr(),
                                sink.data_ptr(), stripes, mode))
        torch.cuda.synchronize()
    return int(cyc.item()) / stripes


def chain_bound_ms(lib, stripes: int) -> tuple[float, float, float]:
    """K7's chain bound for rows of `stripes` stripes: (ms, the cycles of
    one accumulator's step, SM clock MHz). Each accumulator takes every
    stripe of the row in turn, so no design spends less than a step per
    stripe; rows run side by side, one per SM."""
    per = fold_cycles(lib, stripes, 2)
    mhz = sm_clock_mhz(lib)
    return stripes * per / (mhz * 1e3), per, mhz


def unroll_variants_ms(rows, lens, counts=(4, 8, 16, 32, 64)):
    """ms per launch of copies of K7 whose fold loop (lz4t_xxh32_stripes)
    is unrolled each of counts times, over rows (B, W) and lens on the
    card; each copy's hashes are checked against the kept kernel's."""
    import torch

    from plz4_tpu_torch.ops import _build, xxh32

    with open(os.path.join(_build.CSRC, "xxh32.cuh")) as f:
        header = f.read()
    kept = "#pragma unroll 32\n  for (int s = 0; s < ns; s++) {"
    if header.count(kept) != 1:
        raise RuntimeError("xxh32.cuh: the fold's unroll pragma moved")
    want = xxh32.xxh32_batch(rows, lens)
    out = torch.empty_like(want)
    res = {}
    for n in counts:
        d = os.path.join(_build.BUILD_DIR, "xxh32_unroll", str(n))
        os.makedirs(d, exist_ok=True)
        for name in ("xxh32.cu", "lz4_common.cuh"):
            with open(os.path.join(_build.CSRC, name)) as f, \
                    open(os.path.join(d, name), "w") as g:
                g.write(f.read())
        with open(os.path.join(d, "xxh32.cuh"), "w") as g:
            g.write(header.replace(kept, kept.replace("32", str(n), 1)))
        so = os.path.join(d, "libxxh32.so")
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(d, "xxh32.cu")], check=True)
        lib = ctypes.CDLL(so)
        lib.lz4t_launch.restype = ctypes.c_int
        lib.lz4t_launch.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        stream = torch.cuda.current_stream().cuda_stream
        B, W = rows.shape

        def run():
            _checked(lib.lz4t_launch(rows.data_ptr(), lens.data_ptr(),
                                     out.data_ptr(), B, W, 0, stream))

        res[n] = _events_ms(run)
        if not torch.equal(out, want):
            raise RuntimeError(f"the copy unrolled {n} times differs")
    return res


def main() -> int:
    import numpy as np
    import torch

    from plz4_tpu_torch import corpus, native
    from plz4_tpu_torch.ops import encode, xxh32

    if not torch.cuda.is_available():
        print("xxh32_stamps_torch: no CUDA GPU visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = load()
    print(card)
    checked, events_ms = _checked, _events_ms
    dev = torch.device("cuda", 0)
    mhz = sm_clock_mhz(lib)
    print(f"SM clock: {mhz:.0f} MHz")

    N, B = 65536, 128
    data = corpus.silesia_like(32 << 20)
    blocks = [data[i * N:(i + 1) * N] for i in range(B)]
    want = [native.xxh32(b) for b in blocks]
    stripes = N // 16
    for W in (N, encode.out_width(N)):
        rows = np.zeros((B, W), np.uint8)
        for i, b in enumerate(blocks):
            rows[i, :N] = np.frombuffer(b, np.uint8)
        rd = torch.from_numpy(rows).to(dev)
        ld = torch.full((B,), N, dtype=torch.int32, device=dev)
        kept = xxh32.xxh32_batch(rd, ld)
        if kept.cpu().tolist() != want:
            print("K7 differs from native.xxh32", file=sys.stderr)
            return 1
        ms = events_ms(lambda: xxh32.xxh32_batch(rd, ld))
        out = torch.empty((B,), dtype=torch.int64, device=dev)
        stats = torch.zeros((B, 4), dtype=torch.int64, device=dev)
        st_ms = events_ms(lambda: checked(lib.stamp_launch(
            rd.data_ptr(), ld.data_ptr(), out.data_ptr(), stats.data_ptr(),
            B, W, 0)))
        if not torch.equal(out, kept):
            print("the stamped copy differs from K7", file=sys.stderr)
            return 1
        st = stats.cpu().numpy().astype(np.float64)
        print(f"K7 at width {W} (row starts {rd.data_ptr() % 16}, "
              f"{W % 16} mod 16): {ms:.4f} ms per {B}-row launch of 64 KiB; "
              f"stamped copy {st_ms:.4f} ms: block {st[:, 0].mean():.0f} "
              f"cycles a row (max {st[:, 0].max():.0f}), fold "
              f"{st[:, 1].sum() / (B * stripes):.2f} cycles per stripe, "
              f"barrier waits {st[:, 2].mean():.0f} and first chunk "
              f"{st[:, 3].mean():.0f} cycles a row")
    per = {}
    for mode, what in ((0, "the kept fold from shared memory"),
                       (1, "the four chains alone"),
                       (2, "one chain alone")):
        per[mode] = fold_cycles(lib, stripes, mode)
        print(f"fold probe, {what}: {per[mode]:.2f} cycles per stripe "
              f"({stripes} stripes)")
    rows = torch.from_numpy(np.frombuffer(data[:B * N], np.uint8).reshape(
        B, N).copy()).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    print("K7 with its fold unrolled n times, ms per launch: " + ", ".join(
        f"{n}: {v:.4f}" for n, v in unroll_variants_ms(rows, lens).items()))
    chain_ms = stripes * per[2] / (mhz * 1e3)
    byte_ms = (B * N + 4 * B + 8 * B) / 3.35e12 * 1e3
    print(f"K7 bound per {B} x 64 KiB [{card}]: chain {chain_ms:.4f} ms "
          f"({stripes} stripes x {per[2]:.2f} cycles / {mhz:.0f} MHz), "
          f"bytes {byte_ms:.4f} ms; the four chains in one thread "
          f"{stripes * per[1] / (mhz * 1e3):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
