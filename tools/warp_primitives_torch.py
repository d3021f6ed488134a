#!/usr/bin/env python3
"""Latency of the warp primitives the encode kernels' parse steps chain, on
one CUDA GPU: cycles per step of a dependent chain of __match_any_sync (2
and 32 distinct keys), of a byte-table write, __syncwarp, read and
__ballot_sync, of __shfl_sync, of a shared-memory load and of
__ballot_sync, measured with clock64 by one warp.

    python3 tools/warp_primitives_torch.py

Builds its kernel with nvcc into plz4_tpu_torch/_build/.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SRC = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void chains(unsigned* out, unsigned long long* cyc, int iters,
                       int distinct) {
  __shared__ unsigned char own[1 << 14];
  const unsigned lane = threadIdx.x & 31;
  unsigned key = distinct ? lane * 2654435761u : (lane & 1), acc = 0;
  long long t[6];
  t[0] = clock64();
  for (int i = 0; i < iters; i++) {
    const unsigned m = __match_any_sync(0xffffffffu, key);
    key = (key + (m & 1)) * 2654435761u >> 18;
    acc += m;
  }
  t[1] = clock64();
  for (int i = 0; i < iters; i++) {
    const unsigned h = key & ((1 << 14) - 1);
    own[h] = lane;
    __syncwarp();
    const unsigned r = own[h];
    const unsigned b = __ballot_sync(0xffffffffu, r != lane);
    key = (key + (b & 1) + r) * 2654435761u >> 18;
    acc += b;
  }
  t[2] = clock64();
  for (int i = 0; i < iters; i++) {
    const unsigned v = __shfl_sync(0xffffffffu, key, (key >> 3) & 31);
    key = (v + 1) * 2654435761u >> 18;
    acc += v;
  }
  t[3] = clock64();
  for (int i = 0; i < iters; i++) {
    const unsigned v = own[key & ((1 << 14) - 1)];
    key = (key + v + 1) * 2654435761u >> 18;
    acc += v;
  }
  t[4] = clock64();
  for (int i = 0; i < iters; i++) {
    const unsigned b = __ballot_sync(0xffffffffu, (key >> lane) & 1);
    key = (key + b + 1) * 2654435761u >> 18;
    acc += b;
  }
  t[5] = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0)
    for (int k = 0; k < 5; k++) cyc[k] = t[k + 1] - t[k];
}
int main() {
  const int iters = 1000;
  unsigned* out;
  unsigned long long* cyc;
  unsigned long long h[5];
  if (cudaMalloc(&out, 32 * 4) || cudaMalloc(&cyc, 5 * 8)) return 1;
  for (int d = 0; d < 2; d++) {
    for (int rep = 0; rep < 2; rep++)  // the first run warms up
      chains<<<1, 32>>>(out, cyc, iters, d);
    if (cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost)) return 1;
    printf("%s keys: cycles per step: match_any %.1f, byte table + "
           "syncwarp + ballot %.1f, shfl %.1f, shared load %.1f, "
           "ballot %.1f\n", d ? "32 distinct" : "2 distinct",
           h[0] / (double)iters, h[1] / (double)iters, h[2] / (double)iters,
           h[3] / (double)iters, h[4] / (double)iters);
  }
  return 0;
}
"""


def main() -> int:
    from plz4_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "warp_primitives_torch.cu")
    exe = src[:-3]
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build.nvcc(), "-O3", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-o", exe, src],
                   check=True)
    print(card)
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
