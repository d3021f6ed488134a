#!/usr/bin/env python3
"""Kernel times of one tree of the port on one CUDA GPU, for comparing a
parent and a change in turns inside one chip call.

    python3 tools/kernel_times_torch.py [TREE]

imports plz4_tpu_torch from TREE (default: this checkout; e.g. a parent
unpacked with `git archive <commit> | tar -x -C build/parent`), builds its
kernels, and prints one line: ms per launch by CUDA events of K7 over the
main path's 128 rows of 64 KiB (raw rows, and the same rows at the
compressed rows' width CAP), K2a over those rows, K2b over them as 128
chunk rows of 64 large blocks, K2c and K2d over them, and K6b greedy and
depth 2 over 64 rows of 4 MiB (chip_smoke.py's 256 MiB), with the peak
device memory of the K6b launch. The data: corpus.silesia_like (seed 2003)
tiled, as chip_smoke.py makes it.
"""

from __future__ import annotations

import os
import subprocess
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import plz4_tpu_torch
    from plz4_tpu_torch import corpus
    from plz4_tpu_torch.ops import (_build, encode, encode_mid, encode_wide,
                                    xxh32)

    if not plz4_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {plz4_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        print("kernel_times_torch: no CUDA GPU visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()

    def ms(fn, reps):
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
    N, B = 65536, 128
    data = corpus.silesia_like(32 << 20) * 8
    rows = torch.from_numpy(np.frombuffer(data[:B * N], np.uint8).reshape(
        B, N).copy()).to(dev)
    lens = torch.full((B,), N, dtype=torch.int32, device=dev)
    cap_rows = torch.zeros((B, encode.out_width(N)), dtype=torch.uint8,
                           device=dev)
    cap_rows[:, :N] = rows
    wins = torch.zeros((B // 2, N), dtype=torch.uint8, device=dev)
    wlens = torch.zeros((B,), dtype=torch.int32, device=dev)
    res = {
        "K7": ms(lambda: xxh32.xxh32_batch(rows, lens), 50),
        "K7 at CAP width": ms(lambda: xxh32.xxh32_batch(cap_rows, lens), 50),
        "K2a": ms(lambda: encode.encode_batch(rows, lens), 20),
        "K2b chunk rows": ms(lambda: encode.encode_batch_window(
            rows, lens, wins, wlens, wstride=2, chunks=2), 20),
        "K2c": ms(lambda: encode_mid.encode_batch_mid(rows, lens), 10),
        "K2d": ms(lambda: encode_mid.encode_batch_mid(rows, lens, True), 10),
    }
    big = 4 << 20
    wide = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(
        -1, big).copy()).to(dev)
    wide_lens = torch.full((wide.shape[0],), big, dtype=torch.int32,
                           device=dev)
    for mid, name in ((False, "K6b greedy"), (True, "K6b depth 2")):
        torch.cuda.reset_peak_memory_stats()
        res[name] = ms(lambda: encode_wide.encode_batch_wide(
            wide, wide_lens, mid=mid), 2)
        res[f"{name} peak MiB"] = torch.cuda.max_memory_allocated() / 2**20
    print(f"[{card}] {tree}: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
