#!/usr/bin/env python3
"""Where the port's main path spends its time, on one CUDA GPU.

Runs plz4_tpu_torch.compress / decompress (backend="device", level 1 or
--level, 64 KiB blocks, or the default 4 MiB with --block 4M) over a
silesia-like payload three ways: untraced (wall time), under torch.profiler
(device time by kernel and copy, and the device's busy share of the wall
time), and under cProfile (host time by Python function).

    python3 tools/profile_torch_main_path.py [--mib 64] [--seed 2003]
        [--block 64K|256K|1M|4M] [--level 1-12]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--seed", type=int, default=2003)
    ap.add_argument("--block", choices=["64K", "256K", "1M", "4M"],
                    default="64K")
    ap.add_argument("--level", type=int, default=1, choices=range(1, 13))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    import plz4_tpu_torch as plz4
    from plz4_tpu_torch import corpus

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    data = corpus.silesia_like(args.mib << 20, seed=args.seed)
    idx = {"64K": plz4.BLOCK_IDX_64KB, "256K": plz4.BLOCK_IDX_256KB,
           "1M": plz4.BLOCK_IDX_1MB, "4M": plz4.BLOCK_IDX_4MB}[args.block]
    opts = dict(backend="device", level=args.level, block_size_idx=idx)

    def enc():
        return plz4.compress(data, **opts)

    def dec(frame):
        out = plz4.decompress(frame, backend="device")
        torch.cuda.synchronize()
        return out

    frame = enc()  # warm-up: kernel build and load, pinned pools
    assert dec(frame) == data
    for name, fn in (("compress", enc), ("decompress", lambda: dec(frame))):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[1]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            traced = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.self_device_time_total > 0]
        busy_us = sum(e.self_device_time_total for e in events)
        print(f"\n== {name}, {args.block} blocks, level {args.level} "
              f"[{card}]: "
              f"{len(data) / 1e9 / wall:.3f} GB/s "
              f"untraced (median of 3, {wall * 1e3:.1f} ms); traced "
              f"{traced * 1e3:.1f} ms; device busy {busy_us / 1e3:.1f} ms "
              f"= {busy_us / 1e4 / traced:.1f}% of the traced wall time")
        for e in sorted(events, key=lambda e: -e.self_device_time_total):
            print(f"  device {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x  {e.key[:70]}")
        pr = cProfile.Profile()
        pr.runcall(fn)
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(12)
        print("  host, by self time (cProfile):")
        print("\n".join("  " + ln for ln in s.getvalue().splitlines()
                        if ln.strip()[:1].isdigit() or "ncalls" in ln))
    return 0


if __name__ == "__main__":
    sys.exit(main())
