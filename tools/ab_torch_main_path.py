#!/usr/bin/env python3
"""End-to-end A/B of two checkouts of the port on one CUDA GPU: level-1
compress and decompress GB/s through plz4_tpu_torch.compress/decompress
(backend="device") at 64 KiB and 4 MiB blocks, over 128 MiB (32 MiB of
corpus.silesia_like tiled four times), each the median of 5 after a warm-up.
Runs --pairs pairs of processes, one per side, alternating which side runs
first, and prints each run and, per metric, both sides' medians and
quartiles and how many pairs the change won.

    python3 tools/ab_torch_main_path.py build/parent build/change [--pairs 10]

Each side is the root of a checkout (e.g. unpacked from git archive); its
package is imported from there.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys
import time

METRICS = ["64K enc", "64K dec", "4M enc", "4M dec"]


def side(root: str) -> str:
    """One side's run in this process: the four GB/s as one line."""
    sys.path.insert(0, os.path.abspath(root))
    import plz4_tpu_torch as plz4
    from plz4_tpu_torch import corpus

    data = corpus.silesia_like(32 << 20) * 4
    out = []
    for name, idx in (("64K", plz4.BLOCK_IDX_64KB),
                      ("4M", plz4.BLOCK_IDX_4MB)):
        o = dict(backend="device", level=1, block_size_idx=idx)
        warm = data[: 16 << 20]
        assert plz4.decompress(plz4.compress(warm, **o),
                               backend="device") == warm
        te, td = [], []
        for _ in range(5):
            t = time.perf_counter()
            f = plz4.compress(data, **o)
            te.append(time.perf_counter() - t)
            t = time.perf_counter()
            back = plz4.decompress(f, backend="device")
            td.append(time.perf_counter() - t)
            assert back == data
        gb = len(data) / 1e9
        out.append(f"{name} enc {gb / statistics.median(te):.3f} "
                   f"dec {gb / statistics.median(td):.3f}")
    return " | ".join(out)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--side":
        print("E2E", side(sys.argv[2]), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for label in order:
            root = getattr(args, label)
            line = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side", root],
                capture_output=True, text=True, check=True).stdout
            line = [x for x in line.splitlines() if x.startswith("E2E")][0]
            print(f"pair {i + 1} {label}: {line[4:]}", flush=True)
            runs[label].append([float(v) for v in re.findall(
                r"(?:enc|dec) ([0-9.]+)", line)])
    for k, name in enumerate(METRICS):
        p = [r[k] for r in runs["parent"]]
        c = [r[k] for r in runs["change"]]
        qp, qc = statistics.quantiles(p, n=4), statistics.quantiles(c, n=4)
        wins = sum(b > a for a, b in zip(p, c))
        print(f"{name} GB/s [{card}]: parent median {statistics.median(p):.3f}"
              f" (quartiles {qp[0]:.3f}-{qp[2]:.3f}), change median "
              f"{statistics.median(c):.3f} (quartiles {qc[0]:.3f}-"
              f"{qc[2]:.3f}); the change won {wins} of {len(p)} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
