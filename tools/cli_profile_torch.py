#!/usr/bin/env python3
"""Where the time of `python -m plz4_tpu_torch --backend device` goes, on
one CUDA GPU.

Writes --mib MiB of chip_smoke.py's bench corpus to a file under build/,
then runs the CLI's compress and decompress on it in fresh processes:
once plain (the wall and the CLI's own in/out/time line) and once under
cProfile (the top functions by cumulative and by own time). Then the same
frame codec in one process through plz4_tpu_torch.compress /
decompress, the first call (cold: CUDA context, kernel libraries, pinned
pools) and a second (warm), and through Writer.read_from / Reader.write_to
on the file, as the CLI drives them.

    python3 tools/cli_profile_torch.py [--mib 256] [--bs 64KB] [--top 25]
"""

from __future__ import annotations

import argparse
import io
import os
import pstats
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(argv, prof=None):
    cmd = [sys.executable]
    if prof:
        cmd += ["-m", "cProfile", "-o", prof]
    cmd += ["-m", "plz4_tpu_torch", *argv]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise SystemExit(f"{' '.join(argv)} failed:\n{p.stderr[-3000:]}")
    return wall, (p.stdout + p.stderr).strip().splitlines()[-1:]


def top(prof: str, n: int) -> str:
    out = io.StringIO()
    st = pstats.Stats(prof, stream=out)
    st.sort_stats("cumulative").print_stats(n)
    st.sort_stats("tottime").print_stats(n)
    return out.getvalue()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--bs", default=None, help="block size flag, e.g. 64KB")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("cli_profile_torch: no CUDA GPU visible", file=sys.stderr)
        return 1
    import chip_smoke
    import plz4_tpu_torch as plz4
    from plz4_tpu_torch import cli
    from plz4_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build_all()  # the subprocesses load these libraries
    data32 = chip_smoke.bench_corpus(32 << 20)
    data = (data32 * (args.mib // 32 + 1))[: args.mib << 20]
    work = os.path.join(ROOT, "build", "cli_profile")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        src = os.path.join(work, "data.bin")
        with open(src, "wb") as f:
            f.write(data)
        frame, back = src + ".lz4", src + ".out"
        flags = ["--bs", args.bs] if args.bs else []
        gb = len(data) / 1e9
        for what, argv in (
                ("compress", ["--backend", "device", "compress", src, "-o",
                              frame, "-f", *flags]),
                ("decompress", ["--backend", "device", "decompress", frame,
                                "-o", back, "-f"])):
            wall, line = run(argv)
            print(f"{what} [{smi}]: subprocess wall {wall:.2f} s "
                  f"({gb / wall:.3f} GB/s with start-up); {line}")
            prof = os.path.join(work, f"cli_{what}.prof")
            wall_p, line = run(argv, prof)
            print(f"{what} under cProfile: wall {wall_p:.2f} s; {line}")
            print(top(prof, args.top))
        with open(back, "rb") as f:
            if f.read() != data:
                raise SystemExit("CLI round trip mismatch")

        # the same codec in this process: cold, then warm
        kw = dict(backend="device")
        if args.bs:
            kw["block_size_idx"] = cli._parse_block_size(args.bs)
        for turn in ("cold", "warm"):
            t0 = time.perf_counter()
            comp = plz4.compress(data, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if plz4.decompress(comp, **kw) != data:
                raise SystemExit("in-process round trip mismatch")
            t2 = time.perf_counter()
            print(f"in-process {turn} [{smi}]: compress {t1 - t0:.3f} s "
                  f"({gb / (t1 - t0):.3f} GB/s), decompress {t2 - t1:.3f} s "
                  f"({gb / (t2 - t1):.3f} GB/s)")
        with open(src, "rb") as f, open(frame, "wb") as g:
            t0 = time.perf_counter()
            w = plz4.Writer(g, **kw)
            w.read_from(f)
            w.close()
        t1 = time.perf_counter()
        with open(frame, "rb") as f, open(back, "wb") as g:
            r = plz4.Reader(f, **kw)
            r.write_to(g)
            r.close()
        t2 = time.perf_counter()
        print(f"in-process, Writer.read_from / Reader.write_to on the files "
              f"[{smi}]: compress {t1 - t0:.3f} s, decompress "
              f"{t2 - t1:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
