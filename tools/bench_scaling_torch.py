#!/usr/bin/env python3
"""Scaling of the port's block-parallel codec over block meshes of 1, 2 and
4 entries on the visible GPUs (entries repeat the GPUs where there are
fewer, each with its own stream), at two layers:

  * raw kernel: K2a over each entry's slice of the rows, every slice
    launched on its entry's stream, timed with CUDA events from before the
    first launch to after the last;
  * batch layer: parallel/batch.encode_blocks_begin(...).result() (and the
    decode) under the mesh, host staging, copies and compaction included,
    wall clock.

Efficiency is GB/s over (the 1-entry GB/s x entries): on one GPU, entries
beyond the first can only overlap work, so it says how much the streams
overlap, not how a multi-GPU host scales.

    python3 tools/bench_scaling_torch.py

Env knobs: PLZ4_SCALE_BLOCK (block bytes, default 65536),
PLZ4_SCALE_BLOCKS (blocks per entry, default 64), PLZ4_SCALE_REPS (timed
repetitions, default 3). Needs a CUDA GPU (exits non-zero without one).
Prints one JSON line per (layer, mesh size) to stdout, the card's name and
power limit and a summary to stderr; writes no file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK = int(os.environ.get("PLZ4_SCALE_BLOCK", str(64 * 1024)))
PER_ENTRY_BLOCKS = int(os.environ.get("PLZ4_SCALE_BLOCKS", "64"))
REPS = int(os.environ.get("PLZ4_SCALE_REPS", "3"))


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _payload(n_blocks: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(2, 12)),
                                dtype=np.uint8)) + b" " for _ in range(128)]
    out = bytearray()
    while len(out) < n_blocks * BLOCK:
        out += vocab[int(rng.integers(len(vocab)))]
    return np.frombuffer(bytes(out[: n_blocks * BLOCK]),
                         dtype=np.uint8).reshape(n_blocks, BLOCK)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _log("bench_scaling_torch: no CUDA GPU visible")
        return 1
    from plz4_tpu_torch.ops import _build, encode
    from plz4_tpu_torch.parallel import batch as batch_mod, mesh as mesh_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(smi)
    _build.build_all()
    gpus = mesh_mod.visible_gpus()
    kern_base = batch_base = None
    for n in (1, 2, 4):
        mesh = mesh_mod.make_block_mesh([gpus[i % len(gpus)]
                                         for i in range(n)])
        B = PER_ENTRY_BLOCKS * n
        data_np = _payload(B)
        blocks = [data_np[i].tobytes() for i in range(B)]
        slices = []
        for (lo, hi), e in zip(mesh_mod.shard_bounds(B, mesh), mesh.entries):
            rows = torch.from_numpy(data_np[lo:hi].copy())
            slices.append((e, rows.to(e.device),
                           torch.full((hi - lo,), BLOCK, dtype=torch.int32,
                                      device=e.device)))
        torch.cuda.synchronize()

        def kern():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for e, d, ln in slices:
                e.stream.wait_event(start)
                with torch.cuda.stream(e.stream):
                    encode.encode_batch(d, ln)
                    done = torch.cuda.Event()
                    done.record(e.stream)
                torch.cuda.current_stream().wait_event(done)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3

        kern()  # warm-up
        t_k = min(kern() for _ in range(REPS))

        def wall(fn):
            t0 = time.perf_counter()
            r = fn()
            return r, time.perf_counter() - t0

        enc, _ = wall(lambda: batch_mod.encode_blocks_begin(
            blocks, BLOCK, device=mesh).result())
        t_e = min(wall(lambda: batch_mod.encode_blocks_begin(
            blocks, BLOCK, device=mesh).result())[1] for _ in range(REPS))
        dec, _ = wall(lambda: batch_mod.decode_blocks_begin(
            enc, BLOCK, device=mesh).result())
        if dec != blocks:
            _log("bench_scaling_torch: batch-layer round trip mismatch")
            return 1
        t_d = min(wall(lambda: batch_mod.decode_blocks_begin(
            enc, BLOCK, device=mesh).result())[1] for _ in range(REPS))

        gb = B * BLOCK / 1e9
        kern_gbps, batch_gbps, dec_gbps = gb / t_k, gb / t_e, gb / t_d
        kern_base = kern_base or kern_gbps
        batch_base = batch_base or batch_gbps
        kern_eff = kern_gbps / (kern_base * n)
        batch_eff = batch_gbps / (batch_base * n)
        _log(f"n={n}: kernel {kern_gbps:.4f} GB/s ({kern_eff:.1%}) | batch "
             f"encode {batch_gbps:.4f} GB/s ({batch_eff:.1%}) | batch "
             f"decode {dec_gbps:.4f} GB/s")
        for metric, val, eff in (
                (f"kernel encode GB/s over {n} entries", kern_gbps,
                 kern_eff),
                (f"batch-layer encode GB/s over {n} entries", batch_gbps,
                 batch_eff),
                (f"batch-layer decode GB/s over {n} entries", dec_gbps,
                 None)):
            print(json.dumps({
                "metric": metric, "value": val, "unit": "GB/s",
                "vs_baseline": eff, "gpus": len(gpus), "card": smi,
                "block": BLOCK, "blocks": B}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
