#!/usr/bin/env python3
"""Smoke run of plz4_tpu_torch on one CUDA GPU.

Builds the CUDA kernels from csrc/, holds each kernel against its plain
version at the main path's shapes (K1 and K3 also on
corpus.decode_edge_batches: short offsets, rows that wrap their parse's
ring, clen past the row, streams that pass out_cap), then drives the main
paths with backend="device" and checks that they went through the
kernels:

  * a 256 MiB LZ4 frame of 64 KiB level-1 blocks (K2a, K1);
  * the same 256 MiB at the default 4 MiB blocks (K2b over 64 KiB chunk
    rows, K5 over records); K2a and K2b are also held to their plain
    versions on the rows aimed at their warp steps
    (corpus.greedy_edge_rows) and on a block with a random chunk, wherever
    total < CAP;
  * 32 MiB frames of 64 KiB blocks with a dictionary (K2b, K3) and with
    linked blocks (K2b);
  * the level ladder: the bench-corpus ratio at levels 3, 8 and 9-12, a
    256 MiB frame at level 9 (the deep hash-chain kernel K4) at 64 KiB and
    at 4 MiB blocks, and 32 MiB frames at levels 3 (K2c), 8 (K2d) and 12
    (K4), at level 8 with 4 MiB blocks, linked at level 6 and with a
    dictionary at level 9;
  * the whole-block codec at full width: the 256 MiB as 64 rows of 4 MiB
    through one launch of the packed-word encode kernel K6b (greedy, and
    the depth-2 chain for a level-8 request) and one of the packed-word
    decode kernel K6a, framed as a standard 4 MiB frame; K6b is also held
    to its plain version on the greedy and chain edge rows at the first
    widths it takes (corpus.wide_edge_rows), K6a on the rows aimed at its
    parse hand-over and copies at 128 KiB and 4 MiB
    (corpus.wide_decode_edge_rows), and the phase prints K6b's and
    K7's times beside their bounds (K7's chain bound from a probe of
    tools/xxh32_stamps_torch.py) and its peak device memory;
  * block checksums: a 256 MiB frame of 64 KiB blocks whose checksums are
    hashed on the device by K7 on write and on read, and 32 MiB frames at
    4 MiB blocks and with a dictionary; K7 is also held to its plain
    version and native.xxh32 on rows whose starts fall off 16-byte
    boundaries, at lengths on and beside its 4 KiB staging chunks;
  * sharded frames (phase 19): 256 MiB of the bench corpus at 64 KiB
    blocks and 128 MiB at 4 MiB through compress_sharded /
    decompress_sharded on meshes of 1 and 2 entries over cuda:0, each
    frame equal to the unsharded device frame, walls in turns; 32 MiB with
    a dictionary and block checksums on 2 entries; two ranks over gloo in
    two subprocesses, both on cuda:0, whose frames must equal the
    unsharded frame, with the gather's share of their walls; entry() and
    dryrun_multichip(2) and (4) on cuda;
  * the array path and the CLI (phase 20): the torch tensor programs A1
    and A2 (ops/encode_array.py, ops/decode_array.py) on cuda against
    themselves on the CPU and against digests of the JAX package's array
    encoder, 32 MiB array-path frames (64 KiB blocks at levels 1 and 9,
    4 MiB blocks, a dictionary, block checksums) that launch no encode or
    decode kernel, entry_array(), and `python -m plz4_tpu_torch` in
    subprocesses on a 256 MiB file at the defaults (compress, decompress,
    verify), a 64 MiB file at 64 KiB blocks with block checksums (verify
    in process) and an 8 MiB bakeoff.

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc; exits non-zero without them, and on any
failed check. Prints, last, {"ok": true, "device": {...}}; the line
before it holds the per-kernel measurements as one JSON object.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

BLOCK = 65536
ROWS = 128  # the device writer's batch at 64 KiB blocks
BIG = 4 << 20  # the default block size
CHUNKS = BIG // BLOCK  # 64 KiB chunk rows per 4 MiB block
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate
OPS_PER_BYTE = 16  # generous integer-op count of the serial parse
XXH_OPS_PER_BYTE = 1.5  # xxh32: 6 integer ops per lane per 16-byte stripe
WIDE = 256 << 10  # the packed-word kernels' row width held to plain
# bench-corpus ratio (32 rows of 64 KiB) per device level, computed once
# from the JAX package's Pallas kernels in interpret mode on the CPU
# (encode_batch_pallas_mid / _deep over the same rows); the parse is
# byte-exact, so the kernels must give the same streams
LEVEL_RATIOS = {3: 2.4158, 8: 2.4224, 9: 2.4390, 10: 2.4736, 11: 2.4892,
                12: 2.4917}
# A1 over the same 32 rows per level: the ratio and the first 16 hex digits
# of sha256(out rows, totals as <i4, compressible as u8), computed once from
# the JAX package's array encoder (encode_jax.encode_batch) on the CPU
ARRAY_DIGESTS = {1: (2.3794, "8cd94685710218a9"),
                 3: (2.4018, "c5340da6c6761404"),
                 8: (2.4163, "2fc4608a6a0c8171"),
                 9: (2.4291, "ae4a90ece0dba778")}


def bench_corpus(size: int) -> bytes:
    """The first `size` bytes of bench.py's synthetic-text corpus (seed
    1234): the generator is sequential, so a prefix needs only its own
    words. The word draws come in one call (a Generator's bounded draws
    in bulk are its single draws in order); words are at least 3 bytes."""
    rng = np.random.default_rng(1234)
    vocab = []
    for _ in range(512):
        ln = int(rng.integers(2, 12))
        vocab.append(bytes(rng.integers(97, 123, ln, dtype=np.uint8)) + b" ")
    words = rng.integers(len(vocab), size=size // 3 + 1)
    ends = np.cumsum(np.array([len(w) for w in vocab])[words])
    n = int(np.searchsorted(ends, size)) + 1
    return b"".join([vocab[i] for i in words[:n].tolist()])[:size]


def vocab_text(n: int, seed: int) -> bytes:
    r = np.random.default_rng(seed)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
             b"lazy ", b"dog ", b"lz4 ", b"frame ", b"block ", b"\n"]
    out = bytearray()
    while len(out) < n:
        out += words[int(r.integers(len(words)))]
    return bytes(out[:n])


def edge_payloads() -> list[bytes]:
    rnd = np.random.default_rng(9)
    return [b"", b"a", b"abcabcabcabc", b"abcabcabcabca",
            b"hello world " * 12, b"\x00" * BLOCK, vocab_text(4096, 1),
            vocab_text(BLOCK, 2),
            (rnd.integers(0, 256, 7, dtype=np.uint8).tobytes()
             * (BLOCK // 7 + 1))[:BLOCK],
            rnd.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()]


def corrupt_streams(streams: list[bytes], seed: int = 0x5EED) -> list[bytes]:
    out = [bytes([0x04, 50, 0]), bytes([0x14, 0x41, 200, 0]),
           bytes([0x04, 0, 0]), b"\xff" * 40]
    rng = np.random.default_rng(seed)
    for k in range(24):
        s = bytearray(streams[k % len(streams)])
        kind = k % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 6))):
                s[int(rng.integers(len(s)))] = int(rng.integers(256))
        elif kind == 1:
            s = s[: int(rng.integers(1, len(s)))]
        else:
            s = bytearray(rng.integers(0, 256, int(rng.integers(1, 3000)),
                                       dtype=np.uint8).tobytes())
        out.append(bytes(s))
    return out


def rows_of(payloads: list[bytes], width: int):
    a = np.zeros((len(payloads), width), dtype=np.uint8)
    n = np.array([len(p) for p in payloads], dtype=np.int32)
    for i, p in enumerate(payloads):
        a[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    return a, n


def max_err(kern, plain, counts) -> int:
    """Largest |kernel - plain| over each row's compared bytes [0, count)
    and over the per-row counts and flags."""
    ko, kc, kk = (t.cpu().numpy() for t in kern)
    po, pc, pk = (t.numpy() for t in plain)
    err = int(np.abs(kc.astype(np.int64) - pc).max(initial=0))
    err = max(err, int((kk != pk).sum()))
    for i, c in enumerate(counts):
        c = int(c)
        d = np.abs(ko[i, :c].astype(np.int16) - po[i, :c].astype(np.int16))
        err = max(err, int(d.max(initial=0)))
    return err


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn) -> tuple[object, float]:
    t0 = time.perf_counter()
    r = fn()
    return r, (time.perf_counter() - t0) * 1e3


def bound_ms(nbytes: int, nops: int) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def host_rss_mib() -> int:
    """Resident set of the process now (VmRSS), in MiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) // 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class RssPeak:
    """Largest resident set seen while the block runs, sampled every 10 ms
    by a thread (VmHWM cannot be reset, nor even read, everywhere)."""

    def __enter__(self):
        import threading

        self.start = self.peak = host_rss_mib()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                self.peak = max(self.peak, host_rss_mib())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_mib())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    print(f"ok: {what}")


# one rank of phase 19's two-rank run (argv: repo root, coordinator, rank):
# both ranks own an entry on cuda:0 of one 2-entry mesh, write the same
# 32 MiB frames at 64 KiB and 256 KiB blocks and read them back; each
# prints one RANK line of JSON
_RANK_WORKER = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as tdist
import chip_smoke
from plz4_tpu_torch.ops import decode, encode
from plz4_tpu_torch.parallel import dist

rank = int(sys.argv[3])
dist.init_distributed(sys.argv[2], 2, rank)
mesh = dist.pod_mesh(["cuda:0"])
assert mesh.size == 2 and [e.rank for e in mesh.entries] == [0, 1], mesh
data = chip_smoke.bench_corpus(32 << 20)
for idx in (4, 5):
    kw = dict(block_size_idx=idx, level=1)
    warm = data[: 4 << 20]
    assert dist.decompress_sharded(dist.compress_sharded(warm, mesh, **kw),
                                   mesh) == warm
    for mod, attr in ((encode, "launches"), (encode, "window_launches"),
                      (decode, "launches"), (decode, "record_launches")):
        setattr(mod, attr, 0)
    g0, n0 = mesh.gather_seconds, mesh.gathers
    t0 = time.perf_counter()
    comp = dist.compress_sharded(data, mesh, **kw)
    t1 = time.perf_counter()
    out = dist.decompress_sharded(comp, mesh)
    t2 = time.perf_counter()
    print("RANK " + json.dumps(dict(
        rank=rank, idx=idx, sha=hashlib.sha256(comp).hexdigest(),
        intact=out == data, enc_s=t1 - t0, dec_s=t2 - t1,
        gather_s=mesh.gather_seconds - g0, gathers=mesh.gathers - n0,
        launches=[encode.launches, encode.window_launches, decode.launches,
                  decode.record_launches])), flush=True)
# the gather alone: each rank's half of the 32 MiB, after a barrier (the
# in-run gathers also wait for the slower rank)
half = data[rank * (16 << 20):(rank + 1) * (16 << 20)]
every = [None, None]
tdist.barrier()
t0 = time.perf_counter()
tdist.all_gather_object(every, half)
print("RANK " + json.dumps(dict(rank=rank, alone_s=time.perf_counter() - t0,
                                intact=every[rank] == half)), flush=True)
tdist.destroy_process_group()
"""


def two_rank_run(timeout_s: float) -> tuple[list[dict], float]:
    """Phase 19's two-rank gloo run in two subprocesses; every process is
    stopped before this returns. Returns the ranks' RANK records and the
    wall of the run, start-up included."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_WORKER, root, f"localhost:{port}",
         str(rank)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    records, failures = [], []
    try:
        for rank, p in enumerate(procs):
            left = max(1.0, timeout_s - (time.perf_counter() - t0))
            try:
                out, err = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                failures.append(f"rank {rank} passed {timeout_s:.0f} s")
                break
            if p.returncode != 0:
                failures.append(f"rank {rank} exited {p.returncode}:\n"
                                f"{err[-3000:]}")
            records += [json.loads(line[5:]) for line in out.splitlines()
                        if line.startswith("RANK ")]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    check(not failures, "the two-rank run ended cleanly: "
          + ("; ".join(failures) or "both ranks exited 0"))
    return records, wall


def sharded_phase(plz4, smi: str, reset, read, dict64: bytes) -> None:
    """Phase 19: sharded frames on meshes of 1 and 2 entries over cuda:0
    (each entry its own stream), equal to the unsharded device frame; a
    two-rank run over gloo; the entry points."""
    import torch

    from plz4_tpu_torch import entry
    from plz4_tpu_torch.parallel import dist
    from plz4_tpu_torch.parallel import mesh as mesh_mod

    t_phase = time.perf_counter()
    bench32 = bench_corpus(32 << 20)
    meshes = {"unsharded": None,
              "1-entry": mesh_mod.make_block_mesh(["cuda:0"]),
              "2-entry": mesh_mod.make_block_mesh(["cuda:0", "cuda:0"])}
    check(len({id(e.stream) for e in meshes["2-entry"].entries}) == 2,
          "the 2-entry mesh holds two streams on cuda:0")

    def enc(mesh, data, kw):
        if mesh is None:
            return plz4.compress(data, backend="device", **kw)
        return dist.compress_sharded(data, mesh, **kw)

    def dec(mesh, frame, d=None):
        if mesh is None:
            return plz4.decompress(frame, backend="device", dictionary=d)
        return dist.decompress_sharded(frame, mesh, dictionary=d)

    # (a) 256 MiB of the bench corpus at 64 KiB blocks and 128 MiB at
    # 4 MiB, unsharded and on both meshes in turns
    order = ["unsharded", "1-entry", "2-entry", "2-entry", "1-entry",
             "unsharded"]
    for what, data, kw, keys in (
            ("256 MiB at 64 KiB blocks", bench32 * 8,
             dict(block_size_idx=plz4.BLOCK_IDX_64KB, level=1),
             ("encode.launches", "decode.launches")),
            ("128 MiB at 4 MiB blocks", bench32 * 4, dict(level=1),
             ("encode.window_launches", "decode.record_launches"))):
        warm = data[: 8 << 20]  # pinned pools of the slices' shapes
        for m in meshes.values():
            check(dec(m, enc(m, warm, kw)) == warm,
                  f"warm-up round trip of {what} on {m}")
        frames, walls, counts = {}, {k: [] for k in meshes}, {}
        for k in order:
            reset()
            frame, t_e = host_ms(lambda: enc(meshes[k], data, kw))
            torch.cuda.synchronize()
            back, t_d = host_ms(lambda: dec(meshes[k], frame))
            torch.cuda.synchronize()
            counts[k] = read()
            check(back == data, f"{what}: {k} round trip intact")
            frames.setdefault(k, frame)
            walls[k].append((t_e, t_d))
            del frame, back
        ref = frames["unsharded"]
        check(all(f == ref for f in frames.values()),
              f"{what}: the 1- and 2-entry frames equal the unsharded "
              f"device frame")
        check(plz4.decompress(ref, backend="native") == data,
              f"{what}: the frame decodes through the native codec")
        for key in keys:
            u, one, two = (counts[k][key] for k in meshes)
            check(u > 0 and one == u and two == 2 * u,
                  f"{what}: {key} {u} unsharded, {one} on 1 entry, {two} "
                  f"on 2 (each slice launches its own kernel)")
        gb = len(data) / 1e9
        line = "; ".join(
            f"{k} encode " + "/".join(f"{t_e:.1f}" for t_e, _ in w)
            + " ms, decode " + "/".join(f"{t_d:.1f}" for _, t_d in w)
            + f" ms ({gb / (min(t for t, _ in w) / 1e3):.3f} / "
            f"{gb / (min(t for _, t in w) / 1e3):.3f} GB/s best)"
            for k, w in walls.items())
        print(f"phase 19 sharded walls, {what} [{smi}] (turns "
              f"{', '.join(order)}): {line}")
        del data, frames, ref

    # (b) 32 MiB with a dictionary and block checksums on the 2-entry mesh
    kw = dict(block_size_idx=plz4.BLOCK_IDX_64KB, level=1,
              dictionary=dict64, block_checksum=True)
    ref = enc(None, bench32, kw)
    reset()
    frame = enc(meshes["2-entry"], bench32, kw)
    back = dec(meshes["2-entry"], frame, dict64)
    torch.cuda.synchronize()
    c = read()
    check(frame == ref and back == bench32
          and plz4.decompress(frame, backend="native", dictionary=dict64)
          == bench32, "32 MiB with a dictionary and block checksums on the "
                      "2-entry mesh: the unsharded frame, round trip intact, "
                      "native decode")
    check(c["encode.window_launches"] > 0 and c["decode.dict_launches"] > 0
          and c["xxh32.launches"] > 0,
          f"the dictionary frame ran K2b ({c['encode.window_launches']}), "
          f"K3 ({c['decode.dict_launches']}) and K7 ({c['xxh32.launches']})")

    # (c) two ranks over gloo, both on cuda:0. The ranks load the kernel
    # libraries phase 2 built (keyed by the sources' hash in _build/) and
    # compile nothing: two first builds at once would race to write the
    # same library paths, each rank running all nine nvcc jobs (per-process
    # tmp files and os.replace keep a library whole, not the time) while
    # the other waits at its first collective
    refs = {idx: hashlib.sha256(plz4.compress(
        bench32, backend="device", block_size_idx=idx, level=1)).hexdigest()
            for idx in (plz4.BLOCK_IDX_64KB, plz4.BLOCK_IDX_256KB)}
    records, wall = two_rank_run(timeout_s=240)
    alone = [r for r in records if "alone_s" in r]
    records = [r for r in records if "idx" in r]
    check(len(records) == 4 and len(alone) == 2
          and all(r["intact"] for r in alone),
          f"both ranks reported both block sizes ({len(records)} records) "
          f"and a lone gather of 2 x 16 MiB")
    for idx, ref_sha in refs.items():
        rs = [r for r in records if r["idx"] == idx]
        check(len(rs) == 2 and all(r["intact"] for r in rs)
              and all(r["sha"] == ref_sha for r in rs),
              f"two ranks at block class {idx}: both frames equal the "
              f"unsharded frame, both round trips intact")
        # [K2a, K2b, K1, K5]: K2a and K1 at 64 KiB, K2b and K5 at 256 KiB
        path = (0, 2) if idx == plz4.BLOCK_IDX_64KB else (1, 3)
        check(all(r["launches"][i] > 0 for r in rs for i in path),
              f"each rank launched its slices' kernels [K2a, K2b, K1, K5]: "
              f"{[r['launches'] for r in rs]}")
        share = "; ".join(
            f"rank {r['rank']} encode {1e3 * r['enc_s']:.1f} ms + decode "
            f"{1e3 * r['dec_s']:.1f} ms, {r['gathers']} gathers "
            f"{1e3 * r['gather_s']:.1f} ms = "
            f"{100 * r['gather_s'] / (r['enc_s'] + r['dec_s']):.1f}%"
            for r in rs)
        print(f"phase 19 two ranks, 32 MiB at block class {idx} [{smi}]: "
              f"{share} (run wall {wall:.1f} s with start-up)")
    print(f"phase 19 lone gather of 2 x 16 MiB over gloo [{smi}]: "
          + ", ".join(f"rank {r['rank']} {1e3 * r['alone_s']:.1f} ms"
                      for r in alone))

    # (d) entry() on cuda, (e) dryrun_multichip(2) and (4)
    step, args = entry.entry()
    reset()
    totals, compressible, flag = step(*args)
    c = read()
    check(bool(flag) and bool(compressible.all())
          and c["encode.launches"] == 1 and c["decode.launches"] == 1,
          f"entry() on cuda: flag set, K2a and K1 once each "
          f"(totals {totals.tolist()})")
    for n in (2, 4):
        entry.dryrun_multichip(n)  # raises on a mismatch
        print(f"ok: dryrun_multichip({n}) on cuda")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")


def array_phase(plz4, smi: str, reset, read, dict64: bytes) -> None:
    """Phase 20: A1 and A2 on cuda against the CPU; array-path frames,
    which launch no encode or decode kernel; entry_array(); the CLI in
    subprocesses."""
    import shutil

    import torch

    from plz4_tpu_torch import cli, corpus, entry, native
    from plz4_tpu_torch.ops import decode_array, encode_array
    from plz4_tpu_torch.parallel import large

    t_phase = time.perf_counter()
    cuda = torch.device("cuda", 0)

    def same(what, fn, *args):
        """fn over host tensors on cuda and on the CPU: max abs err 0 on
        every output. Returns the CPU outputs."""
        got = fn(*[a.to(cuda) if torch.is_tensor(a) else a for a in args])
        want = fn(*args)
        err = max(int((g.cpu().long() - w.long()).abs().max())
                  if w.numel() else 0 for g, w in zip(got, want))
        check(err == 0, f"phase 20 {what}: cuda equals cpu (max abs err "
                        f"{err})")
        return want

    def tensors(payloads, width):
        return [torch.from_numpy(x) for x in rows_of(payloads, width)]

    # (a) A1 and A2 against themselves on the CPU
    bench = bench_corpus(32 * BLOCK)
    bench_rows = [bench[i:i + BLOCK] for i in range(0, len(bench), BLOCK)]
    rows, lens = tensors(bench_rows, BLOCK)
    for level, (ratio, digest) in ARRAY_DIGESTS.items():
        out, tot, okc = same(f"A1 level {level}, the bench corpus's 32 rows",
                             encode_array.encode_batch, rows, lens, level)
        if level == 1:
            bench_streams = [out[i, :tot[i]].numpy().tobytes()
                             for i in range(32)]
        h = hashlib.sha256(out.numpy().tobytes()
                           + tot.numpy().astype("<i4").tobytes()
                           + okc.numpy().astype(np.uint8).tobytes())
        r = 32 * BLOCK / int(tot.sum())
        check(round(r, 4) == ratio and h.hexdigest()[:16] == digest,
              f"A1 level {level}: ratio {r:.4f} and digest equal the JAX "
              f"array encoder's")
    edges = edge_payloads() + list(corpus.greedy_edge_rows()[0].values())
    erows, elens = tensors(edges, BLOCK)
    for level in (1, 9):
        same(f"A1 level {level}, {len(edges)} edge rows",
             encode_array.encode_batch, erows, elens, level)
    wins, wl = tensors([dict64, dict64[-1000:], b"", dict64[:17]] * 4, BLOCK)
    same("A1 after windows (full, partial, none, 17 bytes)",
         encode_array.encode_batch_dict, rows[:16], lens[:16], wins, wl, 3)
    C = BLOCK + 16
    streams = [s for s in bench_streams + [
        native.compress(p, level=lv) for p in edges[:10] for lv in (1, 12)]
               if len(s) <= C]
    bad = corrupt_streams(streams)
    bad += [s[: len(s) // 2] for s in streams[:8]]  # truncated
    crows, clens = tensors(streams + bad, C)
    out, n, okd = same(f"A2, {len(streams)} streams and {len(bad)} damaged",
                       decode_array.decode_batch, crows, clens, BLOCK)
    okv = okd.numpy()
    check(bool(okv[:len(streams)].all()) and not okv[len(streams):][
        :4].any() and all(out[i, :n[i]].numpy().tobytes() == bench_rows[i]
                          for i in range(32)),
          "A2 verdicts: valid streams ok and intact, bad offsets refused")
    dstreams = [native.compress(p, level=1, dict_=dict64)
                for p in bench_rows[:8] + [dict64[-3000:], dict64[:2000]]]
    drows, dlens = tensors(dstreams, C)
    dbuf = torch.from_numpy(np.frombuffer(dict64, np.uint8).copy())
    _, _, okd = same("A2 against a 64 KiB dictionary",
                     decode_array.decode_batch_dict, drows, dlens, dbuf,
                     len(dict64), BLOCK)
    check(bool(okd.all()), "A2 decodes every dictionary stream")
    for name, (a, nn, cap, _) in corpus.decode_edge_batches().items():
        same(f"A2, the {len(nn)} {name} decode edge rows",
             decode_array.decode_batch, torch.from_numpy(a),
             torch.from_numpy(nn), cap)

    # A1 and A2 at the main path's shape: 128 rows of 64 KiB
    main_rows = corpus.silesia_like(ROWS * BLOCK)
    m_in = [x.to(cuda) for x in tensors(
        [main_rows[i:i + BLOCK] for i in range(0, ROWS * BLOCK, BLOCK)],
        BLOCK)]
    a1_out, a1_tot, _ = encode_array.encode_batch(*m_in, 1)
    a1_ms = cuda_ms(lambda: encode_array.encode_batch(*m_in, 1), 5)
    a1_plain_ms = host_ms(lambda: encode_array.encode_batch(
        *[x.cpu() for x in m_in], 1))[1]
    d_rows = torch.zeros((ROWS, C), dtype=torch.uint8, device=cuda)
    d_rows[:, :C] = a1_out[:, :C]
    d_in = (d_rows, a1_tot)
    dec_out = decode_array.decode_batch(*d_in, BLOCK)
    check(bool(dec_out[2].all()) and torch.equal(dec_out[0], m_in[0]),
          "A2 decodes A1's 128 main-path rows on cuda")
    a2_ms = cuda_ms(lambda: decode_array.decode_batch(*d_in, BLOCK), 5)
    a2_plain_ms = host_ms(lambda: decode_array.decode_batch(
        *[x.cpu() for x in d_in], BLOCK))[1]
    cap = encode_array.out_width(BLOCK)
    a1_bound = bound_ms(ROWS * BLOCK + 4 * ROWS + ROWS * cap + 5 * ROWS,
                        OPS_PER_BYTE * ROWS * BLOCK)
    a2_bound = bound_ms(int(a1_tot.sum()) + 4 * ROWS + ROWS * BLOCK
                        + 5 * ROWS, OPS_PER_BYTE * ROWS * BLOCK)
    print(f"phase 20 [{smi}]: A1 level 1 {a1_ms:.3f} ms, A2 {a2_ms:.3f} ms "
          f"per {ROWS} x 64 KiB rows (CPU {a1_plain_ms:.1f} / "
          f"{a2_plain_ms:.1f} ms); byte bounds {a1_bound[0]:.4f} / "
          f"{a2_bound[0]:.4f} ms")
    del m_in, d_rows, d_in, dec_out, a1_out

    # (b) array-path frames on the card, 32 MiB of the bench corpus
    data = bench_corpus(32 << 20)
    head = data[: 2 << 20]
    kernel_keys = [k for k in read() if k != "xxh32.launches"]
    warm = dict(backend="device", array_path=True,
                block_size_idx=plz4.BLOCK_IDX_64KB)
    check(plz4.decompress(plz4.compress(head, **warm), **warm) == head,
          "array-path warm-up round trip")
    for what, kw in (
            ("64 KiB blocks, level 1",
             dict(block_size_idx=plz4.BLOCK_IDX_64KB, level=1)),
            ("64 KiB blocks, level 9",
             dict(block_size_idx=plz4.BLOCK_IDX_64KB, level=9)),
            ("4 MiB blocks, level 1", dict(level=1)),
            ("a dictionary, 64 KiB blocks",
             dict(block_size_idx=plz4.BLOCK_IDX_64KB, dictionary=dict64)),
            ("block checksums, 64 KiB blocks",
             dict(block_size_idx=plz4.BLOCK_IDX_64KB, block_checksum=True))):
        kw = dict(kw, backend="device", array_path=True)
        d = kw.get("dictionary")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        frame, t_e = host_ms(lambda: plz4.compress(data, **kw))
        torch.cuda.synchronize()
        back, t_d = host_ms(lambda: plz4.decompress(frame, **kw))
        torch.cuda.synchronize()
        c = read()
        peak = torch.cuda.max_memory_allocated()
        ran = {k: c[k] for k in kernel_keys if c[k]}
        check(back == data and not ran
              and (c["xxh32.launches"] > 0) == bool(kw.get("block_checksum")),
              f"array path, {what}: round trip intact, no encode or decode "
              f"kernel launched ({ran}), K7 {c['xxh32.launches']}")
        check(plz4.decompress(frame, backend="native", dictionary=d) == data,
              f"array path, {what}: the frame decodes through native")
        check(plz4.compress(head, **kw) == plz4.compress(
            head, **dict(kw, device="cpu")),
              f"array path, {what}: the first 2 MiB's frame equals the "
              f'device="cpu" frame')
        gb = len(data) / 1e9
        print(f"phase 20 array path, 32 MiB, {what} [{smi}]: encode "
              f"{gb / (t_e / 1e3):.3f} GB/s, decode {gb / (t_d / 1e3):.3f} "
              f"GB/s, ratio {len(data) / len(frame):.4f}, large blocks "
              f"decoded on the host {large.array_host_decodes} (valve "
              f"{large.host_decodes}), peak device memory "
              f"{peak / 2**20:.1f} MiB")
        del frame, back
    kw = dict(backend="device", block_size_idx=plz4.BLOCK_IDX_64KB)
    reset()
    check(plz4.decompress(plz4.compress(head, **kw), **kw) == head, "the "
          "same 2 MiB with the option off round trips")
    c = read()
    check(c["encode.launches"] > 0 and c["decode.launches"] > 0,
          f"with the option off K2a ({c['encode.launches']}) and K1 "
          f"({c['decode.launches']}) ran")

    # (c) the entry step
    step, args = entry.entry_array()
    reset()
    got = step(*args)
    c = read()
    cstep, cargs = entry.entry_array("cpu")
    want = cstep(*cargs)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
          and bool(got[2]) and not any(c[k] for k in kernel_keys),
          f"entry_array() on cuda equals entry_array('cpu') (totals "
          f"{got[0].tolist()}) and launches no kernel")

    # (d) the CLI: `python -m plz4_tpu_torch` in subprocesses
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase20")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        big = os.path.join(work, "bench256.bin")
        with open(big, "wb") as f:
            for _ in range(8):
                f.write(data)
        mid = os.path.join(work, "bench64.bin")
        with open(mid, "wb") as f:
            f.write(data * 2)
        small = os.path.join(work, "bench8.bin")
        with open(small, "wb") as f:
            f.write(data[: 8 << 20])

        def run(*argv):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "plz4_tpu_torch", *argv], cwd=root,
                capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            check(p.returncode == 0, f"plz4_tpu_torch {' '.join(argv[:3])} "
                                     f"exited 0 ({wall:.1f} s)"
                  + ("" if p.returncode == 0 else "\n" + p.stderr[-3000:]))
            return p.stdout + p.stderr, wall

        def verify_in_process(frame):
            """cli.main's verify in this process: a subprocess would repeat
            the decompress's start-up (PERF.md, PR 12)."""
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--backend", "device", "verify", frame])
            return (buf.getvalue() if rc == 0 else ""), \
                time.perf_counter() - t0

        walls = []
        # the 64 KiB pass runs on 64 MiB and verifies in this process, to
        # keep the phase near its ~90 s
        for what, src, reps, flags, sub_verify in (
                ("defaults", big, 8, [], True),
                ("--bs 64KB --bx", mid, 2, ["--bs", "64KB", "--bx"], False)):
            frame, back = src + ".lz4", src + ".out"
            out_c, w_c = run("--backend", "device", "compress", src, "-o",
                             frame, "-f", *flags)
            out_d, w_d = run("--backend", "device", "decompress", frame,
                             "-o", back, "-f")
            out_v, w_v = (run("--backend", "device", "verify", frame)
                          if sub_verify else verify_in_process(frame))
            with open(back, "rb") as f:
                check(f.read() == data * reps, f"CLI {what}: {32 * reps} "
                                               "MiB round trip intact")
            check(f"OK: {reps * len(data)} bytes" in out_v,
                  f"CLI {what}: verify OK")
            walls.append(f"{what}, {32 * reps} MiB: compress {w_c:.1f} s ("
                         + out_c.strip().splitlines()[-1] + "), decompress "
                         f"{w_d:.1f} s (" + out_d.strip().splitlines()[-1]
                         + f"), verify {w_v:.1f} s"
                         + ("" if sub_verify else " in process"))
            os.remove(frame)
            os.remove(back)
        out_b, w_b = run("bakeoff", small, "--device", "-q")
        rows_b = [ln for ln in out_b.splitlines()
                  if ln.split()[:2] in (["device", "1"], ["plz4", "1"])]
        check(len(rows_b) == 2, "bakeoff --device printed its L1 rows")
        print(f"phase 20 CLI walls, subprocesses with start-up [{smi}]: "
              + "; ".join(walls) + f"; bakeoff --device -q on 8 MiB "
              f"{w_b:.1f} s: " + " | ".join(" ".join(r.split())
                                             for r in rows_b))
        # in-process: the CLI's device backend runs the kernels
        frame = small + ".lz4"
        for flags, keys in (
                ([], ("encode.window_launches", "decode.record_launches")),
                (["--bs", "64KB", "--bx"],
                 ("encode.launches", "decode.launches", "xxh32.launches"))):
            reset()
            rc = cli.main(["--backend", "device", "compress", small, "-o",
                           frame, "-f", "-q", *flags])
            rc |= cli.main(["--backend", "device", "decompress", frame, "-o",
                            small + ".out", "-f", "-q"])
            c = read()
            with open(small + ".out", "rb") as f:
                check(rc == 0 and f.read() == data[: 8 << 20]
                      and all(c[k] > 0 for k in keys),
                      f"cli.main {' '.join(flags) or 'defaults'}: round "
                      f"trip intact, {', '.join(f'{k} {c[k]}' for k in keys)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 1
    import plz4_tpu_torch as plz4
    from plz4_tpu_torch import corpus, native
    from plz4_tpu_torch.ops import (_build, decode, encode, encode_deep,
                                    encode_mid, encode_wide, xxh32)
    from plz4_tpu_torch.parallel import batch, large

    dev = torch.device("cuda", 0)
    # every kernel wrapper's launch counter
    counters = [(encode, "launches"), (encode, "window_launches"),
                (encode_mid, "launches"), (encode_mid, "window_launches"),
                (encode_deep, "launches"), (encode_deep, "window_launches"),
                (decode, "launches"), (decode, "dict_launches"),
                (decode, "record_launches"), (encode_wide, "launches"),
                (encode_wide, "mid_launches"), (decode, "wide_launches"),
                (xxh32, "launches")]

    def reset():
        for mod, attr in counters:
            setattr(mod, attr, 0)
        large.host_decodes = large.array_host_decodes = 0

    def read():
        return {f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": getattr(mod, attr)
                for mod, attr in counters}

    def encode_others(counts, key):
        """The encode launches other than key's (the decode side and K7 are
        read separately)."""
        return {k: v for k, v in counts.items()
                if v and k != key and k.startswith("encode")}
    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {kind}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); {nvcc_v.splitlines()[-1]}")

    # ---- 2. build: the CUDA kernels, and the native host codec (frame
    # hashing, cross-checks) so that no build lands inside a timing -------
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    t1 = time.perf_counter()
    native._load()
    native._load_ext()
    print(f"build: {t1 - t0:.1f} s for {_build.KERNELS}; native host codec "
          f"{time.perf_counter() - t1:.1f} s")

    main_data = corpus.silesia_like(32 << 20) * 8  # 256 MiB, 4096 blocks
    bench = bench_corpus(32 * BLOCK)
    bench_rows = [bench[i:i + BLOCK] for i in range(0, len(bench), BLOCK)]
    edges = edge_payloads()
    main_rows = [main_data[i:i + BLOCK] for i in range(0, ROWS * BLOCK, BLOCK)]

    def both(name, kern_fn, plain_fn, host_args, what, upto="ok", **kw):
        """Run an encode kernel and its plain version on the same rows; hold
        ok, totals and each ok row's stream bytes equal (with upto="cap",
        each stream wherever total < CAP, ok or not). Returns (device
        operands, kernel outputs, plain outputs, plain ms, max abs err)."""
        dev_args = [x.to(dev) for x in host_args]
        kern = kern_fn(*dev_args, **kw)
        torch.cuda.synchronize()
        plain, p_ms = host_ms(lambda: plain_fn(*host_args, **kw))
        okv, tot = plain[2].numpy(), plain[1].numpy()
        check(bool((kern[1].cpu().numpy() == tot).all()
                   and (kern[2].cpu().numpy() == okv).all()),
              f"{name} ok/total equal plain on {what}")
        sel = tot < plain[0].shape[1] if upto == "cap" else okv
        err = max_err(kern, plain, np.where(sel, tot, 0))
        where = "wherever total < CAP" if upto == "cap" else "where ok"
        check(err == 0, f"{name} stream bytes equal plain {where} on {what} "
                        f"(max abs err {err})")
        return dev_args, kern, plain, p_ms, err

    # ---- 3. K2a against its plain version --------------------------------
    def enc_both(payloads, what=None):
        return both("K2a", encode.encode_batch, encode.encode_batch_plain,
                    [torch.from_numpy(x) for x in rows_of(payloads, BLOCK)],
                    what or f"{len(payloads)} rows", upto="cap")

    (e_in, e_kern, e_plain, enc_plain_ms, enc_err) = enc_both(main_rows)
    (_, x_kern, _, _, x_err) = enc_both(bench_rows + edges)
    # rows aimed at the greedy parse's warp steps: a search ending on every
    # lane, at skip strides 1-3 and over 30, crowded buckets, runs,
    # matches to matchlimit, 13-80-byte blocks
    greedy_plain, greedy_far = corpus.greedy_edge_rows()
    enc_err = max(enc_err, enc_both(
        list(greedy_plain.values()),
        f"the {len(greedy_plain)} greedy step edge rows")[4])
    x_tot = x_kern[1].cpu().numpy()
    ratio = 32 * BLOCK / int(x_tot[:32].sum())
    print(f"K2a level-1 ratio on the bench corpus (32 rows): {ratio:.4f}")
    check(round(ratio, 4) == 2.4065, "bench-corpus ratio 2.4065")
    enc_ms = cuda_ms(lambda: encode.encode_batch(*e_in), 20)
    e_tot = e_plain[1].numpy()
    enc_bound = bound_ms(ROWS * BLOCK + 8 * ROWS + int(e_tot.sum()) + ROWS,
                         OPS_PER_BYTE * ROWS * BLOCK)

    # ---- 4. K1 against its plain version --------------------------------
    C = BLOCK + decode.ROW_SLACK

    def streams_of(kern, payloads):
        """K2a's stream of each ok row; the native stream of a row K2a left
        raw, where that fits a block."""
        out, tot, okv = (t.cpu().numpy() for t in kern)
        streams = []
        for i, p in enumerate(payloads):
            s = (out[i, :tot[i]].tobytes() if okv[i]
                 else native.compress(p, level=1))
            if len(s) <= BLOCK:
                streams.append(s)
        return streams

    def dec_rows(ha, hn, cap, what):
        da, dn = ha.to(dev), hn.to(dev)
        kern = decode.decode_batch(da, dn, cap)
        torch.cuda.synchronize()
        plain, p_ms = host_ms(lambda: decode.decode_batch_plain(ha, hn, cap))
        nn = plain[1].numpy()
        check(bool((kern[1].cpu().numpy() == nn).all()
                   and (kern[2].cpu().numpy() == plain[2].numpy()).all()),
              f"K1 ok/n_out equal plain on {what}")
        err = max_err(kern, plain, nn)
        check(err == 0, f"K1 bytes [0, n_out) equal plain on {what} (max abs "
                        f"err {err})")
        return (da, dn), kern, plain, p_ms, err

    def dec_both(streams):
        a, n = rows_of(streams, C)
        return dec_rows(torch.from_numpy(a), torch.from_numpy(n), BLOCK,
                        f"{len(streams)} rows")

    main_streams = streams_of(e_kern, main_rows)
    check(len(main_streams) == ROWS, "K2a compressed every main-path row")
    (d_in, d_kern, d_plain, dec_plain_ms, dec_err) = dec_both(main_streams)
    check(bool(d_plain[2].numpy().all()), "K1 decodes every main-path row")
    x_streams = streams_of(x_kern, bench_rows + edges)
    native_streams = [native.compress(p, level=1) for p in edges[:9]]
    corrupt = corrupt_streams(x_streams[:32] + native_streams)
    (_, c_kern, c_plain, _, c_err) = dec_both(
        x_streams + native_streams + corrupt)
    c_ok = c_plain[2].numpy()
    n_good = len(x_streams) + len(native_streams)
    check(bool(c_ok[:n_good].all()) and not c_ok[n_good:n_good + 4].any(),
          "K1 verdicts: valid streams ok, bad-offset streams refused")
    # rows aimed at the parse's hand-over and the copy steps: short offsets
    # at a row's start, rows that wrap the ring of 2,048 sequences 4-8
    # times, clen past the row's width, streams that pass out_cap
    edge_batches = corpus.decode_edge_batches()
    for name, (a, n, cap, _) in edge_batches.items():
        c_err = max(c_err, dec_rows(torch.from_numpy(a), torch.from_numpy(n),
                                    cap, f"the {len(n)} {name} rows")[4])
    dec_ms = cuda_ms(lambda: decode.decode_batch(*d_in, BLOCK), 20)
    dec_bound = bound_ms(
        sum(len(s) for s in main_streams) + 4 * ROWS
        + int(d_plain[1].numpy().sum()) + 5 * ROWS,
        OPS_PER_BYTE * ROWS * BLOCK)

    # ---- 5. main path ---------------------------------------------------
    opts = dict(backend="device", level=1, block_size_idx=plz4.BLOCK_IDX_64KB)
    # warm-up round trip of one batch: pinned staging pools and threads
    # are set-up, not throughput
    warm = main_data[: ROWS * BLOCK]
    check(plz4.decompress(plz4.compress(warm, **opts),
                          backend="device") == warm, "warm-up round trip")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    frame, t_enc = host_ms(lambda: plz4.compress(main_data, **opts))
    torch.cuda.synchronize()
    enc_counts = read()
    back, t_dec = host_ms(lambda: plz4.decompress(frame, backend="device"))
    torch.cuda.synchronize()
    enc_launches, dec_launches = encode.launches, decode.launches
    peak = torch.cuda.max_memory_allocated()
    check(back == main_data, "256 MiB device round trip is intact")
    n_blocks = len(main_data) // BLOCK
    others = encode_others(enc_counts, "encode.launches")
    check(enc_launches == math.ceil(n_blocks / ROWS) and not others,
          f"K2a ran once per batch on the main path ({enc_launches}), no "
          f"other encode kernel ({others})")
    read_batch = plz4.Options(**opts).pending_budget()
    check(dec_launches == math.ceil(n_blocks / read_batch),
          f"K1 ran once per batch on the main path ({dec_launches})")
    check(plz4.decompress(frame, backend="native") == main_data,
          "device frame decodes with backend=native")
    native_frame = plz4.compress(main_data, backend="native",
                                 block_size_idx=plz4.BLOCK_IDX_64KB)
    check(plz4.decompress(native_frame, backend="device") == main_data,
          "native frame decodes with backend=device")
    gb = len(main_data) / 1e9
    print(f"main path [{smi}]: encode {gb / (t_enc / 1e3):.3f} GB/s, "
          f"decode {gb / (t_dec / 1e3):.3f} GB/s through Writer/Reader; "
          f"kernel ms per {ROWS}-row batch: K2a {enc_ms:.3f}, K1 "
          f"{dec_ms:.3f}; frame ratio {len(main_data) / len(frame):.4f}; "
          f"peak device memory {peak / 2**20:.1f} MiB")
    print(f"kernel share of wall at 64 KiB: encode K2a {enc_launches} x "
          f"{enc_ms:.3f} ms = {100 * enc_launches * enc_ms / t_enc:.1f}% of "
          f"{t_enc:.1f} ms; decode K1 {dec_launches} x {dec_ms:.3f} ms = "
          f"{100 * dec_launches * dec_ms / t_dec:.1f}% of {t_dec:.1f} ms")

    # ---- 6. K2b against its plain version -------------------------------
    big_blocks = [main_data[i * BIG:(i + 1) * BIG] for i in range(2)]
    dict64 = corpus.silesia_like(BLOCK, seed=77)

    def chunk_batch(blocks, dicts):
        """K2b's operands for the chunk rows of large blocks, as the
        device writer stages them."""
        R = len(blocks) * CHUNKS
        t = (torch.zeros((R, BLOCK), dtype=torch.uint8),
             torch.zeros((R,), dtype=torch.int32),
             torch.zeros((len(blocks), BLOCK), dtype=torch.uint8),
             torch.zeros((R,), dtype=torch.int32))
        large.stage_chunks(blocks, dicts,
                           t[0].numpy().reshape(len(blocks), CHUNKS, BLOCK),
                           t[1].numpy().reshape(len(blocks), CHUNKS),
                           t[3].numpy().reshape(-1, CHUNKS), t[2].numpy())
        return t

    def window_both(host_args, what, **kw):
        return both("K2b", encode.encode_batch_window,
                    encode.encode_batch_window_plain, host_args, what,
                    upto="cap", **kw)

    cw_host = chunk_batch(big_blocks, None)
    (cw_in, cw_kern, cw_plain, encw_plain_ms, encw_err) = window_both(
        cw_host, f"{2 * CHUNKS} chunk rows of two 4 MiB blocks (wstride 2)",
        wstride=large.CHUNK_WSTRIDE, chunks=CHUNKS)
    # one window per row (wstride 1): a full 64 KiB dictionary, a partial
    # window, an empty one, and a short block after the dictionary
    w_rows = [main_data[j * BLOCK:(j + 1) * BLOCK] for j in (5, 6, 7)] + [
        vocab_text(4096, 3)]
    w_wins = [dict64, main_data[4 * BLOCK:5 * BLOCK],
              edges[-1], dict64]
    wa, wn = rows_of(w_rows, BLOCK)
    wd, _ = rows_of(w_wins, BLOCK)
    w_host = (torch.from_numpy(wa), torch.from_numpy(wn),
              torch.from_numpy(wd),
              torch.tensor([BLOCK, 3000, 0, BLOCK], dtype=torch.int32))
    (_, ww_kern, _, _, ww_err) = window_both(
        w_host, "rows with a full, a partial and an empty window (wstride 1)")
    # copies 65,534-65,536 bytes back from 64 KiB windows
    fa, fn = rows_of([b for b, _, _ in greedy_far.values()], BLOCK)
    fw, _ = rows_of([w for _, w, _ in greedy_far.values()], BLOCK)
    far_host = (torch.from_numpy(fa), torch.from_numpy(fn),
                torch.from_numpy(fw),
                torch.tensor([u for _, _, u in greedy_far.values()],
                             dtype=torch.int32))
    for ws in (1, 2):
        ww_err = max(ww_err, window_both(
            far_host, f"copies 65,534-65,536 bytes back from 64 KiB windows "
            f"(wstride {ws})", wstride=ws)[4])
    # a 3.5-chunk block whose second chunk is random: that chunk does not
    # shrink, yet the large-block path stitches its stream (literals)
    text = corpus.silesia_like(3 * BLOCK, seed=6)
    noise = np.random.default_rng(23).integers(0, 256, BLOCK, dtype=np.uint8)
    rnd_block = text[:BLOCK] + noise.tobytes() + text[BLOCK:5 * BLOCK // 2]
    rnd_host = chunk_batch([rnd_block], None)
    _, _, r_plain, _, r_err = window_both(
        rnd_host, "the chunk rows of a block with a random chunk (wstride 2)",
        wstride=large.CHUNK_WSTRIDE, chunks=CHUNKS)
    check(bool(((r_plain[1] < r_plain[0].shape[1]) & ~r_plain[2]).any()),
          "the random chunk does not shrink")
    ww_err = max(ww_err, r_err)
    encw_ms = cuda_ms(lambda: encode.encode_batch_window(
        *cw_in, wstride=large.CHUNK_WSTRIDE, chunks=CHUNKS), 10)
    cw_lens = cw_host[1].numpy()
    cw_tot = cw_plain[1].numpy()
    encw_bound = bound_ms(
        int(cw_lens.sum()) + cw_host[2].numel() + 8 * len(cw_lens)
        + int(cw_tot.sum()) + 5 * len(cw_lens),
        OPS_PER_BYTE * (int(cw_lens.sum())
                        + int(cw_host[3].numpy().sum()) // 2))

    # ---- 7. K3 against its plain version --------------------------------
    dbuf = torch.from_numpy(np.frombuffer(dict64, np.uint8).copy())

    def dict_rows(ha, hn, hd, cap, what):
        da, dn, dd = ha.to(dev), hn.to(dev), hd.to(dev)
        D = hd.shape[0]
        kern = decode.decode_batch_dict(da, dn, dd, D, cap)
        torch.cuda.synchronize()
        plain, p_ms = host_ms(lambda: decode.decode_batch_dict_plain(
            ha, hn, hd, D, cap))
        nn = plain[1].numpy()
        check(bool((kern[1].cpu().numpy() == nn).all()
                   and (kern[2].cpu().numpy() == plain[2].numpy()).all()),
              f"K3 ok/n_out equal plain on {what}")
        err = max_err(kern, plain, nn)
        check(err == 0, f"K3 bytes [0, n_out) equal plain on {what} (max "
                        f"abs err {err})")
        return (da, dn, dd), kern, plain, p_ms, err

    def dict_both(streams, what):
        a, n = rows_of(streams, C)
        return dict_rows(torch.from_numpy(a), torch.from_numpy(n), dbuf,
                         BLOCK, what)

    dict_main = [native.compress(main_data[i * BLOCK:(i + 1) * BLOCK],
                                 level=1, dict_=dict64) for i in range(ROWS)]
    (k3_in, _, k3_plain, k3_plain_ms, k3_err) = dict_both(
        dict_main, f"{ROWS} dictionary blocks of the main data")
    check(bool(k3_plain[2].numpy().all()), "K3 decodes every dictionary block")
    wout, wtot, wok = (t.cpu().numpy() for t in ww_kern)
    k2b_dict = [wout[i, :wtot[i]].tobytes() for i in (0, 3) if wok[i]]
    check(len(k2b_dict) == 2, "K2b compressed both full-dictionary rows")
    edge_dict = [native.compress(p, level=1, dict_=dict64) for p in edges[:9]]
    bad_off = [bytes([0x00, 0x04, 0x00, 0x40]) + b"abcd",  # ends at window
               bytes([0x00, 0xFF, 0xFF, 0x40]) + b"abcd",  # offset 65535
               bytes([0x04, 0, 0]), b"\xff" * 40]
    k3_corrupt = corrupt_streams(dict_main[:16] + k2b_dict + edge_dict,
                                 seed=0xD1C7)
    good = k2b_dict + edge_dict + bad_off[:2]
    (_, _, x3_plain, _, x3_err) = dict_both(
        good + bad_off[2:] + k3_corrupt, "K2b, native, bad-offset and "
        "corrupt dictionary streams")
    x3_ok = x3_plain[2].numpy()
    check(bool(x3_ok[:len(good)].all())
          and not x3_ok[len(good):len(good) + 2].any(),
          "K3 verdicts: valid streams ok, zero-offset and endless streams "
          "refused")
    x3_n = x3_plain[1].numpy()
    check(bool(x3_plain[0][len(good) - 2, :x3_n[len(good) - 2]].numpy()
               .tobytes() == dict64[-4:] + b"abcd"),
          "K3: a match that ends at the window/block boundary")
    for name, (a, n, cap, win) in edge_batches.items():
        x3_err = max(x3_err, dict_rows(
            torch.from_numpy(a), torch.from_numpy(n),
            torch.from_numpy(np.frombuffer(win, np.uint8).copy()), cap,
            f"the {len(n)} {name} rows")[4])
    k3_ms = cuda_ms(lambda: decode.decode_batch_dict(*k3_in, BLOCK, BLOCK),
                    20)
    k3_bound = bound_ms(
        sum(len(s) for s in dict_main) + 4 * ROWS + BLOCK
        + int(k3_plain[1].numpy().sum()) + 5 * ROWS,
        OPS_PER_BYTE * int(k3_plain[1].numpy().sum()))

    # ---- 8. K5 against its plain version --------------------------------
    def record_batch(items, dicts):
        """K5's operands for large blocks, as the device reader stages
        them; items [(stored block, records)], dicts per block."""
        K = max(max(len(r) for _, r in items), CHUNKS + 1)
        t = (torch.zeros((len(items), K, large.CHUNK_IN), dtype=torch.uint8),
             torch.zeros((len(items), K, 7), dtype=torch.int32),
             torch.zeros((len(items), BLOCK), dtype=torch.uint8))
        for j, (item, d) in enumerate(zip(items, dicts)):
            large.stage_records([item], d, t[0].numpy()[j:j + 1],
                                t[1].numpy()[j:j + 1], t[2].numpy()[j:j + 1])
        return t

    def split(stored):
        return stored, native.chunk_split(stored, BLOCK, max_out=BIG)

    def records_both(host_args, what):
        dev_args = [x.to(dev) for x in host_args]
        kern = decode.decode_records_batch(*dev_args)
        torch.cuda.synchronize()
        plain, p_ms = host_ms(
            lambda: decode.decode_records_batch_plain(*host_args))
        nn = plain[1].numpy()
        check(bool((kern[1].cpu().numpy() == nn).all()
                   and (kern[2].cpu().numpy() == plain[2].numpy()).all()),
              f"K5 ok/n_out equal plain on {what}")
        flat = [t.reshape(-1, BLOCK) if t.dim() == 3 else t.reshape(-1)
                for t in kern]
        pflat = [t.reshape(-1, BLOCK) if t.dim() == 3 else t.reshape(-1)
                 for t in plain]
        err = max_err(flat, pflat, nn.reshape(-1))
        check(err == 0, f"K5 bytes [0, n_out) equal plain on {what} (max "
                        f"abs err {err})")
        return dev_args, kern, plain, p_ms, err

    k5_items = [split(native.compress(big_blocks[0], level=1)),
                split(native.compress(big_blocks[1], level=1, dict_=dict64))]
    check(all(r is not None and len(r) > 1 for _, r in k5_items),
          "both stored 4 MiB blocks split into records")
    k5_host = record_batch(k5_items, [None, dict64])
    n_recs = sum(len(r) for _, r in k5_items)
    (_, _, k5_plain, _, k5_err) = records_both(
        k5_host, f"two 4 MiB blocks, {n_recs} records, the second after a "
        "64 KiB dictionary")
    ok5, n5 = k5_plain[2].numpy(), k5_plain[1].numpy()
    check(all(bool(ok5[j, :len(r)].all())
              and (n5[j, :len(r)] == r[:, 6]).all()
              and b"".join(k5_plain[0][j, k, :n5[j, k]].numpy().tobytes()
                           for k in range(len(r))) == big_blocks[j]
              for j, (_, r) in enumerate(k5_items)),
          "K5 rebuilds both 4 MiB blocks")
    bad_rows, bad_metas = k5_host[0].clone(), k5_host[1].clone()
    bad_rows[0, 7, 50:60] ^= 0x5A  # flipped bytes in a record slice
    bad_metas[0, 20, 0] -= 9  # a truncated record
    bad_metas[1, 11, 0] += 5  # a record slice that runs long
    bad_rows[1, 30, 5] ^= 0xFF
    (_, _, _, _, k5c_err) = records_both(
        (bad_rows, bad_metas, k5_host[2]), "truncated and flipped records")

    # ---- 9. main path at the default 4 MiB blocks ------------------------
    opts4 = dict(backend="device", level=1)  # default block size, checksum
    warm4 = main_data[: 2 * BIG]
    check(plz4.decompress(plz4.compress(warm4, **opts4),
                          backend="device") == warm4,
          "warm-up round trip at 4 MiB blocks")
    del frame, back, native_frame
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    with RssPeak() as rss:
        frame4, t_enc4 = host_ms(lambda: plz4.compress(main_data, **opts4))
        torch.cuda.synchronize()
        enc4_others = encode_others(read(), "encode.window_launches")
        back4, t_dec4 = host_ms(lambda: plz4.decompress(frame4,
                                                        backend="device"))
        torch.cuda.synchronize()
    k2b_launches, k5_launches = encode.window_launches, decode.record_launches
    other4 = (decode.launches, decode.dict_launches)
    valve = large.host_decodes
    peak4 = torch.cuda.max_memory_allocated()
    check(back4 == main_data, "256 MiB device round trip at 4 MiB blocks is "
                              "intact")
    n_big = len(main_data) // BIG
    check(k2b_launches == n_big // 2,
          f"K2b ran once per 2-block writer batch ({k2b_launches})")
    read_batch4 = plz4.Options(**opts4).pending_budget()
    check(k5_launches == math.ceil(n_big / read_batch4),
          f"K5 ran once per {read_batch4}-block reader batch ({k5_launches})")
    check(other4 == (0, 0) and not enc4_others,
          f"no other encode kernel ({enc4_others}) and no K1/K3 launch "
          f"({other4}) at 4 MiB")
    check(valve == 0, "no block took the host valve")
    check(plz4.decompress(frame4, backend="native") == main_data,
          "4 MiB device frame decodes with backend=native")
    native4 = plz4.compress(main_data, backend="native")
    check(plz4.decompress(native4, backend="device") == main_data,
          "native 4 MiB frame decodes with backend=device")
    # K5 at the reader's batch shape: read_batch4 blocks of the main data
    n_k5 = min(read_batch4, n_big)
    k5_main = record_batch(
        [split(native.compress(main_data[i * BIG:(i + 1) * BIG], level=1))
         for i in range(n_k5)], [None] * n_k5)
    (k5_dev, _, _, k5_plain_ms, k5m_err) = records_both(
        k5_main, f"a reader batch of {n_k5} native 4 MiB blocks")
    k5_err = max(k5_err, k5m_err)
    k5_ms = cuda_ms(lambda: decode.decode_records_batch(*k5_dev), 3)
    k5_out = int(k5_main[1][:, :, 6].sum())
    k5_bound = bound_ms(
        int(k5_main[1][:, :, 0].sum()) + k5_main[1].numel() * 4
        + k5_main[2].numel() + k5_out + 5 * k5_main[1].shape[0]
        * k5_main[1].shape[1], OPS_PER_BYTE * k5_out)
    del k5_dev
    gb = len(main_data) / 1e9
    print(f"main path 4 MiB [{smi}]: encode {gb / (t_enc4 / 1e3):.3f} GB/s, "
          f"decode {gb / (t_dec4 / 1e3):.3f} GB/s through Writer/Reader; "
          f"frame ratio {len(main_data) / len(frame4):.4f}; peak device "
          f"memory {peak4 / 2**20:.1f} MiB; peak host RSS {rss.peak} MiB "
          f"({rss.start} before it); "
          f"ms per batch: K2b {encw_ms:.3f} ({2 * CHUNKS} chunk rows, bound "
          f"{encw_bound[0]:.4f}), K5 {k5_ms:.3f} ({k5_main[1].shape[0]} "
          f"blocks, bound {k5_bound[0]:.4f}), K3 {k3_ms:.3f} ({ROWS} rows, "
          f"bound {k3_bound[0]:.4f})")
    # kernel time over wall time: each launch timed alone at the main
    # path's shapes, times the main path's launches
    print(f"kernel share of wall at 4 MiB: encode K2b {k2b_launches} x "
          f"{encw_ms:.3f} ms = {100 * k2b_launches * encw_ms / t_enc4:.1f}%"
          f" of {t_enc4:.1f} ms; decode K5 {k5_launches} x {k5_ms:.3f} ms "
          f"= {100 * k5_launches * k5_ms / t_dec4:.1f}% of {t_dec4:.1f} ms")

    # ---- 10. dictionary and linked frames at 64 KiB blocks ---------------
    win_data = main_data[: 32 << 20]
    n_win = len(win_data) // BLOCK
    read_batch = plz4.Options(**opts).pending_budget()
    k3_launches = 0
    for name, extra in (("dictionary", dict(dictionary=dict64)),
                        ("linked", dict(block_linked=True))):
        o = opts | extra
        d = extra.get("dictionary")
        encode.launches = encode.window_launches = 0
        decode.launches = decode.dict_launches = decode.record_launches = 0
        f = plz4.compress(win_data, **o)
        back = plz4.decompress(f, backend="device", dictionary=d)
        torch.cuda.synchronize()
        counts = (encode.window_launches, encode.launches,
                  decode.dict_launches, decode.launches)
        check(back == win_data, f"32 MiB {name} frame device round trip")
        check(counts[:2] == (math.ceil(n_win / ROWS), 0),
              f"{name}: K2b ran once per writer batch ({counts})")
        if d is not None:
            k3_launches = counts[2]
            check(counts[2:] == (math.ceil(n_win / read_batch), 0),
                  f"{name}: K3 ran once per reader batch ({counts})")
        else:  # linked frames decode serially on the host, as in plz4_tpu
            check(counts[2:] == (0, 0), f"{name}: no decode launch")
        check(plz4.decompress(f, backend="native", dictionary=d) == win_data,
              f"{name} device frame decodes with backend=native")
        head = win_data[: 8 << 20]
        check(plz4.compress(head, **o) == plz4.compress(head, device="cpu",
                                                        **o),
              f"{name}: the first 8 MiB frame equals the device=cpu frame")

    # ---- 11. K2c, K2d and K4 against their plain versions ---------------
    main_host = tuple(torch.from_numpy(x) for x in rows_of(main_rows, BLOCK))
    edge_host = tuple(torch.from_numpy(x) for x in rows_of(edges, BLOCK))
    chunk_what = f"{2 * CHUNKS} chunk rows of two 4 MiB blocks"
    window_what = ("rows with a full, a partial and an empty 64 KiB window "
                   "and a short block")
    # rows aimed at the chain parse's warp steps: 8 KiB plain rows, and 64
    # KiB rows after 64 KiB windows (depth 4 keeps two tables in device
    # memory there), at preload strides 1 and 2
    step_plain, step_far = corpus.chain_edge_rows()
    step_host = tuple(torch.from_numpy(x) for x in
                      rows_of(list(step_plain.values()), 8192))
    fa, fn = rows_of([b for b, _, _ in step_far.values()], BLOCK)
    fw, _ = rows_of([w for _, w, _ in step_far.values()], BLOCK)
    far_host = (torch.from_numpy(fa), torch.from_numpy(fn),
                torch.from_numpy(fw),
                torch.tensor([u for _, _, u in step_far.values()],
                             dtype=torch.int32))
    mid = {}  # depth4 -> (ms, plain ms, max err, plain totals, chunk ms)
    for depth4, name in ((False, "K2c"), (True, "K2d")):
        m_in, _, m_plain, m_plain_ms, m_err = both(
            name, encode_mid.encode_batch_mid,
            encode_mid.encode_batch_mid_plain,
            main_host, f"{ROWS} main-path rows", depth4=depth4)
        errs = [m_err]
        errs.append(both(name, encode_mid.encode_batch_mid,
                         encode_mid.encode_batch_mid_plain, edge_host,
                         "the edge payloads", depth4=depth4)[4])
        c_in, _, _, _, c_err = both(
            name, encode_mid.encode_batch_mid_window,
            encode_mid.encode_batch_mid_window_plain, cw_host,
            chunk_what + " (wstride 2)", depth4=depth4,
            wstride=large.CHUNK_WSTRIDE, chunks=CHUNKS)
        errs.append(c_err)
        errs.append(both(name, encode_mid.encode_batch_mid_window,
                         encode_mid.encode_batch_mid_window_plain, w_host,
                         window_what + " (wstride 1)", depth4=depth4)[4])
        errs.append(both(name, encode_mid.encode_batch_mid,
                         encode_mid.encode_batch_mid_plain, step_host,
                         f"the {len(step_plain)} step edge rows",
                         depth4=depth4)[4])
        for ws in (1, 2):
            errs.append(both(name, encode_mid.encode_batch_mid_window,
                             encode_mid.encode_batch_mid_window_plain,
                             far_host, f"copies 65,534-65,536 bytes back "
                             f"from 64 KiB windows (wstride {ws})",
                             depth4=depth4, wstride=ws)[4])
        kw = dict(wstride=large.CHUNK_WSTRIDE, chunks=CHUNKS)
        r_kern = encode_mid.encode_batch_mid_window(
            *[x.to(dev) for x in rnd_host], depth4, **kw)
        r_plain = encode_mid.encode_batch_mid_window_plain(*rnd_host, depth4,
                                                           **kw)
        r_tot = r_plain[1].numpy()
        fits = r_tot < r_plain[0].shape[1]
        check(bool((fits & ~r_plain[2].numpy()).any()),
              "the random chunk does not shrink")
        errs.append(max_err(r_kern, r_plain, np.where(fits, r_tot, 0)))
        check(errs[-1] == 0, f"{name} stream bytes equal plain wherever "
              f"total < CAP on a block with a random chunk (max abs err "
              f"{errs[-1]})")
        ms = cuda_ms(lambda: encode_mid.encode_batch_mid(*m_in, depth4), 5)
        c_ms = cuda_ms(lambda: encode_mid.encode_batch_mid_window(
            *c_in, depth4, large.CHUNK_WSTRIDE, CHUNKS), 5)
        mid[depth4] = (ms, m_plain_ms, max(errs), m_plain[1].numpy(), c_ms)
        del m_in, c_in
    for level in (1, 3, 8):
        f = plz4.compress(rnd_block, backend="device", level=level)
        check(f == plz4.compress(rnd_block, backend="device", level=level,
                                 device="cpu") and len(f) < len(rnd_block),
              f"level {level}: a 4 MiB-block frame with a random chunk "
              "equals the device=cpu frame")
        check(plz4.decompress(f, backend="device") == rnd_block
              and plz4.decompress(f, backend="native") == rnd_block,
              f"level {level}: the frame with a random chunk round-trips")
    deep = {}  # tries -> (ms, plain ms, max err, plain totals, chunk ms)
    for tries in (2, 32):
        d_in, _, d_plain, d_plain_ms, d_err = both(
            "K4", encode_deep.encode_batch_deep,
            encode_deep.encode_batch_deep_plain, main_host,
            f"{ROWS} main-path rows (tries {tries}, hash_log 15)",
            tries=tries)
        errs = [d_err]
        errs.append(both("K4", encode_deep.encode_batch_deep,
                         encode_deep.encode_batch_deep_plain, edge_host,
                         f"the {len(edges)} edge payloads (tries {tries})",
                         tries=tries)[4])
        c_in, _, _, _, c_err = both(
            "K4", encode_deep.encode_batch_deep_window,
            encode_deep.encode_batch_deep_window_plain, cw_host,
            f"{chunk_what} (tries {tries}, hash_log 14, 32 KiB windows)",
            tries=tries, chunks=CHUNKS)
        errs.append(c_err)
        errs.append(both("K4", encode_deep.encode_batch_deep_window,
                         encode_deep.encode_batch_deep_window_plain, w_host,
                         f"{window_what} (tries {tries}, hash_log 14)",
                         tries=tries)[4])
        ms = cuda_ms(lambda: encode_deep.encode_batch_deep(*d_in, tries), 3)
        c_ms = cuda_ms(lambda: encode_deep.encode_batch_deep_window(
            *c_in, tries, CHUNKS), 3)
        deep[tries] = (ms, d_plain_ms, max(errs), d_plain[1].numpy(), c_ms)
        del d_in, c_in
    print(f"K4 plain-version rows held: {ROWS} main-path, {len(edges)} edge, "
          f"{2 * CHUNKS} chunk and {len(w_rows)} window rows at tries 2 and "
          "32")
    print(f"ms per batch [{smi}]: K2c {mid[False][0]:.3f} ({ROWS} rows), "
          f"{mid[False][4]:.3f} ({2 * CHUNKS} chunk rows); K2d "
          f"{mid[True][0]:.3f}, {mid[True][4]:.3f} (chunk rows: two tables "
          f"in device memory); K4 tries 2 {deep[2][0]:.3f}, {deep[2][4]:.3f} "
          f"(chunk rows); K4 tries 32 {deep[32][0]:.3f}, {deep[32][4]:.3f}")

    def row_bound(totals):
        """The byte bound of an encode over ROWS main-path rows."""
        return bound_ms(ROWS * BLOCK + 8 * ROWS + int(totals.sum()) + ROWS,
                        OPS_PER_BYTE * ROWS * BLOCK)

    # ---- 12. bench-corpus ratio per level --------------------------------
    bench_dev = [torch.from_numpy(x).to(dev) for x in rows_of(bench_rows,
                                                               BLOCK)]
    for level, want in LEVEL_RATIOS.items():
        _, tot, okl = batch.dispatch_encode(*bench_dev, level)
        tot = tot.cpu().numpy()
        r = 32 * BLOCK / int(tot.sum())
        check(bool(okl.cpu().numpy().all()) and round(r, 4) == want,
              f"level {level} bench-corpus ratio {r:.4f} == {want}")

    # ---- 13. this slice's main path: 256 MiB at level 9 ------------------
    del frame4, back4, native4
    k4_launches = 0
    for label, o9, warm_n, k4_key, n_batches, k4_ms in (
            ("64 KiB", dict(backend="device", level=9,
                            block_size_idx=plz4.BLOCK_IDX_64KB),
             ROWS * BLOCK, "encode_deep.launches", n_blocks // ROWS,
             deep[2][0]),
            ("4 MiB", dict(backend="device", level=9), 2 * BIG,
             "encode_deep.window_launches", n_big // 2, deep[2][4])):
        warm = main_data[:warm_n]
        check(plz4.decompress(plz4.compress(warm, **o9),
                              backend="device") == warm,
              f"level 9 warm-up round trip at {label} blocks")
        torch.cuda.synchronize()
        reset()
        f9, t_enc9 = host_ms(lambda: plz4.compress(main_data, **o9))
        torch.cuda.synchronize()
        enc_counts = read()
        reset()
        b9, t_dec9 = host_ms(lambda: plz4.decompress(f9, backend="device"))
        torch.cuda.synchronize()
        dec_counts = read()
        check(b9 == main_data, f"256 MiB level-9 round trip at {label} "
                               "blocks is intact")
        others = {k: v for k, v in enc_counts.items()
                  if k != k4_key and v}
        check(enc_counts[k4_key] == n_batches and not others,
              f"level 9 at {label}: K4 once per Writer batch "
              f"({enc_counts[k4_key]} of {n_batches}), no other encode "
              f"launch ({others})")
        if label == "64 KiB":
            k4_launches = enc_counts[k4_key]
        check(plz4.decompress(f9, backend="native") == main_data,
              f"level-9 {label} frame decodes with backend=native")
        head = main_data[: 1 << 20]
        check(plz4.compress(head, **o9) == plz4.compress(head, device="cpu",
                                                         **o9),
              f"level 9 at {label}: the first 1 MiB frame equals the "
              "device=cpu frame")
        dec_used = {k: v for k, v in dec_counts.items() if v}
        print(f"level-9 main path {label} [{smi}]: encode "
              f"{gb / (t_enc9 / 1e3):.3f} GB/s ({t_enc9:.1f} ms), decode "
              f"{gb / (t_dec9 / 1e3):.3f} GB/s ({t_dec9:.1f} ms); frame "
              f"ratio {len(main_data) / len(f9):.4f}; decode launches "
              f"{dec_used}; K4 share of encode wall {enc_counts[k4_key]} x "
              f"{k4_ms:.3f} ms = "
              f"{100 * enc_counts[k4_key] * k4_ms / t_enc9:.1f}%")
        del f9, b9

    # ---- 14. the rest of the ladder at 32 MiB ----------------------------
    ladder_launches = {}
    kb64 = dict(block_size_idx=plz4.BLOCK_IDX_64KB)
    n_batch32 = math.ceil(n_win / ROWS)
    # cell, options, the launch counter, its launches, the kernel and its ms
    # per launch from phase 11 (None: no share printed)
    for name, o, key, want, kern_ms in (
            ("level 3", dict(level=3) | kb64, "encode_mid.launches",
             n_batch32, ("K2c", mid[False][0])),
            ("level 8", dict(level=8) | kb64, "encode_mid.launches",
             n_batch32, ("K2d", mid[True][0])),
            ("level 12", dict(level=12) | kb64, "encode_deep.launches",
             n_batch32, None),
            ("level 8 at 4 MiB blocks", dict(level=8),
             "encode_mid.window_launches", len(win_data) // BIG // 2,
             ("K2d", mid[True][4])),
            ("linked level 6", dict(level=6, block_linked=True) | kb64,
             "encode_mid.window_launches", n_batch32, None),
            ("dictionary level 9", dict(level=9, dictionary=dict64) | kb64,
             "encode_deep.window_launches", n_batch32, None)):
        d = o.get("dictionary")
        reset()
        torch.cuda.reset_peak_memory_stats()
        f, t_e = host_ms(lambda: plz4.compress(win_data, backend="device",
                                               **o))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = read()
        back = plz4.decompress(f, backend="device", dictionary=d)
        torch.cuda.synchronize()
        check(back == win_data, f"32 MiB {name} frame device round trip")
        others = {k: v for k, v in counts.items() if k != key and v}
        check(counts[key] == want and not others,
              f"{name}: {key} {counts[key]} of {want}, no other encode "
              f"launch ({others})")
        check(plz4.decompress(f, backend="native", dictionary=d) == win_data,
              f"{name} device frame decodes with backend=native")
        ladder_launches[name] = counts[key]
        share = ""
        if kern_ms:
            share = (f"; {kern_ms[0]} share of encode wall {counts[key]} x "
                     f"{kern_ms[1]:.3f} ms = "
                     f"{100 * counts[key] * kern_ms[1] / t_e:.1f}%")
        print(f"{name} [{smi}]: encode {len(win_data) / 1e6 / t_e:.3f} GB/s, "
              f"frame ratio {len(win_data) / len(f):.4f}, peak device memory "
              f"{peak / 2**20:.1f} MiB{share}")

    # ---- 15. K7 against its plain version and native.xxh32 --------------
    def hash_both(host_args, seed, what, blocks):
        """K7 and its plain version on the same rows, held to each other and
        to native.xxh32 of each row's bytes. Returns (plain ms, err)."""
        kern = xxh32.xxh32_batch(*[x.to(dev) for x in host_args], seed).cpu()
        plain, p_ms = host_ms(lambda: xxh32.xxh32_batch_plain(*host_args,
                                                              seed))
        err = int((kern - plain).abs().max()) if len(kern) else 0
        check(err == 0 and kern.tolist() == [native.xxh32(b, seed)
                                             for b in blocks],
              f"K7 equals plain and native.xxh32 on {what}, seed {seed:#x} "
              f"(max abs err {err})")
        return p_ms, err

    k2a_out, k2a_tot = e_kern[0].cpu(), e_kern[1].cpu()
    k2a_tot = k2a_tot.clamp(max=k2a_out.shape[1])
    k2a_blocks = [k2a_out[i, :k2a_tot[i]].numpy().tobytes()
                  for i in range(ROWS)]
    edge_blocks = [main_data[:n] for n in range(41)] + [main_data[:BLOCK]]
    edge_rows = tuple(torch.from_numpy(x)
                      for x in rows_of(edge_blocks, BLOCK + 3))
    # rows whose starts fall off 16-byte boundaries (every residue of the
    # width mod 4 and mod 16; 65,860 is CAP of a 64 KiB row), at lengths on
    # and beside K7's 4 KiB staging chunks
    xxh_blocks = edge_blocks[:41] + [main_data[:n] for n in (
        4095, 4096, 4097, 8191, 8192, 8193, 16383, 16384, 16385, 65535,
        BLOCK)]
    xxh_widths = (65537, 65538, 65539, 65544, 65548, encode.out_width(BLOCK))
    k7_err = 0
    for seed in (0, 0x9E3779B1):
        p_ms, e1 = hash_both(main_host, seed, f"{ROWS} main-path rows",
                             main_rows)
        if seed == 0:
            k7_plain_ms = p_ms
        e2 = hash_both((k2a_out, k2a_tot), seed,
                       f"K2a's {ROWS} output rows with their totals",
                       k2a_blocks)[1]
        e3 = hash_both(edge_rows, seed, "lengths 0-40 and 65,536 in rows of "
                       "65,539 bytes", edge_blocks)[1]
        k7_err = max(k7_err, e1, e2, e3)
        want = [native.xxh32(b, seed) for b in xxh_blocks]
        plain = None
        for W in xxh_widths:
            a, n = rows_of(xxh_blocks, W)
            if plain is None:
                plain = xxh32.xxh32_batch_plain(torch.from_numpy(a),
                                                torch.from_numpy(n), seed)
            # the rows on the card at their allocation's start and 3 bytes
            # into it: row r starts at off + r W
            flat = torch.zeros(a.size + 3, dtype=torch.uint8, device=dev)
            for off in (0, 3):
                flat[off:off + a.size] = torch.from_numpy(a).view(-1).to(dev)
                kern = xxh32.xxh32_batch(flat[off:off + a.size].view(a.shape),
                                         torch.from_numpy(n).to(dev),
                                         seed).cpu()
                err = int((kern - plain).abs().max())
                check(err == 0 and plain.tolist() == want,
                      f"K7 equals plain and native.xxh32 on chunk-edge "
                      f"lengths in rows of {W} bytes at offset {off}, seed "
                      f"{seed:#x} (max abs err {err})")
                k7_err = max(k7_err, err)
    main_dev = [x.to(dev) for x in main_host]
    k7_ms = cuda_ms(lambda: xxh32.xxh32_batch(*main_dev), 20)
    k7_bound = bound_ms(ROWS * BLOCK + 4 * ROWS + 8 * ROWS,
                        XXH_OPS_PER_BYTE * ROWS * BLOCK)
    print(f"K7 [{smi}]: {k7_ms:.4f} ms per {ROWS}-row batch of 64 KiB "
          f"(bound {k7_bound[0]:.4f} ms by {k7_bound[1]}; plain "
          f"{k7_plain_ms:.1f} ms)")
    del main_dev

    # ---- 16. K6b and K6a against their plain versions -------------------
    wide_blocks = [main_data[i * WIDE:(i + 1) * WIDE] for i in range(8)]
    w256 = tuple(torch.from_numpy(x) for x in rows_of(wide_blocks, WIDE))
    w256_win = (torch.from_numpy(rows_of([dict64] * 8, BLOCK)[0]),
                torch.tensor([BLOCK, 3000, 0, BLOCK, BLOCK, 517, BLOCK, 12],
                             dtype=torch.int32))
    big2 = tuple(torch.from_numpy(x) for x in rows_of(big_blocks, BIG))
    rnd = np.random.default_rng(41)
    # the first K6b width of each route (the byte-wide kernels take 4 bytes
    # less): plain and after a 64 KiB window
    edge_widths = {(False, 0): 101144, (True, 0): 109320,
                   (False, BLOCK): 68440, (True, BLOCK): 76616}
    k6b = {}  # mid -> (plain ms of 8 x 256 KiB, max err, plain of big2)
    for mid_mode, name in ((False, "K6b greedy"), (True, "K6b mid")):
        run = functools.partial(both, name, encode_wide.encode_batch_wide,
                                encode_wide.encode_batch_wide_plain,
                                mid=mid_mode)
        _, k256, _, p_ms, e1 = run(w256, f"8 rows of {WIDE >> 10} KiB")
        errs = [e1, run(w256 + w256_win, f"8 rows of {WIDE >> 10} KiB after "
                        "full, partial and empty 64 KiB windows")[4]]
        _, _, p_big, _, e3 = run(big2, "2 rows of 4 MiB")
        errs.append(e3)
        for (m, Dw), W in edge_widths.items():
            if m != mid_mode:
                continue
            ea = rows_of([main_data[:W], rnd.integers(
                0, 256, W, dtype=np.uint8).tobytes()], W)
            args = tuple(torch.from_numpy(x) for x in ea)
            if Dw:
                args += (torch.from_numpy(rows_of([dict64] * 2, BLOCK)[0]),
                         torch.tensor([BLOCK, 999], dtype=torch.int32))
            errs.append(run(args, f"the first K6b width {W} after a "
                                  f"{Dw}-byte window")[4])
        # the greedy or chain edge rows at the first K6b widths, alone and
        # at the end of full rows, plain and after their 64 KiB windows
        (eb, en), (wb, wn, wwins, wwl) = corpus.wide_edge_rows(mid_mode)
        errs.append(run(tuple(torch.from_numpy(x) for x in rows_of(eb, en)),
                        f"{len(eb)} edge rows of {en} bytes")[4])
        errs.append(run(tuple(torch.from_numpy(x) for x in rows_of(wb, wn))
                        + (torch.from_numpy(np.stack(
                            [np.frombuffer(w, np.uint8) for w in wwins])),
                           torch.tensor(wwl, dtype=torch.int32)),
                        f"{len(wb)} far-window edge rows of {wn} bytes")[4])
        k6b[mid_mode] = (p_ms, max(errs), p_big)
        if not mid_mode:
            k6b_256 = k256

    def dec_wide_both(streams, cap, what):
        C_ = max(16, (max(len(x) for x in streams) + 16 + 3) & ~3)
        a, n = rows_of(streams, C_)
        return dec_wide_rows(torch.from_numpy(a), torch.from_numpy(n), cap,
                             what)

    def dec_wide_rows(ha, hn, cap, what):
        kern = decode.decode_batch(ha.to(dev), hn.to(dev), cap)
        torch.cuda.synchronize()
        plain, p_ms = host_ms(lambda: decode.decode_batch_wide_plain(
            ha, hn, cap))
        okw = plain[2].numpy()
        check(bool((kern[1].cpu().numpy() == plain[1].numpy()).all()
                   and (kern[2].cpu().numpy() == okw).all()),
              f"K6a ok/n_out equal plain on {what}")
        err = max_err(kern, plain, np.where(okw, plain[1].numpy(), 0))
        check(err == 0, f"K6a bytes [0, n_out) equal plain where ok on "
                        f"{what} (max abs err {err})")
        return plain, p_ms, err

    wout, wtot, wok = (t.cpu() for t in k6b_256)
    src256 = [b for i, b in enumerate(wide_blocks) if wok[i]] + wide_blocks
    s256 = [wout[i, :wtot[i]].numpy().tobytes() for i in range(8) if wok[i]]
    s256 += [native.compress(b, level=1) for b in wide_blocks]
    lit_run = WIDE + 4000  # a literal run past out_cap after 9 bytes
    bad256 = [bytes([0x14, 0x41, 1, 0, 0xF0]) + b"\xff" * (lit_run // 255)
              + bytes([lit_run % 255]) + b"b" * 64, bytes([0x04, 0, 0]),
              bytes([0x14, 0x41, 1, 0])]
    corrupt256 = corrupt_streams(s256, seed=0x6A)
    p6a, _, e6a_1 = dec_wide_both(s256 + bad256 + corrupt256, WIDE,
                                  f"{len(s256)} K6b and native streams, "
                                  "bad-literal, zero-offset, match-ended, "
                                  "corrupt and truncated streams")
    ok6, n6 = p6a[2].numpy(), p6a[1].numpy()
    ns = len(s256)
    check(bool(ok6[:ns].all()) and not ok6[ns:ns + 3].any()
          and int(n6[ns]) > WIDE,
          "K6a verdicts: valid streams ok, bad ones refused, the bad literal "
          f"run reports n_out {int(n6[ns])} > out_cap {WIDE}")
    check(all(p6a[0][i].numpy().tobytes() == src256[i] for i in range(ns)),
          "K6a rebuilds the 256 KiB blocks")
    s4 = [native.compress(b, level=1) for b in big_blocks]
    trunc4 = [s4[0][: len(s4[0]) // 3], bytearray(s4[1])]
    trunc4[1][len(s4[1]) // 2] ^= 0xFF
    p6b, k6a_plain_ms, e6a_2 = dec_wide_both(
        s4 + [bytes(x) for x in trunc4], BIG,
        "native 4 MiB blocks, truncated and flipped")
    check(all(p6b[0][i].numpy().tobytes() == big_blocks[i] for i in (0, 1))
          and not p6b[2].numpy()[2], "K6a decodes the native 4 MiB blocks")
    k6a_err = max(e6a_1, e6a_2)
    # the rows aimed at the parse hand-over and the copy steps with the row
    # and the output in device memory: short offsets, ring wraps (over 200
    # times in a 4 MiB row of 440,000 sequences), clen past C, out_cap
    # crossings, bad literal runs and rows that run to C, each followed by
    # a sentinel or a nonzero row
    for name, (a, n, cap) in corpus.wide_decode_edge_rows().items():
        pe, _, e = dec_wide_rows(torch.from_numpy(a), torch.from_numpy(n),
                                 cap, f"the {len(n)} {name} rows "
                                 f"(out_cap {cap >> 10} KiB)")
        k6a_err = max(k6a_err, e)
        if name in ("bad-literal", "big-4m"):
            okp = pe[2].numpy()
            sent = [i for i in range(1, len(n)) if okp[i] and not okp[i - 1]]
            check(bool(len(sent)) and all(
                torch.equal(pe[0][i, :pe[1][i]], pe[0][sent[0], :pe[1][i]])
                for i in sent),
                f"{name}: the sentinel rows after the bad rows are intact")

    # ---- 17. the whole-block codec at full width: 64 rows of 4 MiB ------
    from plz4_tpu_torch.frame import block_io, header, trailer

    def synced(fn):
        r = fn()
        torch.cuda.synchronize()
        return r

    torch.cuda.reset_peak_memory_stats()
    n_wide = len(main_data) // BIG
    wd = torch.from_numpy(np.frombuffer(main_data, np.uint8).reshape(
        n_wide, BIG).copy()).to(dev)
    wl = torch.full((n_wide,), BIG, dtype=torch.int32, device=dev)
    synced(lambda: encode.encode_batch(wd[:1], wl[:1]))  # warm-up
    reset()
    (wout, wtot, wok), t_wenc = host_ms(
        lambda: synced(lambda: encode.encode_batch(wd, wl)))
    check(bool(wok.all()), f"K6b compressed all {n_wide} rows of 4 MiB")
    C_w = (int(wtot.max()) + 16 + 3) & ~3
    comp = wout[:, :C_w] * (torch.arange(C_w, device=dev)[None]
                            < wtot[:, None])
    (dout, dn, dok), t_wdec = host_ms(
        lambda: synced(lambda: decode.decode_batch(comp, wtot, BIG)))
    wide_counts = {k: v for k, v in read().items() if v}
    check(bool(dok.all()) and bool((dn == BIG).all())
          and torch.equal(dout, wd),
          f"{n_wide} x 4 MiB rows round trip through K6b and K6a intact")
    check(wide_counts == {"encode_wide.launches": 1,
                          "decode.wide_launches": 1},
          f"exactly one K6b and one K6a launch ({wide_counts})")
    gb = len(main_data) / 1e9
    print(f"whole-block codec [{smi}]: {n_wide} x 4 MiB, encode "
          f"{gb / (t_wenc / 1e3):.3f} GB/s ({t_wenc:.1f} ms), decode "
          f"{gb / (t_wdec / 1e3):.3f} GB/s ({t_wdec:.1f} ms); ratio "
          f"{len(main_data) / int(wtot.sum()):.4f}")
    # frame the streams as a standard 4 MiB-BD frame, block checksums by K7
    h_comp = xxh32.xxh32_batch(wout, wtot).cpu().tolist()
    wt = wtot.cpu().tolist()
    parts = [header.write_header(block_size_idx=plz4.BLOCK_IDX_4MB,
                                 block_checksum=True)]
    for i in range(n_wide):
        parts.append(block_io.frame_block(
            comp[i, :wt[i]].cpu().numpy().tobytes(), False, True,
            checksum=h_comp[i]))
    parts.append(trailer.write_trailer(native.xxh32(main_data)))
    wide_frame = b"".join(parts)
    check(plz4.decompress(wide_frame, backend="native") == main_data,
          "the K6b streams framed as a 4 MiB frame decode with native")
    del comp, dout, parts, wide_frame
    # the level-8 request: mid mode at depth 2, as the Pallas wrapper runs it
    reset()
    (mout, mtot, mok), t_menc = host_ms(
        lambda: synced(lambda: encode_mid.encode_batch_mid(wd, wl,
                                                           depth4=True)))
    mid_counts = {k: v for k, v in read().items() if v}
    check(mid_counts == {"encode_wide.mid_launches": 1},
          f"a level-8 request at 4 MiB: one K6b launch in mid mode "
          f"({mid_counts})")
    p_big = k6b[True][2]
    mo, mt, mk = mout[:2].cpu(), mtot[:2].cpu(), mok[:2].cpu()
    check(torch.equal(mt, p_big[1]) and torch.equal(mk, p_big[2])
          and all(torch.equal(mo[i, :mt[i]], p_big[0][i, :mt[i]])
                  for i in range(2)),
          "its first two streams equal the depth-2 plain version's")
    print(f"whole-block codec level 8 [{smi}]: encode "
          f"{gb / (t_menc / 1e3):.3f} GB/s ({t_menc:.1f} ms), ratio "
          f"{len(main_data) / int(mtot.sum()):.4f}")
    del mout
    k6b_ms = cuda_ms(lambda: encode.encode_batch(wd, wl), 1)
    k6b_mid_ms = cuda_ms(lambda: encode_mid.encode_batch_mid(wd, wl, True), 1)
    comp = wout[:, :C_w] * (torch.arange(C_w, device=dev)[None]
                            < wtot[:, None])
    k6a_ms = cuda_ms(lambda: decode.decode_batch(comp, wtot, BIG), 1)
    k6b_bound = bound_ms(len(main_data) + 8 * n_wide + int(wtot.sum())
                         + 5 * n_wide, OPS_PER_BYTE * len(main_data))
    k6b_mid_bound = bound_ms(len(main_data) + 8 * n_wide + int(mtot.sum())
                             + 5 * n_wide, OPS_PER_BYTE * len(main_data))
    k6a_bound = bound_ms(int(wtot.sum()) + 4 * n_wide + len(main_data)
                         + 5 * n_wide, OPS_PER_BYTE * len(main_data))
    print(f"ms per {n_wide} x 4 MiB launch [{smi}]: K6b greedy "
          f"{k6b_ms:.1f}, K6b mid {k6b_mid_ms:.1f}, K6a {k6a_ms:.1f}")
    peak17 = torch.cuda.max_memory_allocated()
    # K7's chain bound: a row's stripes x the cycles of one accumulator's
    # step (each accumulator takes every stripe in turn; a probe kernel of
    # tools/xxh32_stamps_torch.py) / the SM clock measured beside it
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import xxh32_stamps_torch

    k7_chain = xxh32_stamps_torch.chain_bound_ms(xxh32_stamps_torch.load(),
                                                 BLOCK // 16)
    print(f"phase 17 [{smi}]: K6b greedy {k6b_ms:.3f} ms per {n_wide} x "
          f"4 MiB launch (bound {k6b_bound[0]:.4f} ms by {k6b_bound[1]}), "
          f"K6b depth 2 {k6b_mid_ms:.3f} (bound {k6b_mid_bound[0]:.4f} by "
          f"{k6b_mid_bound[1]}); K7 {k7_ms:.4f} ms per {ROWS} x 64 KiB "
          f"(bound {k7_bound[0]:.4f} by {k7_bound[1]}, chain bound "
          f"{k7_chain[0]:.4f}: {BLOCK // 16} stripes x {k7_chain[1]:.2f} "
          f"cycles / {k7_chain[2]:.0f} MHz); peak device memory of this "
          f"phase {peak17 / 2**20:.1f} MiB")
    del wd, wl, wout, comp, mtot
    torch.cuda.empty_cache()

    # ---- 18. block checksums at full width --------------------------------
    optsc = dict(backend="device", level=1,
                 block_size_idx=plz4.BLOCK_IDX_64KB, block_checksum=True)
    head = main_data[: 8 << 20]
    fc_head = plz4.compress(head, **optsc)
    check(plz4.decompress(fc_head, backend="device") == head,
          "warm-up round trip with block checksums")
    check(fc_head == plz4.compress(head, device="cpu", **optsc),
          "block checksums: the first 8 MiB frame equals the device=cpu "
          "frame")
    real_xxh32 = native.xxh32
    host_hashes = [0]

    def counting(data, seed=0):
        host_hashes[0] += 1
        return real_xxh32(data, seed)

    native.xxh32 = counting
    try:
        reset()
        frame_c, t_encc = host_ms(lambda: plz4.compress(main_data, **optsc))
        torch.cuda.synchronize()
        enc_counts, enc_hashes = read(), host_hashes[0]
        reset()
        back_c, t_decc = host_ms(lambda: plz4.decompress(frame_c,
                                                         backend="device"))
        torch.cuda.synchronize()
        dec_counts, dec_hashes = read(), host_hashes[0] - enc_hashes
    finally:
        native.xxh32 = real_xxh32
    check(back_c == main_data, "256 MiB frame with block checksums: device "
                               "round trip intact")
    check(enc_hashes == 0 and dec_hashes == 0,
          f"zero host native.xxh32 block hashes on write ({enc_hashes}) and "
          f"read ({dec_hashes})")
    k7_enc, k7_dec = enc_counts["xxh32.launches"], dec_counts["xxh32.launches"]
    check(k7_enc == 2 * math.ceil(n_blocks / ROWS)
          and enc_counts["encode.launches"] == math.ceil(n_blocks / ROWS),
          f"K7 twice per Writer batch ({k7_enc}), K2a once "
          f"({enc_counts['encode.launches']})")
    check(k7_dec == math.ceil(n_blocks / read_batch) == dec_counts[
        "decode.launches"], f"K7 once per Reader batch ({k7_dec})")
    k7_launches = k7_enc + k7_dec
    check(plz4.decompress(frame_c, backend="native") == main_data,
          "the checksummed device frame decodes with backend=native")
    native_c = plz4.compress(main_data, backend="native",
                             block_size_idx=plz4.BLOCK_IDX_64KB,
                             block_checksum=True)
    check(plz4.decompress(native_c, backend="device") == main_data,
          "a native block-checksummed frame decodes on the device")
    bad = bytearray(frame_c)
    bad[7 + 4 + 1000] ^= 0x20  # inside the first block's payload
    try:
        plz4.decompress(bytes(bad), backend="device")
        raised = None
    except plz4.errors.Lz4Error as e:
        raised = e
    check(raised is plz4.errors.ErrBlockHash,
          f"a flipped byte in a block raises ErrBlockHash ({raised!r})")
    print(f"block checksums [{smi}]: encode {gb / (t_encc / 1e3):.3f} GB/s, "
          f"decode {gb / (t_decc / 1e3):.3f} GB/s through Writer/Reader; "
          f"frame ratio {len(main_data) / len(frame_c):.4f}; K7 launches "
          f"{k7_enc} + {k7_dec}, K7's share of the walls at "
          f"{k7_ms:.4f} ms a launch: encode "
          f"{100 * k7_enc * k7_ms / t_encc:.2f}%, decode "
          f"{100 * k7_dec * k7_ms / t_decc:.2f}%")
    del frame_c, back_c, native_c, bad
    for name, o in (("4 MiB blocks", dict(block_checksum=True, level=1)),
                    ("a dictionary", dict(optsc, dictionary=dict64))):
        o = dict(o, backend="device")
        d = o.get("dictionary")
        f = plz4.compress(win_data, **o)
        check(plz4.decompress(f, backend="device", dictionary=d) == win_data
              and plz4.decompress(f, backend="native", dictionary=d)
              == win_data, f"32 MiB frame with block checksums and {name} "
                           "round trip")

    # ---- 19. sharded frames and the entry points -------------------------
    sharded_phase(plz4, smi, reset, read, dict64)

    # ---- 20. the array path and the CLI ----------------------------------
    array_phase(plz4, smi, reset, read, dict64)

    mid_bound = {d4: row_bound(mid[d4][3]) for d4 in mid}
    deep_bound = row_bound(deep[2][3])
    kernels = [
        dict(name="K2a greedy block encode", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_encode.cu",
             replaces="plz4_tpu/ops/encode_pallas.py:397",
             launches=enc_launches, max_abs_err=max(enc_err, x_err),
             ms=enc_ms, plain_ms=enc_plain_ms, bound_ms=enc_bound[0],
             bound_by=enc_bound[1], library_ms=None),
        dict(name="K1 block decode", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_decode.cu",
             replaces="plz4_tpu/ops/decode_pallas.py:1091",
             launches=dec_launches, max_abs_err=max(dec_err, c_err),
             ms=dec_ms, plain_ms=dec_plain_ms, bound_ms=dec_bound[0],
             bound_by=dec_bound[1], library_ms=None),
        dict(name="K2b window-prefix greedy encode", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_encode_window.cu",
             replaces="plz4_tpu/ops/encode_pallas.py:862",
             launches=k2b_launches, max_abs_err=max(encw_err, ww_err),
             ms=encw_ms, plain_ms=encw_plain_ms, bound_ms=encw_bound[0],
             bound_by=encw_bound[1], library_ms=None),
        dict(name="K3 dictionary block decode", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_decode_window.cu",
             replaces="plz4_tpu/ops/decode_pallas.py:326",
             launches=k3_launches, max_abs_err=max(k3_err, x3_err),
             ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=None),
        dict(name="K5 carry-record decode", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_decode_window.cu",
             replaces="plz4_tpu/ops/decode_pallas.py:784",
             launches=k5_launches, max_abs_err=max(k5_err, k5c_err),
             ms=k5_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound[0],
             bound_by=k5_bound[1], library_ms=None),
        # K6c computes K5's function; the port runs both as K5's kernel
        dict(name="K6c carry-record decode (K5's CUDA kernel)", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_decode_window.cu",
             replaces="plz4_tpu/ops/decode_pallas.py:731",
             launches=k5_launches, max_abs_err=max(k5_err, k5c_err),
             ms=k5_ms, plain_ms=k5_plain_ms, bound_ms=k5_bound[0],
             bound_by=k5_bound[1], library_ms=None),
        dict(name="K2c depth-2 chain encode (levels 3-7)", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_encode_mid.cu",
             replaces="plz4_tpu/ops/encode_pallas.py:570",
             launches=ladder_launches["level 3"], max_abs_err=mid[False][2],
             ms=mid[False][0], plain_ms=mid[False][1],
             bound_ms=mid_bound[False][0], bound_by=mid_bound[False][1],
             library_ms=None),
        dict(name="K2d depth-4 chain encode (level 8)", route="cuda",
             source="plz4_tpu_torch/csrc/lz4_encode_mid.cu",
             replaces="plz4_tpu/ops/encode_pallas.py:580",
             launches=ladder_launches["level 8"], max_abs_err=mid[True][2],
             ms=mid[True][0], plain_ms=mid[True][1],
             bound_ms=mid_bound[True][0], bound_by=mid_bound[True][1],
             library_ms=None),
        dict(name="K4 deep hash-chain encode (levels 9-12; tries 2)",
             route="cuda", source="plz4_tpu_torch/csrc/lz4_encode_deep.cu",
             replaces="plz4_tpu/ops/encode_pallas.py:1031",
             launches=k4_launches, max_abs_err=max(deep[2][2], deep[32][2]),
             ms=deep[2][0], plain_ms=deep[2][1], bound_ms=deep_bound[0],
             bound_by=deep_bound[1], library_ms=None),
        # the plain ms of K6b and K6a are over their 8 x 256 KiB and 2 x
        # 4 MiB held rows; ms and bound over the 64 x 4 MiB launch
        dict(name="K6b packed-word encode, greedy (rows over 96 KiB)",
             route="cuda", source="plz4_tpu_torch/csrc/lz4_encode_wide.cu",
             replaces="plz4_tpu/ops/encode_pallas.py:38",
             launches=wide_counts["encode_wide.launches"],
             max_abs_err=k6b[False][1], ms=k6b_ms, plain_ms=k6b[False][0],
             bound_ms=k6b_bound[0], bound_by=k6b_bound[1], library_ms=None),
        dict(name="K6b packed-word encode, depth-2 chain (levels 3-12)",
             route="cuda", source="plz4_tpu_torch/csrc/lz4_encode_wide.cu",
             replaces="plz4_tpu/ops/encode_pallas.py:38",
             launches=mid_counts["encode_wide.mid_launches"],
             max_abs_err=k6b[True][1], ms=k6b_mid_ms, plain_ms=k6b[True][0],
             bound_ms=k6b_mid_bound[0], bound_by=k6b_mid_bound[1],
             library_ms=None),
        dict(name="K6a whole-block decode (blocks over 96 KiB; a parse "
                  "thread feeding seven copy warps)",
             route="cuda", source="plz4_tpu_torch/csrc/lz4_decode_wide.cu",
             replaces="plz4_tpu/ops/decode_pallas.py:130",
             launches=wide_counts["decode.wide_launches"],
             max_abs_err=k6a_err, ms=k6a_ms, plain_ms=k6a_plain_ms,
             bound_ms=k6a_bound[0], bound_by=k6a_bound[1], library_ms=None),
        dict(name="K7 xxh32 over a batch (not Pallas)", route="cuda",
             source="plz4_tpu_torch/csrc/xxh32.cu",
             replaces="plz4_tpu/ops/xxh32_jax.py:42", launches=k7_launches,
             max_abs_err=k7_err, ms=k7_ms, plain_ms=k7_plain_ms,
             bound_ms=k7_bound[0], bound_by=k7_bound[1], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
