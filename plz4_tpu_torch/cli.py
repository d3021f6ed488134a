"""CLI: compress / decompress / verify / bakeoff.

Reference: cmd/plz4 (kong CLI): the same subcommands, aliases and flags,
argparse-based. stdin/stdout are used when no file is given; the `.lz4`
suffix is inferred (reference: cmd/plz4/internal/ops/target.go).

`--backend device` and `bakeoff --device` run the block codec as the CUDA
kernels on the GPU (`python -m plz4_tpu_torch` always does); main()'s
`device` keyword lets a caller in the same process ask for the kernels'
plain versions on the CPU instead (device="cpu"). The command line has no
flag for it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import Reader, Writer, errors as zerr
from .frame import descriptor as desc, header as hdr
from .opts import clamp_level
from .sparse import SparseWriter


def _parse_block_size(s: str) -> int:
    """Accept an index (4-7) or a byte size like 64KB/4MB (reference:
    ops/compress.go:213-227)."""
    s = s.strip().upper()
    if s in ("4", "5", "6", "7"):
        return int(s)
    mult = 1
    for suffix, m in (("KB", 1 << 10), ("K", 1 << 10), ("MB", 1 << 20),
                      ("M", 1 << 20), ("B", 1)):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
            mult = m
            break
    return desc.block_size_to_idx(int(s) * mult)


def _open_src(path: str | None):
    if path in (None, "-"):
        return sys.stdin.buffer, None
    return open(path, "rb"), path


def _open_dst(path: str | None, force: bool):
    if path in (None, "-"):
        return sys.stdout.buffer, None
    if os.path.exists(path) and not force:
        raise SystemExit(f"{path} exists; use -f to overwrite")
    return open(path, "wb"), path


def _infer_out(src: str | None, mode: str) -> str | None:
    if src in (None, "-"):
        return None
    if mode == "c":
        return src + ".lz4"
    if src.endswith(".lz4"):
        return src[:-4]
    return src + ".out"


def _common_opts(args) -> dict:
    opts = dict(parallel=args.cpus, backend=args.backend,
                device=args.torch_device)
    if args.dict:
        with open(args.dict, "rb") as f:
            opts["dictionary"] = f.read()
    return opts


def cmd_compress(args) -> int:
    src, src_path = _open_src(args.file)
    dst_path = args.output or _infer_out(src_path, "c")
    dst, _ = _open_dst(dst_path, args.force)
    opts = _common_opts(args)
    opts.update(
        level=clamp_level(args.level),
        block_size_idx=_parse_block_size(args.block_size),
        block_linked=args.block_linked,
        block_checksum=args.block_checksum,
        content_checksum=not args.no_content_checksum,
    )
    if args.content_size and src_path:
        opts["content_size"] = os.path.getsize(src_path)
    t0 = time.perf_counter()
    w = Writer(dst, **opts)
    n_in = w.read_from(src)
    w.close()
    dt = time.perf_counter() - t0
    n_out = w.dst_position
    if not args.quiet:
        ratio = n_in / n_out if n_out else 0.0
        print(
            f"in={n_in} out={n_out} ratio={ratio:.3f} "
            f"time={dt:.3f}s speed={n_in / 1e6 / max(dt, 1e-9):.1f} MB/s",
            file=sys.stderr,
        )
    if src_path:
        src.close()
    if dst_path:
        dst.close()
    return 0


def cmd_decompress(args) -> int:
    src, src_path = _open_src(args.file)
    dst_path = args.output or _infer_out(src_path, "d")
    dst, _ = _open_dst(dst_path, args.force)
    opts = _common_opts(args)
    t0 = time.perf_counter()
    r = Reader(src, **opts)
    if args.sparse and dst_path:
        sw = SparseWriter(dst)
        n_out = r.write_to(sw)
        sw.close()
    else:
        n_out = r.write_to(dst)
    r.close()
    dt = time.perf_counter() - t0
    n_in = r.positions[0]
    if not args.quiet:
        print(
            f"in={n_in} out={n_out} time={dt:.3f}s "
            f"speed={n_out / 1e6 / max(dt, 1e-9):.1f} MB/s",
            file=sys.stderr,
        )
    if src_path:
        src.close()
    if dst_path:
        dst.close()
    return 0


def cmd_verify(args) -> int:
    src, src_path = _open_src(args.file)
    opts = _common_opts(args)

    skip_frames = []

    def on_skip(rd, nibble, size):
        skip_frames.append((nibble, size))
        while size > 0:
            b = rd.read(min(size, 1 << 20))
            if not b:
                break
            size -= len(b)

    # header metadata dump (reference: ops/verify.go:170-198)
    if src_path:
        src.close()  # metadata dump + full decode use their own handles
        with open(src_path, "rb") as f:
            try:
                h = hdr.read_header(f, skip_callback=lambda r, n, s: r.read(s))
            except zerr.Lz4Error as e:
                print(f"invalid header: {e}", file=sys.stderr)
                return 1
        if h is not None:
            print(f"block size:        {h.block_size} (idx {h.block_size_idx})")
            print(f"block independent: {h.block_independent}")
            print(f"block checksum:    {h.block_checksum}")
            print(f"content checksum:  {h.content_checksum}")
            print(f"content size:      {h.content_size}")
            print(f"dict id:           {h.dict_id}")
        if args.header_only:
            return 0
        src = open(src_path, "rb")

    class _Discard:
        def write(self, b):
            return len(b)

    r = Reader(src, skip_callback=on_skip, **opts)
    try:
        n = r.write_to(_Discard())
    except zerr.Lz4Error as e:
        kind = "corrupted" if zerr.is_corrupted(e) else "truncated/invalid"
        print(f"verify FAILED ({kind}): {e}", file=sys.stderr)
        return 1
    finally:
        r.close()
        if src_path:
            src.close()
    for nibble, size in skip_frames:
        print(f"skippable frame: nibble={nibble} size={size}")
    print(f"OK: {n} bytes")
    return 0



def _check_roundtrip(out: bytes, data: bytes, label: str) -> None:
    """Bakeoff round-trip gate. An explicit check (not assert): python -O
    strips asserts, and a bakeoff must never report throughput for a
    silently corrupt codec path."""
    if out != data:
        raise SystemExit(f"bakeoff: {label} round-trip MISMATCH "
                         f"({len(out)} vs {len(data)} bytes)")

def cmd_bakeoff(args) -> int:
    """Benchmark all levels against an independent competitor (reference:
    ops/bakeoff.go benchmarks plz4 vs pierrec/lz4 with --ram and -B raw
    block-API modes). Competitors here: the native frame engine, the raw
    block API (-B), the device backend (--device), and the reference's
    vendored upstream lz4 when its sources are mounted."""
    src, src_path = _open_src(args.file)
    data = src.read()
    if src_path:
        src.close()
    from . import compress, compress_block, decompress, decompress_block
    from .native import upstream

    have_upstream = upstream.available()
    if not have_upstream and not args.quiet:
        print(f"(upstream lz4 rows unavailable: "
              f"{upstream.unavailable_reason()})", file=sys.stderr)

    def progress(label, i, n):
        if args.quiet or not sys.stderr.isatty():
            return
        print(f"\r{label:24} [{i}/{n}]", end="", file=sys.stderr, flush=True)

    def clear():
        if not args.quiet and sys.stderr.isatty():
            print("\r" + " " * 40 + "\r", end="", file=sys.stderr, flush=True)

    rows = []
    levels = list(range(1, 13))

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    if args.block:
        # raw block-API mode (-B): 64 KiB blocks, no framing
        bs = 64 << 10
        blocks = [data[i : i + bs] for i in range(0, len(data), bs)]
        for li, level in enumerate(levels):
            progress(f"plz4-block L{level}", li, len(levels))
            comp, te = timed(lambda: [
                compress_block(b, level=level) for b in blocks])
            outs, td = timed(lambda: [
                decompress_block(c, dst_size=bs) for c in comp])
            _check_roundtrip(b"".join(outs), data, "plz4-block")
            rows.append(("plz4-block", level, sum(map(len, comp)), te, td))
        if have_upstream:
            for li, level in enumerate(levels):
                progress(f"upstream-block L{level}", li, len(levels))
                comp, te = timed(lambda: [
                    upstream.compress(b, level) for b in blocks])
                outs, td = timed(lambda: [
                    upstream.decompress(c, bs) for c in comp])
                _check_roundtrip(b"".join(outs), data, "upstream-block")
                rows.append(("upstream-block", level,
                             sum(map(len, comp)), te, td))
    else:
        for li, level in enumerate(levels):
            progress(f"plz4 L{level}", li, len(levels))
            comp, te = timed(lambda: compress(
                data, level=level, parallel=args.cpus,
                content_checksum=False))
            out, td = timed(lambda: decompress(comp, parallel=args.cpus))
            _check_roundtrip(out, data, f"plz4 L{level}")
            rows.append(("plz4", level, len(comp), te, td))
        if have_upstream:
            bs = 4 << 20
            blocks = [data[i : i + bs] for i in range(0, len(data), bs)]
            for li, level in enumerate(levels):
                progress(f"upstream L{level}", li, len(levels))
                comp, te = timed(lambda: [
                    upstream.compress(b, level) for b in blocks])
                outs, td = timed(lambda: [
                    upstream.decompress(c, bs) for c in comp])
                _check_roundtrip(b"".join(outs), data, f"upstream L{level}")
                rows.append(("upstream", level, sum(map(len, comp)), te, td))
        if args.device:
            progress("device L1", 0, 1)
            comp, te = timed(lambda: compress(
                data, level=1, backend="device", parallel=args.cpus,
                content_checksum=False, device=args.torch_device))
            out, td = timed(lambda: decompress(
                comp, backend="device", parallel=args.cpus,
                device=args.torch_device))
            _check_roundtrip(out, data, "device L1")
            rows.append(("device", 1, len(comp), te, td))
    clear()

    print(f"payload: {len(data)} bytes"
          + (" (raw block API, 64KiB)" if args.block else ""))
    print(f"{'codec':16} {'level':5} {'ratio':>7} {'enc MB/s':>9} "
          f"{'dec MB/s':>9}")
    for codec, level, csize, te, td in rows:
        print(f"{codec:16} {level:5} {len(data) / csize:7.3f} "
              f"{len(data) / 1e6 / max(te, 1e-9):9.1f} "
              f"{len(data) / 1e6 / max(td, 1e-9):9.1f}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="plz4",
        description="parallel LZ4 frame codec (device backend: CUDA)",
    )
    p.add_argument("-c", "--cpus", type=int, default=-1,
                   help="parallelism (-1 auto, 0 sync)")
    p.add_argument("--dict", help="dictionary file")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "native", "device"])
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", aliases=["c"], help="compress a file")
    c.add_argument("file", nargs="?")
    c.add_argument("-o", "--output")
    c.add_argument("-l", "--level", type=int, default=1)
    c.add_argument("--bs", dest="block_size", default="7",
                   help="block size: 4-7 or bytes (64KB..4MB)")
    c.add_argument("--bd", dest="block_linked", action="store_true",
                   help="linked (dependent) blocks")
    c.add_argument("--bx", dest="block_checksum", action="store_true",
                   help="block checksums")
    c.add_argument("--no-cx", dest="no_content_checksum", action="store_true",
                   help="disable content checksum")
    c.add_argument("--cs", dest="content_size", action="store_true",
                   help="record content size")
    c.add_argument("-f", "--force", action="store_true")
    c.add_argument("-q", "--quiet", action="store_true")
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress", aliases=["d"], help="decompress a file")
    d.add_argument("file", nargs="?")
    d.add_argument("-o", "--output")
    d.add_argument("-s", "--sparse", action="store_true",
                   help="sparse output file")
    d.add_argument("-f", "--force", action="store_true")
    d.add_argument("-q", "--quiet", action="store_true")
    d.set_defaults(fn=cmd_decompress)

    v = sub.add_parser("verify", aliases=["v"], help="verify a frame")
    v.add_argument("file", nargs="?")
    v.add_argument("-s", "--header-only", action="store_true")
    v.set_defaults(fn=cmd_verify)

    b = sub.add_parser("bakeoff", aliases=["b"], help="benchmark levels")
    b.add_argument("file", nargs="?")
    b.add_argument("--device", action="store_true",
                   help="also benchmark the device backend")
    b.add_argument("-B", "--block", action="store_true",
                   help="raw block-API mode (no framing, 64KiB blocks)")
    b.add_argument("--ram", action="store_true",
                   help="in-memory mode (accepted for reference CLI parity; "
                        "payloads are always read into memory here)")
    b.add_argument("-q", "--quiet", action="store_true")
    b.set_defaults(fn=cmd_bakeoff)
    return p


def main(argv=None, *, device: str = "cuda") -> int:
    """Run the CLI on argv (sys.argv[1:] when None); `device` is the torch
    device of the device backend ("cuda", or "cpu" for the kernels' plain
    versions)."""
    args = build_parser().parse_args(argv)
    args.torch_device = device
    try:
        return args.fn(args)
    except zerr.Lz4Error as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
