"""Plain reference for LZ4 frames of linked blocks, in plain Python.

In a frame whose FLG has B.Indep clear (lz4's doc/lz4_Frame_format.md), a
block's matches may reach back into the decoded bytes of the blocks
before it: at most 65,535 bytes back from the match's position, and never
before the frame's first byte (no dictionary ID). lz4ref.decode_block
refuses any such match; decode_block here takes the history the format
lets the block read, the last 64 KiB decoded before it, and otherwise
asks what lz4ref's strict decoder asks of a block.

decode_frame decodes a whole frame block by block, each block's history
the bytes decoded so far. The benchmark's check judges the blocks of one
frame in parallel instead: each block is decoded after the 64 KiB of the
object that precede it, and compared with the object's next bytes. Where
every block passes, the frame decodes to the object by induction (the
first block has no history; each next one reads only bytes already shown
to be the object's), which is what decode_frame would find.

It imports nothing of the program under test, nor torch or JAX.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

from . import lz4ref
from .lz4ref import LAST_LITERALS, MF_LIMIT, MIN_MATCH, RAW_FLAG, RefError

BLOCK_IDX = 4  # 64 KiB blocks, liblz4's default (LZ4F_default)
HISTORY = 64 << 10  # the decoded bytes a linked block may read


def header(block_size_idx: int = BLOCK_IDX) -> bytes:
    """The header the configuration states: B.Indep clear, no checksums,
    no content size, no dictionary ID."""
    return lz4ref.frame_header(block_size_idx, independent=False)


def decode_block(src, out_cap: int, history=b"") -> tuple[bytes, int]:
    """Decode one linked block of at most out_cap bytes after `history`
    (the frame's bytes decoded before it; only its last 64 KiB is read):
    (the block's bytes, the number of its sequences whose offset reaches
    before the block's start). Raise RefError where the stream breaks the
    block format or a match reaches past the history."""
    src = bytes(src)
    hist = bytes(history[-HISTORY:])
    h = len(hist)
    n = len(src)
    out = bytearray(hist)
    ip = 0
    refs = 0
    last_start = last_end = -1
    while True:
        if ip >= n:
            raise RefError("stream ends before a token")
        t = src[ip]
        ip += 1
        lit = t >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise RefError("literal length runs past the stream")
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n:
            raise RefError("literals run past the stream")
        out += src[ip:ip + lit]
        ip += lit
        if ip == n:
            break  # the last sequence: literals only
        if ip + 2 > n:
            raise RefError("offset runs past the stream")
        off = src[ip] | (src[ip + 1] << 8)
        ip += 2
        m = t & 15
        if m == 15:
            while True:
                if ip >= n:
                    raise RefError("match length runs past the stream")
                b = src[ip]
                ip += 1
                m += b
                if b != 255:
                    break
        m += MIN_MATCH
        op = len(out)
        if off == 0 or off > op:
            raise RefError(f"offset {off} reaches before the history at "
                           f"{op - h}")
        if op - h + m > out_cap:
            raise RefError("output runs past the block size")
        refs += off > op - h
        if off >= m:
            out += out[op - off:op - off + m]
        else:  # overlapping copy: the last `off` bytes repeat
            out += (out[op - off:op] * (m // off + 1))[:m]
        last_start, last_end = op - h, op - h + m
    size = len(out) - h
    if size > out_cap:
        raise RefError("output runs past the block size")
    if last_end >= 0 and (last_end > size - LAST_LITERALS
                          or last_start > size - MF_LIMIT):
        raise RefError("a match too near the end of the block")
    return bytes(out[h:]), refs


def encode_block(src: bytes, history=b"") -> bytes:
    """lz4ref.encode_block's greedy parse after `history` (only its last
    64 KiB is read): its table starts with the history's positions, so
    matches may reach into it. Valid linked blocks for the tests of the
    decoder and the check, not the program's parse."""
    hist = bytes(history[-HISTORY:])
    c = hist + bytes(src)
    h, n = len(hist), len(c)
    out = bytearray()
    anchor = h
    if n - h >= MF_LIMIT + 1:
        table = {c[p:p + 4]: p for p in range(max(0, h - 3))}
        ip = h
        limit = n - MF_LIMIT  # last position a match may start at
        while ip <= limit:
            key = c[ip:ip + 4]
            ref = table.get(key)
            table[key] = ip
            if ref is None or ip - ref > lz4ref.MAX_OFFSET:
                ip += 1
                continue
            m = 4
            end = n - LAST_LITERALS
            while ip + m < end and c[ref + m] == c[ip + m]:
                m += 1
            lz4ref._sequence(out, c[anchor:ip], ip - ref, m)
            ip += m
            anchor = ip
    lz4ref._sequence(out, c[anchor:], 0, 0)
    return bytes(out)


def compress_frame(data: bytes) -> bytes:
    """A frame of linked 64 KiB blocks by encode_block, raw where a block
    does not shrink; the configuration's header, no checksums."""
    bs = lz4ref.BLOCK_SIZES[BLOCK_IDX]
    parts = [header()]
    for p in range(0, len(data), bs):
        blk = data[p:p + bs]
        comp = encode_block(blk, data[max(0, p - HISTORY):p])
        if len(comp) < len(blk):
            parts += [len(comp).to_bytes(4, "little"), comp]
        else:
            parts += [(len(blk) | RAW_FLAG).to_bytes(4, "little"), blk]
    parts.append(lz4ref.END_MARK)
    return b"".join(parts)


def decode_frame(frame: bytes) -> tuple[bytes, int]:
    """Decode a whole frame of linked blocks under the configuration's
    header: (the content, its window_refs). Raise RefError where the
    frame breaks the format."""
    hdr = header()
    if frame[:len(hdr)] != hdr:
        raise RefError("not the configuration's header")
    bs = lz4ref.BLOCK_SIZES[BLOCK_IDX]
    out = bytearray()
    refs = 0
    pos = len(hdr)
    while True:
        if pos + 4 > len(frame):
            raise RefError("no end mark")
        word = int.from_bytes(frame[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            break
        size = word & ~RAW_FLAG
        if size > bs or pos + size > len(frame):
            raise RefError("a block word past the block size or the frame")
        stored = frame[pos:pos + size]
        pos += size
        if word & RAW_FLAG:
            out += stored
        else:
            blk, r = decode_block(stored, bs, out[-HISTORY:])
            out += blk
            refs += r
    if pos != len(frame):
        raise RefError("bytes after the end mark")
    return bytes(out), refs


def scan_frame(frame: bytes, payload, block_size_idx: int = BLOCK_IDX):
    """lz4ref.scan_frame under linked blocks: the header byte for byte
    (B.Indep clear), each size word, the block count and the end mark.
    Returns (faults, blocks, raws) as lz4ref.scan_frame does, each of
    blocks a (stored, expected, block_size, history) whose history is the
    payload's 64 KiB before the block."""
    payload = memoryview(payload)
    bs = lz4ref.BLOCK_SIZES[block_size_idx]
    n_blocks = -(-len(payload) // bs)
    hdr = header(block_size_idx)
    faults = {"headers": int(frame[:len(hdr)] != hdr), "words": 0}
    blocks, raws = [], []
    pos = len(hdr)
    k = 0
    while True:
        if pos + 4 > len(frame):
            faults["words"] += 1  # no end mark
            break
        word = int.from_bytes(frame[pos:pos + 4], "little")
        pos += 4
        if word == 0:
            break
        size, raw = word & ~RAW_FLAG, bool(word & RAW_FLAG)
        blk = payload[k * bs:(k + 1) * bs]
        stored = frame[pos:pos + size]
        pos += size
        if k >= n_blocks or len(stored) != size or size > bs:
            faults["words"] += 1
            break
        if raw:
            faults["words"] += int(stored != blk)
            raws.append(bytes(blk))
        elif size >= len(blk):
            faults["words"] += 1  # a compressed block must be the shorter
        else:
            blocks.append((stored, bytes(blk), bs, bytes(
                payload[max(0, k * bs - HISTORY):k * bs])))
        k += 1
    faults["words"] += int(k != n_blocks) + int(pos != len(frame))
    return faults, blocks, raws


def judge(items) -> list[tuple[int, int, int]]:
    """For each (frame, stream, expected, out_cap, history): (frame, 1 if
    it does not decode to expected after history else 0, its
    window_refs)."""
    got = []
    for frame, stream, expected, cap, hist in items:
        try:
            blk, refs = decode_block(stream, cap, hist)
            got.append((frame, int(blk != expected), refs))
        except RefError:
            got.append((frame, 1, 0))
    return got


def judge_in_pool(items: list, workers: int, raws: list = (),
                  per_task: int = 32):
    """judge each (frame, stream, expected, out_cap, history) item, and
    lz4ref.count_shrinkable each raw block, in a pool of spawned processes
    (as the benchmark's harness.reference_bad does). Returns (the judged
    items in order, how many raw blocks the reference shrinks, the
    top-level names of the modules the reference's processes loaded)."""
    tasks = [items[i:i + per_task] for i in range(0, len(items), per_task)]
    raw_tasks = [raws[i:i + 4] for i in range(0, len(raws), 4)]
    n = max(1, min(workers, os.cpu_count() or 1,
                   len(tasks) + len(raw_tasks)))
    # spawned, so that they start from a fresh import and share nothing
    # with the program's process; a worker that dies raises here
    with ProcessPoolExecutor(n, multiprocessing.get_context("spawn")) as ex:
        shrink = ex.map(lz4ref.count_shrinkable, raw_tasks)
        judged = [j for part in ex.map(judge, tasks) for j in part]
        shrinkable = sum(shrink)
        mods = ex.submit(lz4ref.loaded_modules).result()
    return judged, shrinkable, mods
