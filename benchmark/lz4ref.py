"""Plain LZ4 reference: block decode and encode, frame header and frame
checks, in plain Python.

It follows the LZ4 block and frame format specifications (lz4's
doc/lz4_Block_format.md and doc/lz4_Frame_format.md) and imports nothing of
the program under test. The benchmark judges the program's output with it:
a frame's header, size words, raw blocks and end mark, and its compressed
blocks decoded and compared with the input; in the resident cells the
compressed rows, decoded the same way. A block or row the program keeps
raw is encoded by the reference: where that comes out shorter, the
program gave up on a block that compresses.

The decoder is strict: besides a well-formed stream it asks for what the
block format requires of an encoder (the last sequence holds only
literals, the last 5 bytes are literals, the last match starts at least
12 bytes before the end), and for matches that stay inside the block
(independent blocks).
"""

from __future__ import annotations

MAGIC = 0x184D2204
END_MARK = b"\x00\x00\x00\x00"
RAW_FLAG = 0x80000000
BLOCK_SIZES = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
MIN_MATCH = 4
LAST_LITERALS = 5  # the last 5 bytes of a block are literals
MF_LIMIT = 12  # the last match starts at least 12 bytes before the end
MAX_OFFSET = 65535
SHRINK = 16  # count_shrinkable's margin: a sixteenth of the block

_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917, 668265263,
                           374761393)
_M32 = 0xFFFFFFFF


class RefError(ValueError):
    """A stream or frame that the format does not allow."""


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 of data (the frame format's checksum), plain Python."""
    n = len(data)
    p = 0
    if n >= 16:
        v = [(seed + _P1 + _P2) & _M32, (seed + _P2) & _M32, seed & _M32,
             (seed - _P1) & _M32]
        while p + 16 <= n:
            for k in range(4):
                w = int.from_bytes(data[p:p + 4], "little")
                v[k] = (_rotl((v[k] + w * _P2) & _M32, 13) * _P1) & _M32
                p += 4
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M32
    else:
        h = (seed + _P5) & _M32
    h = (h + n) & _M32
    while p + 4 <= n:
        w = int.from_bytes(data[p:p + 4], "little")
        h = (_rotl((h + w * _P3) & _M32, 17) * _P4) & _M32
        p += 4
    while p < n:
        h = (_rotl((h + data[p] * _P5) & _M32, 11) * _P1) & _M32
        p += 1
    h ^= h >> 15
    h = (h * _P2) & _M32
    h ^= h >> 13
    h = (h * _P3) & _M32
    h ^= h >> 16
    return h


def frame_header(block_size_idx: int, independent: bool = True,
                 block_checksum: bool = False,
                 content_checksum: bool = False) -> bytes:
    """The frame header the configuration states: magic, FLG (version 01),
    BD and the header checksum byte. No content size, no dictionary id."""
    flg = (1 << 6) | (independent << 5) | (block_checksum << 4) \
        | (content_checksum << 2)
    bd = block_size_idx << 4
    desc = bytes([flg, bd])
    return MAGIC.to_bytes(4, "little") + desc + bytes(
        [(xxh32(desc) >> 8) & 0xFF])


def decode_block(src, out_cap: int) -> bytearray:
    """Decode one independent LZ4 block of at most out_cap bytes; raise
    RefError where the stream breaks the block format."""
    src = bytes(src)
    n = len(src)
    out = bytearray()
    ip = 0
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
            raise RefError(f"offset {off} reaches outside the block at {op}")
        if op + m > out_cap:
            raise RefError("output runs past the block size")
        if off >= m:
            out += out[op - off:op - off + m]
        else:  # overlapping copy: the last `off` bytes repeat
            out += (out[op - off:op] * (m // off + 1))[:m]
        last_start, last_end = op, op + m
    if len(out) > out_cap:
        raise RefError("output runs past the block size")
    if last_end >= 0 and (last_end > len(out) - LAST_LITERALS
                          or last_start > len(out) - MF_LIMIT):
        raise RefError("a match too near the end of the block")
    return out


def encode_block(src: bytes) -> bytes:
    """A greedy LZ4 block encoder (one hash probe a position, as lz4's
    fast mode without acceleration): valid streams for the tests of the
    decoder and the frame checks, not the program's parse."""
    n = len(src)
    out = bytearray()
    anchor = 0
    if n >= MF_LIMIT + 1:
        table: dict[bytes, int] = {}
        ip = 0
        limit = n - MF_LIMIT  # last position a match may start at
        while ip <= limit:
            key = src[ip:ip + 4]
            ref = table.get(key)
            table[key] = ip
            if ref is None or ip - ref > MAX_OFFSET:
                ip += 1
                continue
            m = 4
            end = n - LAST_LITERALS
            while ip + m < end and src[ref + m] == src[ip + m]:
                m += 1
            _sequence(out, src[anchor:ip], ip - ref, m)
            ip += m
            anchor = ip
    _sequence(out, src[anchor:], 0, 0)
    return bytes(out)


def _length(out: bytearray, v: int) -> None:
    while v >= 255:
        out.append(255)
        v -= 255
    out.append(v)


def _sequence(out: bytearray, lits: bytes, off: int, m: int) -> None:
    """One sequence: literals, then a match of m >= 4 bytes at off
    (m == 0: the last sequence, literals only)."""
    ln = len(lits)
    ml = m - MIN_MATCH if m else 0
    out.append((min(ln, 15) << 4) | min(ml, 15))
    if ln >= 15:
        _length(out, ln - 15)
    out += lits
    if m:
        out += off.to_bytes(2, "little")
        if ml >= 15:
            _length(out, ml - 15)


def compress_frame(data: bytes, block_size_idx: int) -> bytes:
    """A frame of independent blocks by encode_block, raw where a block
    does not shrink; no checksums."""
    bs = BLOCK_SIZES[block_size_idx]
    parts = [frame_header(block_size_idx)]
    for p in range(0, len(data), bs):
        blk = data[p:p + bs]
        comp = encode_block(blk)
        if len(comp) < len(blk):
            parts += [len(comp).to_bytes(4, "little"), comp]
        else:
            parts += [(len(blk) | RAW_FLAG).to_bytes(4, "little"), blk]
    parts.append(END_MARK)
    return b"".join(parts)


def scan_frame(frame: bytes, payload, block_size_idx: int):
    """Judge one frame against the payload it compressed, under a
    configuration of independent blocks and no checksums, all but the
    contents of its compressed blocks: the header (byte for byte), each
    size word (a compressed block shorter than its input, a raw block equal
    to it), the block count and the end mark with nothing after it.

    Returns (faults, blocks, raws): faults counts bad headers and bad
    words, blocks lists (stored, expected, block_size) for each compressed
    block, for count_bad, and raws each block stored raw, for
    count_shrinkable."""
    payload = memoryview(payload)
    bs = BLOCK_SIZES[block_size_idx]
    n_blocks = -(-len(payload) // bs)
    hdr = frame_header(block_size_idx)
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
            blocks.append((stored, bytes(blk), bs))
        k += 1
    faults["words"] += int(k != n_blocks) + int(pos != len(frame))
    return faults, blocks, raws


def count_bad(items) -> int:
    """How many (stream, expected, out_cap) do not decode to expected."""
    bad = 0
    for stream, expected, cap in items:
        try:
            bad += int(decode_block(stream, cap) != expected)
        except RefError:
            bad += 1
    return bad


def count_shrinkable(blocks) -> int:
    """How many blocks encode_block stores in at least 1/SHRINK fewer
    bytes than they hold: blocks a compressor must not keep raw. (A block
    that saves less is left to the compressor: another match finder may
    fairly fall just short of shrinking it.)"""
    return sum(len(encode_block(b)) <= len(b) - len(b) // SHRINK
               for b in blocks)


def loaded_modules() -> list[str]:
    """The top-level names of every module this process has loaded."""
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)})
