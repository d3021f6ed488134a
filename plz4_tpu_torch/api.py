"""Public API: Reader/Writer + one-shot helpers + raw block API.

Mirrors the reference's public surface (plz4_reader.go, plz4_writer.go,
plz4_block.go, plz4_opts.go) with pythonic construction: keyword options in
place of functional options. All reference options are supported:

  parallel, pending_size, content_checksum, progress, dictionary,
  level, block_checksum, block_size_idx (or byte size), block_linked,
  content_size, dict_id, read_offset, content_size_check, skip_callback,
  dict_callback, backend ("native" host codec / "device" CUDA kernels / "auto"),
  device ("cuda", or "cpu" for the kernels' plain versions), array_path
  (the device backend through the tensor programs A1/A2).
"""

from __future__ import annotations

import io
from typing import Optional

from . import errors as zerr
from . import native
from .engine.reader import FrameReader as Reader
from .engine.writer import FrameWriter as Writer
from .frame import header as _hdr
from .opts import WINDOW_SIZE, clamp_level
from .spans import span


def write_skip_frame_header(dst, nibble: int, size: int) -> int:
    """Write a skippable-frame header; caller then writes `size` payload
    bytes (reference: WriteSkipFrameHeader, plz4_writer.go:60-62)."""
    raw = _hdr.write_skip_header(nibble, size)
    dst.write(raw)
    return len(raw)


def compress(data: bytes, **opts) -> bytes:
    """One-shot frame compression.

    Uses a chunked fan-out fast path when no streaming feature is engaged
    (engine/oneshot.py); otherwise the streaming Writer."""
    from .engine import oneshot
    from .opts import Options

    with span("compress"):
        o = Options(**opts)
        fast = oneshot.compress_bytes(data, o)
        if fast is not None:
            return fast
        out = io.BytesIO()
        w = Writer(out, o)
        w.write(data)
        w.close()
        return out.getvalue()


def decompress(data: bytes, **opts) -> bytes:
    """One-shot frame decompression (handles concatenated frames).

    Uses a parse-then-fan-out fast path when no streaming feature is
    engaged (engine/oneshot.py); otherwise the streaming Reader."""
    from .engine import oneshot
    from .opts import Options

    o = Options(**opts)
    fast = oneshot.decompress_bytes(data, o)
    if fast is not None:
        return fast
    r = Reader(io.BytesIO(data), o)
    try:
        return r.read()
    finally:
        r.close()


# ---------------------------------------------------------------------------
# Raw block API (reference: plz4_block.go)
# ---------------------------------------------------------------------------

class DictContext:
    """Reusable dictionary for the raw block API: builds the window's match
    tables once so many small records compress without per-call dictionary
    loading (reference analog: attached dict contexts,
    compress/indie.go:235-287). compress_block is NOT thread-safe — use
    one context per thread; decompress_block is stateless and shareable."""

    def __init__(self, dictionary: bytes) -> None:
        self._ctx = native.DictContext(dictionary)

    def compress_block(self, src: bytes, *, level: int = 1) -> bytes:
        return self._ctx.compress(src, level=clamp_level(level))

    def decompress_block(self, src: bytes, *, dst_size: int) -> bytes:
        return self._ctx.decompress(src, dst_size)


def compress_block_bound(src_len: int) -> int:
    """Max compressed size of a block (reference: CompressBlockBound,
    plz4_block.go:78)."""
    return native.compress_bound(src_len)


def compress_block(
    src: bytes,
    *,
    level: int = 1,
    dictionary: Optional[bytes] = None,
    dst: Optional[bytearray] = None,
) -> bytes:
    """One-shot raw block compression, no framing (reference:
    CompressBlock, plz4_block.go:96-123)."""
    level = clamp_level(level)
    if dictionary is not None and len(dictionary) > WINDOW_SIZE:
        dictionary = dictionary[-WINDOW_SIZE:]
    out = native.compress(src, level=level, dict_=dictionary)
    if dst is not None:
        if len(dst) < len(out):
            # a fixed caller-sized buffer must not be silently reallocated
            # (reference: ErrDstSize, plz4_block.go:109-112)
            raise zerr.ErrDstSize
        dst[: len(out)] = out
        return bytes(dst[: len(out)])
    return out


def decompress_block(
    src: bytes,
    *,
    dictionary: Optional[bytes] = None,
    dst_size: Optional[int] = None,
) -> bytes:
    """One-shot raw block decompression. Without dst_size, retries with
    geometric buffer growth (x4 start, x2 up to 3 tries — reference:
    plz4_block.go:150-171)."""
    if dictionary is not None and len(dictionary) > WINDOW_SIZE:
        dictionary = dictionary[-WINDOW_SIZE:]
    if dst_size is not None:
        return native.decompress(src, dst_size, dict_=dictionary)
    cap = max(64, len(src) * 4)
    last: Exception = zerr.ErrDecompress
    for _ in range(3):
        try:
            return native.decompress(src, cap, dict_=dictionary)
        except zerr.Lz4Error as e:
            last = e
            cap *= 2
    raise last
