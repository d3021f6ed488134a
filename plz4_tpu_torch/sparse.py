"""Sparse file writer: converts all-zero runs into seeks so decompressed
output creates sparse files.

Reference: pkg/sparse/sparse.go — 4 KiB chunk zero-scan (the Go unsafe
uint64-OR loop becomes a numpy any() reduction), trailing hole committed by
seek-back + 1-byte write on close (sparse/sparse.go:136-160).
"""

from __future__ import annotations

import numpy as np

CHUNK = 4096


def _is_zero(chunk: memoryview) -> bool:
    return not np.frombuffer(chunk, dtype=np.uint8).any()


class SparseWriter:
    """Wraps a seekable binary file object; write() turns zero runs into
    holes. Close commits any trailing hole."""

    def __init__(self, f) -> None:
        self._f = f
        self._pending_hole = 0  # zero bytes not yet materialized
        self._wrote_any = False
        self._closed = False

    def write(self, data) -> int:
        # cast to bytes view: a non-uint8 memoryview counts ELEMENTS, which
        # would record holes itemsize-times too small vs the bytes written
        mv = memoryview(data).cast("B")
        n = len(mv)
        i = 0
        while i < n:
            chunk = mv[i : i + CHUNK]
            if len(chunk) == CHUNK and _is_zero(chunk):
                self._pending_hole += len(chunk)
            else:
                # scan the tail chunk too: all-zero tails stay pending so a
                # trailing hole is possible
                if _is_zero(chunk):
                    self._pending_hole += len(chunk)
                else:
                    self._commit_hole()
                    self._f.write(chunk)
                    self._wrote_any = True
            i += len(chunk)
        return n

    def read_from(self, rd, chunk_size: int = 1 << 20) -> int:
        total = 0
        while True:
            b = rd.read(chunk_size)
            if not b:
                return total
            total += self.write(b)

    def flush(self) -> None:
        f = getattr(self._f, "flush", None)
        if f:
            f()

    def close(self) -> None:
        """Commit a trailing hole by seeking to end-1 and writing one zero
        byte (reference: sparse/sparse.go:136-160). Does not close the
        underlying file."""
        if self._closed:
            return
        self._closed = True
        if self._pending_hole > 0:
            self._f.seek(self._pending_hole - 1, 1)
            self._f.write(b"\x00")
            self._pending_hole = 0
        self.flush()

    def _commit_hole(self) -> None:
        if self._pending_hole > 0:
            self._f.seek(self._pending_hole, 1)
            self._pending_hole = 0

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False
