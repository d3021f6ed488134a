"""Frame reader engine.

Reference analogs: rdr/rdr.go (header/body state machine, concatenated
frames, read-offset random access), sync/reader.go and async/reader.go
(block pipelines). The Go pipeline maps to:

  * native backend: a read-ahead dispatch loop that keeps up to the pending
    budget of blocks in flight on a thread pool (the dispatch goroutine +
    semaphore analog, async/reader.go:104-185), consumed in order.
  * device backend: stored blocks gathered into fixed-shape batches and
    decoded by the CUDA block-decode kernel (parallel/batch.py ->
    ops/decode.py).

Linked frames are decoded serially with a rolling 64 KiB window
(reference: rdr/rdr.go:338-341 forces NParallel=1; compress/dict.go:171-184
maintains the window). Content checksums verify at each EndMark; the reader
then transparently continues into concatenated frames.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

from .. import errors as zerr
from .. import native
from ..frame import block_io, header as hdr
from ..opts import WINDOW_SIZE, Options, calc_pending
from .writer import _HashWorker


def _decompress_job(stored: bytes, uncompressed: bool, cap: int,
                    dict_: bytes | None):
    if uncompressed:
        return stored
    return native.decompress(stored, cap, dict_=dict_)


def _decompress_group(group: list, cap: int, dict_: bytes | None) -> list:
    """Decompress several blocks in one task. The dict-free all-compressed
    case runs as a single C batch call (one GIL release for the group)."""
    if (dict_ is None and len(group) > 1
            and all(not unc for (_, unc) in group)):
        return native.decompress_batch([d for (d, _) in group], cap)
    return [_decompress_job(data, unc, cap, dict_) for (data, unc) in group]


class FrameReader:
    """Streaming LZ4 frame reader with the reference's full semantics."""

    def __init__(self, src, opts: Options | None = None, **kw) -> None:
        self._o = opts if opts is not None else Options(**kw)
        self._src = src
        self._closed = False
        self._err: BaseException | None = None
        self._eof = False
        self._buf = memoryview(b"")
        self._parallel = self._o.resolved_parallel()
        self._frame_parallel = self._parallel
        self._budget = self._o.pending_budget()
        self._pool: ThreadPoolExecutor | None = None
        self._src_pos = 0                # compressed bytes consumed
        self._dst_pos = 0                # decompressed bytes produced
        self._first_frame = True
        self._use_device = self._o.backend == "device"
        if self._use_device:
            from ..parallel import batch as dev_batch
            from ..parallel import mesh as mesh_mod

            # with a block mesh active, the mesh decides the devices: the
            # batch layer gets the mesh in place of a device
            self._device = (mesh_mod.active_mesh()
                            or dev_batch.resolve_device(self._o.device))
        # per-frame state
        self._hdr: hdr.FrameHeader | None = None
        self._blk_rdr: block_io.FrameBlockReader | None = None
        self._dispatch_done = True       # stored-block stream exhausted
        self._pending: deque = deque()   # in-flight decompress futures
        self._ready: deque = deque()     # decoded blocks awaiting consumption
        self._device_queue: deque = deque()
        self._device_pending: deque = deque()  # dispatched device batches
        self._hasher: native.Xxh32Stream | None = None
        self._dstream: native.StreamDecompressor | None = None
        self._frame_dict: bytes | None = None
        self._frame_decoded = 0
        self._check_content = True

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        self._check_readable()
        try:
            if n is None or n < 0:
                chunks = [bytes(self._buf)] if self._buf else []
                self._buf = memoryview(b"")
                while True:
                    b = self._next_chunk()
                    if not b:
                        return b"".join(chunks)
                    chunks.append(b)
            out = bytearray()
            while len(out) < n:
                if not self._buf:
                    try:
                        b = self._next_chunk()
                    except BaseException as e:
                        # deferred-error semantics: hand back what was
                        # already decoded; the latched error surfaces on
                        # the next call (reference: rdr/rdr.go:71-80)
                        if out:
                            self._latch(e)
                            return bytes(out)
                        raise
                    if not b:
                        break
                    self._buf = memoryview(b)
                take = min(n - len(out), len(self._buf))
                out += self._buf[:take]
                self._buf = self._buf[take:]
            return bytes(out)
        except BaseException as e:
            self._latch(e)
            raise

    def write_to(self, wr) -> int:
        """io.WriterTo analog: stream everything into `wr`."""
        self._check_readable()
        total = 0
        try:
            if self._buf:
                wr.write(bytes(self._buf))
                total += len(self._buf)
                self._buf = memoryview(b"")
            while True:
                b = self._next_chunk()
                if not b:
                    return total
                wr.write(b)
                total += len(b)
        except BaseException as e:
            self._latch(e)
            raise

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._shutdown_pool()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False

    @property
    def positions(self) -> tuple[int, int]:
        """(compressed consumed, decompressed produced)."""
        return self._src_pos, self._dst_pos

    def __del__(self):  # best-effort: abandoned readers must not leak threads
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _check_readable(self) -> None:
        if self._closed:
            raise zerr.ErrClosed
        if self._err is not None:
            raise self._err

    def _latch(self, e: BaseException) -> None:
        if self._err is None:
            self._err = e

    def _next_chunk(self) -> bytes:
        """Next decoded block across frames (b'' at end of the stream)."""
        while True:
            if self._eof:
                return b""
            if self._hdr is None:
                if not self._begin_frame():
                    self._eof = True
                    return b""
            out = self._next_block_decoded()
            if out is None:
                self._finish_frame()
                continue
            if len(out) == 0:
                continue
            if self._hasher is not None:
                self._hasher.update(out)
            self._frame_decoded += len(out)
            self._dst_pos += len(out)
            if self._o.progress is not None:
                self._o.progress(self._src_pos, self._dst_pos)
            return out

    # ---- frame lifecycle ---------------------------------------------
    def _begin_frame(self) -> bool:
        h = hdr.read_header(self._src, skip_callback=self._o.skip_callback)
        if h is None:
            return False
        self._hdr = h
        self._src_pos += h.size
        self._check_content = True
        self._frame_decoded = 0
        self._dispatch_done = False

        # resolve frame dictionary (reference: rdr/rdr.go:254-259)
        d = self._o.dictionary
        if h.dict_id is not None and self._o.dict_callback is not None:
            cb = self._o.dict_callback(h.dict_id)
            if cb is not None:
                d = cb
        if d is not None and len(d) > WINDOW_SIZE:
            d = d[-WINDOW_SIZE:]
        self._frame_dict = d
        self._dstream = None  # fresh rolling window per frame

        # random access (first frame only; reference: rdr/rdr.go:264-285)
        if self._first_frame and self._o.read_offset is not None:
            off = self._o.read_offset
            if not h.block_independent:
                raise zerr.ErrReadOffsetLinked
            if off < h.size:
                raise zerr.ErrReadOffset
            self._seek_to(off)
            self._check_content = False  # partial read: no content checks
        self._first_frame = False

        # content hash runs on a dedicated thread, fed in consumption
        # order — overlaps the serial reduction with parallel decompression
        # (reference: AsyncHash, async/hash.go:14-51)
        self._hasher = (_HashWorker()
                        if (h.content_checksum and self._check_content)
                        else None)
        # dynamic worker scaling by declared content size, recomputed per
        # frame from the unmodified setting (reference: async/reader.go:90-99
        # derives nTasks from NParallel fresh for every frame). The clamp
        # feeds the per-frame read-ahead budget below — the shared pool
        # stays sized by the unmodified setting so later frames are
        # unaffected; a 1-block frame just stops over-dispatching.
        self._frame_parallel = self._parallel
        if h.content_size is not None and self._parallel > 0:
            blocks = h.content_size // h.block_size + 1
            self._frame_parallel = max(1, min(self._parallel, blocks))
        self._budget = calc_pending(
            self._o.pending_size, self._frame_parallel, h.block_size_idx)
        # the device path verifies block checksums in one K7 launch per
        # batch (parallel/batch.py) instead of per-block host hashing
        defer = (self._use_device and h.block_checksum
                 and h.block_independent and self._frame_parallel != 0)
        self._blk_rdr = block_io.FrameBlockReader(
            self._src, h, hash_fn=native.xxh32, defer_checksum=defer)
        return True

    def _seek_to(self, off: int) -> None:
        skip = off - self._hdr.size
        seek = getattr(self._src, "seek", None)
        if seek is not None:
            try:
                seek(skip, 1)
                self._src_pos = off
                return
            except (OSError, ValueError):
                pass
        remaining = skip
        while remaining > 0:
            b = self._src.read(min(remaining, 1 << 20))
            if not b:
                raise zerr.ErrReadOffset
            remaining -= len(b)
        self._src_pos = off

    def _finish_frame(self) -> None:
        h = self._hdr
        if self._check_content:
            if self._hasher is not None:
                want = self._blk_rdr.content_checksum
                if want is not None and self._hasher.digest() != want:
                    raise zerr.ErrContentHash
            if (self._o.content_size_check and h.content_size is not None
                    and self._frame_decoded != h.content_size):
                raise zerr.ErrContentSize
        self._hdr = None
        self._blk_rdr = None
        self._hasher = None

    # ---- block pipeline ----------------------------------------------
    def _read_stored(self):
        """Next stored block; None once the EndMark is consumed."""
        if self._dispatch_done:
            return None
        blk = self._blk_rdr.next_block()
        if blk is None:
            self._src_pos += 4
            if self._hdr.content_checksum:
                self._src_pos += 4
            self._dispatch_done = True
            return None
        self._src_pos += blk.src_size
        return blk

    def _next_block_decoded(self) -> bytes | None:
        h = self._hdr
        serial = (not h.block_independent) or self._parallel == 0
        if serial:
            return self._decode_in_order()
        if self._use_device:
            return self._decode_device()
        return self._decode_threaded()

    def _decode_in_order(self) -> bytes | None:
        blk = self._read_stored()
        if blk is None:
            return None
        h = self._hdr
        if not h.block_independent:
            # rolling window lives in a C-side stream context: no per-block
            # window re-materialization (reference keeps a Python-side DictT
            # analog instead, compress/dict.go:171-184)
            if self._dstream is None:
                self._dstream = native.StreamDecompressor(
                    dict_=self._frame_dict)
            if blk.uncompressed:
                self._dstream.append_raw(blk.data)
                return blk.data
            return self._dstream.decompress(blk.data, h.block_size)
        return _decompress_job(
            blk.data, blk.uncompressed, h.block_size, self._frame_dict)

    def _decode_threaded(self) -> bytes | None:
        h = self._hdr
        if self._o.worker_pool is not None:
            submit = self._o.worker_pool.submit
        else:
            if self._pool is None:
                from .writer import _make_pool

                self._pool = _make_pool(self._parallel, "plz4-decompress")
            submit = self._pool.submit
        # dispatch in small groups: one future covers several GIL-releasing
        # C calls (the per-future overhead otherwise rivals the decompress)
        from .writer import _group_size

        group_n = _group_size(h.block_size_idx)
        budget_groups = max(1, self._budget // group_n)
        while len(self._pending) < budget_groups and not self._dispatch_done:
            group = []
            while len(group) < group_n and not self._dispatch_done:
                blk = self._read_stored()
                if blk is None:
                    break
                group.append((blk.data, blk.uncompressed))
            if not group:
                break
            self._pending.append(
                submit(_decompress_group, group, h.block_size,
                       self._frame_dict))
        if self._ready:
            return self._ready.popleft()
        if not self._pending:
            return None
        self._ready.extend(self._pending.popleft().result())
        return self._ready.popleft()

    def _decode_device(self) -> bytes | None:
        h = self._hdr
        if self._device_queue:
            return self._device_queue.popleft()
        # Read-ahead double buffer: keep up to two batches dispatched so
        # batch k+1's staging/H2D overlaps batch k's device compute (kernel
        # launches are asynchronous; Pending.result() is the only blocking
        # point).
        from ..parallel import batch as dev_batch
        limit = max(1, self._budget)
        while len(self._device_pending) < 2 and not self._dispatch_done:
            batch = []
            while len(batch) < limit and not self._dispatch_done:
                blk = self._read_stored()
                if blk is None:
                    break
                batch.append(blk)
            if not batch:
                break
            self._device_pending.append(dev_batch.decode_blocks_begin(
                [(b.data, b.uncompressed) for b in batch], h.block_size,
                dict_=self._frame_dict,
                checksums=[b.checksum for b in batch]
                if h.block_checksum else None,
                device=self._device, array_path=self._o.array_path))
        if not self._device_pending:
            return None
        self._device_queue.extend(self._device_pending.popleft().result())
        return self._device_queue.popleft()

    def _shutdown_pool(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        if self._hasher is not None:
            self._hasher.stop()
        self._pending.clear()
        self._ready.clear()
        self._device_queue.clear()
        for pending in self._device_pending:
            pending.discard()  # return staging buffers without fetching
        self._device_pending.clear()
