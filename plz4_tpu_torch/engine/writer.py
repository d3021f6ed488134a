"""Frame writer engine.

Reference analogs: sync/writer.go (parallel == 0), async/writer.go
(parallel > 0). The Go goroutine pipeline maps to:

  * native backend: a thread pool compressing blocks (the C codec releases
    the GIL, so fan-out is real), an ordered pending deque bounded by the
    pending budget (the reference's semChan backpressure semaphore,
    async/writer.go:439-448), and in-order emission by the caller thread
    (the writeLoop reorder analog, async/writer.go:284-381).
  * device backend: blocks staged into fixed-shape batches and encoded by
    the CUDA greedy-encode kernel (parallel/batch.py -> ops/encode.py).

Linked-block mode snapshots the trailing 64 KiB window *before* dispatch so
compression itself stays parallel (reference: _genDict,
async/writer.go:412-437). Content checksums stream through the native
xxh32 in staging order (reference: AsyncHashIdx, async/hash.go:58-111).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from .. import errors as zerr
from .. import native
from ..frame import block_io, header as hdr, trailer
from ..opts import WINDOW_SIZE, Options
from ..spans import span


class _HashWorker:
    """Serial xxh32 accumulator on a dedicated thread, fed in block order —
    overlaps the order-dependent content hash with parallel compression
    (reference: AsyncHashIdx, async/hash.go:58-111)."""

    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=64)
        self._stream = native.Xxh32Stream()
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                continue  # drain so producers never block on a dead hash
            try:
                self._stream.update(item)
            except BaseException as e:
                self._err = e

    def update(self, data: bytes) -> None:
        if self._err is not None:
            raise self._err
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="plz4-hash")
            self._thread.start()
        self._q.put(data)

    def digest(self) -> int:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._err is not None:
            # a partial hash must never be reported as the content digest
            raise self._err
        return self._stream.digest()

    def stop(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None


def _compress_job(src: bytes, dict_: bytes | None, level: int):
    """Compress one block; fall back to raw when not strictly smaller
    (reference: incompressible fallback, blk/blk.go:75-92)."""
    if len(src) == 0:
        return b"", True
    cap = len(src) - 1 if len(src) > 1 else 1
    out = native.compress_into(src, cap, level=level, dict_=dict_)
    if out is None:
        return src, True
    return out, False


def _compress_group(group: list) -> list:
    """Compress several blocks in one task. The dict-free case runs as a
    single C batch call (one GIL release covers the whole group)."""
    if len(group) > 1 and all(d is None for (_, d, _) in group):
        blocks = [src for (src, _, _) in group]
        level = group[0][2]
        cap = max((len(b) for b in blocks), default=1)
        outs = native.compress_batch(blocks, cap_each=max(cap, 16),
                                     level=level)
        return [(src, True) if out is None or len(src) == 0 else (out, False)
                for src, out in zip(blocks, outs)]
    return [_compress_job(src, d, level) for (src, d, level) in group]


def _group_size(block_size_idx: int) -> int:
    from ..frame import descriptor as desc

    return {
        desc.BLOCK_IDX_64KB: 8,
        desc.BLOCK_IDX_256KB: 4,
        desc.BLOCK_IDX_1MB: 2,
        desc.BLOCK_IDX_4MB: 1,
    }[block_size_idx]


def _make_pool(workers: int, prefix: str) -> ThreadPoolExecutor:
    """ThreadPoolExecutor with all workers pre-spawned. The stdlib pool
    spawns lazily at submit time and sticks at one thread whenever a single
    worker keeps draining the queue between submits — which serializes the
    whole pipeline."""
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix=prefix)
    barrier = threading.Barrier(workers + 1)

    def hold():
        try:
            barrier.wait(timeout=5)
        except threading.BrokenBarrierError:  # pragma: no cover
            pass

    for _ in range(workers):
        pool.submit(hold)
    try:
        barrier.wait(timeout=5)
    except threading.BrokenBarrierError:  # pragma: no cover
        pass
    return pool


class FrameWriter:
    """Streaming LZ4 frame writer with the reference's full semantics."""

    def __init__(self, dst, opts: Options | None = None, **kw) -> None:
        self._o = opts if opts is not None else Options(**kw)
        self._dst = dst
        self._closed = False
        self._err: BaseException | None = None
        self._header_written = False
        self._stage = bytearray()
        self._src_total = 0      # bytes accepted from caller
        self._src_emitted = 0    # source bytes whose blocks are written
        self._dst_pos = 0
        self._hasher = _HashWorker() if self._o.content_checksum else None
        self._parallel = self._o.resolved_parallel()
        # dynamic worker scaling: no point spinning more workers than the
        # payload has blocks (reference: async/writer.go:457-466)
        if self._o.content_size is not None and self._parallel > 0:
            blocks = self._o.content_size // self._o.block_size + 1
            self._parallel = max(1, min(self._parallel, blocks))
        self._budget = self._o.pending_budget()
        self._pool: ThreadPoolExecutor | None = None
        self._pending: deque = deque()  # (future, src_len)
        # rolling window for linked mode; constant dict for independent mode
        self._window = bytes(self._o.dictionary or b"")
        self._group: list = []  # (src, dict, level) awaiting dispatch
        self._group_n = _group_size(self._o.block_size_idx)
        self._use_device = self._o.backend == "device"
        if self._use_device:
            from ..parallel import batch as dev_batch
            from ..parallel import mesh as mesh_mod

            # with a block mesh active, the mesh decides the devices: the
            # batch layer gets the mesh in place of a device
            self._device = (mesh_mod.active_mesh()
                            or dev_batch.resolve_device(self._o.device))
        self._device_stage: list = []  # (src, window) tuples
        self._device_pending: deque = deque()  # in-flight device batches
        self._stream: native.StreamCompressor | None = None  # sync linked

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def write(self, data) -> int:
        self._check_writable()
        try:
            return self._write(data)
        except BaseException as e:
            self._latch(e)
            raise

    def read_from(self, rd, chunk_size: int = 1 << 20) -> int:
        """io.ReaderFrom analog: drain `rd` into the frame."""
        self._check_writable()
        total = 0
        try:
            while True:
                chunk = rd.read(chunk_size)
                if not chunk:
                    return total
                total += self._write(chunk)
        except BaseException as e:
            self._latch(e)
            raise

    def flush(self) -> None:
        """Emit any partial block and wait until all pending blocks are
        written (reference: Flush barrier, async/writer.go:109-133)."""
        self._check_writable()
        try:
            self._flush_stage()
            self._drain(wait_all=True)
        except BaseException as e:
            self._latch(e)
            raise

    def close(self) -> None:
        if self._closed:
            return
        if self._err is not None:
            self._closed = True
            self._shutdown_pool()
            return
        try:
            with span("writer.close"):
                self._ensure_header()
                self._flush_stage()
                self._drain(wait_all=True)
                if (self._o.content_size is not None
                        and self._src_total != self._o.content_size):
                    raise zerr.ErrContentSize
                content_hash = (self._hasher.digest() if self._hasher
                                else None)
                self._write_out(trailer.write_trailer(content_hash))
        except BaseException as e:
            self._latch(e)
            raise
        finally:
            self._closed = True
            self._shutdown_pool()

    def write_skip_frame(self, nibble: int, payload: bytes) -> None:
        """Emit a whole skippable frame; only legal before frame data
        (reference: WriteSkipFrameHeader, plz4_writer.go:60-62).

        Note this method is stricter than the spec: the format allows
        skippable frames *between* LZ4 frames too, which the reference (and
        this package) supports via the free function
        `plz4_tpu_torch.write_skip_frame_header` on the raw destination stream —
        this Writer method refuses once its own frame has started."""
        self._check_writable()
        if self._header_written or self._stage or self._src_total:
            # staged-but-unflushed data counts as "frame started": emitting
            # the skip frame now would reorder it ahead of earlier writes
            raise zerr.ErrSkip
        self._write_out(hdr.write_skip_header(nibble, len(payload)))
        self._write_out(payload)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()
        else:
            self._closed = True
            self._shutdown_pool()
        return False

    @property
    def dst_position(self) -> int:
        return self._dst_pos

    def __del__(self):  # best-effort: abandoned writers must not leak threads
        try:
            if self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
            if self._hasher is not None:
                self._hasher.stop()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _check_writable(self) -> None:
        if self._closed:
            raise zerr.ErrClosed
        if self._err is not None:
            raise self._err

    def _latch(self, e: BaseException) -> None:
        # first error wins (reference: CAS latch, async/writer.go:552-583)
        if self._err is None:
            self._err = e

    def _write(self, data) -> int:
        with span("writer.write", cut_bytes=0) as sp:
            # cast to a bytes view: for non-uint8 buffers (e.g. an 'I'-typed
            # array) len(mv) counts ELEMENTS while slices copy bytes, which
            # would emit oversized blocks and miscount content_size
            mv = memoryview(data).cast("B")
            # the device path hands a full block of an immutable input on
            # as a view of it: nothing can change it while the block waits
            # in a batch. A mutable buffer may change once write() returns,
            # so its blocks are copied, as on the native backends.
            view = self._use_device and type(mv.obj) is bytes
            consumed = cut = 0
            bs = self._o.block_size
            while consumed < len(mv):
                if not self._stage and len(mv) - consumed >= bs:
                    # full block straight from the caller's buffer (reference:
                    # large-write no-copy path, sync/writer.go:96-107)
                    blk = mv[consumed:consumed + bs]
                    if not view:
                        blk = bytes(blk)
                        cut += bs
                    self._submit_block(blk)
                    consumed += bs
                else:
                    take = min(bs - len(self._stage), len(mv) - consumed)
                    self._stage += mv[consumed:consumed + take]
                    consumed += take
                    cut += take
                    if len(self._stage) == bs:
                        self._submit_block(bytes(self._stage))
                        self._stage.clear()
            self._src_total += consumed
            sp.add(cut_bytes=cut)
            return consumed

    def _ensure_header(self) -> None:
        if self._header_written:
            return
        raw = hdr.write_header(
            block_size_idx=self._o.block_size_idx,
            block_linked=self._o.block_linked,
            block_checksum=self._o.block_checksum,
            content_checksum=self._o.content_checksum,
            content_size=self._o.content_size,
            dict_id=self._o.dict_id,
        )
        self._write_out(raw)
        self._header_written = True

    def _block_dict(
            self, src: bytes | memoryview) -> bytes | memoryview | None:
        """The window src's block encodes after: in linked mode a snapshot
        of the trailing 64 KiB, which then advances over src; else the
        frame's dictionary."""
        if not self._o.block_linked:
            return self._o.dictionary
        with span("writer.window"):
            d = self._window or None
            # a block of WINDOW_SIZE or more holds the whole next window;
            # the window of a full block is the block itself, not a copy
            # (a view where the block is one); join, unlike +, takes views
            self._window = (src if len(src) >= WINDOW_SIZE
                            else b"".join((self._window, src)))[-WINDOW_SIZE:]
            return d

    def _submit_block(self, src: bytes | memoryview) -> None:
        self._ensure_header()
        if self._hasher is not None:
            self._hasher.update(src)
        if (self._parallel == 0 and self._o.block_linked
                and not self._use_device):
            # sync linked mode skips the window snapshot entirely (the
            # stream context below carries it)
            self._submit_sync_linked(src)
            return
        d = self._block_dict(src)

        if self._use_device:
            # windows were snapshotted above, so linked/dict blocks still
            # batch and encode in parallel on device
            self._device_stage.append((src, d))
            if len(self._device_stage) >= self._device_batch_size():
                self._run_device_batch()
            return

        if self._parallel == 0:
            stored, raw = _compress_job(src, d, self._o.level)
            self._emit(stored, raw, len(src))
            return

        # threaded path: blocks are dispatched in small groups so the
        # future/GIL overhead amortizes (one task = several GIL-releasing
        # C calls)
        self._group.append((src, d, self._o.level))
        if len(self._group) >= self._group_n:
            self._submit_group()

    def _submit_sync_linked(self, src: bytes) -> None:
        """Sync linked mode: a stateful stream context carries match state
        across blocks — no per-block window loading at all (reference
        analog: LZ4_compress_fast_continue, clz4/clz4.go:211-286)."""
        if self._stream is None:
            self._stream = native.StreamCompressor(
                self._o.level, dict_=self._o.dictionary)
        if len(src) == 0:
            self._emit(b"", True, 0)
            return
        out = self._stream.compress(src, len(src) - 1 if len(src) > 1 else 1)
        self._emit(src if out is None else out, out is None, len(src))

    def _submit_group(self) -> None:
        if not self._group:
            return
        group = self._group
        self._group = []
        if self._o.worker_pool is not None:
            # shared pool (reference: WithWorkerPool, plz4_opts.go:107-111)
            fut = self._o.worker_pool.submit(_compress_group, group)
        else:
            if self._pool is None:
                self._pool = _make_pool(self._parallel, "plz4-compress")
            fut = self._pool.submit(_compress_group, group)
        self._pending.append((fut, [len(s) for s, _, _ in group]))
        self._drain(wait_all=False)
        budget_groups = max(1, self._budget // max(1, self._group_n))
        while len(self._pending) >= budget_groups:
            self._drain_one()

    def _device_batch_size(self) -> int:
        if self._o.device_batch > 0:
            return self._o.device_batch
        from ..frame import descriptor as desc
        return {
            desc.BLOCK_IDX_64KB: 128,
            desc.BLOCK_IDX_256KB: 32,
            desc.BLOCK_IDX_1MB: 8,
            desc.BLOCK_IDX_4MB: 2,
        }[self._o.block_size_idx]

    def _run_device_batch(self, wait_all: bool = False) -> None:
        """Dispatch the staged blocks and double-buffer: batch k+1's
        staging/H2D overlaps batch k's device compute (kernel launches are
        asynchronous; Pending.result() is the only blocking point). The
        pipeline depth is one in-flight batch — deeper queues would only
        grow device-memory footprint, not overlap."""
        if self._device_stage:
            from ..parallel import batch as dev_batch
            staged = self._device_stage
            self._device_stage = []
            blocks = [s for s, _ in staged]
            dicts = [d for _, d in staged]
            pending = dev_batch.encode_blocks_begin(
                blocks, self._o.block_size, level=self._o.level,
                dicts=dicts if any(d for d in dicts) else None,
                with_checksums=self._o.block_checksum,
                device=self._device, array_path=self._o.array_path)
            self._device_pending.append((pending, blocks))
        while (self._device_pending if wait_all
               else len(self._device_pending) > 1):
            self._drain_device_one()

    def _drain_device_one(self) -> None:
        with span("writer.drain"):
            pending, blocks = self._device_pending.popleft()
            results = pending.result()
            if self._o.block_checksum:
                # block hashes were computed on device alongside the encode
                for src, (stored, raw, csum) in zip(blocks, results):
                    self._emit(stored, raw, len(src), checksum=csum)
            else:
                for src, (stored, raw) in zip(blocks, results):
                    self._emit(stored, raw, len(src))

    def _drain_one(self) -> None:
        fut, src_lens = self._pending.popleft()
        for (stored, raw), src_len in zip(fut.result(), src_lens):
            self._emit(stored, raw, src_len)

    def _drain(self, wait_all: bool) -> None:
        if wait_all:
            self._submit_group()
        while self._pending:
            fut, _ = self._pending[0]
            if not wait_all and not fut.done():
                return
            self._drain_one()
        if wait_all:
            self._run_device_batch(wait_all=True)

    def _flush_stage(self) -> None:
        self._ensure_header()
        if self._stage:
            self._submit_block(bytes(self._stage))
            self._stage.clear()

    def _emit(self, stored: bytes, uncompressed: bool, src_len: int,
              checksum: int | None = None) -> None:
        wire = block_io.frame_block(
            stored, uncompressed, self._o.block_checksum,
            hash_fn=native.xxh32, checksum=checksum)
        self._write_out(wire)
        self._src_emitted += src_len
        if self._o.progress is not None:
            self._o.progress(self._src_emitted, self._dst_pos)

    def _write_out(self, b: bytes) -> None:
        self._dst.write(b)
        self._dst_pos += len(b)

    def _shutdown_pool(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        if self._hasher is not None:
            self._hasher.stop()
        self._pending.clear()
        self._group = []
        self._device_stage = []
        for pending, _ in self._device_pending:
            pending.discard()  # return staging buffers without fetching
        self._device_pending.clear()
