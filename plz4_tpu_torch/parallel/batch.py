"""Host<->device block batching for the CUDA codec.

Pads ragged blocks into fixed-shape (B, N) batches (B bucketed to a power
of two, so staging buffers recycle across batches), dispatches the encode
and decode kernels and compacts the ragged results back out (the
reference's CompressBound-buffer + size-word scheme, blk/blk.go:69-106).

Dispatch is asynchronous: rows are staged in pinned host tensors, copied
to the device, and the kernel and the copy back run on the current CUDA
stream behind an event. Pending.result() is the only point that waits.
The engine keeps two batches in flight, so a batch's staging buffers go
back to the pool only at its result() or discard().

The level picks the encode kernel, as in the JAX package's device ladder
(dispatch_encode, dispatch_encode_dict): greedy at levels 1-2 (K2a, or K2b
after a window), the depth-2 chain at 3-7 (K2c), the depth-4 chain at 8
(K2d) and the deep hash-chain finder at 9-12 (K4, walk budget _DEEP_TRIES).
Blocks over 64 KiB go to large.py as 64 KiB chunks (encode) and records
(decode). Windows (dictionaries and linked predecessors) go to the
window-prefix variants of the encode kernels, and to K3 to decode.

Block checksums are hashed on the device by K7 (ops/xxh32.py), in the same
stream and before the batch's event, as the JAX package does with
xxh32_jax: an encode batch hashes its compressed candidates and its raw
rows (assemble picks one per block), a decode batch its staged compressed
rows. Raw pass-through blocks verify on the host (native.xxh32).

On device="cpu" the same layer runs the kernels' plain versions
synchronously (tests).

array_path=True (Options.array_path) routes the codec through the torch
tensor programs A1 and A2 (ops/encode_array.py, ops/decode_array.py) in
place of the encode and decode kernels, as the JAX package does off the
TPU: plain rows through A1, rows after a window (dictionaries, linked
blocks, the large-block chunks) through A1's window variant, and blocks of
at most 64 KiB through A2; large blocks of several records decode on the
host (large.py). Block checksums stay on K7. The frames are the JAX
package's device-backend frames on a non-TPU backend, byte for byte.

Under a block mesh (mesh.py: an active one, or one passed as `device`),
encode_blocks_begin and decode_blocks_begin shard once, at the top, before
the large-block route: each entry's contiguous slice of the batch runs
through the single-device path on the entry's device and stream, and one
Pending, whose children are the slices, assembles their results in frame
order (the JAX package shards in each layer instead: _shard_args/_fetch
here and in large.py; the output contract is the same).
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

from .. import errors as zerr
from ..ops import decode as dec_ops
from ..ops import decode_array as dec_arr
from ..ops import encode as enc_ops
from ..ops import encode_array as enc_arr
from ..ops import encode_deep as deep_ops
from ..ops import encode_mid as mid_ops
from ..ops import xxh32 as xxh_ops
from ..spans import span
from . import mesh as mesh_mod

EMPTY_BLOCK = b"\x00"  # 1-byte literals-only token: decodes to b""
EMPTY_HASH = 0x02cc5d05  # xxh32(b"")
MAX_BLOCK = enc_ops.MAX_ROW  # widest batch row (64 KiB); wider: large.py
WINDOW = enc_ops.MAX_WINDOW  # window row width D of the dictionary paths


# deep-tier chain-walk budget per level (the JAX package's device ladder);
# levels above 12 take 32
_DEEP_TRIES = {9: 2, 10: 8, 11: 16, 12: 32}


def dispatch_encode(data, lens, level: int):
    """The encode kernel of `level` over plain rows."""
    if level <= 2:
        return enc_ops.encode_batch(data, lens)
    if level <= 8:
        return mid_ops.encode_batch_mid(data, lens, depth4=level >= 8)
    return deep_ops.encode_batch_deep(data, lens,
                                      tries=_DEEP_TRIES.get(level, 32))


def dispatch_encode_dict(data, lens, windows, wlens, level: int,
                         wstride: int = 1, chunks: int = 1):
    """The encode kernel of `level` over rows after a window prefix, shared
    by the dict branch below and the large-block chunk path (large.py).
    wstride > 1 strides the window preload of the greedy and chain kernels
    (large-block chunks); the deep kernel inserts every window position."""
    if level <= 2:
        return enc_ops.encode_batch_window(data, lens, windows, wlens,
                                           wstride, chunks)
    if level <= 8:
        return mid_ops.encode_batch_mid_window(
            data, lens, windows, wlens, depth4=level >= 8, wstride=wstride,
            chunks=chunks)
    return deep_ops.encode_batch_deep_window(
        data, lens, windows, wlens, tries=_DEEP_TRIES.get(level, 32),
        chunks=chunks)


def dispatch_encode_dict_array(data, lens, windows, wlens, level: int,
                               wstride: int = 1, chunks: int = 1):
    """A1 over rows after a window prefix: dispatch_encode_dict's
    signature on the array path. wstride is ignored, as the JAX package's
    array path ignores it. With chunks > 1 the rows are groups of `chunks`
    chunk rows (large.py) and windows holds each group's chunk-0 window:
    every later chunk's window is the chunk row before it, built here on
    the device."""
    if chunks > 1:
        rows = data.reshape(windows.shape[0], chunks, -1)
        windows = torch.cat([windows[:, None], rows[:, :-1]],
                            dim=1).reshape(data.shape)
    return enc_arr.encode_batch_dict(data, lens, windows, wlens, level)


def _pow2(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, n))))


class _HostPool:
    """Recycled host staging tensors keyed by (shape, dtype, pinned).
    Pinned pages make the copies asynchronous and are slow to allocate,
    so a batch's buffers are reused by later batches of the same shape."""

    def __init__(self, max_per_key: int = 4) -> None:
        self._free: dict = {}
        self._max = max_per_key
        self._lock = threading.Lock()

    def take(self, shape, dtype, pinned: bool) -> torch.Tensor:
        key = (tuple(shape), dtype, pinned)
        with self._lock:
            free = self._free.get(key)
            if free:
                return free.pop()
        return torch.empty(shape, dtype=dtype, pin_memory=pinned)

    def give(self, t: torch.Tensor) -> None:
        key = (tuple(t.shape), t.dtype, t.is_pinned())
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self._max:
                free.append(t)


_pool = _HostPool()


class Pending:
    """A dispatched device batch. Kernel launches and copies are
    asynchronous, so the device computes while the caller stages or
    consumes other batches; result() waits for the batch's event and
    those of its children, then assembles host bytes. The engine
    double-buffers these (reference analog: the async reader/writer
    overlap of staging and compute, SURVEY §2.2).

    `assemble` is a callable, or a list of steps run in order, the last
    one returning the result. A decode batch checks every block's hash in
    an earlier step than any block's bytes, so a sharded batch can raise
    what the unsharded batch raises: the first failing step, over all
    slices, in frame order (failed_step names the step a result() raised
    in)."""

    def __init__(self, assemble, staging, event=None, children=()):
        self.steps = (list(assemble) if isinstance(assemble, (list, tuple))
                      else [assemble])
        self._staging = staging
        self._event = event  # CUDA event recorded after the batch's work
        self._children = tuple(children)  # sub-batches the steps consume
        self._result = None
        self._done = False
        self.failed_step: int | None = None

    def result(self):
        if not self._done:
            with span("batch.result"):
                try:
                    self.failed_step = -1
                    with span("batch.wait"):
                        self._wait()
                    with span("batch.assemble"):
                        for k, step in enumerate(self.steps):
                            self.failed_step = k
                            out = step()
                    self.failed_step = None
                    self._result = out
                finally:
                    self._release()
        return self._result

    def discard(self):
        """Abort path: return staging buffers without assembling. Used by
        engine shutdown so in-flight batches do not orphan pool buffers;
        the batch's copies may still be running, so it waits for them.
        Child batches (the large-block paths and a mesh split a batch) are
        discarded too."""
        if not self._done:
            self._wait()
            self._release()

    def _wait(self):
        for c in self._children:
            if not c._done:
                c._wait()
        if self._event is not None:
            self._event.synchronize()

    def _release(self):
        """Give back the staging buffers, and those of every child that a
        step did not consume (a step raised before it)."""
        for b in self._staging:
            _pool.give(b)
        self._staging = ()
        self._done = True
        self.steps = ()
        for c in self._children:
            c.discard()


def resolve_device(device=None) -> torch.device:
    """The torch.device of the device backend: "cuda" (the default) runs
    the CUDA kernels and needs a visible GPU (nothing falls back to the
    CPU); "cpu" runs the kernels' plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'the device backend on device="cuda" needs a CUDA GPU; pass '
            'device="cpu" to run the kernels\' plain versions')
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _mesh_of(device):
    """The mesh a batch shards over: `device` itself when it is one, else
    the active mesh unless the caller named a device."""
    if isinstance(device, mesh_mod.BlockMesh):
        return device
    return mesh_mod.active_mesh() if device is None else None


def _sharded(mesh, n: int, begin) -> Pending:
    """Split a batch of n blocks over mesh: begin(lo, hi, device) dispatches
    blocks [lo, hi) through the single-device path, here on each entry's
    device under its stream with the mesh switched off, for the entries
    this process owns. The returned Pending's result() waits for every
    slice and assembles their results in frame order; a failure in any
    slice (on any rank: dist.gather_outcomes) raises, on every rank, the
    error of the first failing step in frame order."""
    own: list[tuple[int, Pending]] = []
    try:
        for k, ((lo, hi), e) in enumerate(zip(mesh_mod.shard_bounds(n, mesh),
                                              mesh.entries)):
            if hi == lo or e.rank != mesh.rank:
                continue
            stream = (torch.cuda.stream(e.stream) if e.stream is not None
                      else contextlib.nullcontext())
            with mesh_mod.use_mesh(None), stream:
                own.append((k, begin(lo, hi, e.device)))
    except BaseException:
        for _, c in own:
            c.discard()
        raise

    def assemble():
        outcomes = {}
        for k, c in own:
            # every slice is assembled, and its buffers given back, before
            # any raises (and, across ranks, before the gather)
            try:
                outcomes[k] = (None, c.result())
            except Exception as e:  # re-raised below, on every rank
                outcomes[k] = ((c.failed_step, k), e)
        if mesh.multiprocess:
            from . import dist

            outcomes = dist.gather_outcomes(mesh, outcomes)
        failed = [o for o in outcomes.values() if o[0] is not None]
        if failed:
            raise min(failed, key=lambda o: o[0])[1]
        return [r for k in sorted(outcomes) for r in outcomes[k][1]]

    return Pending(assemble, (), children=[c for _, c in own])


def _encode_hashed(kernel):
    """kernel followed by K7 over its compressed candidates (their first
    min(total, CAP) bytes) and over the raw rows."""
    def run(data, lens, *rest):
        out, totals, ok = kernel(data, lens, *rest)
        return (out, totals, ok,
                xxh_ops.xxh32_batch(out, totals.clamp(max=out.shape[1])),
                xxh_ops.xxh32_batch(data, lens))
    return run


def _decode_hashed(kernel):
    """kernel preceded by K7 over the staged compressed rows."""
    def run(comp, clens, *rest):
        h = xxh_ops.xxh32_batch(comp, clens)
        return (*kernel(comp, clens, *rest), h)
    return run


def _dispatch(kernel, host_args, dev: torch.device, extra=()):
    """Run kernel over host staging tensors on dev. Returns its outputs on
    the host and the CUDA event that marks them ready (None on the CPU,
    where the plain version runs synchronously). On CUDA the outputs come
    back by asynchronous copies into pinned pool tensors."""
    with span("batch.enqueue", h2d_bytes=0, d2h_bytes=0) as sp:
        if dev.type == "cpu":
            return kernel(*host_args, *extra), None
        args = [a.to(dev, non_blocking=True) for a in host_args]
        sp.add(h2d_bytes=sum(a.nbytes for a in host_args))
        outs = kernel(*args, *extra)
        host = [_pool.take(o.shape, o.dtype, True) for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        sp.add(d2h_bytes=sum(h.nbytes for h in host))
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return host, event


def encode_blocks_begin(blocks: list[bytes], block_size: int, level: int = 1,
                        dicts: list[bytes | None] | None = None,
                        with_checksums: bool = False,
                        device=None, array_path: bool = False) -> Pending:
    """Dispatch a device encode batch and return a Pending (the engine
    overlaps the next batch's staging with this one's compute).

    dicts, when given, supplies a per-block window (linked mode / user
    dictionary): blocks still encode in parallel because windows were
    snapshotted before dispatch (reference: async/writer.go:412-437).
    Returns [(stored_bytes, uncompressed_flag)] in order, applying the
    incompressible-fallback contract per block. The level picks the kernel
    (dispatch_encode), or array_path=True A1; with_checksums=True appends
    each stored block's xxh32, hashed on the device (zero host hashing).
    """
    with span("batch.begin"):
        if not blocks:
            return Pending(list, ())
        # validate BEFORE taking pool buffers: a raise here must not leak them
        for blk in blocks:
            if len(blk) > block_size:
                raise zerr.ErrSrcSize
        mesh = _mesh_of(device)
        if mesh is not None:
            return _sharded(mesh, len(blocks), lambda lo, hi, dev: (
                encode_blocks_begin(
                    blocks[lo:hi], block_size, level=level,
                    dicts=dicts[lo:hi] if dicts is not None else None,
                    with_checksums=with_checksums, device=dev,
                    array_path=array_path)))
        if block_size > MAX_BLOCK:
            from . import large

            if any(len(b) > large.CHUNK for b in blocks):
                # 256 KiB-4 MiB blocks: encode as window-prefixed 64 KiB
                # chunks in parallel, stitch into standard LZ4 blocks
                return large.encode_large_begin(
                    blocks, block_size, level=level, dicts=dicts,
                    with_checksums=with_checksums, device=device,
                    array_path=array_path)
            block_size = large.CHUNK  # all blocks fit one chunk row
        dev = resolve_device(device)
        pinned = dev.type == "cuda"
        B = _pow2(len(blocks))
        N = block_size
        windowed = dicts is not None and any(d for d in dicts)
        with span("batch.stage"):
            arr = _pool.take((B, N), torch.uint8, pinned)
            lens = _pool.take((B,), torch.int32, pinned)
            a, ln = arr.numpy(), lens.numpy()
            ln.fill(0)
            for i, blk in enumerate(blocks):
                a[i, : len(blk)] = np.frombuffer(blk, dtype=np.uint8)
                a[i, len(blk):] = 0
                ln[i] = len(blk)
            a[len(blocks):] = 0
            staging = [arr, lens]
            if windowed:
                with span("batch.stage_window"):
                    # right-aligned (B, 64 KiB) windows, each row's usable
                    # length in wlens; every window position seeds the
                    # tables (wstride 1)
                    darr = _pool.take((B, WINDOW), torch.uint8, pinned)
                    dlens = _pool.take((B,), torch.int32, pinned)
                    da, dl = darr.numpy(), dlens.numpy()
                    dl.fill(0)
                    for i, d in enumerate(dicts):
                        d = d[-WINDOW:] if d else b""
                        da[i, : WINDOW - len(d)] = 0
                        if d:
                            da[i, WINDOW - len(d):] = np.frombuffer(
                                d, dtype=np.uint8)
                            dl[i] = len(d)
                    da[len(dicts):] = 0
                    staging += [darr, dlens]
        if windowed:
            kernel = (dispatch_encode_dict_array if array_path
                      else dispatch_encode_dict)
            args = (arr, lens, darr, dlens)
        else:
            kernel = enc_arr.encode_batch if array_path else dispatch_encode
            args = (arr, lens)
        if with_checksums:
            kernel = _encode_hashed(kernel)
        outs_h, event = _dispatch(kernel, args, dev, extra=(level,))
        out, totals, compressible = outs_h[:3]

        def assemble():
            outs = out.numpy()
            tot = totals.numpy()
            comp = compressible.numpy()
            if with_checksums:
                comp_hash, raw_hash = outs_h[3].numpy(), outs_h[4].numpy()
            results = []
            for i, blk in enumerate(blocks):
                if len(blk) == 0:
                    stored, raw = b"", True
                elif bool(comp[i]) and int(tot[i]) < len(blk):
                    stored, raw = outs[i, : int(tot[i])].tobytes(), False
                else:
                    stored, raw = blk, True
                if not with_checksums:
                    results.append((stored, raw))
                    continue
                csum = (EMPTY_HASH if not blk else
                        int(raw_hash[i]) if raw else int(comp_hash[i]))
                results.append((stored, raw, csum))
            return results

        return Pending(assemble, staging + list(outs_h), event=event)


def decode_blocks_begin(stored: list[tuple[bytes, bool]], block_size: int,
                        dict_: bytes | None = None,
                        checksums: list | None = None,
                        device=None, array_path: bool = False) -> Pending:
    """Dispatch a device decode batch of (stored_bytes, uncompressed_flag)
    blocks; Pending.result() yields the decoded bytes in order.

    Uncompressed blocks pass through (reference: async/reader.go:149-163
    routes them around the workers). Blocks over 64 KiB go to large.py;
    with a frame dictionary the blocks decode through K3 (array_path=True:
    every block of at most 64 KiB through A2). `checksums`, when
    given, carries the frame's expected per-block xxh32 values: compressed
    blocks verify in one K7 launch per batch, raw pass-through blocks on
    the host at result() time, which raises ErrBlockHash before
    ErrDecompress, in consume order.
    """
    if not stored:
        return Pending(list, ())
    # validate BEFORE sharding and taking pool buffers: a raise here must
    # not leak them
    if block_size <= MAX_BLOCK and any(
            not unc and len(data) > block_size for data, unc in stored):
        raise zerr.ErrBlockSizeOverflow
    mesh = _mesh_of(device)
    if mesh is not None:
        return _sharded(mesh, len(stored), lambda lo, hi, dev: (
            decode_blocks_begin(
                stored[lo:hi], block_size, dict_=dict_,
                checksums=checksums[lo:hi] if checksums is not None else None,
                device=dev, array_path=array_path)))
    if block_size > MAX_BLOCK:
        from . import large

        # large-BD frames: split each block at sequence boundaries; K5
        # decodes the records of multi-record blocks in order
        return large.decode_large_begin(stored, block_size, dict_=dict_,
                                        checksums=checksums, device=device,
                                        array_path=array_path)
    comp_idx = [i for i, (_, unc) in enumerate(stored) if not unc]
    results: list[bytes | None] = [
        data if unc else None for (data, unc) in stored]

    def verify_raw():
        if checksums is None:
            return
        from .. import native

        for i, (data, unc) in enumerate(stored):
            if unc and checksums[i] is not None:
                if native.xxh32(data) != checksums[i]:
                    raise zerr.ErrBlockHash

    if not comp_idx:
        return Pending([verify_raw, lambda: results], ())
    dev = resolve_device(device)
    pinned = dev.type == "cuda"
    B = _pow2(len(comp_idx))
    C = block_size + dec_ops.ROW_SLACK
    arr = _pool.take((B, C), torch.uint8, pinned)
    clens = _pool.take((B,), torch.int32, pinned)
    a, cl = arr.numpy(), clens.numpy()
    cl.fill(1)
    a[:, 0] = EMPTY_BLOCK[0]
    a[:, 1:] = 0
    for j, i in enumerate(comp_idx):
        data = stored[i][0]
        a[j, : len(data)] = np.frombuffer(data, dtype=np.uint8)
        cl[j] = len(data)
    staging = [arr, clens]
    if dict_:
        # the dictionary right-aligned in one 64 KiB window row, shared by
        # the batch (offsets reach at most 65535 bytes back, so the last
        # 64 KiB is all of it that a block can use); A2's row is the pow2
        # bucket of the dictionary, as in the JAX package
        d = dict_[-WINDOW:]
        D = _pow2(max(16, len(d))) if array_path else WINDOW
        dbuf = _pool.take((D,), torch.uint8, pinned)
        db = dbuf.numpy()
        db[: D - len(d)] = 0
        db[D - len(d):] = np.frombuffer(d, dtype=np.uint8)
        staging.append(dbuf)
        kernel = (dec_arr.decode_batch_dict if array_path
                  else dec_ops.decode_batch_dict)
        args, extra = (arr, clens, dbuf), (len(d), block_size)
    else:
        kernel = dec_arr.decode_batch if array_path else dec_ops.decode_batch
        args, extra = (arr, clens), (block_size,)
    hashed = checksums is not None and any(
        checksums[i] is not None for i in comp_idx)
    if hashed:
        kernel = _decode_hashed(kernel)
    outs_h, event = _dispatch(kernel, args, dev, extra=extra)
    out, n_out, ok = outs_h[:3]

    def check_hashes():
        verify_raw()
        if hashed:
            got = outs_h[3].numpy()
            for j, i in enumerate(comp_idx):
                if checksums[i] is not None and int(got[j]) != checksums[i]:
                    raise zerr.ErrBlockHash

    def assemble():
        outs = out.numpy()
        n = n_out.numpy()
        okv = ok.numpy()
        for j, i in enumerate(comp_idx):
            if not bool(okv[j]):
                raise zerr.ErrDecompress
            results[i] = outs[j, : int(n[j])].tobytes()
        return results

    return Pending([check_hashes, assemble], staging + list(outs_h),
                   event=event)
