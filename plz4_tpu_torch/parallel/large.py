"""Device large-block paths (256 KiB / 1 MiB / 4 MiB frame blocks).

The CUDA kernels work on rows of at most 64 KiB, but the frame format's
block classes go to 4 MiB with a 4 MiB default (reference:
descriptor/index.go:92-125, plz4_opts.go:238-255). A large block is
handled as K chunks of 64 KiB:

  * encode: every chunk encodes independently (in parallel on the device)
    through the level's window-prefix encode kernel (K2b, K2c/K2d or K4:
    batch.dispatch_encode_dict), with the previous chunk as its window.
    The chunk span equals the LZ4 window, so [prev|cur] covers every
    position's full 64 KiB reach and the chunk streams hold the matches a
    monolithic encoder could use. The native stitcher
    (native.stitch_chunks) then merges the chunk streams into ONE standard
    LZ4 block, carrying trailing literal runs across boundaries.

  * decode: the native splitter (native.chunk_split) walks the sequence
    structure (control plane only: it skips literal bytes) and cuts the
    stream into records of <= 64 KiB output with carry metadata; K5
    decodes each block's records in order in one launch, each record
    against the previous record's output. Bulk byte movement stays on the
    device; the host does O(sequences) pointer walking.

Block checksums of large blocks are computed by the native xxh32 at
assemble time over the stitched (encode) or stored (decode) bytes, which
exist on the host only, as in the JAX package; blocks of at most 64 KiB in a
large-BD frame go through the batch layer and hash on the device (K7).

With array_path=True (batch.py) the chunk rows encode through A1's window
variant, each chunk's window built on the device from the chunk before it
(wstride ignored), and blocks of several records decode on the host
through native, as the JAX package's non-TPU path does (the carry-record
formulation is a kernel's).

Under a block mesh this layer is not sharded itself: batch.py splits the
batch over the mesh before its large-block route, so each slice arrives
here with its entry's device (the JAX package shards the chunk and record
batches in this layer instead).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import errors as zerr
from .. import native
from ..ops import decode as dec_ops

CHUNK = 65536
# decode-record input slice cap: 64 KiB of literals + their length
# extension (+258) + ONE crossing sequence's length extension (a 4 MiB
# match/literal run costs <= 4 MiB/255 ~= 16450 ext bytes, charged to the
# record where its token lives) + headers/slack
CHUNK_IN = 83968
# window preload stride of chunk rows (the reference's); the deep kernel
# has none
CHUNK_WSTRIDE = 2

host_decodes = 0  # blocks decoded on the host for a record over CHUNK_IN
array_host_decodes = 0  # array path: blocks of several records, on the host


def stage_chunks(blocks, dicts, a, ln, wl, da) -> None:
    """Fill the window encode kernels' chunk-row operands for large blocks:
    a (B, K, CHUNK) rows, ln (B, K) chunk lengths, wl (B, K) usable window
    bytes and da (B, CHUNK) each block's right-aligned window of chunk 0
    (its dictionary or linked predecessor); rows past len(blocks) stay
    empty."""
    a.fill(0)
    ln.fill(0)
    wl.fill(0)
    da.fill(0)
    for j, blk in enumerate(blocks):
        blk = np.frombuffer(blk, dtype=np.uint8)
        kb = (len(blk) + CHUNK - 1) // CHUNK
        a[j, :kb].reshape(-1)[: len(blk)] = blk
        ln[j, :kb] = CHUNK
        ln[j, kb - 1] = len(blk) - (kb - 1) * CHUNK
        # windows: the previous chunk (read in place by the kernel), and
        # for chunk 0 the block's dictionary or linked predecessor
        wl[j, 1:kb] = CHUNK
        d = dicts[j] if dicts else None
        if d:
            d = d[-CHUNK:]
            da[j, CHUNK - len(d):] = np.frombuffer(d, dtype=np.uint8)
            wl[j, 0] = len(d)


def stage_records(items, dict_, r, m, w) -> None:
    """Fill K5's operands for large blocks: items [(stored block bytes,
    its native.chunk_split records)] -> r (B, K, CHUNK_IN) record slices,
    m (B, K, 7) metas (dlen: the frame dictionary's for record 0, CHUNK
    after) and w (B, CHUNK) the right-aligned frame dictionary; padding
    records stay all-zero no-ops."""
    r.fill(0)
    m.fill(0)
    w.fill(0)
    dlen0 = min(len(dict_), CHUNK) if dict_ else 0
    for j, (data, recs) in enumerate(items):
        ca = np.frombuffer(data, dtype=np.uint8)
        for k, rec in enumerate(recs):
            in_off, in_len = int(rec[0]), int(rec[1])
            r[j, k, :in_len] = ca[in_off:in_off + in_len]
        m[j, :len(recs)] = recs[:, [1, 1, 2, 3, 4, 5, 6]]
        m[j, :len(recs), 1] = CHUNK
        m[j, 0, 1] = dlen0
        if dict_:
            dd = dict_[-CHUNK:]
            w[j, CHUNK - len(dd):] = np.frombuffer(dd, dtype=np.uint8)


def encode_large_begin(blocks, block_size: int, level: int = 1,
                       dicts=None, with_checksums: bool = False,
                       device=None, array_path: bool = False):
    """Large-block analog of batch.encode_blocks_begin: blocks may mix
    sizes (a frame's tail block can be <= 64 KiB; those go through the
    chunk-sized batch); returns a Pending with the same result layout."""
    from . import batch as batch_mod

    small_idx = [i for i, b in enumerate(blocks) if len(b) <= CHUNK]
    large_idx = [i for i, b in enumerate(blocks) if len(b) > CHUNK]
    small_pending = None
    if small_idx:
        small_pending = batch_mod.encode_blocks_begin(
            [blocks[i] for i in small_idx], CHUNK, level=level,
            dicts=[dicts[i] for i in small_idx] if dicts else None,
            with_checksums=with_checksums, device=device,
            array_path=array_path)
    if not large_idx:
        return small_pending

    dev = batch_mod.resolve_device(device)
    pinned = dev.type == "cuda"
    # pow2 batch + BD-class chunk count: staging shapes recycle across
    # batches (empty chunk rows cost one token each)
    B = batch_mod._pow2(len(large_idx))
    K = max(block_size, max(len(blocks[i]) for i in large_idx)) // CHUNK
    take = batch_mod._pool.take
    arr = take((B * K, CHUNK), torch.uint8, pinned)
    lens = take((B * K,), torch.int32, pinned)
    wlens = take((B * K,), torch.int32, pinned)
    d0 = take((B, CHUNK), torch.uint8, pinned)
    stage_chunks([blocks[i] for i in large_idx],
                 [dicts[i] for i in large_idx] if dicts else None,
                 arr.numpy().reshape(B, K, CHUNK), lens.numpy().reshape(B, K),
                 wlens.numpy().reshape(B, K), d0.numpy())
    kernel = (batch_mod.dispatch_encode_dict_array if array_path
              else batch_mod.dispatch_encode_dict)
    outs_h, event = batch_mod._dispatch(
        kernel, (arr, lens, d0, wlens), dev, extra=(level, CHUNK_WSTRIDE, K))
    out, totals, _ = outs_h

    def assemble():
        smalls = small_pending.result() if small_pending else []
        CAP = out.shape[1]
        outs = out.numpy().reshape(B, K, CAP)
        tot = totals.numpy().reshape(B, K)
        results: list = [None] * len(blocks)
        for si, r in zip(small_idx, smalls):
            results[si] = r
        for j, i in enumerate(large_idx):
            blk = blocks[i]
            kb = (len(blk) + CHUNK - 1) // CHUNK
            stored, raw = blk, True
            # a chunk at the overflow sentinel leaves the block raw; a
            # chunk that did not shrink still stitches (its literals)
            if int(tot[j, :kb].max()) < CAP:
                st = native.stitch_chunks(
                    blk, CHUNK,
                    [outs[j, k, :int(tot[j, k])].tobytes()
                     for k in range(kb)])
                if st is not None and len(st) < len(blk):
                    stored, raw = st, False
            if with_checksums:
                results[i] = (stored, raw, native.xxh32(stored))
            else:
                results[i] = (stored, raw)
        return results

    return batch_mod.Pending(
        assemble, [arr, lens, wlens, d0, *outs_h], event=event,
        children=[small_pending] if small_pending else ())


def decode_large_begin(stored, block_size: int, dict_=None, checksums=None,
                       device=None, array_path: bool = False):
    """Large-block analog of batch.decode_blocks_begin for frames whose BD
    class exceeds 64 KiB. Per compressed block, the native splitter yields
    its record layout; single-record blocks take the chunk-sized batch
    (K1, or K3 with a dictionary), multi-record blocks K5. Raw blocks pass
    through. Corruption (split failure, record mismatch, checksum)
    surfaces at result() time in consume order, in six steps (raw blocks'
    hashes; split failures; host-valve blocks; the chunk-sized batch's
    hashes, then its bytes; the K5 blocks), so that a batch split over a
    mesh raises what the whole batch raises."""
    from . import batch as batch_mod

    results: list = [None] * len(stored)
    small_idx: list[int] = []      # single carry-free record, K1 / K3
    large: list[tuple[int, np.ndarray]] = []   # (block idx, records), K5
    failed: list[int] = []         # malformed at split time
    host_idx: list[int] = []       # valve, or the array path: native
    for i, (data, unc) in enumerate(stored):
        if unc:
            results[i] = data
            continue
        recs = native.chunk_split(data, CHUNK, max_out=block_size)
        if recs is None:
            failed.append(i)
        elif len(recs) == 1 and len(data) <= CHUNK:
            small_idx.append(i)
        elif array_path or int(recs[:, 1].max()) > CHUNK_IN - 8:
            host_idx.append(i)
        else:
            large.append((i, recs))

    small_pending = None
    if small_idx:
        small_pending = batch_mod.decode_blocks_begin(
            [(stored[i][0], False) for i in small_idx], CHUNK, dict_=dict_,
            checksums=[checksums[i] for i in small_idx]
            if checksums else None, device=device, array_path=array_path)

    staging: list = []
    event = None
    if large:
        dev = batch_mod.resolve_device(device)
        pinned = dev.type == "cuda"
        # pow2 batch + BD-class record count: staging shapes recycle
        # across batches (padding records are no-op decodes)
        B = batch_mod._pow2(len(large))
        K = max(max(len(recs) for _, recs in large),
                block_size // CHUNK + 1)
        take = batch_mod._pool.take
        rows = take((B, K, CHUNK_IN), torch.uint8, pinned)
        metas = take((B, K, 7), torch.int32, pinned)
        win0s = take((B, CHUNK), torch.uint8, pinned)
        stage_records([(stored[i][0], recs) for i, recs in large], dict_,
                      rows.numpy(), metas.numpy(), win0s.numpy())
        outs_h, event = batch_mod._dispatch(
            dec_ops.decode_records_batch, (rows, metas, win0s), dev)
        staging = [rows, metas, win0s, *outs_h]

    # consume order: verify/raise for each block in frame order
    def check_sum(i):
        if checksums is not None and checksums[i] is not None:
            if native.xxh32(stored[i][0]) != checksums[i]:
                raise zerr.ErrBlockHash

    def raw_hashes():
        if checksums is not None:
            for i, (data, unc) in enumerate(stored):
                if unc and checksums[i] is not None:
                    if native.xxh32(data) != checksums[i]:
                        raise zerr.ErrBlockHash

    def split_failures():
        if failed:
            for i in failed:
                check_sum(i)  # checksum failure reports first if both
            raise zerr.ErrDecompress

    def host_blocks():
        global host_decodes, array_host_decodes

        for i in host_idx:
            check_sum(i)
            results[i] = native.decompress(stored[i][0], block_size,
                                           dict_=dict_)
            if array_path:
                array_host_decodes += 1
            else:
                host_decodes += 1

    def small_hashes():
        if small_pending:
            small_pending.steps[0]()

    def small_bytes():
        if small_pending:
            for si, res in zip(small_idx, small_pending.steps[1]()):
                results[si] = res

    def assemble():
        if large:
            outs, ns, oks = (t.numpy() for t in outs_h)
            for j, (i, recs) in enumerate(large):
                check_sum(i)
                want = recs[:, 6]
                kr = len(recs)
                if not (oks[j, :kr].all() and (ns[j, :kr] == want).all()):
                    raise zerr.ErrDecompress
                results[i] = b"".join(
                    outs[j, k, :int(want[k])] for k in range(kr))
        return results

    return batch_mod.Pending(
        [raw_hashes, split_failures, host_blocks, small_hashes, small_bytes,
         assemble], staging, event=event,
        children=[small_pending] if small_pending else ())
