"""Deep hash-chain LZ4 block encode with lazy matching (device levels 9-12):
kernel K4 and its plain version.

encode_batch_deep (plain rows) and encode_batch_deep_window (rows after a
window prefix: linked and dictionary blocks, large-block chunks) run the
CUDA kernel csrc/lz4_encode_deep.cu on CUDA tensors and the plain version
on CPU tensors. Both are byte-exact with the JAX package's Pallas kernel
(encode_pallas.encode_batch_pallas_deep and encode_batch_pallas_deep_dict):
the same ok and total per row, and the same stream bytes [0, total) where
ok holds.

The routing of those Pallas wrappers shapes the output, so it is kept as
it is (deep_route): a row takes a 2^15-slot head table when its i32 chain
fits the TPU kernel's element budget, else, after a window, a 2^14-slot
head with the window cut to its last 32 KiB (the u16-delta-chain variant),
else the depth-4 chain (encode_mid, which takes K6b at depth 2 for rows
the byte-wide budget refuses). Rows of at most 64 KiB after windows of at
most 64 KiB never take the last case; whole blocks over about 66 KiB do.

Plain rows of at most PIPE_MAX_ROW bytes (every plain row of the batch
layer) launch K4's pipelined kernel: the parse reads the walk table from a
ring in shared memory that the block's other warps fill while it runs, so
no table goes to device memory. Rows after a window, and wider plain rows,
launch the kernel that writes the whole table to device memory first. The
route follows from the shape alone (Dc == 0 and N); both give the same
bytes.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from . import encode_mid
from .encode import (BW_MAX_ELEMS, MAX_DISTANCE, _common, _emit, _finish,
                     _words, check_rows, check_windows, empty_outputs,
                     out_width, plain_batch)

# parse and routing constants (own copies; tests pin them to the Pallas
# module's)
DEEP_HASH_LOG = 15  # i32-chain rows
DEEP_HASH_LOG_U16 = 14  # u16-delta-chain rows (windows over the budget)
WINDOW_CUT = 32768  # the u16-chain variant keeps the last 32 KiB of window
LAZY_CAP = 64  # lazy matching stops at a match this long
MIN_MATCH = 4

# plain rows this wide or narrower take the pipelined kernel: the chain
# ring (csrc/lz4_encode_deep.cuh: LZ4T_DEEP_RING) holds all their links
PIPE_MAX_ROW = 65536

launches = 0  # K4 launches by encode_batch_deep
window_launches = 0  # K4 launches by encode_batch_deep_window
pipelined_rows = 0  # rows that encode_batch_deep gave the pipelined kernel


def deep_route(N: int, D: int | None) -> tuple[int, int] | None:
    """(hash_log, Dc) for rows of width N, plain (D None) or after a D-byte
    window, as encode_block_pallas_deep / _deep_dict route them: each row
    reads the last Dc bytes of its window. None: the depth-4 fallback."""
    CAP = out_width(N)
    n_in = (D or 0) + N + 8
    if 2 * n_in + CAP + (1 << DEEP_HASH_LOG) <= BW_MAX_ELEMS:
        return DEEP_HASH_LOG, D or 0
    if D is None:
        return None
    Dc = min(D, WINDOW_CUT)
    n_in = Dc + N + 8
    if n_in + (n_in + 1) // 2 + CAP + (1 << DEEP_HASH_LOG_U16) \
            <= BW_MAX_ELEMS:
        return DEEP_HASH_LOG_U16, Dc
    return None


def _launch(data, lens, windows, wlens, D: int, chunks: int, tries: int,
            route: tuple[int, int]):
    R, N = data.shape
    hash_log, Dc = route
    data, lens = data.contiguous(), lens.contiguous()
    out, totals, ok = empty_outputs(R, N, data.device)
    if not R:
        return out, totals, ok
    # K4's scratch, written before it is read: each row's chain (one u16
    # delta per row position) and walk table (one u32 per block position)
    delta = torch.empty((R, Dc + N + 8), dtype=torch.int16,
                        device=data.device)
    tab = torch.empty((R, N), dtype=torch.int32, device=data.device)
    win_ptr = wl_ptr = 0
    if Dc:
        windows, wlens = windows.contiguous(), wlens.contiguous()
        win_ptr, wl_ptr = windows.data_ptr(), wlens.data_ptr()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        _build.launch("lz4_encode_deep",
                      (data.data_ptr(), lens.data_ptr(), win_ptr, wl_ptr,
                       out.data_ptr(), totals.data_ptr(), ok.data_ptr(),
                       delta.data_ptr(), tab.data_ptr()),
                      (R, N, D, chunks, Dc, out.shape[1], tries, hash_log),
                      stream)
    return out, totals, ok


def _launch_plain(data, lens, tries: int, hash_log: int):
    R, N = data.shape
    data, lens = data.contiguous(), lens.contiguous()
    out, totals, ok = empty_outputs(R, N, data.device)
    if not R:
        return out, totals, ok
    # the chain's scratch, written before it is read; the walk table stays
    # in shared memory
    delta = torch.empty((R, N + 8), dtype=torch.int16, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        _build.launch("lz4_encode_deep",
                      (data.data_ptr(), lens.data_ptr(), out.data_ptr(),
                       totals.data_ptr(), ok.data_ptr(), delta.data_ptr()),
                      (R, N, out.shape[1], tries, hash_log), stream,
                      fn="lz4t_launch_plain")
    return out, totals, ok


def encode_batch_deep(data: torch.Tensor, lens: torch.Tensor,
                      tries: int = 16):
    """data (B, N) uint8 zero-padded rows with N % 4 == 0 and N <= 4 MiB,
    lens (B,) int32 -> (out (B, CAP) uint8, totals (B,) int32, ok (B,)
    bool), walking at most `tries` chain links per search. On CUDA tensors
    it launches K4 on the current stream without synchronising; on CPU
    tensors it runs the plain version."""
    global launches, pipelined_rows
    _, N = check_rows(data, lens)
    route = deep_route(N, None)
    if route is None:
        return encode_mid.encode_batch_mid(data, lens, depth4=True)
    if data.device.type == "cpu":
        return encode_batch_deep_plain(data, lens, tries)
    if N <= PIPE_MAX_ROW:
        res = _launch_plain(data, lens, tries, route[0])
        pipelined_rows += data.shape[0]
    else:
        res = _launch(data, lens, None, None, 0, 1, tries, route)
    if data.shape[0]:
        launches += 1
    return res


def encode_batch_deep_window(data: torch.Tensor, lens: torch.Tensor,
                             windows: torch.Tensor, wlens: torch.Tensor,
                             tries: int = 16, chunks: int = 1):
    """Deep encode of rows after a right-aligned window prefix: the operands
    and row groups of encode.encode_batch_window, without a preload stride
    (every usable window position is inserted). Returns (out (R, CAP)
    uint8, totals (R,) int32, ok (R,) bool). On CUDA tensors it launches K4
    on the current stream without synchronising; on CPU tensors it runs
    the plain version."""
    global window_launches
    _, N = check_rows(data, lens)
    D = check_windows(data, windows, wlens, chunks)
    route = deep_route(N, D)
    if route is None:
        return encode_mid.encode_batch_mid_window(data, lens, windows, wlens,
                                                  depth4=True, chunks=chunks)
    if data.device.type == "cpu":
        return encode_batch_deep_window_plain(data, lens, windows, wlens,
                                              tries, chunks)
    res = _launch(data, lens, windows, wlens, D, chunks, tries, route)
    if data.shape[0]:
        window_launches += 1
    return res


# ---------------------------------------------------------------------------
# plain version: the same parse over Python bytes, one row at a time
# ---------------------------------------------------------------------------

def encode_row_deep_plain(row: bytes, n: int, N: int, window: bytes = b"",
                          wlen: int = 0, tries: int = 16,
                          hash_log: int = DEEP_HASH_LOG
                          ) -> tuple[bytes, int, bool]:
    """One row of width N (n data bytes) after a right-aligned window (its
    routed bytes: the last Dc), the last wlen of them usable: (stream,
    total, ok). The stream is meaningful where ok holds
    (csrc/lz4_encode_deep.cuh)."""
    OT = out_width(N)
    base = len(window)
    first = base - min(max(wlen, 0), base)
    c = window + row[:N] + bytes(8)
    hashes = _words(c, hash_log)[1].tolist()
    head = [0] * (1 << hash_log)
    chain = [0] * len(c)  # chain[p]: the bucket's previous position + 1
    end = base + n
    mflimit, matchlimit = end - 12, end - 5

    def insert(p: int) -> None:
        h = hashes[p]
        chain[p] = head[h]
        head[h] = p + 1

    def walk(p: int, bl: int) -> tuple[int, int]:
        lo = max(first, p - MAX_DISTANCE)
        cand, bp, t = chain[p] - 1, -1, 0
        while cand >= lo and t < tries:
            if c[cand + bl] == c[p + bl]:
                ln = _common(c, p, cand, matchlimit)
                if ln > bl:
                    bl, bp = ln, cand
            cand = chain[cand] - 1
            t += 1
        return bl, bp

    for p in range(first, base):
        insert(p)
    o = bytearray()
    ip = anchor = base
    overflow = n < 0
    while ip <= mflimit and not overflow:
        sip, bl, bp = ip, 0, -1
        while sip <= mflimit:
            insert(sip)
            bl, bp = walk(sip, MIN_MATCH - 1)
            if bl >= MIN_MATCH:
                break
            sip += 1
        if sip > mflimit:
            ip = sip
            continue
        # lazy: move on while the next position has a strictly longer match
        mip, mlen, mpos, hi = sip, bl, bp, sip + 1
        while mip + 1 <= mflimit and mlen < LAZY_CAP:
            p2 = mip + 1
            insert(p2)
            l2, q2 = walk(p2, mlen)
            hi = p2 + 1
            if l2 <= mlen:
                break
            mip, mlen, mpos = p2, l2, q2
        while mip > anchor and mpos > first and c[mip - 1] == c[mpos - 1]:
            mip -= 1
            mpos -= 1
            mlen += 1
        roomy = _emit(c, o, OT, anchor, mip, mpos, mlen)
        nip = mip + mlen
        for p in range(hi, min(nip, mflimit + 1)):
            insert(p)
        ip = anchor = nip
        overflow = not roomy or len(o) > OT - 16
    return _finish(c, o, OT, anchor, end, n, overflow)


def encode_batch_deep_plain(data: torch.Tensor, lens: torch.Tensor,
                            tries: int = 16):
    """Plain version of encode_batch_deep (same signature and results) on
    CPU tensors."""
    route = deep_route(data.shape[1], None)
    if route is None:
        return encode_mid.encode_batch_mid_plain(data, lens, depth4=True)
    return plain_batch(data, lens, functools.partial(
        encode_row_deep_plain, tries=tries, hash_log=route[0]))


def encode_batch_deep_window_plain(data: torch.Tensor, lens: torch.Tensor,
                                   windows: torch.Tensor, wlens: torch.Tensor,
                                   tries: int = 16, chunks: int = 1):
    """Plain version of encode_batch_deep_window (same signature and
    results) on CPU tensors."""
    D = windows.shape[1]
    route = deep_route(data.shape[1], D)
    if route is None:
        return encode_mid.encode_batch_mid_window_plain(
            data, lens, windows, wlens, depth4=True, chunks=chunks)
    hash_log, Dc = route

    def row(blk: bytes, n: int, N: int, win: bytes, wl: int):
        return encode_row_deep_plain(blk, n, N, win[D - Dc:], wl, tries,
                                     hash_log)

    return plain_batch(data, lens, row, windows, wlens, chunks)
