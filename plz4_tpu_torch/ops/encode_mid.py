"""Chain LZ4 block encode (device levels 3-8): kernels K2c (depth 2, levels
3-7) and K2d (depth 4, level 8) and their plain version.

encode_batch_mid (plain rows) and encode_batch_mid_window (rows after a
window prefix: linked and dictionary blocks, large-block chunks) run the
CUDA kernel csrc/lz4_encode_mid.cu on CUDA tensors and the plain version on
CPU tensors. Both are byte-exact with the JAX package's Pallas kernel in
mid mode (encode_pallas.encode_batch_pallas_mid and
encode_batch_pallas_mid_dict): the same ok and total per row, and the same
stream bytes [0, total) where ok holds. Rows that the byte-wide budget
refuses (encode.bw_fits) go to the packed-word kernel K6b in mid mode, which
has depth 2 only: a level-8 row that wide is encoded at depth 2, as the
Pallas wrappers encode it. The kernel parses each row with one warp and
writes a row's stream wherever total < CAP, as the Pallas kernel does: the
large-block path stitches the stream of a chunk that did not shrink.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .decode import MAX_SMEM
from .encode import (MAX_DISTANCE, MID_HASH_LOG, _common, _emit, _finish,
                     _words, bw_fits, check_rows, check_windows,
                     empty_outputs, out_width, plain_batch, seq_scratch)

launches = 0  # K2c/K2d launches by encode_batch_mid
window_launches = 0  # K2c/K2d launches by encode_batch_mid_window


def tables_spill(N: int, D: int, depth4: bool) -> bool:
    """True when the row [window D | block N | 8] and the kernel's tables do
    not fit shared memory together (depth 4 after a 64 KiB window): the two
    oldest tables then live in a device scratch (csrc/lz4_encode_mid.cu)."""
    return (4 if depth4 else 2) * (4 << MID_HASH_LOG) + D + N + 8 > MAX_SMEM


def _launch(data, lens, windows, wlens, D: int, depth4: bool, wstride: int,
            chunks: int):
    R, N = data.shape
    data, lens = data.contiguous(), lens.contiguous()
    out, totals, ok = empty_outputs(R, N, data.device)
    if not R:
        return out, totals, ok
    scratch = None
    if tables_spill(N, D, depth4):
        scratch = torch.empty((R, 2 << MID_HASH_LOG), dtype=torch.int32,
                              device=data.device)
    seqs = seq_scratch(R, N, data.device)
    win_ptr = wl_ptr = 0
    if D:
        windows, wlens = windows.contiguous(), wlens.contiguous()
        win_ptr, wl_ptr = windows.data_ptr(), wlens.data_ptr()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        _build.launch("lz4_encode_mid",
                      (data.data_ptr(), lens.data_ptr(), win_ptr, wl_ptr,
                       out.data_ptr(), totals.data_ptr(), ok.data_ptr(),
                       0 if scratch is None else scratch.data_ptr(),
                       seqs.data_ptr()),
                      (R, N, D, chunks, wstride, out.shape[1], int(depth4)),
                      stream)
    return out, totals, ok


def encode_batch_mid(data: torch.Tensor, lens: torch.Tensor,
                     depth4: bool = False):
    """data (B, N) uint8 zero-padded rows with N % 4 == 0 and N <= 4 MiB,
    lens (B,) int32 -> (out (B, CAP) uint8, totals (B,) int32, ok (B,)
    bool), with the depth-2 chain (K2c) or, with depth4, the depth-4 chain
    (K2d); rows that bw_fits refuses take K6b at depth 2. On CUDA tensors
    it launches the kernel on the current stream without synchronising; on
    CPU tensors it runs the plain version."""
    global launches
    _, N = check_rows(data, lens)
    if not bw_fits(N + 8, out_width(N), mid=True, depth4=depth4):
        from .encode_wide import encode_batch_wide
        return encode_batch_wide(data, lens, mid=True)
    if data.device.type == "cpu":
        return encode_batch_mid_plain(data, lens, depth4)
    res = _launch(data, lens, None, None, 0, depth4, 1, 1)
    if data.shape[0]:
        launches += 1
    return res


def encode_batch_mid_window(data: torch.Tensor, lens: torch.Tensor,
                            windows: torch.Tensor, wlens: torch.Tensor,
                            depth4: bool = False, wstride: int = 1,
                            chunks: int = 1):
    """Chain encode of rows after a right-aligned window prefix: the
    operands and row groups of encode.encode_batch_window (every wstride-th
    window position seeds the tables; a row whose index is not a multiple
    of `chunks` takes the row before it as its window). Returns (out (R,
    CAP) uint8, totals (R,) int32, ok (R,) bool). On CUDA tensors it
    launches K2c or K2d (K6b at depth 2, which preloads every window
    position, where bw_fits refuses the row) on the current stream without
    synchronising; on CPU tensors it runs the plain version."""
    global window_launches
    _, N = check_rows(data, lens)
    D = check_windows(data, windows, wlens, chunks, wstride)
    if not bw_fits(D + N + 8, out_width(N), mid=True, depth4=depth4):
        # chunk rows (D == N <= 64 KiB) always fit
        from .encode_wide import encode_batch_wide
        return encode_batch_wide(data, lens, windows, wlens, mid=True)
    if data.device.type == "cpu":
        return encode_batch_mid_window_plain(data, lens, windows, wlens,
                                             depth4, wstride, chunks)
    res = _launch(data, lens, windows, wlens, D, depth4, wstride, chunks)
    if data.shape[0]:
        window_launches += 1
    return res


# ---------------------------------------------------------------------------
# plain version: the same parse over Python bytes, one row at a time
# ---------------------------------------------------------------------------

def encode_row_mid_plain(row: bytes, n: int, N: int, window: bytes = b"",
                         wlen: int = 0, wstride: int = 1,
                         depth4: bool = False, guard: bool = True,
                         cap: int | None = None) -> tuple[bytes, int, bool]:
    """One row of width N (n data bytes) after a right-aligned window of
    len(window) bytes, the last wlen of them usable: (stream, total, ok).
    The stream is meaningful where ok holds (csrc/lz4_encode_mid.cuh).
    guard=False is K6b's emit (encode._emit). cap: the output width,
    out_width(N) unless a test asks for another."""
    OT = out_width(N) if cap is None else cap
    base = len(window)
    first = base - min(max(wlen, 0), base)
    c = window + row[:N] + bytes(8)
    clip = len(c) - 4
    words, hashes = _words(c, MID_HASH_LOG)
    words, hashes = words.tolist(), hashes.tolist()
    depth = 4 if depth4 else 2
    # slots[h]: the bucket's positions + 1, newest first (0 = empty)
    slots = [[0] * depth for _ in range(1 << MID_HASH_LOG)]

    def insert(h: int, v: int) -> None:
        s = slots[h]
        s.pop()
        s.insert(0, v)

    for p in range(first, base, wstride):
        insert(hashes[p], p + 1)

    end = base + n
    mflimit, matchlimit = end - 12, end - 5
    o = bytearray()
    ip = anchor = base
    overflow = n < 0
    while ip <= mflimit and not overflow:
        sip, found, cand = ip, False, 0
        while sip <= mflimit:
            u, slot = words[sip], slots[hashes[sip]]
            # score each candidate (newest first: a tie keeps the newer
            # one): 0 when invalid, else 1 plus the equal words at +4 and
            # +8; a valid one lies below sip <= mflimit, so no read clips
            best = 0
            for v in slot:
                cd = v - 1
                if cd < first or cd >= sip or sip - cd > MAX_DISTANCE \
                        or words[cd] != u:
                    continue
                sc = (1 if words[cd + 4] != words[sip + 4] else
                      2 if words[cd + 8] != words[sip + 8] else 3)
                if sc > best:
                    best, cand = sc, cd
            slot.pop()
            slot.insert(0, sip + 1)
            if best:
                found = True
                break
            sip += 1
        if not found:
            ip = sip
            continue
        mip, mpos = sip, cand
        while mip > anchor and mpos > first and c[mip - 1] == c[mpos - 1]:
            mip -= 1
            mpos -= 1
        mlen = sip - mip + 4
        mlen += _common(c, mip + mlen, mpos + mlen, matchlimit)
        roomy = _emit(c, o, OT, anchor, mip, mpos, mlen, guard)
        nip = mip + mlen
        insert(hashes[min(nip - 2, clip)], nip - 1)
        ip = anchor = nip
        overflow = not roomy or len(o) > OT - 16
    return _finish(c, o, OT, anchor, end, n, overflow, guard)


def encode_batch_mid_plain(data: torch.Tensor, lens: torch.Tensor,
                           depth4: bool = False):
    """Plain version of K2c/K2d (encode_batch_mid's results on rows that
    bw_fits takes) on CPU tensors."""
    return plain_batch(data, lens, functools.partial(encode_row_mid_plain,
                                                     depth4=depth4))


def encode_batch_mid_window_plain(data: torch.Tensor, lens: torch.Tensor,
                                  windows: torch.Tensor, wlens: torch.Tensor,
                                  depth4: bool = False, wstride: int = 1,
                                  chunks: int = 1):
    """Plain version of K2c/K2d after a window (encode_batch_mid_window's
    results on rows that bw_fits takes) on CPU tensors."""
    return plain_batch(data, lens, functools.partial(
        encode_row_mid_plain, wstride=wstride, depth4=depth4), windows,
        wlens, chunks)
