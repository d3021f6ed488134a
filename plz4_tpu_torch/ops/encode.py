"""Greedy LZ4 block encode (device levels 1-2): kernels K2a and K2b and
their plain version.

encode_batch (K2a, plain rows) and encode_batch_window (K2b, rows after a
window prefix: linked and dictionary blocks, large-block chunks) run the
CUDA kernels csrc/lz4_encode.cu and csrc/lz4_encode_window.cu on CUDA
tensors and the plain version on CPU tensors. All are byte-exact with the
JAX package's Pallas kernel (encode_pallas.encode_batch_pallas and
encode_batch_pallas_dict): the same ok and total per row, and the same
stream bytes [0, total) wherever total < CAP, ok or not (the large-block
path stitches the stream of a chunk that did not shrink). An
incompressible row comes back with ok False, and the frame layer stores it
raw. The kernels parse each row with one warp into sequences (a device
scratch, seq_scratch) and then write them with the whole thread block.

Rows go up to the 4 MiB LZ4 block. Those that the Pallas wrappers' byte-wide
budget refuses (bw_fits: over about 96 KiB plain, 67 KiB after a 64 KiB
window) go to the packed-word kernel K6b (encode_wide.py), as the Pallas
wrappers send them to _encode_kernel; where a row goes decides its bytes.
encode_block_host encodes one block of any size at a device level.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

# parse constants (own copies; tests pin them to the Pallas module's)
HASH_LOG = 14
HASH_MUL = 2654435761
MAX_DISTANCE = 65535
SKIP_STRENGTH = 6
MAX_ROW = 65536  # the batch layer's rows; wider blocks are 64 KiB chunks
MAX_BLOCK_ROW = 4 << 20  # the widest row the encode kernels take
MAX_WINDOW = 65536  # the LZ4 match window
# the Pallas byte-wide kernels' element budget (input + output + tables)
BW_MAX_ELEMS = 230 * 1024
MID_HASH_LOG = 13  # the chain tables' hash log

launches = 0  # K2a launches by encode_batch
window_launches = 0  # K2b launches by encode_batch_window


def out_width(N: int) -> int:
    """Output row width CAP for input rows of width N. It is also the
    encoder's overflow threshold, so it depends on N, not on a row's n."""
    return (N + N // 255 + 64 + 3) & ~3


def bw_fits(n_in: int, cap: int, mid: bool, depth4: bool = False) -> bool:
    """Whether the Pallas wrappers run a row of n_in input bytes ([window |
    block | 8]) and cap output bytes on the byte-wide kernel
    (encode_pallas._bw_fits): K2a-K2d here. False: the packed-word kernel
    K6b, which has no depth-4 tables."""
    tables = (4 if mid and depth4 else 2) << (MID_HASH_LOG if mid
                                              else HASH_LOG)
    return n_in + cap + tables <= BW_MAX_ELEMS


def check_rows(data: torch.Tensor, lens: torch.Tensor) -> tuple[int, int]:
    """(R, N) of an encode launch's rows; raises ValueError on rows the
    encode kernels do not take."""
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("data must be a (R, N) uint8 tensor")
    R, N = data.shape
    if N % 4 or N > MAX_BLOCK_ROW:
        raise ValueError(f"row width {N}: needs N % 4 == 0 and N <= "
                         f"{MAX_BLOCK_ROW}")
    if (lens.shape != (R,) or lens.dtype != torch.int32
            or lens.device != data.device):
        raise ValueError("lens must be a (R,) int32 tensor on data's device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return R, N


def check_windows(data: torch.Tensor, windows: torch.Tensor,
                  wlens: torch.Tensor, chunks: int, wstride: int = 1) -> int:
    """Window width D of a window launch over data's rows (see
    encode_batch_window); raises ValueError on windows the kernels do not
    take."""
    R, N = data.shape
    if windows.dim() != 2 or windows.dtype != torch.uint8:
        raise ValueError("windows must be a (G, D) uint8 tensor")
    G, D = windows.shape
    if (chunks < 1 or G * chunks != R or D % 4 or D > MAX_WINDOW
            or (chunks > 1 and D != N) or wstride < 1):
        raise ValueError(f"windows {tuple(windows.shape)} for {R} rows of "
                         f"{N} bytes in groups of {chunks}, wstride "
                         f"{wstride}: need R == G * chunks, D % 4 == 0, "
                         f"D <= {MAX_WINDOW}, D == N when chunks > 1")
    if (wlens.shape != (R,) or wlens.dtype != torch.int32
            or wlens.device != data.device):
        raise ValueError("wlens must be a (R,) int32 tensor on data's device")
    if windows.device != data.device:
        raise ValueError("windows must be on data's device")
    return D


def empty_outputs(R: int, N: int, device: torch.device):
    """(out (R, CAP) uint8, totals (R,) int32, ok (R,) bool) for a launch."""
    return (torch.empty((R, out_width(N)), dtype=torch.uint8, device=device),
            torch.empty((R,), dtype=torch.int32, device=device),
            torch.empty((R,), dtype=torch.bool, device=device))


def seq_scratch(R: int, N: int, device: torch.device) -> torch.Tensor:
    """The device scratch of an encode launch whose warp parses each row
    into sequences (K2a-K2d): four int32 per sequence, at most N / 4 per row
    of N bytes, and one record more that holds their count."""
    return torch.empty((R, N // 4 + 2, 4), dtype=torch.int32, device=device)


def encode_batch(data: torch.Tensor, lens: torch.Tensor):
    """data (B, N) uint8 zero-padded rows with N % 4 == 0 and N <= 4 MiB,
    lens (B,) int32 -> (out (B, CAP) uint8, totals (B,) int32, ok (B,)
    bool). On CUDA tensors it launches K2a (K6b where bw_fits refuses the
    row) on the current stream without synchronising; on CPU tensors it
    runs the plain version."""
    global launches
    B, N = check_rows(data, lens)
    if not bw_fits(N + 8, out_width(N), mid=False):
        from .encode_wide import encode_batch_wide
        return encode_batch_wide(data, lens)
    if data.device.type == "cpu":
        return encode_batch_plain(data, lens)
    data, lens = data.contiguous(), lens.contiguous()
    out, totals, ok = empty_outputs(B, N, data.device)
    if B:
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            seqs = seq_scratch(B, N, data.device)
            _build.launch("lz4_encode",
                          (data.data_ptr(), lens.data_ptr(), out.data_ptr(),
                           totals.data_ptr(), ok.data_ptr(), seqs.data_ptr()),
                          (B, N, out.shape[1]), stream)
        launches += 1
    return out, totals, ok


def encode_batch_window(data: torch.Tensor, lens: torch.Tensor,
                        windows: torch.Tensor, wlens: torch.Tensor,
                        wstride: int = 1, chunks: int = 1):
    """Encode rows after a right-aligned window prefix.

    data (R, N) uint8 zero-padded rows, lens (R,) int32; windows (R // chunks,
    D) uint8 right-aligned windows, wlens (R,) int32 the usable window bytes
    of each row; every wstride-th window position seeds the match table.
    Rows come in groups of `chunks` consecutive 64 KiB chunks of one large
    block: a row whose index is not a multiple of `chunks` takes the row
    before it as its window (read in place; needs D == N), the first row of
    a group takes windows[r // chunks]. chunks=1 gives each row its own
    window. Returns (out (R, CAP) uint8, totals (R,) int32, ok (R,) bool).
    On CUDA tensors it launches K2b (K6b, which preloads every window
    position, where bw_fits refuses the row) on the current stream without
    synchronising; on CPU tensors it runs the plain version."""
    global window_launches
    R, N = check_rows(data, lens)
    D = check_windows(data, windows, wlens, chunks, wstride)
    if not bw_fits(D + N + 8, out_width(N), mid=False):
        # chunk rows (D == N <= 64 KiB) always fit
        from .encode_wide import encode_batch_wide
        return encode_batch_wide(data, lens, windows, wlens)
    if data.device.type == "cpu":
        return encode_batch_window_plain(data, lens, windows, wlens, wstride,
                                         chunks)
    data, lens = data.contiguous(), lens.contiguous()
    windows, wlens = windows.contiguous(), wlens.contiguous()
    out, totals, ok = empty_outputs(R, N, data.device)
    if R:
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            seqs = seq_scratch(R, N, data.device)
            _build.launch("lz4_encode_window",
                          (data.data_ptr(), lens.data_ptr(),
                           windows.data_ptr(), wlens.data_ptr(),
                           out.data_ptr(), totals.data_ptr(), ok.data_ptr(),
                           seqs.data_ptr()),
                          (R, N, D, chunks, wstride, out.shape[1]), stream)
        window_launches += 1
    return out, totals, ok


# ---------------------------------------------------------------------------
# plain version: the same parse over Python bytes, one row at a time
# ---------------------------------------------------------------------------

def _words(row: bytes, hash_log: int = HASH_LOG
           ) -> tuple[np.ndarray, np.ndarray]:
    """Little-endian u32 at every byte of the row, and its hash."""
    a = np.frombuffer(row + b"\0\0\0", dtype=np.uint8).astype(np.uint64)
    v = a[:-3] | (a[1:-2] << 8) | (a[2:-1] << 16) | (a[3:] << 24)
    h = ((v * HASH_MUL) & 0xFFFFFFFF) >> (32 - hash_log)
    return v, h


def _emit_len_ext(o: bytearray, v: int) -> None:
    o += b"\xff" * (v // 255)
    o.append(v % 255)


def _emit(c: bytes, o: bytearray, OT: int, anchor: int, ip: int,
          mpos: int, mlen: int, guard: bool = True) -> bool:
    """Append literals [anchor, ip) and the match (mpos, mlen; 0 = final
    literals) to o; False when the room guard refuses the sequence.
    guard=False: K6b's emit, which has no room guard (its writes past OT
    are clipped, and only rows that end not ok reach there)."""
    lit = ip - anchor
    if guard and len(o) + lit + (lit >> 8) + (mlen >> 8) + 32 > OT:
        return False
    tok = len(o)
    o.append(0)
    if lit >= 15:
        _emit_len_ext(o, lit - 15)
    o += c[anchor:ip]
    if mlen == 0:
        o[tok] = min(lit, 15) << 4
        return True
    off = ip - mpos
    o += bytes((off & 255, off >> 8))
    mv = mlen - 4
    if mv >= 15:
        _emit_len_ext(o, mv - 15)
    o[tok] = (min(lit, 15) << 4) | min(mv, 15)
    return True


def _common(c: bytes, a: int, b: int, limit: int) -> int:
    """Number of bytes c[a + i] == c[b + i] from i = 0 while a + i < limit."""
    n = 0
    while a + n + 8 <= limit and c[a + n:a + n + 8] == c[b + n:b + n + 8]:
        n += 8
    while a + n < limit and c[a + n] == c[b + n]:
        n += 1
    return n


def encode_row_plain(row: bytes, n: int, N: int, window: bytes = b"",
                     wlen: int = 0, wstride: int = 1, guard: bool = True,
                     cap: int | None = None) -> tuple[bytes, int, bool]:
    """One row of width N (n data bytes) after a right-aligned window of
    len(window) bytes, the last wlen of them usable: (stream, total, ok).
    The stream is meaningful where ok holds. The window preload keeps the
    largest of the positions that share a slot, which is what inserting
    them in order leaves (csrc/lz4_encode.cuh). guard=False is K6b's emit
    (_emit). cap: the output width, out_width(N) unless a test asks for
    another."""
    OT = out_width(N) if cap is None else cap
    base = len(window)
    first = base - min(max(wlen, 0), base)
    c = window + row[:N] + bytes(8)
    clip = len(c) - 4
    words, hashes = _words(c)
    tab = np.zeros(1 << HASH_LOG, dtype=np.int64)
    ps = np.arange(first, base, wstride)
    np.maximum.at(tab, hashes[ps], ps + 1)
    tab = tab.tolist()
    words, hashes = words.tolist(), hashes.tolist()
    end = base + n
    mflimit, matchlimit = end - 12, end - 5
    o = bytearray()
    ip = anchor = base
    overflow = n < 0
    while ip <= mflimit and not overflow:
        sip, cnt, found, cand = ip, 0, False, 0
        while not found and sip <= mflimit:  # sip is below the clip
            u, h = words[sip], hashes[sip]
            cd = tab[h] - 1
            # the stored word of the slot is the word at cd (see
            # csrc/lz4_encode.cuh)
            found = cd >= first and sip - cd <= MAX_DISTANCE and words[cd] == u
            tab[h] = sip + 1
            cand = cd
            if not found:
                sip += 1 + (cnt >> SKIP_STRENGTH)
            cnt += 1
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
        tab[hashes[min(nip - 2, clip)]] = nip - 1
        ip = anchor = nip
        overflow = not roomy or len(o) > OT - 16
    return _finish(c, o, OT, anchor, end, n, overflow, guard)


def _finish(c: bytes, o: bytearray, OT: int, anchor: int, end: int, n: int,
            overflow: bool, guard: bool = True) -> tuple[bytes, int, bool]:
    """Append the final literals [anchor, end) after a parse: (stream,
    total, ok). An overflow, or no room for the literals, gives total OT;
    ok is then OT < n and no overflow, as the kernels compute it, which is
    False at out_width(N) (> n)."""
    rest = end - anchor
    if overflow or len(o) + rest + rest // 255 + 16 > OT \
            or not _emit(c, o, OT, anchor, end, 0, 0, guard):
        return b"", OT, OT < n and not overflow
    return bytes(o), len(o), len(o) < n


def plain_batch(data: torch.Tensor, lens: torch.Tensor, row_fn,
                windows: torch.Tensor | None = None,
                wlens: torch.Tensor | None = None, chunks: int = 1):
    """(out, totals, ok) of a plain version: row_fn(row, n, N) over each
    row, or row_fn(row, n, N, window, wlen) with windows, where row r takes
    row r - 1 as its window when r % chunks > 0, else windows[r //
    chunks]."""
    R, N = data.shape
    d = data.numpy()
    out = torch.zeros((R, out_width(N)), dtype=torch.uint8)
    totals = torch.zeros((R,), dtype=torch.int32)
    ok = torch.zeros((R,), dtype=torch.bool)
    wl = None if wlens is None else wlens.tolist()
    for r, n in enumerate(lens.tolist()):
        if windows is None:
            s, total, good = row_fn(d[r].tobytes(), n, N)
        else:
            win = d[r - 1] if r % chunks else windows.numpy()[r // chunks]
            s, total, good = row_fn(d[r].tobytes(), n, N, win.tobytes(),
                                    wl[r])
        out.numpy()[r, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        totals[r] = total
        ok[r] = good
    return out, totals, ok


def encode_batch_plain(data: torch.Tensor, lens: torch.Tensor):
    """Plain version of K2a (encode_batch's results on rows that bw_fits
    takes) on CPU tensors."""
    return plain_batch(data, lens, encode_row_plain)


def encode_batch_window_plain(data: torch.Tensor, lens: torch.Tensor,
                              windows: torch.Tensor, wlens: torch.Tensor,
                              wstride: int = 1, chunks: int = 1):
    """Plain version of K2b (encode_batch_window's results on rows that
    bw_fits takes) on CPU tensors."""
    return plain_batch(data, lens,
                       functools.partial(encode_row_plain, wstride=wstride),
                       windows, wlens, chunks)


def encode_block_host(data: bytes, level: int = 1, device=None):
    """Encode one block of up to 4 MiB at device level `level` (the batch
    layer's kernel ladder) on the device, CUDA unless device="cpu": its LZ4
    block stream, or None when the block is incompressible (store it raw).
    The counterpart of encode_pallas.encode_block_host."""
    from ..parallel.batch import dispatch_encode, resolve_device

    if not data:
        return b"\x00"
    dev = resolve_device(device)
    N = max(16, (len(data) + 3) & ~3)
    buf = np.zeros((1, N), dtype=np.uint8)
    buf[0, :len(data)] = np.frombuffer(data, dtype=np.uint8)
    out, total, ok = dispatch_encode(
        torch.from_numpy(buf).to(dev),
        torch.tensor([len(data)], dtype=torch.int32, device=dev), level)
    if not bool(ok[0]):
        return None
    return out[0, :int(total[0])].cpu().numpy().tobytes()
