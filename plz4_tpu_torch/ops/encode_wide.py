"""LZ4 block encode of rows too wide for the byte-wide kernels: kernel K6b
and its plain version.

encode_batch_wide runs the CUDA kernel csrc/lz4_encode_wide.cu on CUDA
tensors and the plain version on CPU tensors: greedy (levels 1-2), or the
depth-2 chain (mid, every level above 2 at this width), optionally after a
right-aligned window. It returns what the JAX package's packed-word Pallas
kernel (encode_pallas._encode_kernel, which encode_block_pallas, _dict,
_mid and _mid_dict take where _bw_fits refuses a row) returns: the same ok
and total per row, and the same stream bytes [0, total) where ok holds.
encode.encode_batch / encode_batch_window and encode_mid.encode_batch_mid
/ _window route such rows here (encode.bw_fits).

The parse is the byte-wide kernels' (one warp per row, as K2a/K2b and
K2c run it); the emit is _encode_kernel's, with no room guard
(csrc/lz4_encode.cuh), and the window preload inserts every usable window
position. Rows go up to the 4 MiB LZ4 block.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .encode import (check_rows, check_windows, empty_outputs,
                     encode_row_plain, plain_batch)
from .encode_mid import encode_row_mid_plain

launches = 0  # K6b launches in greedy mode
mid_launches = 0  # K6b launches in mid (depth-2 chain) mode


def encode_batch_wide(data: torch.Tensor, lens: torch.Tensor,
                      windows: torch.Tensor | None = None,
                      wlens: torch.Tensor | None = None, mid: bool = False):
    """data (R, N) uint8 zero-padded rows with N % 4 == 0 and N <= 4 MiB,
    lens (R,) int32; optionally windows (R, D) uint8 right-aligned windows
    with wlens (R,) int32 usable bytes each; mid: the depth-2 chain, else
    greedy. Returns (out (R, CAP) uint8, totals (R,) int32, ok (R,) bool).
    On CUDA tensors it launches K6b on the current stream without
    synchronising; on CPU tensors it runs the plain version."""
    global launches, mid_launches
    R, N = check_rows(data, lens)
    D = 0 if windows is None else check_windows(data, windows, wlens, 1)
    if data.device.type == "cpu":
        return encode_batch_wide_plain(data, lens, windows, wlens, mid)
    out, totals, ok = empty_outputs(R, N, data.device)
    if not R:
        return out, totals, ok
    # the kernel's rows: [window D | block N | 8 zero bytes], built in a
    # device scratch with 16 bytes after the last row, which the parse may
    # read one word into; its warp reads the rows as u32 words
    DT = D + N + 8
    if DT % 4:
        raise ValueError(f"row width {DT}: K6b reads its rows as u32 words")
    flat = torch.empty((R * DT + 16,), dtype=torch.uint8, device=data.device)
    flat[R * DT:] = 0
    rows = flat[:R * DT].view(R, DT)
    if D:
        rows[:, :D] = windows
    rows[:, D:D + N] = data
    rows[:, D + N:] = 0
    lens = lens.contiguous()
    wl_ptr = wlens.contiguous().data_ptr() if D else 0
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        _build.launch("lz4_encode_wide",
                      (rows.data_ptr(), lens.data_ptr(), wl_ptr,
                       out.data_ptr(), totals.data_ptr(), ok.data_ptr()),
                      (R, DT, D, out.shape[1], int(mid)), stream)
    if mid:
        mid_launches += 1
    else:
        launches += 1
    return out, totals, ok


def encode_row_wide_plain(row: bytes, n: int, N: int, window: bytes = b"",
                          wlen: int = 0, mid: bool = False,
                          cap: int | None = None) -> tuple[bytes, int, bool]:
    """One row of width N (n data bytes) after a right-aligned window, the
    last wlen of its bytes usable: (stream, total, ok), K6b's results.
    cap: the output width, out_width(N) unless a test asks for another."""
    if mid:
        return encode_row_mid_plain(row, n, N, window, wlen, guard=False,
                                    cap=cap)
    return encode_row_plain(row, n, N, window, wlen, guard=False, cap=cap)


def encode_batch_wide_plain(data: torch.Tensor, lens: torch.Tensor,
                            windows: torch.Tensor | None = None,
                            wlens: torch.Tensor | None = None,
                            mid: bool = False):
    """Plain version of encode_batch_wide (same signature and results) on
    CPU tensors."""
    return plain_batch(data, lens,
                       functools.partial(encode_row_wide_plain, mid=mid),
                       windows, wlens)
