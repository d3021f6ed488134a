"""xxHash-32 of each row of a batch: kernel K7 and its plain version.

The device side of block checksums (parallel/batch.py): the encode path
hashes its compressed candidates and its raw rows, the decode path its
staged compressed rows, each in one launch per batch. xxh32_batch runs the
CUDA kernel csrc/xxh32.cu on CUDA tensors and the plain version on CPU
tensors; both return what the JAX package's xxh32_jax.xxh32_batch returns
(the standard xxh32 of each row's first lens[r] bytes), as int64 values
holding the u32 bits. Unlike the JAX version the row width need not be a
multiple of 16: only [0, lens[r]) is read.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

P1 = 2654435761
P2 = 2246822519
P3 = 3266489917
P4 = 668265263
P5 = 374761393
M32 = 0xFFFFFFFF

launches = 0  # K7 launches by xxh32_batch


def xxh32_batch(data: torch.Tensor, lens: torch.Tensor, seed: int = 0):
    """data (B, W) uint8, lens (B,) int32 with 0 <= lens[r] <= W -> (B,)
    int64 hashes. On CUDA tensors it launches K7 on the current stream
    without synchronising; on CPU tensors it runs the plain version."""
    global launches
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError("data must be a (B, W) uint8 tensor")
    B, W = data.shape
    if (lens.shape != (B,) or lens.dtype != torch.int32
            or lens.device != data.device):
        raise ValueError("lens must be a (B,) int32 tensor on data's device")
    seed &= M32
    if data.device.type == "cpu":
        return xxh32_batch_plain(data, lens, seed)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    data, lens = data.contiguous(), lens.contiguous()
    out = torch.empty((B,), dtype=torch.int64, device=data.device)
    if B:
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            # the seed's u32 bits as the C int the launcher takes
            _build.launch("xxh32", (data.data_ptr(), lens.data_ptr(),
                                    out.data_ptr()),
                          (B, W, seed - (seed >> 31 << 32)), stream)
        launches += 1
    return out


def xxh32_blocks_host(blocks: list[bytes], seed: int = 0,
                      device=None) -> list[int]:
    """The xxh32 of each block, hashed as one batch on the device (CUDA
    unless device="cpu")."""
    from ..parallel.batch import resolve_device

    if not blocks:
        return []
    dev = resolve_device(device)
    W = max(1, max(len(b) for b in blocks))
    data = np.zeros((len(blocks), W), dtype=np.uint8)
    for i, b in enumerate(blocks):
        data[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    lens = torch.tensor([len(b) for b in blocks], dtype=torch.int32)
    return xxh32_batch(torch.from_numpy(data).to(dev), lens.to(dev),
                       seed).tolist()


# ---------------------------------------------------------------------------
# plain version: the same fold over Python ints, one row at a time
# ---------------------------------------------------------------------------

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def xxh32_row_plain(row: bytes, seed: int = 0) -> int:
    """The xxh32 of row (csrc/xxh32.cuh)."""
    n = len(row)
    words = np.frombuffer(row[:n // 4 * 4], dtype="<u4").tolist()
    if n >= 16:
        acc = [(seed + P1 + P2) & M32, (seed + P2) & M32, seed,
               (seed - P1) & M32]
        for s in range(0, n // 16 * 4, 4):
            for k in range(4):
                acc[k] = _rotl((acc[k] + words[s + k] * P2) & M32, 13) \
                    * P1 & M32
        h = (_rotl(acc[0], 1) + _rotl(acc[1], 7) + _rotl(acc[2], 12)
             + _rotl(acc[3], 18)) & M32
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    i = n // 16 * 16
    while i + 4 <= n:
        h = _rotl((h + words[i // 4] * P3) & M32, 17) * P4 & M32
        i += 4
    for b in row[i:]:
        h = _rotl((h + b * P5) & M32, 11) * P1 & M32
    h ^= h >> 15
    h = h * P2 & M32
    h ^= h >> 13
    h = h * P3 & M32
    return h ^ (h >> 16)


def xxh32_batch_plain(data: torch.Tensor, lens: torch.Tensor, seed: int = 0):
    """Plain version of xxh32_batch (same signature and results) on CPU
    tensors."""
    d = data.numpy()
    return torch.tensor([xxh32_row_plain(d[r, :n].tobytes(), seed & M32)
                         for r, n in enumerate(lens.tolist())],
                        dtype=torch.int64)
