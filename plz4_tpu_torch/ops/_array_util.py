"""Shared helpers of the array codecs (encode_array / decode_array).

One definition keeps the clipped-gather semantics, which both the
speculative-parse decoder and the argsort match finder depend on, from
diverging between the two modules. Every helper works along the last
dimension, the batch on the dimensions before it.
"""

from __future__ import annotations

import math

import torch


def ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(2, n))))


def gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[..., idx] along the last dimension for in-range indices, idx
    broadcast over arr's leading (batch) dimensions."""
    if idx.shape[:-1] != arr.shape[:-1]:
        idx = idx.expand(*arr.shape[:-1], idx.shape[-1])
    return arr.gather(-1, idx)


def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather with indices clipped to [0, len - 1] (out-of-range reads are
    masked later)."""
    return gather(arr, idx.clamp(0, arr.shape[-1] - 1))


def rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """Reverse cumulative minimum along the last dimension: out[..., p] =
    min(x[..., p:])."""
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def orbit(f: torch.Tensor, start: int, s_max: int) -> torch.Tensor:
    """The orbit of `start` under each row of the strictly increasing map f
    (..., L), whose values lie in [0, L), materialized by pointer-doubling
    path expansion: (..., s_max) positions in depth order. s_max is a power
    of two at least the longest chain."""
    levels = int(math.log2(s_max))
    J = f
    P = torch.full((*f.shape[:-1], 1), start, dtype=f.dtype, device=f.device)
    for _ in range(levels):
        P = torch.cat([P, gather(J, P)], dim=-1)
        J = gather(J, J)
    return P
