"""Options carrier for Reader/Writer (reference: internal/pkg/opts/opts.go
and the ~20 functional options in plz4_opts.go).

Invalid numeric inputs are clamped, not errored, matching the reference
(plz4_opts.go:140-146 level clamp, :160-164 block-size clamp).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

from .frame import descriptor as desc

# progress(src_offset, dst_position) — emitted per block in frame order
ProgressFn = Callable[[int, int], None]
# skip_callback(reader, nibble, size)
SkipCallbackFn = Callable[[object, int, int], None]
# dict_callback(dict_id) -> bytes | None — override dictionary by frame id
DictCallbackFn = Callable[[int], Optional[bytes]]

DEFAULT_BLOCK_IDX = desc.BLOCK_IDX_4MB
MIN_LEVEL, MAX_LEVEL = 1, 12
WINDOW_SIZE = 65536  # LZ4 match window / linked-block dictionary span


def clamp_level(level: int) -> int:
    return max(MIN_LEVEL, min(MAX_LEVEL, int(level)))


def resolve_parallel(parallel: int) -> int:
    """<0 = auto (cpu count); 0 = sync; n>0 = n workers.

    Reference: WithParallel, plz4_opts.go:70-79.
    """
    if parallel < 0:
        return os.cpu_count() or 1
    return parallel


def calc_pending(pending_size: int, parallel: int, block_size_idx: int) -> int:
    """In-flight block budget (reference: opts.CalcPending, opts/opts.go:62-95):
    -1 = auto-scale by block size (16x/8x/4x/2x parallel for 64K/256K/1M/4M);
    explicit values pass through with a floor of 1."""
    if parallel <= 0:
        return 1
    if pending_size >= 0:
        return max(1, pending_size)
    scale = {
        desc.BLOCK_IDX_64KB: 16,
        desc.BLOCK_IDX_256KB: 8,
        desc.BLOCK_IDX_1MB: 4,
        desc.BLOCK_IDX_4MB: 2,
    }[block_size_idx]
    return scale * parallel


@dataclass
class Options:
    # global
    parallel: int = -1            # <0 auto, 0 sync, n>0 workers
    pending_size: int = -1        # -1 auto (CalcPending)
    content_checksum: bool = True
    progress: Optional[ProgressFn] = None
    dictionary: Optional[bytes] = None
    worker_pool: Optional[object] = None  # object with submit(fn) -> future
    # "native" | "device" | "auto". backend="device" runs the block codec
    # as CUDA kernels (parallel/batch.py): levels 1-12 (greedy, depth-2 and
    # depth-4 chain, deep hash chain), every block size (blocks over 64 KiB
    # as 64 KiB chunks and records), dictionaries, linked blocks and block
    # checksums (hashed on the device).
    backend: str = "auto"
    # write-side
    level: int = 1
    block_checksum: bool = False
    block_size_idx: int = DEFAULT_BLOCK_IDX
    block_linked: bool = False
    content_size: Optional[int] = None
    dict_id: Optional[int] = None
    # read-side
    read_offset: Optional[int] = None
    content_size_check: bool = True
    skip_callback: Optional[SkipCallbackFn] = None
    dict_callback: Optional[DictCallbackFn] = None
    # device engine tuning
    device_batch: int = 0         # 0 = auto per block size
    # torch device of the device backend: "cuda" runs the CUDA kernels,
    # "cpu" their plain versions (tests)
    device: str = "cuda"
    # route the device backend through the torch tensor programs A1/A2
    # (ops/encode_array.py, ops/decode_array.py) in place of the encode and
    # decode kernels: the JAX package's device path off the TPU, whose
    # frames it reproduces byte for byte (checksums stay on K7); needs
    # backend="device"
    array_path: bool = False

    def __post_init__(self) -> None:
        self.level = clamp_level(self.level)
        if self.block_size_idx not in desc.BLOCK_SIZES:
            # accept a byte count and clamp to the nearest class
            self.block_size_idx = desc.block_size_to_idx(int(self.block_size_idx))
        if self.dictionary is not None and len(self.dictionary) > WINDOW_SIZE:
            # only the last 64 KiB is usable window (reference: dupeDict,
            # compress/dict.go:186-199)
            self.dictionary = self.dictionary[-WINDOW_SIZE:]
        if self.backend not in ("native", "device", "auto"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.array_path and self.backend != "device":
            raise ValueError("array_path=True needs backend='device'")

    @property
    def block_size(self) -> int:
        return desc.block_idx_to_size(self.block_size_idx)

    def resolved_parallel(self) -> int:
        return resolve_parallel(self.parallel)

    def pending_budget(self) -> int:
        return calc_pending(
            self.pending_size, self.resolved_parallel(), self.block_size_idx)
