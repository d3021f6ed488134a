"""plz4_tpu_torch — parallel LZ4 Frame codec on PyTorch + CUDA.

The PyTorch/CUDA port of plz4_tpu: the same frame surface (parallel LZ4
Frame encode/decode, independent and linked blocks, levels 1-12, content
checksums, dictionaries, skippable frames, frame concatenation, random read
access, a raw block API) with the device block codec running as
hand-written CUDA kernels on an NVIDIA Hopper GPU (csrc/, bound by
ops/_build.py) and a native C++ host codec for the serial/sync paths.

backend="device" covers levels 1-12 at every block size (blocks over 64 KiB
as 64 KiB chunks and records), dictionaries, linked blocks and block
checksums (hashed on the device). ops.encode.encode_block_host and
ops.decode.decode_block_host code single blocks of up to 4 MiB.
"""

def _tune_allocator() -> None:
    """Pin glibc's mmap/trim thresholds so multi-MB buffers (block batches,
    one-shot outputs) are served from reusable heap pages instead of fresh
    mmaps. Fresh mmap pages must be demand-faulted on every call — measured
    at >500 ms per 32 MiB under this class of VM — while recycled heap pages
    are free. Opt out with PLZ4_NO_MALLOPT=1."""
    import ctypes
    import os

    if os.environ.get("PLZ4_NO_MALLOPT"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:  # non-glibc platforms: best effort only
        pass


_tune_allocator()

from . import errors  # noqa: F401,E402
from .api import (  # noqa: F401
    DictContext,
    Reader,
    Writer,
    compress,
    compress_block,
    compress_block_bound,
    decompress,
    decompress_block,
    write_skip_frame_header,
)
from .errors import is_corrupted  # noqa: F401
from .frame.descriptor import (  # noqa: F401
    BLOCK_IDX_64KB,
    BLOCK_IDX_256KB,
    BLOCK_IDX_1MB,
    BLOCK_IDX_4MB,
)
from .opts import Options  # noqa: F401

__version__ = "0.1.0"
