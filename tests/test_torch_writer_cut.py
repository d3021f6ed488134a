"""The Writer's block cut on the device backend: a full block of a bytes
input goes on as a view of it, every other input is copied.

A view is safe only where nothing can change the caller's buffer while the
block waits in a batch. These tests overwrite mutable sources after each
write() while their blocks still wait (a device batch fills at 128 blocks
or at close()), and hold the view path's frames to the copy path's, byte for
byte, on device="cpu" (the kernels' plain versions).
"""

import io
import mmap

import numpy as np
import pytest

import plz4_tpu_torch as plz4

from conftest import make_compressible, make_incompressible

N = 65536


def _device(**kw):
    return dict(backend="device", device="cpu", level=1, **kw)


def _mmap(b: bytes):
    m = mmap.mmap(-1, len(b))
    m[:] = b
    return m


# mutable sources of one block's bytes, each as write() would get it
SOURCES = {
    "bytearray": bytearray,
    "numpy": lambda b: np.frombuffer(b, np.uint8).copy(),
    "memoryview": lambda b: memoryview(bytearray(b)),
    "readonly_view": lambda b: memoryview(bytearray(b)).toreadonly(),
    "mmap": _mmap,
}


def _overwrite(src) -> None:
    buf = src.obj if isinstance(src, memoryview) else src
    np.frombuffer(buf, np.uint8)[:] = 0xEE


@pytest.mark.parametrize("linked", [False, True], ids=["indep", "linked"])
@pytest.mark.parametrize("kind", list(SOURCES))
def test_mutable_input_is_never_aliased(kind, linked):
    """Three full blocks from a mutable source, each overwritten once
    write() returns, while all three wait in the Writer's device stage:
    the frame still decodes to the bytes written."""
    blocks = [make_compressible(N, seed=40 + i) for i in range(2)]
    blocks.append(make_incompressible(N, seed=42))
    dst = io.BytesIO()
    with plz4.Writer(dst, **_device(block_size_idx=plz4.BLOCK_IDX_64KB,
                                    block_linked=linked)) as w:
        for b in blocks:
            src = SOURCES[kind](b)
            assert w.write(src) == N
            _overwrite(src)
    frame = dst.getvalue()
    want = b"".join(blocks)
    assert plz4.decompress(frame) == want
    assert plz4.decompress(frame, backend="device", device="cpu") == want


def _payload(bs: int) -> bytes:
    """Full blocks and a short last block: at 64 and 256 KiB two, the second
    incompressible (a raw block stored from the view); at 4 MiB one."""
    text = b"".join(b"record %d of the log, status ok\n" % i
                    for i in range(bs // 24))
    if bs > 4 * N:
        return text[:bs] + text[:777]
    return text[:bs] + make_incompressible(bs, seed=8) + text[:777]


DICT = b"a dictionary of records, status ok\n" * 40
# each block size with independent and linked blocks, each with and without
# a dictionary and with both checksums on in half of them
SIZES = {plz4.BLOCK_IDX_64KB: ("64KB", N),
         plz4.BLOCK_IDX_256KB: ("256KB", 4 * N),
         plz4.BLOCK_IDX_4MB: ("4MB", 64 * N)}
CASES = [(idx, linked, d, sums) for idx in SIZES
         for linked, d, sums in ((False, None, False), (True, None, True),
                                 (False, DICT, True), (True, DICT, False))]
IDS = ["-".join((SIZES[i][0], "linked" if l else "indep",
                 "dict" if d else "nodict", "sums" if s else "nosums"))
       for i, l, d, s in CASES]


@pytest.mark.parametrize("idx,linked,dict_,sums", CASES, ids=IDS)
def test_view_frames_equal_copy_frames(idx, linked, dict_, sums):
    """A bytes input (full blocks cut as views) gives the same frame as the
    same bytes in a bytearray (every block copied)."""
    opts = _device(block_size_idx=idx, block_linked=linked, dictionary=dict_,
                   block_checksum=sums, content_checksum=sums)
    data = _payload(SIZES[idx][1])
    frame = plz4.compress(data, **opts)
    assert frame == plz4.compress(bytearray(data), **opts)
    assert plz4.decompress(frame, dictionary=dict_) == data
