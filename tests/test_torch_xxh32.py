"""Port K7 (xxh32 over a batch of rows): plz4_tpu_torch.ops.xxh32 against
the JAX package's xxh32_jax.xxh32_batch and the native xxh32.

Exact equality: hashes are integers. The plain version (what the port runs
on CPU tensors) and the CUDA kernel's row body built for the host with g++
(csrc/xxh32.cuh) are each held to both references, at every length 0-40,
at 65,536, in rows of odd widths and at two seeds; tests/test_torch_gpu.py
holds the CUDA kernel itself to the plain version on a GPU.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import xxh32_jax
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import _build, xxh32

SEEDS = [0, 0x9E3779B1]
LENGTHS = list(range(41)) + [65535, 65536]


def _blocks() -> list[bytes]:
    rng = np.random.default_rng(0x7832)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in LENGTHS]


def _rows(blocks, width):
    rows = np.zeros((len(blocks), width), np.uint8)
    for i, b in enumerate(blocks):
        rows[i, :len(b)] = np.frombuffer(b, np.uint8)
    return rows, np.array([len(b) for b in blocks], np.int32)


@functools.lru_cache(maxsize=None)
def _jax(seed: int) -> list[int]:
    """xxh32_batch over all blocks (rows padded to its 16-byte multiple)."""
    rows, lens = _rows(_blocks(), 65536)
    return np.asarray(xxh32_jax.xxh32_batch(
        jnp.asarray(rows), jnp.asarray(lens), np.uint32(seed))).tolist()


@functools.lru_cache(maxsize=None)
def _plain(seed: int, width: int) -> list[int]:
    rows, lens = _rows(_blocks(), width)
    return xxh32.xxh32_batch(torch.from_numpy(rows), torch.from_numpy(lens),
                             seed).tolist()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_matches_jax_and_native(seed, n):
    i = LENGTHS.index(n)
    want = native.xxh32(_blocks()[i], seed)
    assert _jax(seed)[i] == want
    assert _plain(seed, 65536)[i] == want


@pytest.mark.parametrize("width", [65537, 65539])
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_odd_row_widths(seed, width):
    """Rows of a width that is no multiple of 4 or 16: only [0, len) is
    read, so the hashes do not move."""
    assert _plain(seed, width) == _jax(seed)


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


@pytest.mark.parametrize("width", [65536, 65537])
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_row_body_matches_jax(seed, width, host_lib):
    """The CUDA kernel's row body (csrc/xxh32.cuh), built for the host."""
    rows, lens = _rows(_blocks(), width)
    out = np.zeros(len(lens), np.int64)
    host_lib.lz4t_host_xxh32(rows.ctypes.data, lens.ctypes.data,
                             out.ctypes.data, len(lens), width,
                             seed - (seed >> 31 << 32))
    assert out.tolist() == _jax(seed)


def test_blocks_host_and_seed_bits():
    blocks = _blocks()[:20] + [b"lz4 " * 1000]
    for seed in (1, 0xFFFFFFFF):
        assert xxh32.xxh32_blocks_host(blocks, seed, device="cpu") == [
            native.xxh32(b, seed) for b in blocks]
    assert xxh32.xxh32_blocks_host([], device="cpu") == []
    assert xxh32.xxh32_blocks_host([b""], device="cpu") == [0x02CC5D05]


@pytest.mark.parametrize("kw,err", [
    (dict(shape=(2, 3, 4)), "data"),
    (dict(dtype=torch.int32), "data"),
    (dict(lens_dtype=torch.int64), "lens"),
    (dict(lens_shape=(3,)), "lens"),
])
def test_xxh32_batch_rejects_bad_operands(kw, err):
    data = torch.zeros(kw.get("shape", (2, 64)), dtype=kw.get("dtype",
                                                              torch.uint8))
    lens = torch.zeros(kw.get("lens_shape", (2,)),
                       dtype=kw.get("lens_dtype", torch.int32))
    with pytest.raises(ValueError, match=err):
        xxh32.xxh32_batch(data, lens)


# ---------------------------------------------------------------------------
# K7's staging ring: rows of any start alignment, lengths at its chunk edges
# ---------------------------------------------------------------------------

# the staging ring's chunk (csrc/xxh32.cuh: LZ4T_XXH_CHUNK)
CHUNK = 4096
XLENGTHS = (list(range(41)) + [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK - 1,
                               2 * CHUNK, 2 * CHUNK + 1, 16383, 16384, 16385,
                               65535, 65536])
# widths of every residue mod 4 and mod 16; 65,860 is CAP of a 64 KiB row,
# the width of the compressed rows the batch layer hashes
XWIDTHS = [65537, 65538, 65539, 65544, 65548, 65860]
# a seed with bit 31 set beside chip_smoke.py's two
XSEEDS = [0, 0x9E3779B1, 0x80000001]


@functools.lru_cache(maxsize=None)
def _xblocks() -> list[bytes]:
    rng = np.random.default_rng(0x7833)
    data = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    return [data[:n] for n in XLENGTHS]


@functools.lru_cache(maxsize=None)
def _xjax(seed: int) -> list[int]:
    rows, lens = _rows(_xblocks(), 65536)
    return np.asarray(xxh32_jax.xxh32_batch(
        jnp.asarray(rows), jnp.asarray(lens), np.uint32(seed))).tolist()


def _at_offset(rows: np.ndarray, offset: int) -> np.ndarray:
    """rows copied to a buffer whose first byte sits `offset` bytes past a
    16-byte boundary."""
    buf = np.zeros(rows.size + 32, np.uint8)
    start = (offset - buf.ctypes.data) % 16
    view = buf[start:start + rows.size].reshape(rows.shape)
    view[:] = rows
    assert view.ctypes.data % 16 == offset
    return view


def test_jax_reference_is_native_xxh32():
    for seed in XSEEDS:
        assert _xjax(seed) == [native.xxh32(b, seed) for b in _xblocks()]


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4, 7, 8, 12, 15])
@pytest.mark.parametrize("width", XWIDTHS)
@pytest.mark.parametrize("seed", XSEEDS)
def test_kernel_row_body_unaligned_rows_match_jax(seed, width, offset,
                                                  host_lib):
    """K7's staging (16-byte loads and funnel shifts, byte loads at a row's
    first and last 16-byte units) and fold, built for the host, on rows
    whose starts fall at every alignment: the first row at `offset` past a
    16-byte boundary, each next one width bytes on."""
    rows, lens = _rows(_xblocks(), width)
    rows = _at_offset(rows, offset)
    out = np.zeros(len(lens), np.int64)
    host_lib.lz4t_host_xxh32(rows.ctypes.data, lens.ctypes.data,
                             out.ctypes.data, len(lens), width,
                             seed - (seed >> 31 << 32))
    assert out.tolist() == _xjax(seed)


@pytest.mark.parametrize("seed", XSEEDS)
def test_plain_chunk_edges_and_unaligned_width(seed):
    rows, lens = _rows(_xblocks(), 65539)
    assert xxh32.xxh32_batch(torch.from_numpy(rows), torch.from_numpy(lens),
                             seed).tolist() == _xjax(seed)
