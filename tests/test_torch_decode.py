"""Port K1 (block decode): plz4_tpu_torch.ops.decode against the JAX
package's Pallas kernel (decode_block_pallas, batched by
decode_batch_pallas) in interpret mode.

Contract: the same ok and n_out per row and the same bytes [0, n_out), on
valid, corrupt, truncated and bad-offset streams alike. The plain version
and the CUDA kernel's row body built for the host with g++ are each held to
the Pallas kernel; tests/test_torch_gpu.py holds the CUDA kernel itself to
the plain version on a GPU.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import decode_pallas
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import _build, decode

from conftest import make_compressible, make_incompressible

OUT_CAP = 65536
C = OUT_CAP + decode.ROW_SLACK  # 65,552: the batch layer's row width


def _streams() -> dict:
    s = {}
    for name, data in {
        "empty": b"",
        "one": b"a",
        "n12": b"abcabcabcabc",
        "text": b"hello world " * 12,
        "zeros": b"\x00" * OUT_CAP,
        "vocab4k": make_compressible(4096, seed=1),
        "vocab64k": make_compressible(OUT_CAP, seed=2),
        "period7": (make_incompressible(7, seed=2) * 9400)[:OUT_CAP],
    }.items():
        s["native-" + name] = native.compress(data, level=1)
    # early bad offsets (tests/test_pallas_kernels.py): off > op with op < 8,
    # and off == 0
    s["off50-op0"] = bytes([0x04, 50, 0])
    s["off200-op1"] = bytes([0x14, 0x41, 200, 0])
    s["off0"] = bytes([0x04, 0, 0])
    base = native.compress(make_compressible(2000, seed=4), level=1)
    s["truncated"] = base[: len(base) // 2]
    flipped = bytearray(native.compress(make_compressible(2000, seed=3),
                                        level=1))
    flipped[1] ^= 0xFF
    s["flipped"] = bytes(flipped)
    s["varint-255s"] = b"\xff" * 40
    s["literal-overrun"] = b"\xf0" + b"\xff" * 100 + b"\x05" + b"a" * 400
    big = native.compress(make_compressible(OUT_CAP, seed=11), level=1)
    rng = np.random.default_rng(0x5EED)
    for k in range(24):
        src = bytearray(big if k % 2 else base)
        kind = k % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 6))):
                src[int(rng.integers(len(src)))] = int(rng.integers(256))
            s[f"mut{k}-flips"] = bytes(src)
        elif kind == 1:
            s[f"mut{k}-cut"] = bytes(src[: int(rng.integers(1, len(src)))])
        else:
            n = int(rng.integers(1, 3000))
            s[f"mut{k}-random"] = rng.integers(0, 256, n,
                                               dtype=np.uint8).tobytes()
    return s


STREAMS = _streams()
NAMES = list(STREAMS)


@functools.lru_cache(maxsize=None)
def _full():
    """All streams as zero-padded rows of width C: rows, clens, the Pallas
    result and the plain version's."""
    B = len(STREAMS)
    rows = np.zeros((B, C), np.uint8)
    clens = np.zeros(B, np.int32)
    for i, s in enumerate(STREAMS.values()):
        rows[i, : len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = len(s)
    ref = tuple(np.asarray(x) for x in decode_pallas.decode_batch_pallas(
        jnp.asarray(rows), jnp.asarray(clens), out_cap=OUT_CAP,
        interpret=True))
    got = tuple(t.numpy() for t in decode.decode_batch(
        torch.from_numpy(rows), torch.from_numpy(clens), OUT_CAP))
    return rows, clens, ref, got


def _assert_same(ref, got, i):
    (ro, rn, rk), (go, gn, gk) = ref, got
    assert int(gn[i]) == int(rn[i])
    assert bool(gk[i]) == bool(rk[i])
    n = int(rn[i])
    assert go[i, :n].tobytes() == ro[i, :n].tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_pallas(name):
    _, _, ref, got = _full()
    _assert_same(ref, got, NAMES.index(name))


def test_valid_and_corrupt_verdicts():
    _, _, _, (_, n_out, ok) = _full()
    for i, name in enumerate(NAMES):
        if name.startswith("native-"):
            assert ok[i], name
    for name in ("off50-op0", "off200-op1", "off0", "truncated",
                 "varint-255s", "literal-overrun"):
        assert not ok[NAMES.index(name)], name
    assert int(n_out[NAMES.index("native-zeros")]) == OUT_CAP


def test_single_block_call_matches_plain():
    """decode_block_pallas directly (one row, no batch map)."""
    s = STREAMS["native-vocab4k"]
    row = np.zeros(C, np.uint8)
    row[: len(s)] = np.frombuffer(s, np.uint8)
    ro, rn, rk = decode_pallas.decode_block_pallas(
        jnp.asarray(row), jnp.int32(len(s)), OUT_CAP, interpret=True)
    out, n, ok = decode.decode_batch(
        torch.from_numpy(row[None]),
        torch.tensor([len(s)], dtype=torch.int32), OUT_CAP)
    assert int(n[0]) == int(rn) == 4096 and bool(ok[0]) == bool(rk)
    assert out[0, :4096].numpy().tobytes() == np.asarray(ro)[:4096].tobytes()


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


@pytest.mark.parametrize("name", NAMES)
def test_kernel_row_body_matches_pallas(name, host_lib):
    """The CUDA kernel's row body (csrc/lz4_decode_ring.cuh), built for the
    host with g++, against the Pallas kernel."""
    rows, clens, ref, _ = _full()
    B = rows.shape[0]
    out = np.zeros((B, OUT_CAP), np.uint8)
    n = np.zeros(B, np.int32)
    ok = np.zeros(B, np.uint8)
    host_lib.lz4t_host_decode(rows.ctypes.data, clens.ctypes.data,
                              out.ctypes.data, n.ctypes.data, ok.ctypes.data,
                              B, C, OUT_CAP)
    _assert_same(ref, (out, n, ok), NAMES.index(name))


@pytest.mark.parametrize("C_,cap", [(65554, 65536), (65552, 65537),
                                    (65552, (4 << 20) + 4)])
def test_decode_batch_rejects_bad_widths(C_, cap):
    with pytest.raises(ValueError, match="row widths"):
        decode.decode_batch(torch.zeros((1, C_), dtype=torch.uint8),
                            torch.ones((1,), dtype=torch.int32), cap)
