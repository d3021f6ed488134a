"""Port K6a (packed-word block decode of wide blocks), and K1 at its new
96 KiB width: plz4_tpu_torch.ops.decode against the JAX package's
decode_block_pallas (batched by decode_batch_pallas) in interpret mode.

decode_block_pallas takes out_cap <= 96 KiB on its byte-wide kernel (K1
here) and wider blocks on the packed-word kernel _decode_kernel (K6a). The
contract is the same ok and n_out per row, and the same bytes [0, n_out)
where ok holds, on valid, corrupt, truncated and bad-offset streams alike.
K6a's n_out on a bad literal run is past the bytes it wrote (it can exceed
out_cap), so bytes are compared where ok holds only. The plain version and
the g++ build of the CUDA row body are each held to the Pallas kernel.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu import errors as tpu_errors
from plz4_tpu.ops import decode_pallas
from plz4_tpu_torch import errors, native
from plz4_tpu_torch.ops import _build, decode, encode

from conftest import make_compressible, make_incompressible

WIDE = 131072  # K6a: out_cap over 96 KiB
BW = 98304  # K1 at the widest out_cap it takes


def _streams(cap: int) -> dict:
    text = make_compressible(cap, seed=41)
    s = {name: native.compress(data, level=lvl) for name, data, lvl in [
        ("text", text, 1), ("text-l9", text, 9),
        ("zeros", b"\x00" * cap, 1),
        ("period7", (make_incompressible(7, seed=2) * (cap // 7 + 1))[:cap],
         1),
        ("random", make_incompressible(cap // 2, seed=43), 1),
        ("short", b"hello world " * 12, 1),
        ("empty", b"", 1),
    ]}
    out, tot, ok = encode.encode_batch(
        torch.from_numpy(np.frombuffer(text, np.uint8).copy()[None]),
        torch.tensor([cap], dtype=torch.int32))
    s["port-encode"] = out[0, :int(tot[0])].numpy().tobytes()
    # the end of a block: a final match, and a final literal run only
    s["ends-on-match"] = bytes([0x14, 0x41, 1, 0])
    s["off0"] = bytes([0x04, 0, 0])
    s["off-past-op"] = bytes([0x14, 0x41, 200, 0])
    s["varint-255s"] = b"\xff" * 40
    # bad literal runs: past clen, and past out_cap after some output (the
    # packed-word kernel then reports n_out > out_cap)
    s["lit-past-clen"] = b"\xf0" + b"\xff" * 6 + b"\x05" + b"a" * 400
    big = cap + 5000 - 15
    s["lit-past-cap"] = (bytes([0x14, 0x41, 1, 0])
                         + b"\xf0" + b"\xff" * (big // 255)
                         + bytes([big % 255]) + b"b" * 64)
    base = s["text"]
    s["truncated"] = base[: len(base) // 2]
    rng = np.random.default_rng(0x5EED)
    for k in range(12):
        src = bytearray(base if k % 2 else s["period7"])
        kind = k % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 6))):
                src[int(rng.integers(len(src)))] = int(rng.integers(256))
        elif kind == 1:
            src = src[: int(rng.integers(1, len(src)))]
        else:
            src = bytearray(rng.integers(0, 256, int(rng.integers(1, 3000)),
                                         dtype=np.uint8).tobytes())
        s[f"corrupt{k}"] = bytes(src)
    return s


@functools.lru_cache(maxsize=None)
def _batch(cap: int):
    """Rows as decode_block_host stages them (the stream and 8 zero bytes,
    rounded to 4), the Pallas result and the plain version's."""
    streams = list(_streams(cap).values())
    C = max(16, (max(len(x) for x in streams) + 8 + 3) & ~3)
    rows = np.zeros((len(streams), C), np.uint8)
    for i, x in enumerate(streams):
        rows[i, :len(x)] = np.frombuffer(x, np.uint8)
    clens = np.array([len(x) for x in streams], np.int32)
    ref = tuple(np.asarray(x) for x in decode_pallas.decode_batch_pallas(
        jnp.asarray(rows), jnp.asarray(clens), out_cap=cap, interpret=True))
    got = tuple(t.numpy() for t in decode.decode_batch(
        torch.from_numpy(rows), torch.from_numpy(clens), cap))
    return rows, clens, ref, got


NAMES = list(_streams(1024))


def _assert_same(ref, got, i):
    (ro, rn, rk), (go, gn, gk) = ref, got
    assert bool(gk[i]) == bool(rk[i])
    assert int(gn[i]) == int(rn[i])
    if rk[i]:
        n = int(rn[i])
        assert go[i, :n].tobytes() == ro[i, :n].tobytes()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("cap", [WIDE, BW], ids=["K6a", "K1-96KiB"])
def test_plain_matches_pallas(cap, name):
    _, _, ref, got = _batch(cap)
    _assert_same(ref, got, NAMES.index(name))


def test_verdicts():
    """Valid streams decode, bad ones are refused, and the bad literal run
    past out_cap reports n_out > out_cap on K6a only."""
    _, _, _, (out, n, ok) = _batch(WIDE)
    v = dict(zip(NAMES, zip(ok.tolist(), n.tolist())))
    for name in ("text", "text-l9", "zeros", "period7", "random", "short",
                 "empty", "port-encode"):
        assert v[name][0], name
    for name in ("ends-on-match", "off0", "off-past-op", "varint-255s",
                 "lit-past-clen", "lit-past-cap", "truncated"):
        assert not v[name][0], name
    assert v["lit-past-cap"][1] > WIDE
    assert v["ends-on-match"][1] == 9
    _, _, _, (_, n1, _) = _batch(BW)
    assert n1[NAMES.index("lit-past-cap")] <= BW
    i = NAMES.index("text")
    assert out[i, :n[i]].tobytes() == make_compressible(WIDE, seed=41)


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


@pytest.mark.parametrize("cap", [WIDE, BW], ids=["K6a", "K1-96KiB"])
def test_kernel_row_body_matches_pallas(cap, host_lib):
    """The CUDA row body of K6a and K1 (csrc/lz4_decode_ring.cuh), built for
    the host."""
    rows, clens, ref, _ = _batch(cap)
    B, C = rows.shape
    out = np.zeros((B, cap), np.uint8)
    n = np.zeros(B, np.int32)
    ok = np.zeros(B, np.uint8)
    fn = (host_lib.lz4t_host_decode_wide if cap > decode.BW_MAX_OUT
          else host_lib.lz4t_host_decode)
    fn(rows.ctypes.data, clens.ctypes.data, out.ctypes.data, n.ctypes.data,
       ok.ctypes.data, B, C, cap)
    for i in range(B):
        _assert_same(ref, (out, n, ok), i)


def test_decode_block_host_matches_pallas():
    for name in ("text", "text-l9", "zeros", "short", "empty", "truncated",
                 "lit-past-cap"):
        comp = _streams(WIDE)[name]
        try:
            want = decode_pallas.decode_block_host(comp, WIDE,
                                                   interpret=True)
        except tpu_errors.Lz4Error:
            with pytest.raises(errors.Lz4Error):
                decode.decode_block_host(comp, WIDE, device="cpu")
            continue
        assert decode.decode_block_host(comp, WIDE, device="cpu") == want


def test_decode_block_host_4mib():
    data = make_compressible(4 << 20, seed=44)
    comp = native.compress(data, level=1)
    assert decode.decode_block_host(comp, len(data), device="cpu") == data


@pytest.mark.parametrize("C_,cap", [(1028, (4 << 20) + 4), (1030, WIDE),
                                    (134148, BW)])
def test_decode_batch_rejects_bad_wide_widths(C_, cap):
    with pytest.raises(ValueError, match="row widths"):
        decode.decode_batch(torch.zeros((1, C_), dtype=torch.uint8),
                            torch.ones((1,), dtype=torch.int32), cap)
