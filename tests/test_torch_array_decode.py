"""A2, the port's array decode (plz4_tpu_torch.ops.decode_array), against
the JAX package's XLA array decoder (plz4_tpu.ops.decode_jax) on the CPU.

Byte-exact contract: the same out rows (all out_cap bytes), n_out and ok
on valid streams and on damaged ones (flipped bytes, truncated streams,
bad offsets, clen past the row, junk), and against a 64 KiB dictionary.
Each batch runs once through each side (cached), and each row is its own
test case. Then the JAX package's decode_jax tests, ported to A2
(device="cpu") with the native codec as the encoder.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import decode_jax
from plz4_tpu_torch import errors as zerr
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import decode_array

from conftest import make_compressible, make_incompressible

N = 4096  # out_cap of the held batches
C = N + 16  # their row width (the batch layer's slack)


def _payloads() -> dict:
    p = {"text": make_compressible(N, seed=1), "zeros": b"\x00" * N,
         "random": make_incompressible(N, seed=2),
         "long_literals": make_incompressible(1000, seed=3) + b"B" * 500,
         "long_match": make_incompressible(64, seed=4) * 64,
         "mixed": make_compressible(2000, seed=5) + b"Z" * 800,
         "empty": b"", "one": b"a", "n13": b"abcabcabcabca"}
    for per in (1, 2, 3, 4, 7, 8, 15):
        p[f"period{per}"] = (make_incompressible(per, seed=per)
                             * (N // per + 1))[:N]
    return p


def _streams() -> dict:
    """name -> (stream, clen): valid native streams at levels 1 and 12,
    then damaged ones."""
    rows = {}
    for name, data in _payloads().items():
        for level in (1, 12):
            s = native.compress(data, level=level)
            if len(s) <= C:
                rows[f"{name}-l{level}"] = (s, len(s))
    good = native.compress(make_compressible(3000, seed=6), level=1)
    rng = np.random.default_rng(7)
    for k in range(8):
        s = bytearray(good)
        s[int(rng.integers(len(s)))] ^= int(rng.integers(1, 256))
        rows[f"flip{k}"] = (bytes(s), len(s))
    for cut in (1, 2, len(good) // 2, len(good) - 1):
        rows[f"trunc{cut}"] = (good[:cut], cut)
    rows["offset0"] = (bytes([0x14, 0x41, 0, 0, 0x10, 0x41]), 6)
    rows["offset_before_start"] = (bytes([0x14, 0x41, 200, 0, 0x10, 0x41]),
                                   6)
    rows["no_final"] = (bytes([0x04, 1, 0]), 3)
    rows["ones"] = (b"\xff" * 40, 40)
    rows["junk"] = (rng.integers(0, 256, 900, dtype=np.uint8).tobytes(), 900)
    # clen past the row: the stream fills the row, clen claims more
    rows["clen_past_C"] = (native.compress(make_incompressible(N, seed=8),
                                           level=1)[:C], C + 500)
    rows["clen_short"] = (good, len(good) - 7)
    rows["output_past_cap"] = (native.compress(b"\x00" * (N + 300)),
                               len(native.compress(b"\x00" * (N + 300))))
    return rows


STREAMS = _streams()
NAMES = list(STREAMS)


def _batch():
    comp = np.zeros((len(STREAMS), C), np.uint8)
    clens = np.zeros((len(STREAMS),), np.int32)
    for i, (s, cl) in enumerate(STREAMS.values()):
        s = s[:C]
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = cl
    return comp, clens


DICT = make_incompressible(70000, seed=9)[-65536:]
DICT_ROWS = {
    "dict_only": DICT[-3000:],
    "dict_head": DICT[:2000] + make_compressible(1500, seed=10),
    "dict_far": DICT[100:1100] * 3,
    "text": make_compressible(N, seed=11),
    "dict_and_self": DICT[-500:] + b"xyz" * 300,
}


def _dict_batch():
    streams = [native.compress(d, level=lv, dict_=DICT)
               for d in DICT_ROWS.values() for lv in (1, 9)]
    streams.append(bytes([0x00, 0xFF, 0xFF]))  # offset past the window
    comp = np.zeros((len(streams), C), np.uint8)
    clens = np.zeros((len(streams),), np.int32)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = len(s)
    return comp, clens


@functools.cache
def _jax(which: str):
    if which == "plain":
        comp, clens = _batch()
        res = decode_jax.decode_batch(jnp.asarray(comp), jnp.asarray(clens),
                                      out_cap=N)
    else:
        comp, clens = _dict_batch()
        dbuf = jnp.asarray(np.frombuffer(DICT, np.uint8))
        res = jax.vmap(lambda c, n: decode_jax.decode_block(
            c, n, N, dict_=dbuf, dlen=jnp.int32(len(DICT)),
            dict_cap=len(DICT)))(jnp.asarray(comp), jnp.asarray(clens))
    return tuple(np.asarray(x) for x in res)


@functools.cache
def _port(which: str):
    if which == "plain":
        comp, clens = _batch()
        res = decode_array.decode_batch(torch.from_numpy(comp),
                                        torch.from_numpy(clens), N)
    else:
        comp, clens = _dict_batch()
        res = decode_array.decode_batch_dict(
            torch.from_numpy(comp), torch.from_numpy(clens),
            torch.from_numpy(np.frombuffer(DICT, np.uint8).copy()),
            len(DICT), N)
    return tuple(x.numpy() for x in res)


def _same(which, i):
    jo, jn, jk = _jax(which)
    po, pn, pk = _port(which)
    assert po.shape == jo.shape and po.dtype == np.uint8
    assert pn.dtype == np.int32 and pk.dtype == bool
    assert int(pn[i]) == int(jn[i]) and bool(pk[i]) == bool(jk[i])
    assert (po[i] == jo[i]).all()
    return bool(pk[i])


@pytest.mark.parametrize("name", NAMES)
def test_a2_matches_decode_jax(name):
    ok = _same("plain", NAMES.index(name))
    valid = name.rsplit("-", 1)[-1] in ("l1", "l12")
    if valid:
        assert ok  # every valid stream decodes
    elif name.startswith(("offset", "no_final", "clen_past", "trunc",
                          "output_past")):
        assert not ok


@pytest.mark.parametrize("i", range(2 * len(DICT_ROWS) + 1))
def test_a2_dict_64k_matches_decode_jax(i):
    ok = _same("dict", i)
    if i < 2 * len(DICT_ROWS):
        data = list(DICT_ROWS.values())[i // 2]
        po, pn, _ = _port("dict")
        assert ok and po[i, : pn[i]].tobytes() == data
    else:
        assert not ok


def test_a2_valid_rows_are_the_payloads():
    po, pn, pk = _port("plain")
    payloads = _payloads()
    for i, name in enumerate(NAMES):
        base, _, lv = name.rpartition("-")
        if lv in ("l1", "l12"):
            assert po[i, : pn[i]].tobytes() == payloads[base]
            assert not po[i, pn[i]:].any()  # zero-padded past n_out


@pytest.mark.parametrize("size", [0, 100, 5000])
def test_decode_block_host_matches_decode_jax(size):
    data = make_compressible(size, seed=500 + size)
    dict_ = make_compressible(3000, seed=501)
    comp = native.compress(data, level=1)
    assert (decode_array.decode_block_host(comp, size, device="cpu")
            == decode_jax.decode_block_host(comp, size) == data)
    compd = native.compress(data, level=1, dict_=dict_)
    assert (decode_array.decode_block_host(compd, size, dict_,
                                           device="cpu")
            == decode_jax.decode_block_host(compd, size, dict_) == data)


# --- the JAX package's decode_jax tests, against A2 ---------------------------


def roundtrip_device(data: bytes, level: int = 1, dict_: bytes | None = None):
    comp = native.compress(data, level=level, dict_=dict_)
    out = decode_array.decode_block_host(comp, out_cap=max(len(data), 8),
                                         dict_=dict_, device="cpu")
    assert out == data, (
        f"A2 decode mismatch: {len(out)} vs {len(data)} bytes")
    return comp


@pytest.mark.parametrize("level", [1, 12])
@pytest.mark.parametrize("size", [12, 13, 5000, 65536])
def test_roundtrip_sizes(level, size):
    roundtrip_device(make_compressible(size, seed=size + level), level)


def test_roundtrip_tiny():
    for size in (0, 1, 5):
        roundtrip_device(make_compressible(size, seed=size), 1)


def test_roundtrip_random_data():
    roundtrip_device(make_incompressible(10000), 1)


def test_roundtrip_zeros_rle():
    # offset-1 self-referential match chains (worst case for resolution)
    roundtrip_device(b"\x00" * 50000, 1)


def test_roundtrip_short_period_patterns():
    for period in (1, 2, 3, 4, 7, 8, 15):
        pat = (make_incompressible(period, seed=period)
               * (20000 // period + 1))[:20000]
        roundtrip_device(pat, 1)


def test_roundtrip_long_literal_runs():
    # forces 255-run literal-length extensions
    roundtrip_device(make_incompressible(70000, seed=5), 1)


def test_roundtrip_long_matches():
    # forces 255-run match-length extensions
    roundtrip_device(make_incompressible(64, seed=6) * 2000, 1)


@pytest.mark.parametrize("level", [1, 9])
def test_dict_decode(level):
    dict_ = make_incompressible(4096, seed=2)
    data = dict_[-2000:] + b"xyz" * 100
    comp = native.compress(data, level=level, dict_=dict_)
    out = decode_array.decode_block_host(comp, out_cap=len(data),
                                         dict_=dict_, device="cpu")
    assert out == data


def test_dict_64k_window():
    dict_ = make_incompressible(70000, seed=3)
    data = dict_[-1000:]
    comp = native.compress(data, level=1, dict_=dict_)
    # the decoder applies the same last-64 KiB window rule
    out = decode_array.decode_block_host(comp, out_cap=len(data),
                                         dict_=dict_[-65536:], device="cpu")
    assert out == data


def test_corruption_flag():
    data = make_compressible(5000)
    comp = bytearray(native.compress(data, level=1))
    detected = 0
    trials = 0
    for i in range(0, len(comp), 13):
        mutated = bytearray(comp)
        mutated[i] ^= 0xFF
        trials += 1
        try:
            out = decode_array.decode_block_host(bytes(mutated),
                                                 out_cap=len(data),
                                                 device="cpu")
            if out != data:
                detected += 1
        except zerr.Lz4Error:
            detected += 1
    assert detected >= trials // 2  # most corruptions must be caught


def test_truncation_rejected():
    data = make_compressible(5000)
    comp = native.compress(data, level=1)
    for cut in (1, len(comp) // 2, len(comp) - 1):
        try:
            out = decode_array.decode_block_host(comp[:cut],
                                                 out_cap=len(data),
                                                 device="cpu")
            assert out != data
        except zerr.Lz4Error:
            pass


def test_decode_batch():
    blocks = [make_compressible(3000, seed=s) for s in range(6)]
    comps = [native.compress(b, level=1) for b in blocks]
    W = max(len(c) for c in comps) + 8
    arr = np.zeros((len(comps), W), dtype=np.uint8)
    for i, c in enumerate(comps):
        arr[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
    clens = np.array([len(c) for c in comps], dtype=np.int32)
    out, n_out, ok = decode_array.decode_batch(torch.from_numpy(arr),
                                               torch.from_numpy(clens), 3000)
    for i, b in enumerate(blocks):
        assert bool(ok[i])
        assert int(n_out[i]) == len(b)
        assert out[i, : len(b)].numpy().tobytes() == b


def test_empty_token_block():
    # a bare 0x00 token is the empty block
    out = decode_array.decode_block_host(b"\x00", out_cap=8, device="cpu")
    assert out == b""
