"""A1, the port's array encode (plz4_tpu_torch.ops.encode_array), against
the JAX package's XLA array encoder (plz4_tpu.ops.encode_jax) on the CPU.

Byte-exact contract: the same out rows (all CAP bytes), totals and
compressible flags at levels 1, 3, 6 and 9, plain and after right-aligned
windows. One batch of rows runs once per (level, variant) through each
side (cached), and each row is its own test case. Then the JAX package's
encode_jax tests, ported to A1 (device="cpu") with the native codec as the
decoder.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import encode_jax
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import _array_util, decode_array, encode_array

from conftest import make_compressible, make_incompressible

N = 4096  # the held batch's row width
D = 4096  # its window width
LEVELS = [1, 3, 6, 9]


def _period(p: int, n: int = N, seed: int = 0) -> bytes:
    return (make_incompressible(p, seed=100 + p + seed) * (n // p + 1))[:n]


ROWS = {
    "text": make_compressible(N, seed=1),
    "zeros": b"\x00" * N,
    **{f"period{p}": _period(p) for p in (1, 2, 3, 4, 5, 6, 7, 8, 16, 32)},
    "random": make_incompressible(N, seed=2),
    "mixed": (make_compressible(1500, seed=3) + make_incompressible(700, seed=4)
              + b"A" * 600 + make_compressible(1296, seed=5)),
    "long_literals": make_incompressible(1000, seed=6) + b"B" * 500,
    "long_match": (make_compressible(200, seed=7) * 21)[:N],
    **{f"len{k}": make_compressible(k, seed=200 + k) for k in range(17)},
    # the period scans read b[idx - d] at idx < d, wrapping to the row's
    # end: rows whose first bytes equal the zero padding or the row's tail
    "lead_zeros": b"\x00" * 40 + make_compressible(2000, seed=8),
    "head_is_tail": _period(64, seed=1),
    "short_period_head": b"abcabcab" + make_incompressible(300, seed=9),
    "text_short": make_compressible(1000, seed=10),
}
NAMES = list(ROWS)


def _batch():
    data = np.zeros((len(ROWS), N), np.uint8)
    lens = np.zeros((len(ROWS),), np.int32)
    for i, r in enumerate(ROWS.values()):
        data[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    return data, lens


def _windows():
    """Right-aligned windows of varied usable length: full, partial, none,
    a few bytes; text windows share words with the text rows."""
    dlen_cycle = [D, 1000, 0, 17, D - 1, 3000, 5]
    wins = np.zeros((len(ROWS), D), np.uint8)
    wl = np.zeros((len(ROWS),), np.int32)
    for i, name in enumerate(NAMES):
        dl = dlen_cycle[i % len(dlen_cycle)]
        w = (make_compressible(D, seed=300 + i) if i % 2
             else ROWS[name][-D:].rjust(D, b"\x07"))[-dl:] if dl else b""
        wins[i, D - len(w):] = np.frombuffer(w, np.uint8)
        wl[i] = len(w)
    return wins, wl


@functools.cache
def _jax(level: int, variant: str):
    data, lens = _batch()
    if variant == "plain":
        res = encode_jax.encode_batch(jnp.asarray(data), jnp.asarray(lens),
                                      level=level)
    else:
        wins, wl = _windows()
        res = encode_jax.encode_batch_dict(
            jnp.asarray(data), jnp.asarray(lens), jnp.asarray(wins),
            jnp.asarray(wl), level=level)
    return tuple(np.asarray(x) for x in res)


@functools.cache
def _port(level: int, variant: str):
    data, lens = (torch.from_numpy(x) for x in _batch())
    if variant == "plain":
        res = encode_array.encode_batch(data, lens, level)
    else:
        wins, wl = (torch.from_numpy(x) for x in _windows())
        res = encode_array.encode_batch_dict(data, lens, wins, wl, level)
    return tuple(x.numpy() for x in res)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("variant", ["plain", "window"])
@pytest.mark.parametrize("level", LEVELS)
def test_a1_matches_encode_jax(level, variant, name):
    i = NAMES.index(name)
    jo, jt, jc = _jax(level, variant)
    po, pt, pc = _port(level, variant)
    assert po.shape == jo.shape == (len(ROWS), encode_array.out_width(N))
    assert po.dtype == np.uint8 and pt.dtype == np.int32 and pc.dtype == bool
    assert int(pt[i]) == int(jt[i])
    assert bool(pc[i]) == bool(jc[i])
    assert (po[i] == jo[i]).all()


@pytest.mark.parametrize("variant", ["plain", "window"])
def test_a1_streams_decode(variant):
    """Every compressible row's stream decodes through native (after its
    window) to the row."""
    po, pt, pc = _port(9, variant)
    wins, wl = _windows()
    for i, row in enumerate(ROWS.values()):
        if not pc[i]:
            continue
        w = wins[i, D - wl[i]:].tobytes() if variant == "window" else None
        s = po[i, : pt[i]].tobytes()
        assert native.decompress(s, len(row), dict_=w) == row


def test_bare_gathers_stay_in_range(monkeypatch):
    """The orbit's and the emission's unclipped gathers are in range by
    construction (f clipped to [0, M], seg to [0, s_max)): held here on
    every call over a plain and a window batch."""
    seen = []
    real = _array_util.gather

    def checked(arr, idx):
        seen.append(1)
        assert int(idx.min()) >= 0 and int(idx.max()) < arr.shape[-1]
        return real(arr, idx)

    for mod in (_array_util, encode_array, decode_array):
        monkeypatch.setattr(mod, "gather", checked)
    data, lens = (torch.from_numpy(x[:8]) for x in _batch())
    wins, wl = (torch.from_numpy(x[:8]) for x in _windows())
    encode_array.encode_batch(data, lens, 3)
    out, tot, ok = encode_array.encode_batch_dict(data, lens, wins, wl, 9)
    comp = torch.zeros((8, N + 16), dtype=torch.uint8)
    w = min(N + 16, out.shape[1])
    comp[:, :w] = out[:, :w]
    decode_array.decode_batch(comp, tot.clamp(max=N + 16), N)
    assert len(seen) > 50


def test_hash_matches_uint32_arithmetic():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    u[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = ((u * np.uint64(encode_array.HASH_PRIME)) & np.uint64(0xFFFFFFFF)) \
        >> np.uint64(32 - encode_array.HASH_LOG)
    got = encode_array._hash(torch.from_numpy(u.astype(np.int64)))
    assert (got.numpy() == want.astype(np.int64)).all()


def test_constants_match_encode_jax():
    assert encode_array.HASH_PRIME == int(encode_jax.HASH_PRIME)
    assert encode_array.HASH_LOG == encode_jax.HASH_LOG
    assert encode_array.PERIODS == encode_jax.PERIODS
    assert encode_array.PROBE_STEPS == encode_jax.PROBE_STEPS
    assert encode_array.WORD_STEPS == encode_jax.WORD_STEPS
    assert encode_array.MAX_DISTANCE == encode_jax.MAX_DISTANCE
    assert encode_array.MAX_DICT == encode_jax.MAX_DICT
    for level in range(1, 13):
        assert (encode_array.candidates_for_level(level)
                == encode_jax.candidates_for_level(level))


@pytest.mark.parametrize("size", [0, 5, 16, 17, 100, 3000])
def test_encode_block_host_matches_encode_jax(size):
    data = make_compressible(size, seed=400 + size)
    dict_ = make_compressible(2500, seed=401)
    for level in (1, 9):
        assert (encode_array.encode_block_host(data, level, device="cpu")
                == encode_jax.encode_block_host(data, level))
        assert (encode_array.encode_block_host(data, level, dict_,
                                               device="cpu")
                == encode_jax.encode_block_host(data, level, dict_))


# --- the JAX package's encode_jax tests, against A1 ---------------------------


def roundtrip(data: bytes):
    comp = encode_array.encode_block_host(data, device="cpu")
    if comp is None:  # incompressible: raw-block fallback is the contract
        assert len(native.compress(data, level=1)) >= len(data) - 64
        return None
    out = native.decompress(comp, len(data))
    assert out == data, "native decoder rejects the A1 block"
    return comp


@pytest.mark.parametrize("size", [13, 100, 5000, 65536])
def test_roundtrip_text(size):
    comp = roundtrip(make_compressible(size, seed=size))
    if comp and size >= 5000:
        assert len(comp) < size  # text must compress


def test_roundtrip_tiny():
    for size in (0, 1, 5, 12):
        data = make_compressible(size, seed=size)
        comp = encode_array.encode_block_host(data, device="cpu")
        if comp is not None:
            assert native.decompress(comp, len(data)) == data


def test_roundtrip_zeros():
    data = b"\x00" * 60000
    comp = roundtrip(data)
    assert comp is not None and len(comp) < 300


def test_roundtrip_periodic():
    for period in (3, 7, 16, 32):
        pat = (make_incompressible(period, seed=period)
               * (30000 // period + 1))[:30000]
        comp = roundtrip(pat)
        assert comp is not None and len(comp) < len(pat) // 10


def test_roundtrip_random_incompressible():
    data = make_incompressible(30000)
    assert encode_array.encode_block_host(data, device="cpu") is None


def test_roundtrip_mixed():
    data = (make_compressible(20000, seed=1)
            + make_incompressible(5000, seed=2)
            + b"A" * 3000
            + make_compressible(20000, seed=3))
    roundtrip(data)


def test_device_encode_device_decode():
    data = make_compressible(40000, seed=11)
    comp = encode_array.encode_block_host(data, device="cpu")
    out = decode_array.decode_block_host(comp, out_cap=len(data),
                                         device="cpu")
    assert out == data


def test_ratio_vs_native_greedy(text_1mb):
    data = text_1mb[:65536]
    comp_dev = encode_array.encode_block_host(data, device="cpu")
    comp_nat = native.compress(data, level=1)
    assert comp_dev is not None
    # within 25% of the native greedy encoder (native L1 hashes 5 bytes on
    # >= 64 KiB inputs; A1 hashes 4)
    assert len(comp_dev) <= int(len(comp_nat) * 1.25), (
        len(comp_dev), len(comp_nat))


def test_long_literal_run_extension():
    # >270 literals forces multi-byte literal-length extension fields
    data = make_incompressible(1000, seed=4) + b"B" * 500
    roundtrip(data)


def test_long_match_extension():
    # a very long match forces multi-byte match-length extensions
    data = make_compressible(200, seed=5) * 300
    comp = roundtrip(data)
    assert comp is not None


def test_encode_batch():
    blocks = [make_compressible(3000, seed=s) for s in range(5)]
    arr = np.zeros((len(blocks), N), dtype=np.uint8)
    lens = np.zeros((len(blocks),), dtype=np.int32)
    for i, blk in enumerate(blocks):
        arr[i, : len(blk)] = np.frombuffer(blk, dtype=np.uint8)
        lens[i] = len(blk)
    out, totals, compressible = encode_array.encode_batch(
        torch.from_numpy(arr), torch.from_numpy(lens))
    for i, blk in enumerate(blocks):
        assert bool(compressible[i])
        comp = out[i, : int(totals[i])].numpy().tobytes()
        assert native.decompress(comp, len(blk)) == blk


def test_device_encode_with_dict():
    dict_ = make_incompressible(4096, seed=31)
    data = dict_[-2000:] + b"tail" * 50
    comp = encode_array.encode_block_host(data, dict_=dict_, device="cpu")
    assert comp is not None
    assert native.decompress(comp, len(data), dict_=dict_) == data
    # the dictionary must improve the ratio
    comp_nd = encode_array.encode_block_host(data, device="cpu")
    if comp_nd is not None:
        assert len(comp) < len(comp_nd)


def test_device_encode_dict_device_decode():
    dict_ = make_incompressible(8192, seed=32)
    data = dict_[-3000:]
    comp = encode_array.encode_block_host(data, dict_=dict_, device="cpu")
    out = decode_array.decode_block_host(comp, out_cap=len(data),
                                         dict_=dict_, device="cpu")
    assert out == data


def test_device_encode_hc_levels_ratio():
    data = make_compressible(65536, seed=33)
    c1 = encode_array.encode_block_host(data, level=1, device="cpu")
    c9 = encode_array.encode_block_host(data, level=9, device="cpu")
    assert c1 is not None and c9 is not None
    assert len(c9) <= len(c1)
    assert native.decompress(c9, len(data)) == data


def test_device_encode_batch_dict():
    B, W = 4, 4096
    dicts_raw = [make_incompressible(W, seed=40 + i) for i in range(B)]
    blocks = [d[-2000:] + bytes([i]) * 2096 for i, d in enumerate(dicts_raw)]
    data = np.zeros((B, N), np.uint8)
    lens = np.zeros((B,), np.int32)
    dicts = np.zeros((B, W), np.uint8)
    dlens = np.zeros((B,), np.int32)
    for i in range(B):
        data[i, : len(blocks[i])] = np.frombuffer(blocks[i], np.uint8)
        lens[i] = len(blocks[i])
        dicts[i, W - len(dicts_raw[i]):] = np.frombuffer(dicts_raw[i],
                                                         np.uint8)
        dlens[i] = len(dicts_raw[i])
    out, totals, _ = encode_array.encode_batch_dict(
        torch.from_numpy(data), torch.from_numpy(lens),
        torch.from_numpy(dicts), torch.from_numpy(dlens))
    for i in range(B):
        comp = out[i, : int(totals[i])].numpy().tobytes()
        assert native.decompress(comp, len(blocks[i]),
                                 dict_=dicts_raw[i]) == blocks[i]
