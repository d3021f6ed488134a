"""Port K3, K5 and K6c (LZ4 decode against a right-aligned window):
plz4_tpu_torch.ops.decode.decode_batch_dict and decode_records_batch
against the JAX package's Pallas kernels in interpret mode.

  * K3: decode_block_pallas_dict (_decode_dict_kernel, strict=True), whole
    blocks against a frame dictionary, at the batch layer's row widths, on
    the boundary-ending sweep of test_pallas_kernels.py and on corrupt
    streams;
  * K5: decode_chunks_pallas (_decode_kernel_bw_rec scanned over a block's
    records), at the 1 KiB record geometry of test_large_block.py, on valid
    and corrupt records;
  * K6c: _decode_dict_kernel with strict=False, the same function for
    shapes over the TPU's SMEM budget, held to the port on valid records.

Contract: the same ok and n_out per row or record and the same bytes
[0, n_out). The plain versions and the CUDA kernels' row body built with
g++ (csrc/lz4_decode_window.cuh) are each held to the Pallas kernels;
tests/test_torch_gpu.py holds the CUDA kernels to the plain versions.
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from plz4_tpu.ops import decode_pallas
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import _build, decode, encode

from conftest import make_compressible, make_incompressible
from test_large_block import chunked_encode, mixed_payload

IMPLS = ["plain", "g++"]


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


def _lib(impl, request):
    return request.getfixturevalue("host_lib") if impl == "g++" else None


# ---------------------------------------------------------------------------
# K3: whole blocks against a frame dictionary
# ---------------------------------------------------------------------------

def _k3_pallas(rows, clens, dbufs, dlens, out_cap):
    """decode_block_pallas_dict over rows; dbufs/dlens per row."""
    def one(args):
        c, l, d, dl = args
        return decode_pallas.decode_block_pallas_dict(
            c, l, d, dl, out_cap=out_cap, interpret=True)

    return tuple(np.asarray(x) for x in jax.lax.map(one, (
        jnp.asarray(rows), jnp.asarray(clens), jnp.asarray(dbufs),
        jnp.asarray(dlens))))


def _k3_port(impl, lib, rows, clens, dbuf, dlen, out_cap):
    if impl == "plain":
        return tuple(t.numpy() for t in decode.decode_batch_dict(
            torch.from_numpy(rows), torch.from_numpy(clens),
            torch.from_numpy(dbuf), dlen, out_cap))
    B, C = rows.shape
    out = np.zeros((B, out_cap), np.uint8)
    n = np.zeros(B, np.int32)
    ok = np.zeros(B, np.uint8)
    lib.lz4t_host_decode_dict(rows.ctypes.data, clens.ctypes.data,
                              dbuf.ctypes.data, out.ctypes.data,
                              n.ctypes.data, ok.ctypes.data, B, C,
                              dbuf.shape[0], dlen, out_cap)
    return out, n, ok


def _assert_rows_same(ref, got, rows=None):
    (ro, rn, rk), (go, gn, gk) = ref, got
    for i in range(len(rn)) if rows is None else rows:
        assert int(gn[i]) == int(rn[i]), i
        assert bool(gk[i]) == bool(rk[i]), i
        n = int(rn[i])
        assert go[i, :n].tobytes() == ro[i, :n].tobytes(), i


W64 = 65536
C64 = W64 + decode.ROW_SLACK


def _k3_streams():
    """Block streams of a 64 KiB-dictionary frame, valid and corrupt."""
    dict_ = make_compressible(W64, seed=51)
    s = {}
    for name, data in {
        "text": make_compressible(W64, seed=52),
        "dict-words": dict_[1000:30000] + dict_[:20000],
        "short": dict_[-300:] + b"tail",
        "zeros": b"\x00" * W64,
        "random": make_incompressible(4096, seed=53),
    }.items():
        s["native-" + name] = native.compress(data, level=1, dict_=dict_)
    # a K2b stream of the same kind as the device writer's
    rows = np.zeros((1, W64), np.uint8)
    blk = dict_[7:40007]
    rows[0, :len(blk)] = np.frombuffer(blk, np.uint8)
    out, tot, ok = encode.encode_batch_window(
        torch.from_numpy(rows), torch.tensor([len(blk)], dtype=torch.int32),
        torch.from_numpy(np.frombuffer(dict_, np.uint8).copy()[None]),
        torch.tensor([W64], dtype=torch.int32))
    assert bool(ok[0])
    s["k2b"] = out[0, :int(tot[0])].numpy().tobytes()
    # a match that ends exactly at the window/block boundary; an offset
    # one past a 4 KiB window (inside the full one); the largest offset
    s["off-at-window"] = bytes([0x00, 0x04, 0x00]) + bytes([0x40]) + b"abcd"
    s["off-past-window"] = bytes([0x00, 0x01, 0x10]) + bytes([0x40]) + b"abcd"
    s["off-max"] = bytes([0x00, 0xFF, 0xFF]) + bytes([0x40]) + b"abcd"
    s["off0"] = bytes([0x04, 0, 0])
    s["varint-255s"] = b"\xff" * 40
    s["literal-overrun"] = b"\xf0" + b"\xff" * 300 + b"\x05" + b"a" * 400
    base = s["native-dict-words"]
    s["truncated"] = base[: len(base) // 2]
    rng = np.random.default_rng(0xD1C7)
    for k in range(12):
        src = bytearray(base if k % 2 else s["native-text"])
        if k % 3 == 0:
            for _ in range(int(rng.integers(1, 6))):
                src[int(rng.integers(len(src)))] = int(rng.integers(256))
        elif k % 3 == 1:
            src = src[: int(rng.integers(1, len(src)))]
        else:
            src = bytearray(rng.integers(0, 256, int(rng.integers(1, 3000)),
                                         dtype=np.uint8).tobytes())
        s[f"mut{k}"] = bytes(src)
    return dict_, s


K3_DICT, K3_STREAMS = _k3_streams()
K3_NAMES = list(K3_STREAMS)


@functools.lru_cache(maxsize=None)
def _k3_full(dlen: int):
    """The frame path's K3 batch (C = 64 KiB + 16, a 64 KiB window row,
    out_cap 64 KiB) with dlen usable dictionary bytes, and its Pallas
    result."""
    B = len(K3_STREAMS)
    rows = np.zeros((B, C64), np.uint8)
    clens = np.zeros(B, np.int32)
    for i, s in enumerate(K3_STREAMS.values()):
        rows[i, :len(s)] = np.frombuffer(s, np.uint8)
        clens[i] = len(s)
    dbuf = np.zeros(W64, np.uint8)
    dbuf[W64 - dlen:] = np.frombuffer(K3_DICT[W64 - dlen:], np.uint8)
    ref = _k3_pallas(rows, clens, np.repeat(dbuf[None], B, 0),
                     np.full(B, dlen, np.int32), W64)
    return rows, clens, dbuf, ref


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", K3_NAMES)
def test_k3_matches_pallas(name, impl, request):
    rows, clens, dbuf, ref = _k3_full(W64)
    got = _k3_port(impl, _lib(impl, request), rows, clens, dbuf, W64, W64)
    _assert_rows_same(ref, got, [K3_NAMES.index(name)])


@pytest.mark.parametrize("impl", IMPLS)
def test_k3_short_dictionary_matches_pallas(impl, request):
    """The same streams against only the last 4 KiB of the dictionary:
    offsets that reach further are bad."""
    rows, clens, dbuf, ref = _k3_full(4096)
    got = _k3_port(impl, _lib(impl, request), rows, clens, dbuf, 4096, W64)
    _assert_rows_same(ref, got)


def test_k3_verdicts():
    rows, clens, dbuf, (out, n, ok) = _k3_full(W64)
    for i, name in enumerate(K3_NAMES):
        if name.startswith("native-") or name in (
                "k2b", "off-at-window", "off-past-window", "off-max"):
            assert ok[i], name
    for name in ("off0", "varint-255s", "literal-overrun", "truncated"):
        assert not ok[K3_NAMES.index(name)], name
    i = K3_NAMES.index("off-at-window")
    assert out[i, :int(n[i])].tobytes() == K3_DICT[-4:] + b"abcd"
    i = K3_NAMES.index("off-max")
    assert out[i, :int(n[i])].tobytes() == K3_DICT[1:5] + b"abcd"
    _, _, _, (_, _, ok4) = _k3_full(4096)
    assert ok4[K3_NAMES.index("off-at-window")]
    assert not ok4[K3_NAMES.index("off-past-window")]


def _boundary_block(off, ml, tail):
    out = bytearray([min(ml - 4, 15)])
    out += bytes([off & 255, off >> 8])
    if ml - 4 >= 15:
        r = ml - 4 - 15
        while r >= 255:
            out.append(255)
            r -= 255
        out.append(r)
    out.append(len(tail) << 4)
    out += tail
    return bytes(out)


@functools.lru_cache(maxsize=None)
def _boundary(D: int):
    """test_pallas_kernels.py's boundary-ending sweep: every word-aligned
    (off, ml = off) pair, matches whose window part ends exactly at the
    window/block boundary, plus ml < off interiors; one batch per window
    size at fixed row widths."""
    rng = np.random.default_rng(0xB0DA + D)
    dict_ = rng.integers(1, 255, D, dtype=np.uint8).tobytes()
    cases = [(off, ml) for off in range(4, D + 1, 4)
             for ml in (off, max(4, off - 3))]
    C, cap = 32, 272
    rows = np.zeros((len(cases), C), np.uint8)
    clens = np.zeros(len(cases), np.int32)
    expect = []
    for i, (off, ml) in enumerate(cases):
        comp = _boundary_block(off, ml, b"QWERT")
        rows[i, :len(comp)] = np.frombuffer(comp, np.uint8)
        clens[i] = len(comp)
        expect.append(dict_[D - off:D - off + ml] + b"QWERT")
    dbuf = np.frombuffer(dict_, np.uint8).copy()
    ref = _k3_pallas(rows, clens, np.repeat(dbuf[None], len(cases), 0),
                     np.full(len(cases), D, np.int32), cap)
    return rows, clens, dbuf, cap, expect, ref


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("D", [16, 64, 256])
def test_k3_boundary_ending_sweep(D, impl, request):
    rows, clens, dbuf, cap, expect, ref = _boundary(D)
    got = _k3_port(impl, _lib(impl, request), rows, clens, dbuf, D, cap)
    _assert_rows_same(ref, got)
    out, n, ok = got
    for i, e in enumerate(expect):
        assert ok[i] and out[i, :int(n[i])].tobytes() == e


@functools.lru_cache(maxsize=None)
def _fuzz():
    """test_pallas_kernels.py's dictionary fuzz: chains whose matches
    straddle the window/block boundary at every alignment, one dictionary
    per row."""
    rng = np.random.default_rng(0xD1C7)
    D, C, cap = 1200, 512, 448
    rows = np.zeros((24, C), np.uint8)
    clens = np.zeros(24, np.int32)
    dbufs = np.zeros((24, D), np.uint8)
    dlens = np.zeros(24, np.int32)
    datas = []
    for t in range(24):
        dlen = int(rng.integers(8, 300)) * 4
        dict_ = bytes(rng.integers(97, 105, dlen, dtype=np.uint8))
        parts = []
        for _ in range(6):
            a = int(rng.integers(0, dlen - 8))
            ln = int(rng.integers(4, min(64, dlen - a)))
            parts.append(dict_[a:a + ln])
            parts.append(bytes(rng.integers(0, 256, int(rng.integers(1, 9)),
                                            dtype=np.uint8)))
        data = b"".join(parts)
        comp = native.compress(data, level=6, dict_=dict_)
        rows[t, :len(comp)] = np.frombuffer(comp, np.uint8)
        clens[t] = len(comp)
        dbufs[t, D - dlen:] = np.frombuffer(dict_, np.uint8)
        dlens[t] = dlen
        datas.append(data)
    ref = _k3_pallas(rows, clens, dbufs, dlens, cap)
    return rows, clens, dbufs, dlens, cap, datas, ref


@pytest.mark.parametrize("impl", IMPLS)
def test_k3_straddle_fuzz(impl, request):
    rows, clens, dbufs, dlens, cap, datas, (ro, rn, rk) = _fuzz()
    lib = _lib(impl, request)
    for t, data in enumerate(datas):
        got = _k3_port(impl, lib, rows[t:t + 1], clens[t:t + 1], dbufs[t],
                       int(dlens[t]), cap)
        _assert_rows_same((ro[t:t + 1], rn[t:t + 1], rk[t:t + 1]), got)
        assert got[0][0, :int(got[1][0])].tobytes() == data


@pytest.mark.parametrize("kw", [dict(C=65554), dict(cap=65540),
                                dict(D=65540), dict(D=0)])
def test_decode_batch_dict_rejects_bad_widths(kw):
    C, cap, D = kw.get("C", 1024), kw.get("cap", 1024), kw.get("D", 1024)
    with pytest.raises(ValueError, match="row widths"):
        decode.decode_batch_dict(torch.zeros((1, C), dtype=torch.uint8),
                                 torch.ones((1,), dtype=torch.int32),
                                 torch.zeros((D,), dtype=torch.uint8), 0, cap)


# ---------------------------------------------------------------------------
# K5 and K6c: the records of large blocks, each against the previous
# record's output (1 KiB records: a faithful miniature of the 64 KiB ones,
# since the chunked encoder keeps offsets within [prev|cur])
# ---------------------------------------------------------------------------

CH = 1024
CIN = CH + 256
KR = 12  # records per block row (padding records are no-ops)


def _records(comp: bytes, dict_: bytes = b""):
    recs = native.chunk_split(comp, CH, max_out=1 << 22)
    assert recs is not None and len(recs) <= KR
    rows = np.zeros((KR, CIN), np.uint8)
    metas = np.zeros((KR, 7), np.int32)
    ca = np.frombuffer(comp, np.uint8)
    for i, r in enumerate(recs):
        in_off, in_len = int(r[0]), int(r[1])
        assert in_len <= CIN - 8
        rows[i, :in_len] = ca[in_off:in_off + in_len]
        metas[i] = [in_len, CH if i else len(dict_), r[2], r[3], r[4], r[5],
                    r[6]]
    win0 = np.zeros(CH, np.uint8)
    if dict_:
        win0[CH - len(dict_):] = np.frombuffer(dict_, np.uint8)
    return rows, metas, win0, len(recs)


def _valid_blocks():
    """name -> (source, records): test_large_block.py's carry-kernel
    cases (mixed payloads, a giant run, a dictionary)."""
    out = {}
    for n in (10000, 1025, 3):
        src = mixed_payload(n, seed=n)
        out[f"mixed{n}"] = (src, _records(chunked_encode(src, CH, level=1)))
    src = b"Q" * 5000 + mixed_payload(3000, seed=5)
    out["giant-run"] = (src, _records(chunked_encode(src, CH, level=6)))
    dict_ = mixed_payload(800, seed=77)
    src = mixed_payload(6000, seed=78)
    out["dict"] = (src, _records(chunked_encode(src, CH, level=6,
                                                dict_=dict_), dict_))
    src = make_compressible(11000, seed=79)
    out["text-l1"] = (src, _records(chunked_encode(src, CH, level=1)))
    return out


VALID = _valid_blocks()


def _corrupt_blocks():
    """name -> records: valid blocks with one record damaged."""
    out = {}
    rng = np.random.default_rng(0xC0DE)
    for k, (name, (_, (rows, metas, win0, nrec))) in enumerate(
            list(VALID.items()) * 2):
        rows, metas = rows.copy(), metas.copy()
        r = int(rng.integers(nrec))
        kind = k % 4
        if kind == 0:  # flipped bytes in a slice
            for _ in range(3):
                p = int(rng.integers(max(1, int(metas[r, 0]))))
                rows[r, p] ^= int(rng.integers(1, 256))
        elif kind == 1:  # a truncated slice
            metas[r, 0] = int(rng.integers(int(metas[r, 0]) + 1))
        elif kind == 2:  # a carried match past the window
            metas[r, 4] = metas[r, 2] + metas[r, 1] + 1
            metas[r, 5] = max(int(metas[r, 5]), 1)
        else:  # a slice that runs long
            metas[r, 0] += 5
        out[f"{name}-{['flip', 'cut', 'carry', 'long'][kind]}{k // 6}"] = (
            rows, metas, win0, nrec)
    return out


CORRUPT = _corrupt_blocks()
REC_NAMES = list(VALID) + list(CORRUPT)


@functools.lru_cache(maxsize=None)
def _rec_full():
    """Every block as one (B, KR, CIN) batch: inputs, the Pallas K5 scan
    and its K6c counterpart."""
    blocks = [VALID[n][1] if n in VALID else CORRUPT[n] for n in REC_NAMES]
    rows = np.stack([b[0] for b in blocks])
    metas = np.stack([b[1] for b in blocks])
    win0s = np.stack([b[2] for b in blocks])
    ref = tuple(np.asarray(x) for x in
                decode_pallas.decode_chunks_batch_pallas(
                    jnp.asarray(rows), jnp.asarray(metas),
                    jnp.asarray(win0s), interpret=True))
    k6c = tuple(np.asarray(x) for x in jax.lax.map(
        lambda a: _k6c_chunks(*a),
        (jnp.asarray(rows), jnp.asarray(metas), jnp.asarray(win0s))))
    return (rows, metas, win0s), ref, k6c


def _k6c_record(row, meta, win):
    """One record through _decode_dict_kernel(strict=False), the packed-
    word kernel that _decode_record falls back to."""
    cw = decode_pallas.pack_words(jnp.concatenate(
        [row, jnp.zeros((8,), row.dtype)]))
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    ow, n, ok = pl.pallas_call(
        functools.partial(decode_pallas._decode_dict_kernel, strict=False),
        out_shape=(jax.ShapeDtypeStruct((win.shape[0] // 4,), jnp.int32),
                   jax.ShapeDtypeStruct((1,), jnp.int32),
                   jax.ShapeDtypeStruct((1,), jnp.int32)),
        in_specs=[smem] * 3, out_specs=(smem,) * 3, interpret=True,
    )(cw, meta, decode_pallas.pack_words(win))
    return decode_pallas.unpack_words(ow), n[0], ok[0]


def _k6c_chunks(rows, metas, win0):
    def step(win, xs):
        out, n, ok = _k6c_record(xs[0], xs[1], win)
        return out, (out, n, ok)

    return jax.lax.scan(step, win0, (rows, metas))[1]


def _rec_port(impl, lib, rows, metas, win0s):
    if impl == "plain":
        return tuple(t.numpy() for t in decode.decode_records_batch(
            torch.from_numpy(rows), torch.from_numpy(metas),
            torch.from_numpy(win0s)))
    B, K, C = rows.shape
    W = win0s.shape[1]
    outs = np.zeros((B, K, W), np.uint8)
    n = np.zeros((B, K), np.int32)
    ok = np.zeros((B, K), np.uint8)
    lib.lz4t_host_decode_records(rows.ctypes.data, metas.ctypes.data,
                                 win0s.ctypes.data, outs.ctypes.data,
                                 n.ctypes.data, ok.ctypes.data, B, K, C, W)
    return outs, n, ok


@functools.lru_cache(maxsize=None)
def _rec_got(impl, lib):
    return _rec_port(impl, lib, *_rec_full()[0])


def _assert_block_same(ref, got, b):
    """Records of block b whose windows are exact: every earlier record
    decoded in full (after a failed record the reference kernel's window
    holds its wild copies, and the host has raised already)."""
    (ro, rn, rk), (go, gn, gk) = ref, got
    for k in range(ro.shape[1]):
        assert int(gn[b, k]) == int(rn[b, k]), k
        assert bool(gk[b, k]) == bool(rk[b, k]), k
        n = int(rn[b, k])
        assert go[b, k, :n].tobytes() == ro[b, k, :n].tobytes(), k
        if not rk[b, k] or n != CH:
            return


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", REC_NAMES)
def test_k5_matches_pallas(name, impl, request):
    lib = _lib(impl, request)
    _, ref, _ = _rec_full()
    _assert_block_same(ref, _rec_got(impl, lib), REC_NAMES.index(name))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(VALID))
def test_k6c_matches_port_on_valid_records(name, impl, request):
    lib = _lib(impl, request)
    _, _, k6c = _rec_full()
    b = REC_NAMES.index(name)
    (go, gn, gk), (ko, kn, kk) = _rec_got(impl, lib), k6c
    nrec = VALID[name][1][3]
    assert (gn[b] == kn[b]).all() and (gk[b] == (kk[b] != 0)).all()
    for k in range(nrec):
        n = int(kn[b, k])
        assert go[b, k, :n].tobytes() == ko[b, k, :n].tobytes()


@pytest.mark.parametrize("name", list(CORRUPT))
def test_k6c_agrees_with_k5_on_corrupt_records(name):
    """K5 and K6c compute one function, but their corrupt-input edges
    could differ (clipped reads, fast tiers); on these records they do
    not, so the port, held to K5 above, is held to K6c too."""
    _, ref, (ko, kn, kk) = _rec_full()
    _assert_block_same(ref, (ko, kn, kk != 0), REC_NAMES.index(name))


@pytest.mark.parametrize("name", list(VALID))
def test_k5_records_rebuild_the_source(name):
    src, (_, metas, _, nrec) = VALID[name]
    outs, n, ok = _rec_got("plain", None)
    b = REC_NAMES.index(name)
    assert ok[b].all()
    assert b"".join(outs[b, k, :int(n[b, k])].tobytes()
                    for k in range(nrec)) == src
    assert (n[b, :nrec] == metas[:nrec, 6]).all() and not n[b, nrec:].any()


def test_k5_corrupt_blocks_fail():
    _, (_, rn, rk), _ = _rec_full()
    outs, n, ok = _rec_got("plain", None)
    for name in CORRUPT:
        b = REC_NAMES.index(name)
        nrec = CORRUPT[name][3]
        metas = CORRUPT[name][1]
        good = ok[b, :nrec].all() and (n[b, :nrec] == metas[:nrec, 6]).all()
        ref_good = rk[b, :nrec].all() and (rn[b, :nrec]
                                           == metas[:nrec, 6]).all()
        assert good == ref_good, name


@pytest.mark.parametrize("shape,err", [
    (dict(CIN=1282), "row widths"),
    (dict(W=1026), "row widths"),
    (dict(CIN=101380, W=65536), "row widths"),
    (dict(mshape=(1, 2, 6)), "metas"),
])
def test_decode_records_batch_rejects_bad_shapes(shape, err):
    CIN_, W_ = shape.get("CIN", 1280), shape.get("W", 1024)
    with pytest.raises(ValueError, match=err):
        decode.decode_records_batch(
            torch.zeros((1, 2, CIN_), dtype=torch.uint8),
            torch.zeros(shape.get("mshape", (1, 2, 7)), dtype=torch.int32),
            torch.zeros((1, W_), dtype=torch.uint8))


def _overlap_record(lit: bytes, off: int, ml: int) -> bytes:
    """lit literals, then a match (off, ml >= 19), then one literal."""
    return (bytes([(len(lit) << 4) | 15]) + lit + bytes([off, 0, ml - 19])
            + b"\x10x")


# in-record matches with off < 8 within the first widen(off) bytes of a
# record: op 6 and off 6 (widened to 12), which K5 gets right because 6
# divides the clamped shift, and op 13 and off 7 (widened to 14), the
# record of test_torch_frame_window.py's 256 KiB frame that K5 gets wrong
OVERLAP = {"op6-off6": _overlap_record(b"quick ", 6, 20),
           "op13-off7": _overlap_record(b"quick kernel ", 7, 21)}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(OVERLAP))
def test_k5_start_of_record_overlap_follows_k6c(name, impl, request):
    """A short-period match near a record's start. The port decodes it as
    LZ4 does (the native codec) and as K6c does. On op13-off7 the Pallas
    K5 kernel _decode_kernel_bw_rec returns ok with other bytes: its
    widened 8-wide groups read from op - widen(off), clamped at 0 where
    that lies before the record start."""
    comp = OVERLAP[name]
    want = native.decompress(comp, CH)
    rows = np.zeros((1, KR, CIN), np.uint8)
    metas = np.zeros((1, KR, 7), np.int32)
    rows[0, 0, :len(comp)] = np.frombuffer(comp, np.uint8)
    metas[0, 0] = [len(comp), 0, 0, 0, 0, 0, len(want)]
    win0s = np.zeros((1, CH), np.uint8)
    outs, n, ok = _rec_port(impl, _lib(impl, request), rows, metas, win0s)
    assert ok[0, 0] and outs[0, 0, :int(n[0, 0])].tobytes() == want
    ko, kn, kk = _k6c_record(jnp.asarray(rows[0, 0]), jnp.asarray(metas[0, 0]),
                             jnp.asarray(win0s[0]))
    assert int(kk) and np.asarray(ko)[:int(kn)].tobytes() == want


def _vocab(n: int, seed: int) -> bytes:
    """Text of 12 short words: the native encoder's matches stay within
    the 1 KiB record window."""
    r = np.random.default_rng(seed)
    words = [bytes(r.integers(97, 123, int(r.integers(3, 9)), dtype=np.uint8))
             + b" " for _ in range(12)]
    out = bytearray()
    while len(out) < n:
        out += words[int(r.integers(12))]
    return bytes(out[:n])


# blocks that another encoder wrote (the native codec, as the lz4 tools
# do): their matches may end exactly at a record boundary, so the splitter
# cuts there cleanly and the record ends with a match that fills it
NATIVE_CUT = {f"native-vocab{seed}": _vocab(9000, seed) for seed in (9, 21)}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(NATIVE_CUT))
def test_k5_record_ending_on_a_full_match(name, impl, request):
    """The port decodes every record of such a block. The Pallas K5 and
    K6c kernels refuse each record that a match fills (they parse on
    past the record's end and find no input), so the JAX package's device
    reader cannot decode these frames on a TPU; the port ends a record
    when a match fills it (PERF.md, Findings)."""
    src = NATIVE_CUT[name]
    rows, metas, win0, nrec = _records(native.compress(src, level=1))
    cuts = [k - 1 for k in range(1, nrec) if not metas[k, 2:6].any()]
    assert cuts
    outs, n, ok = _rec_port(impl, _lib(impl, request), rows[None],
                            metas[None], win0[None])
    assert ok[0, :nrec].all()
    assert b"".join(outs[0, k, :int(n[0, k])].tobytes()
                    for k in range(nrec)) == src
    ref_ok = np.asarray(decode_pallas.decode_chunks_pallas(
        jnp.asarray(rows), jnp.asarray(metas), jnp.asarray(win0),
        interpret=True)[2])
    assert not ref_ok[cuts].any()
    k = cuts[0]
    _, _, k6c_ok = _k6c_record(jnp.asarray(rows[k]), jnp.asarray(metas[k]),
                               jnp.asarray(outs[0, k - 1] if k else win0))
    assert not int(k6c_ok)


# ---------------------------------------------------------------------------
# K5's lane copies (csrc/lz4_decode_window.cuh): short offsets, at and near
# a record's start, against the plain version's byte-serial copies
# ---------------------------------------------------------------------------

SHORT_OFFS = range(1, 65)
SHORT_MLS = (4, 5, 15, 18, 19, 31, 32, 33, 63, 64, 65, 100, 130)
SHORT_OPS = (0, 1, 7, 31, 32, 40)  # output position where the match starts


def _short_match_record(op: int, off: int, ml: int, carried: bool):
    """One record: op literals then a match (off, ml) and one literal, or
    (carried) the same match as the record's carried prologue match."""
    lits = bytes((37 * k + 11) & 255 for k in range(op))
    if carried:
        comp = lits + b"\x10z"
        meta = [len(comp), CH, op, 0, off, ml, op + ml + 1]
    else:
        mv = ml - 4
        comp = bytes([(min(op, 15) << 4) | min(mv, 15)])
        if op >= 15:
            comp += bytes([op - 15])
        comp += lits + bytes([off & 255, off >> 8])
        if mv >= 15:
            comp += b"\xff" * ((mv - 15) // 255) + bytes([(mv - 15) % 255])
        comp += b"\x10z"
        meta = [len(comp), CH, 0, 0, 0, 0, op + ml + 1]
    return comp, meta


@functools.lru_cache(maxsize=None)
def _short_batch(off: int):
    """Every (op, ml, carried) record of one offset as a 2-record block
    against a random window: record 1 repeats record 0's stream, so its
    window-sourced bytes come from record 0's output buffer."""
    cases = [(op, ml, carried) for op in SHORT_OPS for ml in SHORT_MLS
             for carried in (False, True)]
    rng = np.random.default_rng(off)
    rows = np.zeros((len(cases), 2, CIN), np.uint8)
    metas = np.zeros((len(cases), 2, 7), np.int32)
    win0s = rng.integers(0, 256, (len(cases), CH), dtype=np.uint8)
    for b, (op, ml, carried) in enumerate(cases):
        comp, meta = _short_match_record(op, off, ml, carried)
        for k in range(2):
            rows[b, k, :len(comp)] = np.frombuffer(comp, np.uint8)
            metas[b, k] = meta
    args = (rows, metas, win0s)
    return args, tuple(t.numpy() for t in decode.decode_records_batch(
        *(torch.from_numpy(a) for a in args)))


@pytest.mark.parametrize("off", SHORT_OFFS)
def test_k5_lane_copies_follow_plain_on_short_offsets(off, host_lib):
    """Offsets 1-64 and match lengths 4-130 starting at output positions
    0-40, in-record and as the carried match: steps that read the window,
    steps that repeat a period shorter than a step, and steps that read
    the step before."""
    args, (po, pn, pk) = _short_batch(off)
    go, gn, gk = _rec_port("g++", host_lib, *args)
    assert pk.all() and (gk != 0).all()
    assert (gn == pn).all()
    assert go.tobytes() == po.tobytes()
    # the match's bytes by the LZ4 rule, against the window for record 0
    _, metas, win0s = args
    ops = [op for op in SHORT_OPS for _ in SHORT_MLS for _ in (0, 1)]
    mls = [ml for _ in SHORT_OPS for ml in SHORT_MLS for _ in (0, 1)]
    for b, (op, ml) in enumerate(zip(ops, mls)):
        o = bytearray(win0s[b].tobytes()) + bytearray(po[b, 0, :op].tobytes())
        for _ in range(ml):
            o.append(o[-off])
        assert po[b, 0, :op + ml].tobytes() == bytes(o[CH:]), (op, ml)
