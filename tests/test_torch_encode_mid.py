"""Port K2c and K2d (depth-2 and depth-4 chain block encode, device levels
3-8): plz4_tpu_torch.ops.encode_mid against the JAX package's Pallas kernel
in mid mode (encode_pallas.encode_batch_pallas_mid and
encode_batch_pallas_mid_dict) in interpret mode.

Byte-exact contract, as for K2a: the same ok and total per row, and the
same stream bytes [0, total) where ok holds. Plain rows, rows after full,
partial, empty and tiny windows, window preload strides 1 and 2, and the
grouped chunk rows of large blocks, at depth 2 and depth 4. The plain
version and the CUDA kernel's row body built with g++ are each held to the
Pallas kernel, and the row body to the plain version at depth 2;
tests/test_torch_gpu.py holds the CUDA kernel to the plain version.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import encode_pallas
from plz4_tpu_torch import corpus, native
from plz4_tpu_torch.ops import _build, encode, encode_mid

from conftest import make_compressible, make_incompressible

N = D = 65536
DEPTHS = {"depth2": False, "depth4": True}

PAYLOADS = {
    "empty": b"",
    "one": b"a",
    "n12": b"abcabcabcabc",
    "n13": b"abcabcabcabca",
    "text": b"hello world " * 12,
    "zeros": b"\x00" * N,
    "vocab4k": make_compressible(4096, seed=1),
    "vocab64k": make_compressible(N, seed=2),
    "period7": (make_incompressible(7, seed=2) * (N // 7 + 1))[:N],
    "random64k": make_incompressible(N, seed=3),
}


def _window_cases() -> dict:
    """name -> (block, window row of D bytes, usable window bytes): the
    window cases of test_torch_encode_window.py."""
    dict_ = make_compressible(D, seed=31)
    text = make_compressible(N, seed=32)
    noise = make_incompressible(D, seed=34)
    frag = b"".join(noise[a:a + 40] + b"\x01\x02"
                    for a in range(0, 40000, 97))[:N]
    part = noise[-1001:]
    garbage = make_incompressible(D, seed=1)  # below first: never read
    return {
        "full": (text, dict_, D),
        "dict-fragments": (frag, noise, D),
        "partial-odd": (frag[:30000], garbage[:D - 1001] + part, 1001),
        "partial-tiny": (b"hello world " * 50, garbage[:D - 5] + b"hello", 5),
        "empty-window": (text, garbage, 0),
        "short-block": (dict_[5000:5100], dict_, D),
        "n12": (dict_[:12], dict_, D),
        "one": (b"a", dict_, D),
        "empty-block": (b"", dict_, D),
        "zeros": (b"\x00" * N, b"\x00" * D, D),
        "random": (make_incompressible(N, seed=33), dict_, D),
        "period7-after-itself": ((make_incompressible(7, seed=4) * 9363)[:N],
                                 (make_incompressible(7, seed=4)
                                  * 9363)[:D], D),
    }


WINDOW_CASES = _window_cases()
# the cases also run with the chunk rows' preload stride
STRIDE2_CASES = ["full", "dict-fragments", "partial-odd",
                 "period7-after-itself"]


def _rows(payloads, width):
    rows = np.zeros((len(payloads), width), np.uint8)
    lens = np.array([len(p) for p in payloads], np.int32)
    for i, p in enumerate(payloads):
        rows[i, :len(p)] = np.frombuffer(p, np.uint8)
    return rows, lens


def _window_batch(cases: dict, names):
    rows, lens = _rows([cases[n][0] for n in names], N)
    wins = np.stack([np.frombuffer(cases[n][1], np.uint8) for n in names])
    wlens = np.array([cases[n][2] for n in names], np.int32)
    return rows, lens, wins, wlens


def _np(res):
    return tuple(np.asarray(x) for x in res)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@functools.lru_cache(maxsize=None)
def _plain_rows(depth4: bool):
    rows, lens = _rows(list(PAYLOADS.values()), N)
    ref = _np(encode_pallas.encode_batch_pallas_mid(
        jnp.asarray(rows), jnp.asarray(lens), interpret=True, depth4=depth4))
    got = _np(encode_mid.encode_batch_mid(*_t(rows, lens), depth4))
    return (rows, lens), ref, got


@functools.lru_cache(maxsize=None)
def _windows(depth4: bool, wstride: int):
    names = list(WINDOW_CASES) if wstride == 1 else STRIDE2_CASES
    args = _window_batch(WINDOW_CASES, names)
    ref = _np(encode_pallas.encode_batch_pallas_mid_dict(
        *(jnp.asarray(a) for a in args), interpret=True, depth4=depth4,
        wstride=wstride))
    got = _np(encode_mid.encode_batch_mid_window(
        *_t(*args), depth4=depth4, wstride=wstride))
    return args, ref, got


def _assert_same(ref, got, i):
    (ro, rt, rk), (go, gt, gk) = ref, got
    assert int(gt[i]) == int(rt[i])
    assert bool(gk[i]) == bool(rk[i])
    if rk[i]:
        t = int(rt[i])
        assert go[i, :t].tobytes() == ro[i, :t].tobytes()


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


def _host_encode(lib, rows, lens, wins, wlens, depth4, wstride=1, chunks=1):
    """The CUDA kernel's row body (csrc/lz4_encode_mid.cuh) built with g++;
    wins None is a plain batch (D = 0)."""
    R, width = rows.shape
    Dw = 0 if wins is None else wins.shape[1]
    CAP = encode.out_width(width)
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, np.uint8)
    args = (rows.ctypes.data, lens.ctypes.data,
            0 if wins is None else wins.ctypes.data,
            0 if wlens is None else wlens.ctypes.data, out.ctypes.data,
            tot.ctypes.data, ok.ctypes.data, R, width, Dw, chunks, wstride,
            CAP)
    lib.lz4t_host_encode_mid(*args, int(depth4))
    return out, tot, ok


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(PAYLOADS))
def test_plain_rows_plain_matches_pallas(name, depth):
    _, ref, got = _plain_rows(DEPTHS[depth])
    _assert_same(ref, got, list(PAYLOADS).index(name))


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(PAYLOADS))
def test_plain_rows_kernel_row_body_matches_pallas(name, depth, host_lib):
    (rows, lens), ref, _ = _plain_rows(DEPTHS[depth])
    _assert_same(ref, _host_encode(host_lib, rows, lens, None, None,
                                   DEPTHS[depth]), list(PAYLOADS).index(name))


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(PAYLOADS))
def test_ok_streams_decode_natively(name, depth):
    (_, lens), _, (out, tot, ok) = _plain_rows(DEPTHS[depth])
    i = list(PAYLOADS).index(name)
    if not ok[i]:
        assert int(tot[i]) >= lens[i]  # stored raw by the batch layer
        return
    assert native.decompress(out[i, :int(tot[i])].tobytes(), N) \
        == PAYLOADS[name]


def _window_params():
    return [pytest.param(d, ws, name, id=f"{name}-{d}-wstride{ws}")
            for d in DEPTHS for ws in (1, 2)
            for name in (WINDOW_CASES if ws == 1 else STRIDE2_CASES)]


@pytest.mark.parametrize("depth,wstride,name", _window_params())
def test_window_rows_plain_matches_pallas(depth, wstride, name):
    args, ref, got = _windows(DEPTHS[depth], wstride)
    names = list(WINDOW_CASES) if wstride == 1 else STRIDE2_CASES
    _assert_same(ref, got, names.index(name))


@pytest.mark.parametrize("depth,wstride,name", _window_params())
def test_window_rows_kernel_row_body_matches_pallas(depth, wstride, name,
                                                    host_lib):
    args, ref, _ = _windows(DEPTHS[depth], wstride)
    names = list(WINDOW_CASES) if wstride == 1 else STRIDE2_CASES
    _assert_same(ref, _host_encode(host_lib, *args, DEPTHS[depth], wstride),
                 names.index(name))


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_window_streams_decode_natively(name, depth):
    (_, lens, _, _), _, (out, tot, ok) = _windows(DEPTHS[depth], 1)
    blk, win, wl = WINDOW_CASES[name]
    i = list(WINDOW_CASES).index(name)
    if not ok[i]:
        assert int(tot[i]) >= lens[i]
        return
    assert native.decompress(out[i, :int(tot[i])].tobytes(), N,
                             dict_=win[D - wl:]) == blk


# ---------------------------------------------------------------------------
# tiny windows and narrow rows
# ---------------------------------------------------------------------------

TINY_N = 1024
TINY = {
    "w4-full": (make_compressible(900, seed=51), b"the ", 4),
    "w16-part": (make_compressible(1000, seed=52),
                 make_incompressible(6, seed=53) + b"over lazy ", 10),
    "w64-empty": (make_compressible(TINY_N, seed=54),
                  make_compressible(64, seed=55), 0),
}


@functools.lru_cache(maxsize=None)
def _tiny(name: str, depth4: bool):
    blk, win, wl = TINY[name]
    rows, lens = _rows([blk], TINY_N)
    wins = np.frombuffer(win, np.uint8)[None].copy()
    wlens = np.array([wl], np.int32)
    ref = _np(encode_pallas.encode_batch_pallas_mid_dict(
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(wins),
        jnp.asarray(wlens), interpret=True, depth4=depth4))
    got = _np(encode_mid.encode_batch_mid_window(
        *_t(rows, lens, wins, wlens), depth4=depth4))
    return (rows, lens, wins, wlens), ref, got


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(TINY))
def test_tiny_windows_match_pallas(name, depth, host_lib):
    args, ref, got = _tiny(name, DEPTHS[depth])
    _assert_same(ref, got, 0)
    _assert_same(ref, _host_encode(host_lib, *args, DEPTHS[depth]), 0)
    assert ref[2][0]  # each tiny case compresses


# ---------------------------------------------------------------------------
# chunk rows of large blocks: windows read in place from the previous row
# ---------------------------------------------------------------------------

K = 4  # chunks per large block (a 256 KiB block)


@functools.lru_cache(maxsize=None)
def _chunks(depth4: bool):
    """Two 256 KiB-class blocks as K chunk rows each (the second 2.5 chunks
    long), the first after a 777-byte dictionary, at the chunk rows'
    preload stride 2: the port's grouped layout against the Pallas kernel
    on the concatenated windows the JAX package builds."""
    b0 = make_compressible(K * N, seed=41)
    b1 = make_compressible(2 * N + N // 2, seed=42)
    d0 = np.zeros((2, D), np.uint8)
    d0[0, D - 777:] = np.frombuffer(make_compressible(777, seed=43), np.uint8)
    rows = np.zeros((2 * K, N), np.uint8)
    lens = np.zeros(2 * K, np.int32)
    wlens = np.zeros(2 * K, np.int32)
    for j, blk in enumerate((b0, b1)):
        for k in range(K):
            part = blk[k * N:(k + 1) * N]
            rows[j * K + k, :len(part)] = np.frombuffer(part, np.uint8)
            lens[j * K + k] = len(part)
            if part:
                wlens[j * K + k] = N if k else (777 if j == 0 else 0)
    wins = np.concatenate([d0[:, None, :], rows.reshape(2, K, N)[:, :-1, :]],
                          axis=1).reshape(2 * K, D)
    ref = _np(encode_pallas.encode_batch_pallas_mid_dict(
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(wins),
        jnp.asarray(wlens), interpret=True, depth4=depth4, wstride=2))
    got = _np(encode_mid.encode_batch_mid_window(
        *_t(rows, lens, d0, wlens), depth4=depth4, wstride=2, chunks=K))
    return (rows, lens, d0, wlens), ref, got


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("r", range(2 * K))
def test_chunk_rows_plain_match_pallas(r, depth):
    _, ref, got = _chunks(DEPTHS[depth])
    _assert_same(ref, got, r)


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("r", range(2 * K))
def test_chunk_rows_kernel_row_body_match_pallas(r, depth, host_lib):
    args, ref, _ = _chunks(DEPTHS[depth])
    _assert_same(ref, _host_encode(host_lib, *args, DEPTHS[depth], 2,
                                   chunks=K), r)


def test_chain_depth_pays_off():
    """Depth 4 finds more than depth 2 on the text rows, plain and after a
    window."""
    names = list(PAYLOADS)
    for i in (names.index("vocab64k"), names.index("vocab4k")):
        assert _plain_rows(True)[2][1][i] < _plain_rows(False)[2][1][i]
    full = list(WINDOW_CASES).index("full")
    assert _windows(True, 1)[2][1][full] < _windows(False, 1)[2][1][full]


def test_tables_spill_only_at_depth4_after_a_full_window():
    """The shared-memory arithmetic of csrc/lz4_encode_mid.cu: only depth 4
    after a 64 KiB window keeps two tables in device memory; every call
    the batch layer makes stays on the Pallas byte-wide path (no K6b)."""
    assert not encode_mid.tables_spill(N, 0, False)
    assert not encode_mid.tables_spill(N, D, False)
    assert not encode_mid.tables_spill(N, 0, True)
    assert encode_mid.tables_spill(N, D, True)
    cap = encode.out_width(N)
    for depth4 in (False, True):
        assert encode_pallas._bw_fits(D + N + 8, cap, mid=True, depth4=depth4)


def test_mid_constants_match_pallas():
    assert encode_mid.MID_HASH_LOG == encode_pallas.MID_HASH_LOG
    assert encode_mid.MID_HASH_LOG == 13


@pytest.mark.parametrize("kw,err", [
    (dict(shape=(2, 130)), "row width"),
    (dict(chunks=3), "windows"),
    (dict(wstride=0), "windows"),
    (dict(win_shape=(2, 65540)), "windows"),
])
def test_encode_batch_mid_rejects_bad_shapes(kw, err):
    data = torch.zeros(kw.pop("shape", (2, 1024)), dtype=torch.uint8)
    win = torch.zeros(kw.pop("win_shape", (2, 1024)), dtype=torch.uint8)
    lens = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match=err):
        encode_mid.encode_batch_mid_window(data, lens, win, lens, **kw)


# ---------------------------------------------------------------------------
# edge rows of the warp-cooperative parse (corpus.chain_edge_rows): runs of
# periods 1-4, crowded buckets, a step's first match on every lane, matches
# to matchlimit, 13-80-byte blocks, and copies 65,534-65,536 bytes back
# from a window at preload strides 1 and 2
# ---------------------------------------------------------------------------

EDGE_N = 8192
EDGE, FAR = corpus.chain_edge_rows()


@functools.lru_cache(maxsize=None)
def _edge(depth4: bool):
    rows, lens = _rows(list(EDGE.values()), EDGE_N)
    ref = _np(encode_pallas.encode_batch_pallas_mid(
        jnp.asarray(rows), jnp.asarray(lens), interpret=True, depth4=depth4))
    got = _np(encode_mid.encode_batch_mid(*_t(rows, lens), depth4))
    return (rows, lens), ref, got


@functools.lru_cache(maxsize=None)
def _far(depth4: bool, wstride: int):
    args = _window_batch(FAR, list(FAR))
    ref = _np(encode_pallas.encode_batch_pallas_mid_dict(
        *(jnp.asarray(a) for a in args), interpret=True, depth4=depth4,
        wstride=wstride))
    got = _np(encode_mid.encode_batch_mid_window(
        *_t(*args), depth4=depth4, wstride=wstride))
    return args, ref, got


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(EDGE))
def test_edge_rows_plain_matches_pallas(name, depth):
    _, ref, got = _edge(DEPTHS[depth])
    _assert_same(ref, got, list(EDGE).index(name))


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(EDGE))
def test_edge_rows_kernel_row_body_matches_pallas(name, depth, host_lib):
    (rows, lens), ref, _ = _edge(DEPTHS[depth])
    _assert_same(ref, _host_encode(host_lib, rows, lens, None, None,
                                   DEPTHS[depth]), list(EDGE).index(name))


@pytest.mark.parametrize("wstride", [1, 2])
@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(FAR))
def test_far_rows_plain_matches_pallas(name, depth, wstride):
    _, ref, got = _far(DEPTHS[depth], wstride)
    _assert_same(ref, got, list(FAR).index(name))


@pytest.mark.parametrize("wstride", [1, 2])
@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("name", list(FAR))
def test_far_rows_kernel_row_body_matches_pallas(name, depth, wstride,
                                                 host_lib):
    args, ref, _ = _far(DEPTHS[depth], wstride)
    _assert_same(ref, _host_encode(host_lib, *args, DEPTHS[depth], wstride),
                 list(FAR).index(name))


def test_edge_rows_reach_their_lanes():
    """The lane-hits row puts a step's first match on every lane: its
    sequences start after 0-69 literals (the depth-2 plain version's
    stream, read by the native decoder's sequence walk)."""
    (_, lens), _, (out, tot, ok) = _edge(False)
    i = list(EDGE).index("lane-hits")
    assert ok[i]
    s, p, lits = out[i, :int(tot[i])].tobytes(), 0, set()
    while p < len(s):
        tok = s[p]
        p += 1
        lit = tok >> 4
        if lit == 15:
            while s[p] == 255:
                lit += 255
                p += 1
            lit += s[p]
            p += 1
        p += lit
        lits.add(lit)
        if p >= len(s):
            break
        p += 2
        if tok & 15 == 15:
            while s[p] == 255:
                p += 1
            p += 1
    assert set(range(32)) <= lits


def _cached_batches(depth4: bool):
    """name -> (operands, wstride, chunks, Pallas outputs, plain version's
    outputs) of every batch this module holds to Pallas."""
    out = {"plain": (_plain_rows(depth4), 1, 1),
           "edge": (_edge(depth4), 1, 1),
           "chunks": (_chunks(depth4), 2, K)}
    for ws in (1, 2):
        out[f"windows-wstride{ws}"] = (_windows(depth4, ws), ws, 1)
        out[f"far-wstride{ws}"] = (_far(depth4, ws), ws, 1)
    for name in TINY:
        out[f"tiny-{name}"] = (_tiny(name, depth4), 1, 1)
    return {name: (c[0] + (None, None) * (len(c[0]) == 2), ws, chunks, c[1],
                   c[2])
            for name, (c, ws, chunks) in out.items()}


BATCHES = ["plain", "edge", "chunks", "windows-wstride1", "windows-wstride2",
           "far-wstride1", "far-wstride2"] + [f"tiny-{n}" for n in TINY]


@pytest.mark.parametrize("batch", BATCHES)
def test_lanes_body_matches_plain(batch, host_lib):
    """The lanes' body and the plain version give the same ok and total on
    every row of every cached batch at depth 2, and the same bytes where ok
    holds."""
    args, ws, chunks, _, plain = _cached_batches(False)[batch]
    lanes = _host_encode(host_lib, *args, False, ws, chunks)
    for i in range(len(lanes[1])):
        _assert_same(plain, lanes, i)


@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("batch", BATCHES)
def test_streams_match_pallas_wherever_total_fits(batch, depth, host_lib):
    """Every row whose total is below the overflow sentinel CAP carries the
    Pallas kernel's bytes [0, total), ok or not: the large-block path
    stitches the stream of a chunk that did not shrink. Held for the
    lanes' body and the plain version."""
    args, ws, chunks, ref, got = _cached_batches(DEPTHS[depth])[batch]
    host = _host_encode(host_lib, *args, DEPTHS[depth], ws, chunks)
    CAP = ref[0].shape[1]
    if batch == "plain":  # random64k does not shrink, yet has a stream
        assert any(t < CAP and not k for t, k in zip(ref[1], ref[2]))
    for res in (host, got):
        assert res[1].tolist() == ref[1].tolist()
        for i, t in enumerate(ref[1].tolist()):
            if t < CAP:
                assert res[0][i, :t].tobytes() == ref[0][i, :t].tobytes()
