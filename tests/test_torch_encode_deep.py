"""Port K4 (deep hash-chain block encode with lazy matching, device levels
9-12): plz4_tpu_torch.ops.encode_deep against the JAX package's Pallas
kernel (encode_pallas.encode_batch_pallas_deep and
encode_batch_pallas_deep_dict) in interpret mode.

Byte-exact contract, as for K2a: the same ok and total per row, and the
same stream bytes [0, total) where ok holds, at walk budgets 2, 8, 16 and
32. Both of the Pallas kernel's chain variants are covered: plain rows and
small windows take the i32 chain with 2^15 heads; the batch layer's 64 KiB
windows (dictionaries, linked blocks, large-block chunk rows) take the
u16-delta chain with 2^14 heads and the window cut to 32 KiB, and a 16 KiB
window takes 2^14 heads without the cut. The port runs one u16-delta
chain, built before the parse, for both. The plain version and the CUDA
kernel's row body built with g++ are each held to the Pallas kernel;
tests/test_torch_gpu.py holds the CUDA kernel to the plain version.
"""

import functools
import os
import random
import re
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import encode_pallas
from plz4_tpu.parallel import batch as tpu_batch
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import _build, encode, encode_deep, encode_mid
from plz4_tpu_torch.parallel import batch

from conftest import make_compressible, make_incompressible

N = D = 65536
TRIES = (2, 8, 16, 32)


def _shapes() -> dict:
    """The deep-kernel shapes of tests/test_pallas_kernels.py: edges, mixed
    fuzz, boundary shapes, and runs longer than the lazy cap."""
    out = {"zeros": b"\x00" * 3000, "one": b"a", "short13": b"abcabcabcabca",
           "period4": b"abcd" * 700,
           "runs": b"A" * 500 + b"xyz" * 100 + b"B" * 800,
           "empty": b"", "n12": b"abcabcabcabc",
           "lazy-cap-runs": (b"q" * 300 + make_compressible(200, seed=5)
                             + b"xy" * 150 + b"z" * 90)}
    rng = random.Random(0)
    for seed in range(8):
        rng.seed(seed)
        parts = []
        for _ in range(rng.randint(1, 5)):
            k = rng.randint(0, 3)
            if k == 0:
                parts.append(make_compressible(rng.randint(1, 2000),
                                               seed=seed * 7 + 1))
            elif k == 1:
                parts.append(make_incompressible(rng.randint(1, 600),
                                                 seed=seed * 7 + 2))
            elif k == 2:
                parts.append(bytes([rng.randint(0, 255)])
                             * rng.randint(1, 700))
            else:
                parts.append((make_incompressible(rng.randint(2, 9),
                                                  seed=seed * 7 + 3)
                              * 300)[: rng.randint(1, 900)])
        out[f"fuzz{seed}"] = b"".join(parts)
    rng = random.Random(99)
    for seed in range(12):
        rng.seed(seed)
        shape = seed % 6
        if shape == 0:
            data = make_compressible(2000, seed=seed) + b"\x00" * (12 + seed)
        elif shape == 1:
            data = b"\x00" * (1500 + seed) + make_incompressible(17, seed=seed)
        elif shape == 2:
            p = make_incompressible(3 + seed % 14, seed=seed)
            data = (p * 700)[: 2000 + seed]
        elif shape == 3:
            data = make_compressible(1500, seed=seed)
            data = data + data[-(5 + seed % 8):]
        elif shape == 4:
            data = b"".join(bytes([rng.randrange(256)])
                            * rng.randrange(1, 40) for _ in range(150))
        else:
            data = make_compressible(3000, seed=seed)[: 2993 + seed % 9]
        out[f"boundary{seed}"] = data
    return out


SHAPES = _shapes()
SMALL_N = 12288  # fits every shape
FULL = {"vocab64k": make_compressible(N, seed=2),
        "period7": (make_incompressible(7, seed=2) * (N // 7 + 1))[:N],
        "random64k": make_incompressible(N, seed=3)}


def _window_cases() -> dict:
    """name -> (block, window row of D bytes, usable window bytes)."""
    dict_ = make_compressible(D, seed=31)
    text = make_compressible(N, seed=32)
    noise = make_incompressible(D, seed=34)
    frag = b"".join(noise[a:a + 40] + b"\x01\x02"
                    for a in range(0, 40000, 97))[:N]
    garbage = make_incompressible(D, seed=1)  # below first: never read
    return {
        "full": (text, dict_, D),
        "dict-fragments": (frag, noise, D),
        "partial-40000": (frag[:30000], garbage[:D - 40000] + noise[:40000],
                          40000),
        "partial-odd": (frag[:30000], garbage[:D - 1001] + noise[-1001:],
                        1001),
        "empty-window": (text, garbage, 0),
        "short-block": (dict_[-5000:-4900], dict_, D),
        "one": (b"a", dict_, D),
        "empty-block": (b"", dict_, D),
        "zeros": (b"\x00" * N, b"\x00" * D, D),
        "period7-after-itself": ((make_incompressible(7, seed=4) * 9363)[:N],
                                 (make_incompressible(7, seed=4)
                                  * 9363)[:D], D),
    }


WINDOW_CASES = _window_cases()


def _rows(payloads, width):
    rows = np.zeros((len(payloads), width), np.uint8)
    lens = np.array([len(p) for p in payloads], np.int32)
    for i, p in enumerate(payloads):
        rows[i, :len(p)] = np.frombuffer(p, np.uint8)
    return rows, lens


def _np(res):
    return tuple(np.asarray(x) for x in res)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _assert_same(ref, got, i):
    (ro, rt, rk), (go, gt, gk) = ref, got
    assert int(gt[i]) == int(rt[i])
    assert bool(gk[i]) == bool(rk[i])
    if rk[i]:
        t = int(rt[i])
        assert go[i, :t].tobytes() == ro[i, :t].tobytes()


@functools.lru_cache(maxsize=None)
def _plain(which: str, tries: int):
    """Plain rows: the small shapes at SMALL_N or the full 64 KiB rows."""
    pays = SHAPES if which == "small" else FULL
    rows, lens = _rows(list(pays.values()),
                       SMALL_N if which == "small" else N)
    ref = _np(encode_pallas.encode_batch_pallas_deep(
        jnp.asarray(rows), jnp.asarray(lens), interpret=True, tries=tries))
    got = _np(encode_deep.encode_batch_deep(*_t(rows, lens), tries))
    return (rows, lens), ref, got


@functools.lru_cache(maxsize=None)
def _windows(names: tuple, width: int, tries: int):
    """Rows of WINDOW_CASES after windows cut to their last `width`
    bytes."""
    rows, lens = _rows([WINDOW_CASES[n][0] for n in names], N)
    wins = np.stack([np.frombuffer(WINDOW_CASES[n][1][D - width:], np.uint8)
                     for n in names])
    wlens = np.array([min(WINDOW_CASES[n][2], width) for n in names],
                     np.int32)
    args = (rows, lens, wins, wlens)
    ref = _np(encode_pallas.encode_batch_pallas_deep_dict(
        *(jnp.asarray(a) for a in args), interpret=True, tries=tries))
    got = _np(encode_deep.encode_batch_deep_window(*_t(*args), tries))
    return args, ref, got


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


def _host_encode(lib, rows, lens, wins, wlens, tries, chunks=1):
    """The CUDA kernel's row body (csrc/lz4_encode_deep.cuh) built with g++,
    routed as the wrapper routes it; wins None is a plain batch."""
    R, width = rows.shape
    Dw = None if wins is None else wins.shape[1]
    hash_log, Dc = encode_deep.deep_route(width, Dw)
    CAP = encode.out_width(width)
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, np.uint8)
    if wins is None and width <= encode_deep.PIPE_MAX_ROW:
        lib.lz4t_host_encode_deep_plain(
            rows.ctypes.data, lens.ctypes.data, out.ctypes.data,
            tot.ctypes.data, ok.ctypes.data, R, width, CAP, tries, hash_log)
        return out, tot, ok
    lib.lz4t_host_encode_deep(
        rows.ctypes.data, lens.ctypes.data,
        0 if wins is None else wins.ctypes.data,
        0 if wlens is None else wlens.ctypes.data, out.ctypes.data,
        tot.ctypes.data, ok.ctypes.data, R, width, Dw or 0, chunks, Dc, CAP,
        tries, hash_log)
    return out, tot, ok


@pytest.mark.parametrize("tries", TRIES)
@pytest.mark.parametrize("name", list(SHAPES))
def test_small_shapes_match_pallas(name, tries, host_lib):
    (rows, lens), ref, got = _plain("small", tries)
    i = list(SHAPES).index(name)
    _assert_same(ref, got, i)
    _assert_same(ref, _host_encode(host_lib, rows, lens, None, None, tries),
                 i)
    if got[2][i]:
        assert native.decompress(got[0][i, :got[1][i]].tobytes(),
                                 len(SHAPES[name])) == SHAPES[name]


@pytest.mark.parametrize("tries", TRIES)
@pytest.mark.parametrize("name", list(FULL))
def test_full_rows_match_pallas(name, tries, host_lib):
    (rows, lens), ref, got = _plain("full", tries)
    i = list(FULL).index(name)
    _assert_same(ref, got, i)
    _assert_same(ref, _host_encode(host_lib, rows, lens, None, None, tries),
                 i)


def _window_params():
    return [pytest.param(tries, name, id=f"{name}-t{tries}")
            for tries in (2, 32) for name in WINDOW_CASES]


@pytest.mark.parametrize("tries,name", _window_params())
def test_window_rows_match_pallas(tries, name, host_lib):
    """64 KiB windows: the u16-chain route, 2^14 heads, the last 32 KiB."""
    names = tuple(WINDOW_CASES)
    args, ref, got = _windows(names, D, tries)
    i = names.index(name)
    _assert_same(ref, got, i)
    _assert_same(ref, _host_encode(host_lib, *args, tries), i)
    if got[2][i]:
        blk, win, wl = WINDOW_CASES[name]
        wl = min(wl, encode_deep.WINDOW_CUT)
        assert native.decompress(got[0][i, :got[1][i]].tobytes(), N,
                                 dict_=win[D - wl:]) == blk


SIXTEEN = ("full", "partial-odd", "dict-fragments")


@pytest.mark.parametrize("name", SIXTEEN)
def test_16k_window_takes_hash_log_14_uncut(name, host_lib):
    assert encode_deep.deep_route(N, 16384) == (14, 16384)
    args, ref, got = _windows(SIXTEEN, 16384, 16)
    i = SIXTEEN.index(name)
    _assert_same(ref, got, i)
    _assert_same(ref, _host_encode(host_lib, *args, 16), i)


SMALL_WIN = 4096


@functools.lru_cache(maxsize=None)
def _small_windows(tries: int):
    """Small shapes after a 4 KiB window (the i32 chain, 2^15 heads)."""
    dict_ = make_compressible(SMALL_WIN, seed=71)
    names = list(SHAPES)[:12]
    rows, lens = _rows([dict_[100:900] + SHAPES[n] for n in names], SMALL_N)
    wins = np.tile(np.frombuffer(dict_, np.uint8), (len(names), 1))
    wlens = np.array([SMALL_WIN if i % 3 else 1500 for i in range(len(names))],
                     np.int32)
    args = (rows, lens, wins, wlens)
    ref = _np(encode_pallas.encode_batch_pallas_deep_dict(
        *(jnp.asarray(a) for a in args), interpret=True, tries=tries))
    got = _np(encode_deep.encode_batch_deep_window(*_t(*args), tries))
    return args, ref, got


@pytest.mark.parametrize("tries", (8, 16))
@pytest.mark.parametrize("r", range(12))
def test_small_windows_take_hash_log_15(r, tries, host_lib):
    assert encode_deep.deep_route(SMALL_N, SMALL_WIN) == (15, SMALL_WIN)
    args, ref, got = _small_windows(tries)
    _assert_same(ref, got, r)
    _assert_same(ref, _host_encode(host_lib, *args, tries), r)


# ---------------------------------------------------------------------------
# chunk rows of large blocks: the last 32 KiB of the previous row, in place
# ---------------------------------------------------------------------------

K = 4


@functools.lru_cache(maxsize=None)
def _chunks():
    """Two 256 KiB-class blocks as K chunk rows each, the first after a
    777-byte dictionary, at level 9's walk budget: the port's grouped
    layout against the Pallas kernel on the concatenated windows the JAX
    package builds."""
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
    ref = _np(encode_pallas.encode_batch_pallas_deep_dict(
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(wins),
        jnp.asarray(wlens), interpret=True, tries=2))
    got = _np(encode_deep.encode_batch_deep_window(
        *_t(rows, lens, d0, wlens), 2, chunks=K))
    return (rows, lens, d0, wlens), ref, got


@pytest.mark.parametrize("r", range(2 * K))
def test_chunk_rows_match_pallas(r, host_lib):
    args, ref, got = _chunks()
    _assert_same(ref, got, r)
    _assert_same(ref, _host_encode(host_lib, *args, 2, chunks=K), r)


def test_chunk_streams_stitch_into_the_blocks():
    (rows, lens, _, _), _, (out, tot, _) = _chunks()
    for j in range(2):
        n = int(lens[j * K:(j + 1) * K].sum())
        blk = rows[j * K:(j + 1) * K].reshape(-1)[:n].tobytes()
        streams = [out[j * K + k, :int(tot[j * K + k])].tobytes()
                   for k in range(K) if lens[j * K + k]]
        st = native.stitch_chunks(blk, N, streams)
        d = b"" if j else make_compressible(777, seed=43)
        assert native.decompress(st, n, dict_=d or None) == blk


# ---------------------------------------------------------------------------
# routing, constants, ladder
# ---------------------------------------------------------------------------

def test_route_matches_pallas_budget():
    """deep_route against _deep_fits / _deep_fits_u16 and the dict
    wrapper's 32 KiB cut, over row and window widths up to 64 KiB."""
    for n in range(4, N + 1, 2044):
        cap = encode.out_width(n)
        want = 15 if encode_pallas._deep_fits(n + 8, cap) else None
        got = encode_deep.deep_route(n, None)
        assert got == (None if want is None else (15, 0)), n
        for d in list(range(0, D + 1, 4092)) + [16384, 32768, D]:
            if encode_pallas._deep_fits(d + n + 8, cap):
                want = (15, d)
            else:
                du = min(d, 32768)
                want = ((14, du) if encode_pallas._deep_fits_u16(
                    du + n + 8, cap) else None)
            assert encode_deep.deep_route(n, d) == want, (n, d)


def test_depth4_fallbacks_are_unreachable_at_batch_shapes():
    """The Pallas wrappers' depth-4 fallbacks need rows over 64 KiB: the
    widest plain row and the widest row after the widest window still
    route to the deep kernel (the route only shrinks as N and D shrink)."""
    assert encode_deep.deep_route(encode.MAX_ROW, None) == (15, 0)
    assert encode_deep.deep_route(encode.MAX_ROW, encode.MAX_WINDOW) \
        == (14, 32768)
    assert encode_deep.deep_route(2 * N, None) is None
    assert encode_deep.deep_route(2 * N, D) is None


def test_deep_constants_match_pallas():
    assert encode_deep.DEEP_HASH_LOG == encode_pallas.DEEP_HASH_LOG
    assert encode_deep.DEEP_HASH_LOG_U16 == encode_pallas.DEEP_HASH_LOG_U16
    assert encode_deep.BW_MAX_ELEMS == encode_pallas._BW_MAX_ELEMS
    assert batch._DEEP_TRIES == tpu_batch._DEEP_TRIES
    # the lazy cap is the Pallas wrapper's default of PLZ4_DEEP_LAZYCAP
    assert encode_deep.LAZY_CAP == 64


def test_csrc_constants_match_python():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csrc = os.path.join(root, "plz4_tpu_torch", "csrc")
    deep = open(os.path.join(csrc, "lz4_encode_deep.cuh")).read()
    mid = open(os.path.join(csrc, "lz4_encode_mid.cuh")).read()
    assert f"#define LZ4T_DEEP_LAZY_CAP {encode_deep.LAZY_CAP}\n" in deep
    assert f"#define LZ4T_DEEP_MIN_MATCH {encode_deep.MIN_MATCH}\n" in deep
    assert f"#define LZ4T_MID_HASH_LOG {encode_mid.MID_HASH_LOG}\n" in mid


def test_level_ladder_sizes_strictly_improve():
    """The port's analog of tests/test_device_backend.py's ladder pin:
    greedy, depth 2, depth 4 and the deep finder give strictly smaller
    streams on the same text, wider walk budgets never larger ones, and
    all decode."""
    data = make_compressible(8000, seed=41)
    rows, lens = _t(*_rows([data], 8000))
    sizes = [encode.encode_batch(rows, lens),
             encode_mid.encode_batch_mid(rows, lens),
             encode_mid.encode_batch_mid(rows, lens, depth4=True)]
    sizes += [encode_deep.encode_batch_deep(rows, lens, t) for t in TRIES]
    for out, tot, ok in sizes:
        assert bool(ok[0])
        assert native.decompress(out[0, :int(tot[0])].numpy().tobytes(),
                                 len(data)) == data
    tots = [int(tot[0]) for _, tot, _ in sizes]
    assert tots[0] > tots[1] > tots[2] > tots[3], tots
    assert tots[3] >= tots[4] >= tots[5] >= tots[6], tots


# ---------------------------------------------------------------------------
# K4's prebuilt chain and its ring (csrc/lz4_encode_deep.cuh)
# ---------------------------------------------------------------------------

def _deep_define(name: str) -> int:
    """A #define of csrc/lz4_encode_deep.cuh."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "plz4_tpu_torch", "csrc",
                           "lz4_encode_deep.cuh")) as f:
        return int(re.search(rf"#define {name} (\d+)\b", f.read()).group(1))


MAX_DELTA = 65535  # a longer link is stored as 0, which ends the chain
WINDOW_CUT = encode_deep.WINDOW_CUT

def _plain_chain(row: bytes, n: int, N: int, window: bytes, wlen: int,
                 tries: int, hash_log: int):
    """The chain that the plain version's insert-as-you-go parse leaves,
    as K4's u16 deltas over [first, mflimit], read from its frame when it
    returns."""
    got = {}
    code = encode_deep.encode_row_deep_plain.__code__

    def prof(frame, event, arg):
        if event == "return" and frame.f_code is code:
            got.update((k, frame.f_locals[k])
                       for k in ("chain", "first", "mflimit"))

    sys.setprofile(prof)
    try:
        encode_deep.encode_row_deep_plain(row, n, N, window, wlen, tries,
                                          hash_log)
    finally:
        sys.setprofile(None)
    first, mflimit, chain = got["first"], got["mflimit"], got["chain"]
    out = np.zeros(len(window) + N + 8, np.uint16)
    for p in range(first, mflimit + 1):
        d = p - (chain[p] - 1)
        out[p] = d if chain[p] and d <= MAX_DELTA else 0
    return out


def _host_chain(lib, rows, lens, wins, wlens, chunks=1):
    """lz4t_deep_build's deltas, routed as the wrapper routes the rows."""
    R, width = rows.shape
    Dw = None if wins is None else wins.shape[1]
    hash_log, Dc = encode_deep.deep_route(width, Dw)
    out = np.zeros((R, Dc + width + 8), np.uint16)
    lib.lz4t_host_deep_chain(
        rows.ctypes.data, lens.ctypes.data,
        0 if wins is None else wins.ctypes.data,
        0 if wlens is None else wlens.ctypes.data, out.ctypes.data, R, width,
        Dw or 0, chunks, Dc, hash_log)
    return out, hash_log, Dc


PEER_CHUNK = _deep_define("LZ4T_DEEP_PEER_CHUNK")
PEER_ENTRIES = _deep_define("LZ4T_DEEP_PEER_SLOTS") * PEER_CHUNK


def _peer_edges() -> bytes:
    """Random bytes with a bucket on both sides of every peer-chunk edge:
    a run of one byte, or a 3-byte period, over the last steps of one
    chunk and the first of the next."""
    row = bytearray(make_incompressible(N, seed=62))
    for k, e in enumerate(range(PEER_CHUNK, N, PEER_CHUNK)):
        row[e - 40:e + 40] = (bytes([k]) * 80 if k % 2 else
                              (make_incompressible(3, seed=k) * 27)[:80])
    return bytes(row)


def _peer_cases() -> dict:
    """name -> plain row for the split build's peer ring (the table
    ring's memory before the table needs it): full rows that cycle the
    ring's slots, periods around the 32 lanes of a step, and rows too
    short to fill one peer chunk."""
    out = {"zeros": bytes(N)}
    for p in (1, 2, 3, 4, 5, 8, 16, 31, 32, 33):
        out[f"period{p}"] = (make_incompressible(p, seed=60 + p)
                             * (N // p + 1))[:N]
    out["not-a-multiple-of-32"] = make_compressible(PEER_ENTRIES + 7233,
                                                    seed=61)
    out["shorter-than-a-peer-chunk"] = make_compressible(PEER_CHUNK - 300,
                                                         seed=63)
    out["n13"] = b"abcabcabcabca"
    out["n12"] = b"abcabcabcabc"
    out["n5"] = b"abcab"
    out["empty"] = b""
    out["groups-straddle-peer-chunk-edges"] = _peer_edges()
    return out


PEER_CASES = _peer_cases()


def _chain_batches():
    """name -> (args, chunks): the module's cached batches."""
    out = {"small": (_plain("small", 2)[0] + (None, None), 1),
           "full": (_plain("full", 2)[0] + (None, None), 1),
           "windows": (_windows(tuple(WINDOW_CASES), D, 2)[0], 1),
           "chunks": (_chunks()[0], K),
           "peers": (_rows(list(PEER_CASES.values()), N) + (None, None),
                     1)}
    return out


def _chain_params():
    return [pytest.param(name, r, id=f"{name}-{r}")
            for name, n in (("small", len(SHAPES)), ("full", len(FULL)),
                            ("windows", len(WINDOW_CASES)), ("chunks", 2 * K))
            for r in range(n)] + [
        pytest.param("peers", r, id=f"peers-{case}")
        for r, case in enumerate(PEER_CASES)]


@pytest.mark.parametrize("name,r", _chain_params())
def test_prebuilt_chain_is_the_insert_as_you_go_chain(name, r, host_lib):
    (rows, lens, wins, wlens), chunks = _chain_batches()[name]
    got, hash_log, Dc = _host_chain(host_lib, rows, lens, wins, wlens,
                                    chunks)
    N = rows.shape[1]
    window = b""
    if wins is not None:
        D_ = wins.shape[1]
        src = wins[r // chunks] if r % chunks == 0 else rows[r - 1]
        window = src[D_ - Dc:].tobytes()
    want = _plain_chain(rows[r].tobytes(), int(lens[r]), N, window,
                        int(wlens[r]) if wlens is not None else 0, 2,
                        hash_log)
    assert got[r].tobytes() == want.tobytes()


def _ring_rows():
    """Rows of a 64 KiB block after a 32 KiB window (row positions 0 ..
    98,311, the ring's slots reused past 65,536) of random bytes with
    16-byte repeats at distances around the match window's edge: the
    second copy at or past row position 65,536, the first copy's slot
    reused when the parse loads slots ahead of its position."""
    rng = np.random.default_rng(0x2196)
    rows, wins = [], []
    dists = (65504, 65505, 65520, 65533, 65534, 65535, 65536, 65537)
    for k in range(3):
        row = bytearray(rng.integers(0, 256, WINDOW_CUT + N, dtype=np.uint8)
                        .tobytes())
        for j, d in enumerate(dists * 3):
            q = 800 + 1000 * j + 37 * k
            pat = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            row[q:q + 16] = pat
            row[q + d:q + d + 16] = pat
            if j % 3 == 0:  # a longer chain: a third copy in between
                row[q + d // 2:q + d // 2 + 16] = pat
        if k == 2:  # runs across the boundary: long chains of one bucket
            row[60000:72000] = b"\x07" * 12000
        wins.append(b"\x00" * WINDOW_CUT + bytes(row[:WINDOW_CUT]))
        rows.append(bytes(row[WINDOW_CUT:]))
    return rows, wins


RING_ROWS = _ring_rows()


@functools.lru_cache(maxsize=None)
def _ring(tries: int):
    rows, lens = _rows(RING_ROWS[0], N)
    wins, _ = _rows(RING_ROWS[1], D)
    wlens = np.full(len(rows), D, np.int32)
    args = (rows, lens, wins, wlens)
    assert encode_deep.deep_route(N, D) == (14, WINDOW_CUT)
    ref = _np(encode_pallas.encode_batch_pallas_deep_dict(
        *(jnp.asarray(a) for a in args), interpret=True, tries=tries))
    got = _np(encode_deep.encode_batch_deep_window(*_t(*args), tries))
    return args, ref, got


@pytest.mark.parametrize("tries", (2, 32))
@pytest.mark.parametrize("r", range(3))
def test_ring_reuse_across_65536_matches_pallas(r, tries, host_lib):
    args, ref, got = _ring(tries)
    _assert_same(ref, got, r)
    _assert_same(ref, _host_encode(host_lib, *args, tries), r)
    assert ref[2][r]
    assert native.decompress(got[0][r, :got[1][r]].tobytes(), N,
                             dict_=RING_ROWS[1][r][D - WINDOW_CUT:]) \
        == RING_ROWS[0][r]


@pytest.mark.parametrize("r", range(3))
def test_ring_rows_chain_is_the_insert_as_you_go_chain(r, host_lib):
    rows, lens = _rows(RING_ROWS[0], N)
    wins, _ = _rows(RING_ROWS[1], D)
    wlens = np.full(len(rows), D, np.int32)
    got, hash_log, Dc = _host_chain(host_lib, rows, lens, wins, wlens)
    want = _plain_chain(rows[r].tobytes(), int(lens[r]), N,
                        wins[r, D - Dc:].tobytes(), D, 2, hash_log)
    assert got[r].tobytes() == want.tobytes()


def _offsets(stream: bytes) -> set:
    """The match offsets of an LZ4 block stream."""
    out, ip = set(), 0
    while True:
        tok = stream[ip]
        ip += 1
        lit = tok >> 4
        if lit == 15:
            while stream[ip] == 255:
                lit += 255
                ip += 1
            lit += stream[ip]
            ip += 1
        ip += lit
        if ip >= len(stream):
            return out
        out.add(stream[ip] | stream[ip + 1] << 8)
        ip += 2
        if tok & 15 == 15:
            while stream[ip] == 255:
                ip += 1
            ip += 1


def test_ring_rows_find_matches_at_the_window_edge():
    """At tries 32 the walks reach the planted copies 65,504-65,535 bytes
    back, whose links lie in slots the ring has reused."""
    _, ref, got = _ring(32)
    for r in range(3):
        offs = _offsets(got[0][r, :got[1][r]].tobytes())
        assert {65504, 65505, 65520, 65533, 65534, 65535} <= offs, r


# ---------------------------------------------------------------------------
# plain rows through the table ring (lz4t_pipe_tab): the parse waits for
# each chunk of the walk table and hands it back once its scan has passed
# it; the host build fills a chunk only when the parse waits for it and
# poisons every chunk it hands back
# ---------------------------------------------------------------------------

CHUNK = _deep_define("LZ4T_DEEP_PIPE_CHUNK")
RING_ENTRIES = _deep_define("LZ4T_DEEP_PIPE_SLOTS") * CHUNK


def _plant(row: bytearray, dst: int, src: int, n: int) -> None:
    """Copy row[src:src + n] to dst, the bytes on either side of the copy
    made to differ from those of its source, so the match is exactly n
    bytes long."""
    row[dst:dst + n] = row[src:src + n]
    row[dst - 1] = row[src - 1] ^ 0xFF if src else row[dst - 1]
    row[dst + n] = row[src + n] ^ 0xFF


def _pipe_cases() -> dict:
    """name -> (payload, [(match start, match length)] the stream must
    hold)."""
    out = {"shorter-than-a-chunk": (make_compressible(CHUNK - 300, seed=51),
                                    []),
           "not-a-multiple-of-the-chunk": (
               make_compressible(RING_ENTRIES + 3 * CHUNK + 517, seed=52),
               []),
           "incompressible": (make_incompressible(N, seed=53), []),
           "zeros": (bytes(N), [])}
    # random bytes with planted copies (short rows: random bytes do not
    # shrink). The scan's steps start at 130 + 32 j after the first match:
    # the step from CHUNK - 30 finds the match at CHUNK + 1 in chunk 1;
    # after it the steps start at CHUNK + 61 + 32 j, and the one from
    # 8 CHUNK - 3 (the last entries of the ring's last slot and the first
    # of its first) finds the match at 8 CHUNK + 5
    row = bytearray(make_incompressible(RING_ENTRIES + 600, seed=54))
    want = [(70, 60), (CHUNK + 1, 60), (RING_ENTRIES + 5, 60)]
    for (dst, n), src in zip(want, (0, 200, 400)):
        _plant(row, dst, src, n)
    out["scan-straddles-two-chunks"] = (bytes(row), want)
    # the scan's step from CHUNK - 32 finds a match at CHUNK - 1, its last
    # entry: the lazy test then reads the first entry of chunk 1
    row = bytearray(make_incompressible(2 * CHUNK, seed=56))
    want = [(70, 58), (CHUNK - 1, 10)]
    for (dst, n), src in zip(want, (0, 200)):
        _plant(row, dst, src, n)
    out["lazy-test-reads-the-next-chunk"] = (bytes(row), want)
    # a 6,000-byte match: the parse passes chunks it never reads, then
    # scans on
    row = bytearray(make_incompressible(28000, seed=55))
    _plant(row, 20000, 1000, 6000)
    out["match-skips-whole-chunks"] = (bytes(row), [(20000, 6000)])
    return out


PIPE_CASES = _pipe_cases()


@functools.lru_cache(maxsize=None)
def _pipe(tries: int):
    rows, lens = _rows([p for p, _ in PIPE_CASES.values()], N)
    ref = _np(encode_pallas.encode_batch_pallas_deep(
        jnp.asarray(rows), jnp.asarray(lens), interpret=True, tries=tries))
    plain = _np(encode_deep.encode_batch_deep_plain(*_t(rows, lens), tries))
    return (rows, lens), ref, plain


def _sequences(stream: bytes) -> list:
    """(match start, match length) of each sequence of an LZ4 block
    stream with a match."""
    out, ip, pos = [], 0, 0
    while True:
        tok = stream[ip]
        ip += 1
        lit = tok >> 4
        if lit == 15:
            while stream[ip] == 255:
                lit += 255
                ip += 1
            lit += stream[ip]
            ip += 1
        ip += lit
        pos += lit
        if ip >= len(stream):
            return out
        ip += 2
        m = tok & 15
        if m == 15:
            while stream[ip] == 255:
                m += 255
                ip += 1
            m += stream[ip]
            ip += 1
        out.append((pos, m + 4))
        pos += m + 4


def _pipe_params():
    return [pytest.param(tries, name, id=f"{name}-t{tries}")
            for tries in TRIES for name in PIPE_CASES]


@pytest.mark.parametrize("tries,name", _pipe_params())
def test_pipelined_rows_match_pallas_and_plain(tries, name, host_lib):
    (rows, lens), ref, plain = _pipe(tries)
    i = list(PIPE_CASES).index(name)
    host = _host_encode(host_lib, rows, lens, None, None, tries)
    _assert_same(ref, plain, i)
    _assert_same(ref, host, i)
    _assert_same(plain, host, i)  # all bytes, also where ok is false
    payload, want = PIPE_CASES[name]
    if name == "incompressible":
        assert not ref[2][i]
        return
    assert ref[2][i]
    stream = host[0][i, :host[1][i]].tobytes()
    assert native.decompress(stream, len(payload)) == payload
    seqs = _sequences(stream)
    assert seqs[:len(want)] == want
    if name == "zeros":  # capped entries, walked again: one long match
        assert seqs[0][1] > N - 100
    if name == "scan-straddles-two-chunks":
        for (a, m), (b, _) in zip(seqs, seqs[1:]):
            step = a + m + (b - a - m) // 32 * 32  # the step that found b
            assert step // CHUNK != (step + 31) // CHUNK
    if name == "match-skips-whole-chunks":
        a, m = seqs[0]
        assert (a + m) // CHUNK - -(-a // CHUNK) >= 2


def test_pipe_ring_fits_shared_memory():
    slots = _deep_define("LZ4T_DEEP_PIPE_SLOTS")
    assert slots & (slots - 1) == 0
    assert CHUNK & (CHUNK - 1) == 0 and CHUNK % 32 == 0
    assert _deep_define("LZ4T_DEEP_RING") == encode_deep.PIPE_MAX_ROW
    # the split build's peer ring (a u32 word a position) lies in the
    # table ring's entries
    peer_slots = _deep_define("LZ4T_DEEP_PEER_SLOTS")
    assert peer_slots & (peer_slots - 1) == 0
    assert PEER_CHUNK & (PEER_CHUNK - 1) == 0 and PEER_CHUNK % 32 == 0
    assert PEER_ENTRIES <= slots * CHUNK
    # the chain ring, the table ring, two mbarriers a slot of each ring,
    # the widest row: within a block's 232,448 bytes
    assert (2 * encode_deep.PIPE_MAX_ROW + slots * (CHUNK * 4 + 16)
            + peer_slots * 16 + encode_deep.PIPE_MAX_ROW + 8) <= 232448
