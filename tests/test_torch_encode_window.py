"""Port K2b (greedy block encode after a window prefix):
plz4_tpu_torch.ops.encode.encode_batch_window against the JAX package's
Pallas kernel (encode_pallas.encode_batch_pallas_dict) in interpret mode.

Byte-exact contract, as for K2a: the same ok and total per row, and the
same stream bytes [0, total) where ok holds. Windows are full, partial,
empty and strided (wstride 1 for dictionaries and linked blocks, 2 for the
chunks of large blocks), at the frame path's row widths (64 KiB block rows
after 64 KiB window rows). The plain version and the CUDA kernel's row body
built with g++ are each held to the Pallas kernel, and the row body to the
plain version; tests/test_torch_gpu.py holds the CUDA kernel to the plain
version.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import encode_pallas
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import _build, encode

from conftest import make_compressible, make_incompressible

N = D = 65536


def _garbage(n: int, seed: int) -> bytes:
    """Bytes below a partial window's first usable byte: never read."""
    return make_incompressible(n, seed=seed)


def _cases() -> dict:
    """name -> (block, window row of D bytes, usable window bytes)."""
    dict_ = make_compressible(D, seed=31)
    text = make_compressible(N, seed=32)
    noise = make_incompressible(D, seed=34)
    frag = b"".join(noise[a:a + 40] + b"\x01\x02"
                    for a in range(0, 40000, 97))[:N]
    part = noise[-1001:]
    return {
        "full": (text, dict_, D),
        "dict-fragments": (frag, noise, D),
        "partial-odd": (frag[:30000], _garbage(D - 1001, 1) + part, 1001),
        "partial-tiny": (b"hello world " * 50, _garbage(D - 5, 2)
                         + b"hello", 5),
        "empty-window": (text, _garbage(D, 3), 0),
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


CASES = _cases()
NAMES = list(CASES)


def _batch(names):
    rows = np.zeros((len(names), N), np.uint8)
    lens = np.zeros(len(names), np.int32)
    wins = np.zeros((len(names), D), np.uint8)
    wlens = np.zeros(len(names), np.int32)
    for i, name in enumerate(names):
        blk, win, wl = CASES[name]
        rows[i, :len(blk)] = np.frombuffer(blk, np.uint8)
        lens[i] = len(blk)
        wins[i] = np.frombuffer(win, np.uint8)
        wlens[i] = wl
    return rows, lens, wins, wlens


def _pallas(rows, lens, wins, wlens, wstride):
    return tuple(np.asarray(x) for x in encode_pallas.encode_batch_pallas_dict(
        jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(wins),
        jnp.asarray(wlens), interpret=True, wstride=wstride))


@functools.lru_cache(maxsize=None)
def _full(wstride: int):
    """All cases, one window per row: inputs, Pallas result, plain's."""
    args = _batch(NAMES)
    ref = _pallas(*args, wstride)
    got = tuple(t.numpy() for t in encode.encode_batch_window(
        *(torch.from_numpy(a) for a in args), wstride=wstride))
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


def _host_encode(lib, rows, lens, wins, wlens, wstride, chunks=1):
    """K2b's row body built with g++ (the lanes' body)."""
    R = rows.shape[0]
    CAP = encode.out_width(N)
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, np.uint8)
    lib.lz4t_host_encode_window(
        rows.ctypes.data, lens.ctypes.data, wins.ctypes.data,
        wlens.ctypes.data, out.ctypes.data, tot.ctypes.data, ok.ctypes.data,
        R, N, wins.shape[1], chunks, wstride, CAP)
    return out, tot, ok


@pytest.mark.parametrize("wstride", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_pallas(name, wstride):
    _, ref, got = _full(wstride)
    _assert_same(ref, got, NAMES.index(name))


@pytest.mark.parametrize("wstride", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_row_body_matches_pallas(name, wstride, host_lib):
    """The CUDA kernel's row body (csrc/lz4_encode.cuh, no value table) and
    window preload, built for the host with g++, against the Pallas
    kernel."""
    args, ref, _ = _full(wstride)
    _assert_same(ref, _host_encode(host_lib, *args, wstride),
                 NAMES.index(name))


@pytest.mark.parametrize("name", NAMES)
def test_ok_streams_decode_natively_with_window(name):
    (_, lens, _, _), _, (out, tot, ok) = _full(1)
    blk, win, wl = CASES[name]
    i = NAMES.index(name)
    if not ok[i]:
        assert int(tot[i]) >= lens[i]  # stored raw by the batch layer
        return
    stream = out[i, :int(tot[i])].tobytes()
    assert native.decompress(stream, N, dict_=win[D - wl:]) == blk


def test_window_matches_pay_off():
    """Fragments of an incompressible window compress only through it
    (the 2^14-slot table keeps about a quarter of a full window's 64 Ki
    positions, so many fragments still go out as literals)."""
    (_, lens, _, _), _, (_, tot, ok) = _full(1)
    frag = NAMES.index("dict-fragments")
    assert ok[frag] and int(tot[frag]) < int(lens[frag]) // 2


# ---------------------------------------------------------------------------
# chunk rows of large blocks: windows read in place from the previous row
# ---------------------------------------------------------------------------

K = 4  # chunks per large block (a 256 KiB block)


@functools.lru_cache(maxsize=None)
def _chunks():
    """Two 256 KiB-class blocks as K chunk rows each (the second 2.5
    chunks long, so one row is padding), the first after a 777-byte
    dictionary: the port's grouped layout, the Pallas kernel on the
    concatenated windows the JAX package builds, and the plain version."""
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
    wins = np.concatenate([d0[:, None, :],
                           rows.reshape(2, K, N)[:, :-1, :]],
                          axis=1).reshape(2 * K, D)
    ref = _pallas(rows, lens, wins, wlens, 2)
    got = tuple(t.numpy() for t in encode.encode_batch_window(
        torch.from_numpy(rows), torch.from_numpy(lens), torch.from_numpy(d0),
        torch.from_numpy(wlens), wstride=2, chunks=K))
    return (rows, lens, d0, wlens), ref, got


@pytest.mark.parametrize("r", range(2 * K))
def test_chunk_rows_plain_match_pallas(r):
    _, ref, got = _chunks()
    _assert_same(ref, got, r)


@pytest.mark.parametrize("r", range(2 * K))
def test_chunk_rows_kernel_row_body_match_pallas(r, host_lib):
    (rows, lens, d0, wlens), ref, _ = _chunks()
    _assert_same(ref, _host_encode(host_lib, rows, lens, d0, wlens, 2,
                                   chunks=K), r)


def test_chunk_streams_stitch_into_the_blocks():
    (rows, lens, _, _), _, (out, tot, _) = _chunks()
    for j in range(2):
        blk = rows[j * K:(j + 1) * K].reshape(-1)[: int(lens[j * K:(j + 1)
                                                             * K].sum())]
        streams = [out[j * K + k, :int(tot[j * K + k])].tobytes()
                   for k in range(K) if lens[j * K + k]]
        st = native.stitch_chunks(blk.tobytes(), N, streams)
        d = (b"" if j else make_compressible(777, seed=43))
        assert native.decompress(st, len(blk), dict_=d or None) \
            == blk.tobytes()


@pytest.mark.parametrize("kw,err", [
    (dict(chunks=3), "windows"),
    (dict(wstride=0), "windows"),
    (dict(win_shape=(2, 65537)), "windows"),
    (dict(win_shape=(1, 65536), chunks=2, N=1024), "windows"),
    (dict(wl_dtype=torch.int64), "wlens"),
])
def test_encode_batch_window_rejects_bad_shapes(kw, err):
    n = kw.pop("N", 1024)
    data = torch.zeros((2, n), dtype=torch.uint8)
    win = torch.zeros(kw.pop("win_shape", (2, 1024)), dtype=torch.uint8)
    wl = torch.zeros((2,), dtype=kw.pop("wl_dtype", torch.int32))
    with pytest.raises(ValueError, match=err):
        encode.encode_batch_window(data, torch.zeros((2,), dtype=torch.int32),
                                   win, wl, **kw)


def _cached(batch: str):
    """(operands, wstride, chunks, Pallas outputs, plain's) of a cached
    batch: the window cases at wstride 1 or 2, or the chunk rows."""
    if batch == "chunks":
        args, ref, got = _chunks()
        return args, 2, K, ref, got
    ws = int(batch[-1])
    args, ref, got = _full(ws)
    return args, ws, 1, ref, got


@functools.lru_cache(maxsize=None)
def _lanes(batch: str):
    """The lanes' body's results on a cached batch."""
    args, ws, chunks, _, _ = _cached(batch)
    return _host_encode(_build.load_host(), *args, ws, chunks)


def _batch_rows():
    return ([pytest.param(b, i, id=f"{b}-{n}") for b in ("wstride1",
                                                          "wstride2")
             for i, n in enumerate(NAMES)]
            + [pytest.param("chunks", r, id=f"chunks-{r}")
               for r in range(2 * K)])


@pytest.mark.parametrize("batch,i", _batch_rows())
def test_lanes_body_matches_plain(batch, i, host_lib):
    """The lanes' body and the plain version give the same ok and total,
    and the same bytes wherever total < CAP."""
    (so, st, sk), (lo, lt, lk) = _cached(batch)[4], _lanes(batch)
    assert (int(lt[i]), bool(lk[i])) == (int(st[i]), bool(sk[i]))
    if st[i] < so.shape[1]:
        assert lo[i, :st[i]].tobytes() == so[i, :st[i]].tobytes()


@pytest.mark.parametrize("batch,i", _batch_rows())
def test_streams_match_pallas_wherever_total_fits(batch, i, host_lib):
    """A row whose total is below the overflow sentinel CAP carries the
    Pallas kernel's bytes [0, total), ok or not: the large-block path
    stitches the stream of a chunk that did not shrink. Held for the lanes'
    body and the plain version."""
    _, _, _, (ro, rt, _), got = _cached(batch)
    for out, tot, _ in (_lanes(batch), got):
        assert int(tot[i]) == int(rt[i])
        if rt[i] < ro.shape[1]:
            assert out[i, :rt[i]].tobytes() == ro[i, :rt[i]].tobytes()
