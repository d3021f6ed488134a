"""Port K6b (whole-block encode of wide rows, greedy and depth 2) as a
warp-cooperative parse: the host build of its path (csrc/lz4_encode_wide.cuh:
K2a/K2b's and K2c's lanes' bodies with K6b's emit, handing sequences
through the ring to the emit warps' steps) against the JAX package's
packed-word Pallas kernel in interpret mode, and against K6b's plain
version (encode_wide.encode_row_wide_plain).

Byte-exact contract: the same ok and total per row, and the same stream
bytes [0, total) where ok holds; against the plain version also wherever
total < CAP (the sequences tile the output, so no byte below the clip
depends on the order the emit warps write in). The rows: the wide batches
that test_torch_wide.py and test_torch_wide_edges.py hold to Pallas (each
reference batch computed once in this module), the greedy and chain edge
rows at the first widths K6b takes (corpus.wide_edge_rows), two seeded
4 MiB rows, and rows under output caps that stop the stream near its
end or in the middle, where K6b's op arithmetic (no room guard) decides
total. tests/test_torch_gpu.py holds the CUDA kernel to the plain
version.
"""

import functools
import shutil

import numpy as np
import pytest
import torch

from plz4_tpu_torch import corpus, native
from plz4_tpu_torch.ops import _build, encode, encode_wide

import test_torch_wide as tw
import test_torch_wide_edges as te
from conftest import make_compressible, make_incompressible


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


def _host_wide(lib, rows, lens, D=0, wins=None, wlens=None, mid=False,
               cap=None):
    """K6b's host path on rows (R, N) after optional right-aligned windows
    (R, D): the kernel's [window | block | 8 zero] rows, built here. cap:
    the output width (default CAP of N)."""
    R, N = rows.shape
    DT = D + N + 8
    comb = np.zeros((R, DT), np.uint8)
    if D:
        comb[:, :D] = wins
    comb[:, D:D + N] = rows
    CAP = encode.out_width(N) if cap is None else cap
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, np.uint8)
    wl = np.zeros(R, np.int32) if wlens is None else np.asarray(wlens,
                                                                np.int32)
    lib.lz4t_host_encode_wide(
        comb.ctypes.data, np.ascontiguousarray(lens).ctypes.data,
        wl.ctypes.data, out.ctypes.data, tot.ctypes.data, ok.ctypes.data, R,
        DT, D, CAP, int(mid))
    return out, tot, ok.astype(bool)


def _plain_wide(rows, lens, D=0, wins=None, wlens=None, mid=False,
                cap=None):
    """K6b's plain version on the rows _host_wide takes, with its results'
    layout."""
    R, N = rows.shape
    CAP = encode.out_width(N) if cap is None else cap
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, bool)
    for r in range(R):
        win = wins[r].tobytes() if D else b""
        s, tot[r], ok[r] = encode_wide.encode_row_wide_plain(
            rows[r].tobytes(), int(lens[r]), N, win,
            int(wlens[r]) if D else 0, mid=mid, cap=cap)
        out[r, :len(s)] = np.frombuffer(s, np.uint8)
    return out, tot, ok


def _same_where_ok(ref, got, i):
    (ro, rt, rk), (go, gt, gk) = ref, got
    assert bool(gk[i]) == bool(rk[i])
    assert int(gt[i]) == int(rt[i])
    if rk[i]:
        t = int(rt[i])
        assert go[i, :t].tobytes() == ro[i, :t].tobytes()


def _same_where_fits(ref, got):
    """ok and total on every row, bytes wherever total < CAP."""
    (ro, rt, rk), (go, gt, gk) = ref, got
    assert np.array_equal(np.asarray(gk, bool), np.asarray(rk, bool))
    assert np.array_equal(gt, rt)
    for i, t in enumerate(rt.tolist()):
        if t < ro.shape[1]:
            assert go[i, :t].tobytes() == ro[i, :t].tobytes(), i


# ---------------------------------------------------------------------------
# the wide batches of test_torch_wide.py and test_torch_wide_edges.py,
# against Pallas interpret mode
# ---------------------------------------------------------------------------

WIDE_KINDS = ["greedy", "mid", "greedy-window", "mid-window"]


@functools.lru_cache(maxsize=None)
def _host_wide_batch(kind: str):
    rows, lens, wins, wl = tw._rows()
    window = kind.endswith("window")
    return _host_wide(_build.load_host(), rows, lens, tw.D if window else 0,
                      wins if window else None, wl if window else None,
                      mid=kind.startswith("mid"))


@pytest.mark.parametrize("name", tw.NAMES)
@pytest.mark.parametrize("kind", WIDE_KINDS)
def test_lanes_path_and_plain_match_pallas(kind, name, host_lib):
    """The 128 KiB rows (text, random, near-incompressible, zeros, short,
    empty), plain and after full, partial and empty windows."""
    i = tw.NAMES.index(name)
    ref = tw._ref(kind)
    _same_where_ok(ref, _host_wide_batch(kind), i)
    _same_where_ok(ref, tw._port(kind), i)


EDGE_CASES = [(k, D, N) for k, D, N in te.CASES
              if not encode.bw_fits(D + N + 8, encode.out_width(N),
                                    k != "greedy", k == "depth4")]


@pytest.mark.parametrize("kind,D,N", EDGE_CASES,
                         ids=[f"{k}-D{D}-N{N}" for k, D, N in EDGE_CASES])
def test_lanes_path_and_plain_match_pallas_at_the_edge(kind, D, N, host_lib):
    """The first K6b width of each route (a deep or depth-4 request runs
    K6b at depth 2 there)."""
    rows, lens, win, wl = te._rows(N)
    ref = te._ref(kind, D, N)
    host = _host_wide(host_lib, rows, lens, D, win[:, :D] if D else None, wl,
                      mid=kind != "greedy")
    te._same(ref, host)
    args = [torch.from_numpy(x) for x in (rows, lens)]
    if D:
        args += [torch.from_numpy(np.ascontiguousarray(win[:, :D])),
                 torch.from_numpy(wl)]
    te._same(ref, tuple(t.numpy() for t in encode_wide.encode_batch_wide(
        *args, mid=kind != "greedy")))


# ---------------------------------------------------------------------------
# the lanes' path against the plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _edge_batches(mid: bool):
    """corpus.wide_edge_rows through the lanes' path and the plain version:
    {"plain" | "window": (lanes, plain, blocks)}."""
    lib = _build.load_host()
    (blocks, N), (wblocks, Nw, wins, wlens) = corpus.wide_edge_rows(mid)
    out = {}
    for key, bl, width, kw in (
            ("plain", blocks, N, {}),
            ("window", wblocks, Nw,
             dict(D=65536, wins=np.stack([np.frombuffer(w, np.uint8)
                                          for w in wins]), wlens=wlens))):
        rows, lens = _rows_of(bl, width)
        out[key] = (_host_wide(lib, rows, lens, mid=mid, **kw),
                    _plain_wide(rows, lens, mid=mid, **kw), bl)
    return out


def _rows_of(blocks, width):
    rows = np.zeros((len(blocks), width), np.uint8)
    for i, b in enumerate(blocks):
        rows[i, :len(b)] = np.frombuffer(b, np.uint8)
    return rows, np.array([len(b) for b in blocks], np.int32)


def _edge_ids(mid: bool):
    plain, windowed = (corpus.chain_edge_rows() if mid
                       else corpus.greedy_edge_rows())
    ids = [(k, where) for k in plain for where in ("alone", "at-end")]
    wids = [(k, where) for k in windowed for where in ("alone", "filled")]
    return ids, wids


def _edge_params():
    out = []
    for mid in (False, True):
        ids, wids = _edge_ids(mid)
        mode = "mid" if mid else "greedy"
        out += [pytest.param(mid, "plain", i, id=f"{mode}-{k}-{w}")
                for i, (k, w) in enumerate(ids)]
        out += [pytest.param(mid, "window", i, id=f"{mode}-window-{k}-{w}")
                for i, (k, w) in enumerate(wids)]
    return out


@pytest.mark.parametrize("mid,key,i", _edge_params())
def test_lanes_path_matches_plain_on_edge_rows(mid, key, i, host_lib):
    """Every greedy / chain edge row past the bw_fits edge, alone and at
    the row's end: the same ok and total, the same bytes wherever total <
    CAP, and an ok stream decodes to its block."""
    lanes, plain, blocks = _edge_batches(mid)[key]
    rows = (lanes[0][i:i + 1], lanes[1][i:i + 1], lanes[2][i:i + 1])
    ref = (plain[0][i:i + 1], plain[1][i:i + 1], plain[2][i:i + 1])
    _same_where_fits(ref, rows)
    if key == "plain" and lanes[2][i]:
        t = int(lanes[1][i])
        assert native.decompress(lanes[0][i, :t].tobytes(),
                                 len(blocks[i])) == blocks[i]


def test_edge_rows_reach_the_row_end():
    """The at-end rows fill their row (n = N), so their last steps read the
    row's last words; most of them compress."""
    for mid in (False, True):
        (blocks, N), (wblocks, Nw, _, _) = corpus.wide_edge_rows(mid)
        assert N == corpus.WIDE_EDGE[mid, 0] and all(
            len(b) == N for b in blocks[1::2])
        assert Nw == corpus.WIDE_EDGE[mid, 65536] and all(
            len(b) == Nw for b in wblocks[1::2])
        assert not encode.bw_fits(N + 8, encode.out_width(N), mid)
        assert not encode.bw_fits(65536 + Nw + 8, encode.out_width(Nw), mid)
        assert encode.bw_fits(N + 4, encode.out_width(N - 4), mid)
        lanes = _edge_batches(mid)["plain"][0]
        assert lanes[2].mean() > 0.5


@functools.lru_cache(maxsize=None)
def _big_rows():
    """Two seeded 4 MiB rows: the bench's Silesia-like data, and text with
    random stretches."""
    n = 4 << 20
    a = corpus.silesia_like(n, seed=77)
    rng = np.random.default_rng(78)
    b = bytearray(make_compressible(n, seed=79))
    for p in range(0, n - 70000, 1 << 19):
        b[p:p + 70000] = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    return _rows_of([a, bytes(b)], n)


@pytest.mark.parametrize("mid", [False, True], ids=["greedy", "mid"])
def test_lanes_path_matches_plain_on_4mib_rows(mid, host_lib):
    rows, lens = _big_rows()
    lanes = _host_wide(host_lib, rows, lens, mid=mid)
    plain = _plain_wide(rows, lens, mid=mid)
    _same_where_fits(plain, lanes)
    assert lanes[2].all()
    for i in range(2):
        t = int(lanes[1][i])
        assert native.decompress(lanes[0][i, :t].tobytes(),
                                 4 << 20) == rows[i].tobytes()


# ---------------------------------------------------------------------------
# output caps: K6b's op arithmetic decides total
# ---------------------------------------------------------------------------

CAP_N = 32768


@functools.lru_cache(maxsize=None)
def _cap_rows():
    """Rows whose streams stop in the middle under a small cap
    (incompressible, near-incompressible) or near their end (text)."""
    return _rows_of([make_compressible(CAP_N, seed=81),
                    make_incompressible(CAP_N, seed=82),
                    tw.near_incompressible(CAP_N, 83, 256, 6),
                    tw.near_incompressible(CAP_N, 84, 64, 9)], CAP_N)


def _caps(mid):
    """Output caps around each row's full total (where a room guard of 32
    bytes would refuse a sequence that K6b's emit takes), and caps that
    stop the streams mid-row."""
    rows, lens = _cap_rows()
    full = _plain_wide(rows, lens, mid=mid)[1]
    caps = sorted({int(t) + k for t in full for k in range(0, 48, 3)}
                  | {CAP_N // 4, CAP_N // 2, CAP_N // 2 + 1})
    return rows, lens, caps


@pytest.mark.parametrize("mid", [False, True], ids=["greedy", "mid"])
def test_lanes_path_matches_plain_under_output_caps(mid, host_lib):
    rows, lens, caps = _caps(mid)
    inside_guard = 0
    for cap in caps:
        lanes = _host_wide(host_lib, rows, lens, mid=mid, cap=cap)
        plain = _plain_wide(rows, lens, mid=mid, cap=cap)
        _same_where_fits(plain, lanes)
        # a total the room guard's 32-byte margin would have refused
        inside_guard += int(((lanes[1] < cap) & (lanes[1] > cap - 32)).sum())
    assert inside_guard > 0


@pytest.mark.parametrize("mid", [False, True], ids=["greedy", "mid"])
def test_streams_stop_mid_row_under_small_caps(mid, host_lib):
    """Under a cap of half the row, the incompressible rows overflow in the
    middle of the row (total is the cap), and the text row still fits."""
    rows, lens = _cap_rows()
    cap = CAP_N // 2
    out, tot, ok = _host_wide(host_lib, rows, lens, mid=mid, cap=cap)
    assert tot[1:].tolist() == [cap] * 3
    assert ok[0] and tot[0] < cap
