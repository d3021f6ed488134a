"""The row-width routes of the port's encode and decode entry points, and
the byte-wide kernels at their new widths.

Where a row goes decides its bytes: the Pallas wrappers keep a row on the
byte-wide kernel while _bw_fits (encode) or out_cap <= _BW_MAX_OUT (decode)
holds, else take the packed-word kernel, and a deep request too wide for
its chain takes the depth-4 mid kernel first (deep_route). The port's route
functions are pinned to those over a width grid, and at the widths where
each route switches the port's plain versions and the g++ builds of the
CUDA row bodies (K2a, K2b, K2c, K2d on one side, K6b on the other) are held
to the Pallas wrappers in interpret mode: the same ok and total per row,
and the same stream bytes where ok holds.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import decode_pallas, encode_pallas
from plz4_tpu_torch.ops import (_build, decode, encode, encode_deep,
                                encode_mid)

from conftest import make_compressible
from test_torch_wide import near_incompressible

WINDOW = 65536
# the last width each byte-wide route takes, plain and after a 64 KiB
# window (the first K6b width is 4 bytes more)
EDGES = {("greedy", 0): 101140, ("mid", 0): 109316, ("depth4", 0): 101140,
         ("greedy", WINDOW): 68436, ("mid", WINDOW): 76612,
         ("depth4", WINDOW): 68436}


def _grid() -> list[int]:
    ws = {4, 64, 4096, 65536, 98304, 102400, 114688, 1 << 18, 1 << 20,
          4 << 20}
    for e in EDGES.values():
        ws |= {e - 4, e, e + 4, e + 8}
    return sorted(ws)


@pytest.mark.parametrize("D", [0, 4096, WINDOW])
@pytest.mark.parametrize("kind", ["greedy", "mid", "depth4"])
def test_bw_fits_matches_pallas(kind, D):
    for N in _grid():
        cap = encode.out_width(N)
        mid, depth4 = kind != "greedy", kind == "depth4"
        assert encode.bw_fits(D + N + 8, cap, mid, depth4) == \
            encode_pallas._bw_fits(D + N + 8, cap, mid, depth4=depth4), N


def test_route_edges():
    for (kind, D), last in EDGES.items():
        mid, depth4 = kind != "greedy", kind == "depth4"
        assert encode.bw_fits(D + last + 8, encode.out_width(last), mid,
                              depth4)
        assert not encode.bw_fits(D + last + 12, encode.out_width(last + 4),
                                  mid, depth4)
    assert encode.BW_MAX_ELEMS == encode_pallas._BW_MAX_ELEMS


def test_decode_route_matches_pallas():
    assert decode.BW_MAX_OUT == decode_pallas._BW_MAX_OUT == 96 * 1024
    for cap in _grid():
        assert decode.bw_fits(cap) == (cap <= decode_pallas._BW_MAX_OUT)


@pytest.mark.parametrize("D", [None, 4096, WINDOW])
def test_deep_route_over_the_width_grid(D):
    """encode_block_pallas_deep / _deep_dict's routing, at every width up
    to 4 MiB: None is the depth-4 mid fallback."""
    for N in _grid():
        cap = encode.out_width(N)
        if encode_pallas._deep_fits((D or 0) + N + 8, cap):
            want = (15, D or 0)
        elif D is None:
            want = None
        else:
            du = min(D, 32768)
            want = ((14, du) if encode_pallas._deep_fits_u16(du + N + 8, cap)
                    else None)
        assert encode_deep.deep_route(N, D) == want, N


def test_batch_chunking_did_not_move():
    """The batch layer's 64 KiB rows and chunks stay where they were: only
    the kernels' own limit widened."""
    from plz4_tpu_torch.parallel import batch, large

    assert batch.MAX_BLOCK == large.CHUNK == encode.MAX_ROW == 65536
    assert encode.MAX_BLOCK_ROW == 4 << 20 == decode.MAX_WIDE_OUT


# ---------------------------------------------------------------------------
# the kernels on both sides of each edge
# ---------------------------------------------------------------------------

PALLAS = {
    "greedy": encode_pallas.encode_batch_pallas,
    "mid": encode_pallas.encode_batch_pallas_mid,
    "depth4": functools.partial(encode_pallas.encode_batch_pallas_mid,
                                depth4=True),
}
PALLAS_WINDOW = {
    "greedy": encode_pallas.encode_batch_pallas_dict,
    "mid": encode_pallas.encode_batch_pallas_mid_dict,
    "depth4": functools.partial(encode_pallas.encode_batch_pallas_mid_dict,
                                depth4=True),
}
CASES = [(kind, D, N) for (kind, D), last in EDGES.items()
         for N in (last, last + 4)]
CASE_IDS = [f"{k}-D{D}-N{N}" for k, D, N in CASES]


@functools.lru_cache(maxsize=None)
def _rows(N: int):
    pl = [make_compressible(N, seed=N % 997), near_incompressible(N, 5, 256,
                                                                  6)]
    rows = np.zeros((len(pl), N), np.uint8)
    for i, p in enumerate(pl):
        rows[i] = np.frombuffer(p, np.uint8)
    win = np.tile(np.frombuffer(make_compressible(WINDOW, seed=8), np.uint8),
                  (len(pl), 1))
    return (rows, np.full(len(pl), N, np.int32), win,
            np.array([WINDOW, 2000], np.int32))


@functools.lru_cache(maxsize=None)
def _ref(kind: str, D: int, N: int):
    rows, lens, win, wl = _rows(N)
    if D:
        r = PALLAS_WINDOW[kind](jnp.asarray(rows), jnp.asarray(lens),
                                jnp.asarray(win), jnp.asarray(wl),
                                interpret=True)
    else:
        r = PALLAS[kind](jnp.asarray(rows), jnp.asarray(lens),
                         interpret=True)
    return tuple(np.asarray(x) for x in r)


def _same(ref, got):
    (ro, rt, rk), (go, gt, gk) = ref, got
    assert np.array_equal(np.asarray(gk, bool), rk)
    assert np.array_equal(np.asarray(gt), rt)
    for i in range(len(rt)):
        if rk[i]:
            assert go[i, :rt[i]].tobytes() == ro[i, :rt[i]].tobytes()


@pytest.mark.parametrize("kind,D,N", CASES, ids=CASE_IDS)
def test_plain_matches_pallas_at_the_edge(kind, D, N):
    rows, lens, win, wl = (torch.from_numpy(x) for x in _rows(N))
    depth4 = kind == "depth4"
    if kind == "greedy":
        got = (encode.encode_batch_window(rows, lens, win, wl) if D
               else encode.encode_batch(rows, lens))
    elif D:
        got = encode_mid.encode_batch_mid_window(rows, lens, win, wl,
                                                 depth4=depth4)
    else:
        got = encode_mid.encode_batch_mid(rows, lens, depth4=depth4)
    _same(_ref(kind, D, N), tuple(t.numpy() for t in got))


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


@pytest.mark.parametrize("kind,D,N", CASES, ids=CASE_IDS)
def test_kernel_row_bodies_match_pallas_at_the_edge(kind, D, N, host_lib):
    """The last byte-wide width runs the CUDA row body of K2a, K2b, K2c or
    K2d (shared memory holds it on the H100), the next one K6b's."""
    rows, lens, win, wl = _rows(N)
    R = rows.shape[0]
    CAP = encode.out_width(N)
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, np.uint8)
    outs = (out.ctypes.data, tot.ctypes.data, ok.ctypes.data)
    mid, depth4 = kind != "greedy", kind == "depth4"
    if not encode.bw_fits(D + N + 8, CAP, mid, depth4):  # K6b
        comb = np.zeros((R, D + N + 8), np.uint8)
        comb[:, :D] = win[:, :D]
        comb[:, D:D + N] = rows
        host_lib.lz4t_host_encode_wide(comb.ctypes.data, lens.ctypes.data,
                                       wl.ctypes.data, *outs, R, D + N + 8,
                                       D, CAP, int(mid))
    elif mid:  # K2c / K2d, shared memory: tables + [window | row | 8]
        n_tab = 2 if encode_mid.tables_spill(N, D, depth4) else 2 + 2 * depth4
        assert n_tab * 4 * 8192 + D + N + 8 <= decode.MAX_SMEM
        host_lib.lz4t_host_encode_mid(rows.ctypes.data, lens.ctypes.data,
                                      win.ctypes.data, wl.ctypes.data, *outs,
                                      R, N, D, 1, 1, CAP, int(depth4))
    elif D:  # K2b: 2^14 x 4 B + [window | row | 8]
        assert 65536 + D + N + 8 <= decode.MAX_SMEM
        host_lib.lz4t_host_encode_window(rows.ctypes.data, lens.ctypes.data,
                                         win.ctypes.data, wl.ctypes.data,
                                         *outs, R, N, D, 1, 1, CAP)
    else:  # K2a: 2 x 2^14 x 4 B + [row | 8]
        assert 131072 + N + 8 <= decode.MAX_SMEM
        host_lib.lz4t_host_encode(rows.ctypes.data, lens.ctypes.data, *outs,
                                  R, N, CAP)
    _same(_ref(kind, D, N), (out, tot, ok))
