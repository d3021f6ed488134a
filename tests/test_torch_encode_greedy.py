"""Port K2a and K2b (greedy block encode): the rows aimed at the
warp-cooperative parse's steps (corpus.greedy_edge_rows), against the JAX
package's Pallas kernel in interpret mode.

Byte-exact contract, as in test_torch_encode.py: the same ok and total per
row, and the same stream bytes [0, total) where ok holds; and, since the
large-block path stitches the stream of a chunk that did not shrink, the
same bytes wherever total < CAP. The plain version and the CUDA kernels'
lanes' body built with g++ are each held to the Pallas kernel, and the
lanes' body to the plain version; tests/test_torch_gpu.py holds the CUDA
kernels to the plain version.
"""

import functools
import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import encode_pallas
from plz4_tpu_torch import corpus, native
from plz4_tpu_torch.ops import _build, encode

N = D = 65536
EDGE, FAR = corpus.greedy_edge_rows()
EDGE_NAMES, FAR_NAMES = list(EDGE), list(FAR)


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


@functools.lru_cache(maxsize=None)
def _edge():
    """The plain edge rows at width N: operands, Pallas result, plain's."""
    rows, lens = _rows(list(EDGE.values()), N)
    ref = _np(encode_pallas.encode_batch_pallas(
        jnp.asarray(rows), jnp.asarray(lens), interpret=True))
    got = _np(encode.encode_batch(*_t(rows, lens)))
    return (rows, lens), ref, got


@functools.lru_cache(maxsize=None)
def _far(wstride: int):
    """The window rows (64 KiB windows, copies up to 65,536 bytes back)."""
    rows, lens = _rows([b for b, _, _ in FAR.values()], N)
    wins = np.stack([np.frombuffer(w, np.uint8) for _, w, _ in FAR.values()])
    wlens = np.array([u for _, _, u in FAR.values()], np.int32)
    args = (rows, lens, wins, wlens)
    ref = _np(encode_pallas.encode_batch_pallas_dict(
        *(jnp.asarray(a) for a in args), interpret=True, wstride=wstride))
    got = _np(encode.encode_batch_window(*_t(*args), wstride=wstride))
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


def _host_encode(lib, rows, lens, wins=None, wlens=None, wstride=1,
                 chunks=1):
    """The CUDA kernels' row body (csrc/lz4_encode.cuh) built with g++: K2a's
    entry for a plain batch (wins None), K2b's otherwise."""
    R, width = rows.shape
    CAP = encode.out_width(width)
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, np.uint8)
    res = (out.ctypes.data, tot.ctypes.data, ok.ctypes.data)
    win = (0, 0, 0) if wins is None else (
        wins.ctypes.data, wlens.ctypes.data, wins.shape[1])
    if wins is None:
        lib.lz4t_host_encode(rows.ctypes.data, lens.ctypes.data, *res, R,
                             width, CAP)
    else:
        lib.lz4t_host_encode_window(rows.ctypes.data, lens.ctypes.data,
                                    win[0], win[1], *res, R, width, win[2],
                                    chunks, wstride, CAP)
    return out, tot, ok


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_rows_plain_matches_pallas(name):
    _, ref, got = _edge()
    _assert_same(ref, got, EDGE_NAMES.index(name))


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_rows_kernel_row_body_matches_pallas(name, host_lib):
    (rows, lens), ref, _ = _edge()
    _assert_same(ref, _host_encode(host_lib, rows, lens),
                 EDGE_NAMES.index(name))


@pytest.mark.parametrize("wstride", [1, 2])
@pytest.mark.parametrize("name", FAR_NAMES)
def test_far_rows_plain_matches_pallas(name, wstride):
    _, ref, got = _far(wstride)
    _assert_same(ref, got, FAR_NAMES.index(name))


@pytest.mark.parametrize("wstride", [1, 2])
@pytest.mark.parametrize("name", FAR_NAMES)
def test_far_rows_kernel_row_body_matches_pallas(name, wstride, host_lib):
    args, ref, _ = _far(wstride)
    _assert_same(ref, _host_encode(host_lib, *args, wstride=wstride),
                 FAR_NAMES.index(name))


@pytest.mark.parametrize("name", EDGE_NAMES)
def test_edge_streams_decode_natively(name):
    (_, lens), _, (out, tot, ok) = _edge()
    i = EDGE_NAMES.index(name)
    if not ok[i]:
        assert int(tot[i]) >= lens[i]  # stored raw by the batch layer
        return
    assert native.decompress(out[i, :int(tot[i])].tobytes(), N) == EDGE[name]


def _cached_batches():
    """name -> (operands as _host_encode takes them, Pallas outputs, plain
    version's outputs) of every batch this module holds to Pallas."""
    (rows, lens), ref, got = _edge()
    out = {"edge": ((rows, lens), {}, ref, got)}
    for ws in (1, 2):
        args, ref, got = _far(ws)
        out[f"far-wstride{ws}"] = (args, dict(wstride=ws), ref, got)
    return out


BATCHES = ["edge", "far-wstride1", "far-wstride2"]


@pytest.mark.parametrize("batch", BATCHES)
def test_lanes_body_matches_plain(batch, host_lib):
    """The lanes' body and the plain version give the same ok and total on
    every row, and the same bytes wherever total < CAP."""
    args, kw, _, plain = _cached_batches()[batch]
    lanes = _host_encode(host_lib, *args, **kw)
    CAP = lanes[0].shape[1]
    assert lanes[1].tolist() == plain[1].tolist()
    assert lanes[2].tolist() == plain[2].tolist()
    for i, t in enumerate(plain[1].tolist()):
        if t < CAP:
            assert lanes[0][i, :t].tobytes() == plain[0][i, :t].tobytes()


@pytest.mark.parametrize("batch", BATCHES)
def test_streams_match_pallas_wherever_total_fits(batch, host_lib):
    """Every row whose total is below the overflow sentinel CAP carries the
    Pallas kernel's bytes [0, total), ok or not. Held for the lanes' body
    and the plain version."""
    args, kw, ref, got = _cached_batches()[batch]
    host = _host_encode(host_lib, *args, **kw)
    CAP = ref[0].shape[1]
    for res in (host, got):
        assert res[1].tolist() == ref[1].tolist()
        for i, t in enumerate(ref[1].tolist()):
            if t < CAP:
                assert res[0][i, :t].tobytes() == ref[0][i, :t].tobytes()


def _scalar_tries() -> int:
    """LZ4T_SCALAR_TRIES of csrc/lz4_encode.cuh: the attempts of a search
    that the lanes' body runs as scalar code before its first step."""
    src = os.path.join(os.path.dirname(encode.__file__), os.pardir, "csrc",
                       "lz4_encode.cuh")
    with open(src) as f:
        return int(re.search(r"#define LZ4T_SCALAR_TRIES (\d+)",
                             f.read()).group(1))


def _search_stats(row: bytes) -> tuple[list[int], int, int]:
    """Replay the greedy parse of one plain row (encode.encode_row_plain's
    decisions): the attempt count of every search's match, and how many
    attempts in a lanes' step took their candidate from a lower lane of the
    same step, valid and not."""
    S = _scalar_tries()
    c = row + bytes(8)
    words, hashes = encode._words(c)
    words, hashes = words.tolist(), hashes.tolist()
    tab = [0] * (1 << encode.HASH_LOG)
    end = len(row)
    mflimit, matchlimit = end - 12, end - 5
    ip = anchor = 0
    hits, peer_valid, peer_invalid = [], 0, 0
    while ip <= mflimit:
        sip, cnt, found, step_start = ip, 0, False, None
        while sip <= mflimit:
            if cnt >= S and (cnt - S) % 32 == 0:
                step_start = sip
            cd = tab[hashes[sip]] - 1
            tab[hashes[sip]] = sip + 1
            found = (cd >= 0 and sip - cd <= encode.MAX_DISTANCE
                     and words[cd] == words[sip])
            if step_start is not None and cd >= step_start:
                peer_valid += found
                peer_invalid += not found
            if found:
                break
            sip += 1 + (cnt >> encode.SKIP_STRENGTH)
            cnt += 1
        if not found:
            break
        hits.append(cnt)
        mip, mpos = sip, cd
        while mip > anchor and mpos > 0 and c[mip - 1] == c[mpos - 1]:
            mip, mpos = mip - 1, mpos - 1
        nip = sip + 4 + encode._common(c, sip + 4, cd + 4, matchlimit)
        tab[hashes[nip - 2]] = nip - 1
        ip = anchor = nip
    return hits, peer_valid, peer_invalid


def test_edge_rows_reach_every_lane_and_stride():
    """The edge rows end searches on every lane of a step, at skip strides 1,
    2, 3 and over 30, and give lanes whose candidate is a lower lane of the
    same step, holding the same word and another one."""
    S = _scalar_tries()
    lanes, strides, peers = set(), set(), [0, 0]
    for name, row in EDGE.items():
        hits, pv, pi = _search_stats(row)
        lanes |= {(k - S) % 32 for k in hits if k >= S}
        strides |= {1 + (k >> encode.SKIP_STRENGTH) for k in hits}
        peers[0] += pv
        peers[1] += pi
    assert set(range(32)) <= lanes
    assert {1, 2, 3} <= strides and max(strides) > 30
    assert peers[0] > 0 and peers[1] > 0


def test_skip_offset_is_the_schedule():
    """corpus._skip_offset, the closed form's Python twin in the rows'
    construction, sums the skip steps."""
    for cnt in (0, 1, 63, 64, 65, 127, 128, 129, 2100):
        a, b = cnt >> 6, cnt & 63
        assert corpus._skip_offset(cnt) == cnt + 32 * a * (a - 1) + a * b
