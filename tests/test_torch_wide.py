"""Port K6b (packed-word block encode of wide rows) and the row-width
routes: plz4_tpu_torch.ops against the JAX package's Pallas wrappers in
interpret mode, at rows too wide for the byte-wide kernels.

The Pallas wrappers (encode_block_pallas, _dict, _mid, _mid_dict, _deep,
_deep_dict) send such rows to the packed-word kernel _encode_kernel: greedy,
or the depth-2 chain for every chain and deep request. The port's entry
points must route them the same way (to K6b) and give the same ok and total
per row and the same stream bytes [0, total) where ok holds. Two
implementations are held to Pallas: the plain version (what the port runs
on CPU tensors) and the CUDA kernel's row body built for the host with g++.
Rows include incompressible and near-incompressible ones, where K6b's emit
(no room guard) and the byte-wide kernels' differ. The widths at which the
routes switch are in test_torch_wide_edges.py.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import decode_pallas, encode_pallas
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import (_build, decode, encode, encode_deep,
                                encode_mid, encode_wide)

from conftest import make_compressible, make_incompressible

N = 131072  # 128 KiB rows: past every byte-wide route
D = 65536  # the batch layer's window width


def near_incompressible(n: int, seed: int, every: int, run: int) -> bytes:
    """Random bytes with a copied run of `run` bytes every `every` bytes:
    streams that end close to n, where the emit guards decide ok."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, n, dtype=np.uint8)
    for p in range(every, n - run, every):
        src = int(rng.integers(0, p - run))
        a[p:p + run] = a[src:src + run]
    return a.tobytes()


PAYLOADS = {
    "text": make_compressible(N, seed=31),
    "random": make_incompressible(N, seed=32),
    "near6": near_incompressible(N, 33, 256, 6),
    "near5": near_incompressible(N, 37, 256, 5),
    "near4": near_incompressible(N, 34, 256, 4),
    "zeros": b"\x00" * N,
    "short": make_compressible(5000, seed=35),
    "empty": b"",
}
NAMES = list(PAYLOADS)
WINDOW = make_compressible(D, seed=36)
# per row: the usable window bytes (full, partial, empty, full, ...)
WLENS = [D, 3000, 0, D, 517, D, D, 60000]


def _rows():
    rows = np.zeros((len(PAYLOADS), N), np.uint8)
    lens = np.array([len(p) for p in PAYLOADS.values()], np.int32)
    for i, p in enumerate(PAYLOADS.values()):
        rows[i, :len(p)] = np.frombuffer(p, np.uint8)
    wins = np.tile(np.frombuffer(WINDOW, np.uint8), (len(PAYLOADS), 1))
    return rows, lens, wins, np.array(WLENS, np.int32)


# kind -> (Pallas batch wrapper, the port's entry point, K6b mode)
KINDS = {
    "greedy": (encode_pallas.encode_batch_pallas, encode.encode_batch, False),
    "mid": (encode_pallas.encode_batch_pallas_mid,
            encode_mid.encode_batch_mid, True),
    "depth4": (functools.partial(encode_pallas.encode_batch_pallas_mid,
                                 depth4=True),
               functools.partial(encode_mid.encode_batch_mid, depth4=True),
               True),
    "deep": (functools.partial(encode_pallas.encode_batch_pallas_deep,
                               tries=8),
             functools.partial(encode_deep.encode_batch_deep, tries=8), True),
    "greedy-window": (encode_pallas.encode_batch_pallas_dict,
                      encode.encode_batch_window, False),
    "mid-window": (encode_pallas.encode_batch_pallas_mid_dict,
                   encode_mid.encode_batch_mid_window, True),
    "deep-window": (functools.partial(
        encode_pallas.encode_batch_pallas_deep_dict, tries=8),
        functools.partial(encode_deep.encode_batch_deep_window, tries=8),
        True),
}


@functools.lru_cache(maxsize=None)
def _ref(kind: str):
    """The Pallas batch result of one kind over all payloads."""
    rows, lens, wins, wl = _rows()
    args = [jnp.asarray(rows), jnp.asarray(lens)]
    if kind.endswith("window"):
        args += [jnp.asarray(wins), jnp.asarray(wl)]
    return tuple(np.asarray(x) for x in KINDS[kind][0](*args,
                                                       interpret=True))


@functools.lru_cache(maxsize=None)
def _port(kind: str):
    rows, lens, wins, wl = _rows()
    args = [torch.from_numpy(rows), torch.from_numpy(lens)]
    if kind.endswith("window"):
        args += [torch.from_numpy(wins), torch.from_numpy(wl)]
    return tuple(t.numpy() for t in KINDS[kind][1](*args))


def _assert_same(ref, got, i):
    (ro, rt, rk), (go, gt, gk) = ref, got
    assert bool(gk[i]) == bool(rk[i])
    assert int(gt[i]) == int(rt[i])
    if rk[i]:
        t = int(rt[i])
        assert go[i, :t].tobytes() == ro[i, :t].tobytes()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_pallas(kind, name):
    _assert_same(_ref(kind), _port(kind), NAMES.index(name))


@pytest.mark.parametrize("kind", list(KINDS))
def test_verdicts_and_streams(kind):
    """The rows' verdicts are the ones the emit contract predicts, and the
    ok streams decode to their rows."""
    out, tot, ok = _port(kind)
    verdict = dict(zip(NAMES, ok.tolist()))
    assert verdict["text"] and verdict["zeros"] and verdict["short"]
    assert not verdict["random"] and not verdict["empty"]
    assert not verdict["near4"]  # 4-byte matches save nothing: raw
    for name in ("near6", "near5", "near4"):  # streams that end near n
        assert abs(int(tot[NAMES.index(name)]) - N) < N // 100
    for i, (name, data) in enumerate(PAYLOADS.items()):
        if ok[i]:
            prefix = WINDOW[D - WLENS[i]:] if kind.endswith("window") \
                and WLENS[i] else b""
            got = native.decompress(out[i, :tot[i]].tobytes(), len(data),
                                    dict_=prefix or None)
            assert got == data, name


def test_requests_that_fall_back_share_one_stream():
    """At this width depth-4 and deep requests run K6b at depth 2, so they
    give the depth-2 streams; after a window the deep request keeps the
    whole window (the mid fallback's), not the deep kernel's 32 KiB cut."""
    for a, b in (("mid", "depth4"), ("mid", "deep"),
                 ("mid-window", "deep-window")):
        for x, y in zip(_port(a), _port(b)):
            assert np.array_equal(x, y)


def test_wide_rows_take_k6b():
    rows, lens, wins, wl = (torch.from_numpy(x) for x in _rows())
    assert not encode.bw_fits(N + 8, encode.out_width(N), mid=False)
    assert encode_deep.deep_route(N, None) is None
    assert encode_deep.deep_route(N, D) is None
    for mid in (False, True):
        got = encode_wide.encode_batch_wide(rows, lens, mid=mid)
        want = _port("mid" if mid else "greedy")
        for x, y in zip(got, want):
            assert np.array_equal(x.numpy(), y)
    got = encode_wide.encode_batch_wide(rows, lens, wins, wl)
    for x, y in zip(got, _port("greedy-window")):
        assert np.array_equal(x.numpy(), y)


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


@pytest.mark.parametrize("kind", ["greedy", "mid", "greedy-window",
                                  "mid-window"])
def test_kernel_row_body_matches_pallas(kind, host_lib):
    """The CUDA kernel's row body (lz4_encode_wide.cuh: the lanes' parse
    with K6b's emit, through the ring), built for the host, on the rows
    the kernel sees: [window | block | 8 zero bytes]."""
    rows, lens, wins, wl = _rows()
    Dk = D if kind.endswith("window") else 0
    R = rows.shape[0]
    DT = Dk + N + 8
    comb = np.zeros((R, DT), np.uint8)
    comb[:, :Dk] = wins[:, :Dk]
    comb[:, Dk:Dk + N] = rows
    CAP = encode.out_width(N)
    out = np.zeros((R, CAP), np.uint8)
    tot = np.zeros(R, np.int32)
    ok = np.zeros(R, np.uint8)
    host_lib.lz4t_host_encode_wide(comb.ctypes.data, lens.ctypes.data,
                                   wl.ctypes.data, out.ctypes.data,
                                   tot.ctypes.data, ok.ctypes.data, R, DT,
                                   Dk, CAP, int(kind.startswith("mid")))
    ref = _ref(kind)
    for i in range(R):
        _assert_same(ref, (out, tot, ok), i)


def test_encode_block_host_matches_pallas():
    """encode_block_host (level 1) against the JAX package's, at a wide and
    a narrow block, and its streams through decode_block_host."""
    for data in (PAYLOADS["text"], PAYLOADS["short"], PAYLOADS["random"],
                 b"", b"abc"):
        got = encode.encode_block_host(data, device="cpu")
        assert got == encode_pallas.encode_block_host(data, interpret=True)
        if got is not None:
            assert decode.decode_block_host(got, max(len(data), 4),
                                            device="cpu") == data
            assert decode_pallas.decode_block_host(
                got, max(len(data), 4), interpret=True) == data


@pytest.mark.parametrize("level", [3, 8, 12])
def test_encode_block_host_levels(level):
    data = PAYLOADS["text"]
    got = encode.encode_block_host(data, level=level, device="cpu")
    assert native.decompress(got, len(data)) == data
    assert len(got) < len(encode.encode_block_host(data, device="cpu"))


@pytest.mark.parametrize("shape,err", [
    ((1, (4 << 20) + 4), "row width"),
    ((1, N + 2), "row width"),
])
def test_encode_batch_wide_rejects_bad_rows(shape, err):
    with pytest.raises(ValueError, match=err):
        encode_wide.encode_batch_wide(
            torch.zeros(shape, dtype=torch.uint8),
            torch.zeros((shape[0],), dtype=torch.int32))
