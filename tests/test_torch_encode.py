"""Port K2 (greedy block encode): plz4_tpu_torch.ops.encode against the
JAX package's Pallas kernel in interpret mode.

Byte-exact contract: the same ok and total per row, and the same stream
bytes [0, total) where ok holds. Two implementations are held to the
Pallas kernel: the plain version (what the port runs on CPU tensors) and
the CUDA kernel's own row body built for the host with g++, which is also
held to the plain version; tests/test_torch_gpu.py holds the CUDA kernel
itself to the plain version on a GPU.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu import native as tpu_native
from plz4_tpu.ops import encode_pallas
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import _build, encode

from conftest import make_compressible, make_incompressible

N = 65536
SMALL = 256  # the small row width

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
    "random64k": make_incompressible(N, seed=3),  # incompressible, n == N
}
SMALL_IDS = [k for k, v in PAYLOADS.items() if len(v) <= SMALL]


def _rows(payloads, width):
    rows = np.zeros((len(payloads), width), dtype=np.uint8)
    lens = np.array([len(p) for p in payloads], dtype=np.int32)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    return rows, lens


@functools.lru_cache(maxsize=None)
def _full():
    """All payloads at row width N: rows, lens, the Pallas batch result
    and the plain version's."""
    rows, lens = _rows(list(PAYLOADS.values()), N)
    ref = tuple(np.asarray(x) for x in encode_pallas.encode_batch_pallas(
        jnp.asarray(rows), jnp.asarray(lens), interpret=True))
    got = tuple(t.numpy() for t in encode.encode_batch(
        torch.from_numpy(rows), torch.from_numpy(lens)))
    return rows, lens, ref, got


def _assert_same(ref, got, i):
    (ro, rt, rk), (go, gt, gk) = ref, got
    assert int(gt[i]) == int(rt[i])
    assert bool(gk[i]) == bool(rk[i])
    if rk[i]:
        t = int(rt[i])
        assert go[i, :t].tobytes() == ro[i, :t].tobytes()


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_plain_matches_pallas_batch(name):
    _, _, ref, got = _full()
    _assert_same(ref, got, list(PAYLOADS).index(name))


@pytest.mark.parametrize("name", SMALL_IDS)
def test_plain_matches_pallas_block_small_width(name):
    data = PAYLOADS[name]
    rows, lens = _rows([data], SMALL)
    ro, rt, rk = encode_pallas.encode_block_pallas(
        jnp.asarray(rows[0]), jnp.int32(lens[0]), interpret=True)
    ref = (np.asarray(ro)[None], np.asarray(rt)[None], np.asarray(rk)[None])
    out, tot, ok = encode.encode_batch(torch.from_numpy(rows),
                                       torch.from_numpy(lens))
    assert out.shape == (1, encode.out_width(SMALL)) == ref[0].shape
    _assert_same(ref, (out.numpy(), tot.numpy(), ok.numpy()), 0)


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_ok_streams_decode_natively(name):
    _, lens, _, (out, tot, ok) = _full()
    i = list(PAYLOADS).index(name)
    if not ok[i]:
        assert int(tot[i]) >= lens[i]  # stored raw by the batch layer
        return
    stream = out[i, : int(tot[i])].tobytes()
    assert native.decompress(stream, N) == PAYLOADS[name]
    assert tpu_native.decompress(stream, N) == PAYLOADS[name]


def test_incompressible_edge_rows():
    _, _, (_, rt, rk), (_, gt, gk) = _full()
    names = list(PAYLOADS)
    for name in ("empty", "one", "n12", "random64k"):
        assert not gk[names.index(name)]
    assert not rk[names.index("random64k")]
    assert gt[names.index("random64k")] == rt[names.index("random64k")]


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_kernel_row_body_matches_pallas(name, host_lib):
    """The CUDA kernel's row body (csrc/lz4_encode.cuh), built for the host
    with g++, against the Pallas kernel."""
    rows, lens, ref, _ = _full()
    lib = host_lib
    B = rows.shape[0]
    CAP = encode.out_width(N)
    out = np.zeros((B, CAP), np.uint8)
    tot = np.zeros(B, np.int32)
    ok = np.zeros(B, np.uint8)
    lib.lz4t_host_encode(rows.ctypes.data, lens.ctypes.data, out.ctypes.data,
                         tot.ctypes.data, ok.ctypes.data, B, N, CAP)
    _assert_same(ref, (out, tot, ok), list(PAYLOADS).index(name))


@pytest.mark.parametrize("shape,err", [
    ((2, (4 << 20) + 4), "row width"),  # over the 4 MiB LZ4 block
    ((2, 130), "row width"),
])
def test_encode_batch_rejects_bad_rows(shape, err):
    with pytest.raises(ValueError, match=err):
        encode.encode_batch(torch.zeros(shape, dtype=torch.uint8),
                            torch.zeros((shape[0],), dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _lanes():
    """K2a's lanes' body built with g++ on the cached batch."""
    rows, lens, _, _ = _full()
    B = rows.shape[0]
    CAP = encode.out_width(N)
    out = np.zeros((B, CAP), np.uint8)
    tot = np.zeros(B, np.int32)
    ok = np.zeros(B, np.uint8)
    _build.load_host().lz4t_host_encode(
        rows.ctypes.data, lens.ctypes.data, out.ctypes.data, tot.ctypes.data,
        ok.ctypes.data, B, N, CAP)
    return out, tot, ok


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_lanes_body_matches_plain(name, host_lib):
    """The lanes' body and the plain version give the same ok and total,
    and the same bytes wherever total < CAP."""
    (so, st, sk), (lo, lt, lk) = _full()[3], _lanes()
    i = list(PAYLOADS).index(name)
    assert (int(lt[i]), bool(lk[i])) == (int(st[i]), bool(sk[i]))
    if st[i] < so.shape[1]:
        assert lo[i, :st[i]].tobytes() == so[i, :st[i]].tobytes()


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_streams_match_pallas_wherever_total_fits(name, host_lib):
    """A row whose total is below the overflow sentinel CAP carries the
    Pallas kernel's bytes [0, total), ok or not (random64k does not shrink,
    yet has a stream). Held for the lanes' body and the plain version."""
    _, _, (ro, rt, _), got = _full()
    lanes = _lanes()
    i = list(PAYLOADS).index(name)
    if name == "random64k":
        assert rt[i] < ro.shape[1] and not got[2][i]
    for out, tot, _ in (lanes, got):
        assert int(tot[i]) == int(rt[i])
        if rt[i] < ro.shape[1]:
            assert out[i, :rt[i]].tobytes() == ro[i, :rt[i]].tobytes()
