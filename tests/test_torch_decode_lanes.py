"""K1's and K3's parse-and-copy row body (csrc/lz4_decode_ring.cuh): a
parse that hands sequences 32 at a time through a ring of 2,048 to copy
warps that write 224 output bytes per step.

Its host build (lz4t_host_decode, lz4t_host_decode_dict: the copy warps'
lanes as loops, the parse waiting on a full ring by copying the oldest
batch) and the plain versions are held to the JAX package's Pallas kernels
in interpret mode (decode_batch_pallas, decode_block_pallas_dict) on
corpus.decode_edge_batches: short offsets at and near a row's start, rows
that wrap the ring four to eight times, rows whose clen exceeds their
width, and streams that pass out_cap in a literal run or a match. The
contract: the same ok and n_out per row and the same bytes [0, n_out). The
host build is also held to the plain versions on seeded random and damaged
streams. tests/test_torch_gpu.py holds the kernels themselves to the plain
versions on a GPU.
"""

import functools
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import decode_pallas
from plz4_tpu_torch import corpus, errors, native
from plz4_tpu_torch.ops import _build, decode

from conftest import make_compressible

BATCHES = corpus.decode_edge_batches()
KERNELS = ["K1", "K3"]


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


@functools.partial(jax.jit, static_argnames=("out_cap",))
def _k3_pallas(rows, clens, dbuf, out_cap):
    dlen = jnp.int32(dbuf.shape[0])
    return jax.lax.map(
        lambda a: decode_pallas.decode_block_pallas_dict(
            a[0], a[1], dbuf, dlen, out_cap=out_cap, interpret=True),
        (rows, clens))


@functools.lru_cache(maxsize=None)
def _pallas(kernel: str, name: str):
    rows, clens, cap, win = BATCHES[name]
    if kernel == "K1":
        ref = decode_pallas.decode_batch_pallas(
            jnp.asarray(rows), jnp.asarray(clens), out_cap=cap,
            interpret=True)
    else:
        ref = _k3_pallas(jnp.asarray(rows), jnp.asarray(clens),
                         jnp.asarray(np.frombuffer(win, np.uint8)), cap)
    return tuple(np.asarray(x) for x in ref)


def _host(lib, kernel, rows, clens, cap, win):
    B, C = rows.shape
    out = np.zeros((B, cap), np.uint8)
    n = np.zeros(B, np.int32)
    ok = np.zeros(B, np.uint8)
    if kernel == "K1":
        lib.lz4t_host_decode(
            rows.ctypes.data, clens.ctypes.data, out.ctypes.data,
            n.ctypes.data, ok.ctypes.data, B, C, cap)
    else:
        d = np.frombuffer(win, np.uint8).copy()
        lib.lz4t_host_decode_dict(
            rows.ctypes.data, clens.ctypes.data, d.ctypes.data,
            out.ctypes.data, n.ctypes.data, ok.ctypes.data, B, C, len(d),
            len(d), cap)
    return out, n, ok


def _plain(kernel, rows, clens, cap, win):
    r, c = torch.from_numpy(rows), torch.from_numpy(clens)
    if kernel == "K1":
        got = decode.decode_batch(r, c, cap)
    else:
        d = torch.from_numpy(np.frombuffer(win, np.uint8).copy())
        got = decode.decode_batch_dict(r, c, d, len(win), cap)
    return tuple(t.numpy() for t in got)


_host_cache: dict = {}


def _port(impl, kernel, name, lib):
    key = (impl, kernel, name)
    if key not in _host_cache:
        args = BATCHES[name]
        _host_cache[key] = (_host(lib, kernel, *args) if impl == "g++"
                            else _plain(kernel, *args))
    return _host_cache[key]


def _assert_rows_same(ref, got, rows):
    (ro, rn, rk), (go, gn, gk) = ref, got
    for i in rows:
        assert int(gn[i]) == int(rn[i]), i
        assert bool(gk[i]) == bool(rk[i]), i
        n = int(rn[i])
        assert go[i, :n].tobytes() == ro[i, :n].tobytes(), i


@pytest.mark.parametrize("name", ["ring-wrap", "clen-over-C", "out-cap"])
@pytest.mark.parametrize("impl", ["plain", "g++"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_edge_rows_match_pallas(kernel, impl, name, request):
    lib = request.getfixturevalue("host_lib") if impl == "g++" else None
    got = _port(impl, kernel, name, lib)
    _assert_rows_same(_pallas(kernel, name), got, range(len(got[1])))


def _short_rows(off: int) -> list[int]:
    per_off = len(corpus.SHORT_OPS) * len(corpus.SHORT_MLS)
    k = corpus.SHORT_OFFS.index(off)
    return list(range(k * per_off, (k + 1) * per_off))


@pytest.mark.parametrize("off", corpus.SHORT_OFFS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_short_offsets_match_pallas(kernel, off, host_lib):
    """Offsets 1-64 and match lengths 4-130 starting at output positions
    0-40: steps that repeat a period shorter than a step, read the step
    before, and (K3) read the window; K1 refuses an offset past the
    output."""
    ref = _pallas(kernel, "short-offsets")
    got = _port("g++", kernel, "short-offsets", host_lib)
    rows = _short_rows(off)
    _assert_rows_same(ref, got, rows)
    # the bytes by the LZ4 rule
    win = BATCHES["short-offsets"][3]
    go, gn, gk = got
    i = iter(rows)
    for op in corpus.SHORT_OPS:
        for ml in corpus.SHORT_MLS:
            r = next(i)
            if kernel == "K1" and off > op:
                assert not gk[r] and int(gn[r]) == op
                continue
            o = bytearray(win if kernel == "K3" else b"")
            o += go[r, :op].tobytes()
            for _ in range(ml):
                o.append(o[-off])
            assert gk[r] and int(gn[r]) == op + ml + 1
            assert go[r, :op + ml].tobytes() == bytes(o[len(o) - op - ml:])


def _n_sequences(s: bytes) -> int:
    """Sequences of a valid LZ4 block stream that copy something."""
    ip = n = 0
    while ip < len(s):
        t = s[ip]
        ip += 1
        lit = t >> 4
        if lit == 15:
            while True:
                b = s[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        ip += lit
        if ip >= len(s):
            return n + (lit > 0)
        ip += 2
        if t & 15 == 15:
            while s[ip] == 255:
                ip += 1
            ip += 1
        n += 1
    return n


def test_ring_wrap_rows_wrap_the_ring():
    rows, clens, cap, _ = BATCHES["ring-wrap"]
    counts = [_n_sequences(rows[i, :clens[i]].tobytes())
              for i in range(5)]
    assert min(counts) >= 4 * 2048 and max(counts) >= 7 * 2048
    assert counts[4] == 8192  # exactly four rounds, then an empty batch
    ref = _pallas("K1", "ring-wrap")
    assert ref[2][[0, 1, 2, 4]].all() and not ref[2][3]  # K1: no window
    assert _pallas("K3", "ring-wrap")[2][:5].all()


def _random_streams(seed: int, n: int = 25) -> list[bytes]:
    """Random bytes, damaged native streams, and random sequences with
    random lengths and offsets (some past the output, some 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = k % 5
        if kind == 0:
            out.append(rng.integers(0, 256, int(rng.integers(1, 600)),
                                    dtype=np.uint8).tobytes())
        elif kind in (1, 2):
            s = bytearray(native.compress(
                make_compressible(int(rng.integers(64, 3000)),
                                  seed=int(rng.integers(1 << 30))), level=1))
            if kind == 1:
                for _ in range(int(rng.integers(1, 4))):
                    s[int(rng.integers(len(s)))] = int(rng.integers(256))
            else:
                s = s[:int(rng.integers(1, len(s) + 1))]
            out.append(bytes(s))
        else:
            s = bytearray()
            op = 0
            for _ in range(int(rng.integers(1, 400))):
                lits = rng.integers(0, 256, int(rng.integers(0, 20)),
                                    dtype=np.uint8).tobytes()
                ml = int(rng.integers(4, 40))
                bad = rng.random() < 0.02
                off = int(rng.integers(0, 70)) if bad else int(
                    rng.integers(1, min(op + len(lits), 300) + 1)) if (
                    op + len(lits)) else 1
                s += corpus.lz4_sequence(lits, off, ml)
                op += len(lits) + ml
            out.append(bytes(s + corpus.lz4_sequence(b"q" * (kind - 2))))
    return out


@pytest.mark.parametrize("width", [(1024, 1024), (256, 2048), (4096, 512)])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kernel", KERNELS)
def test_ring_body_matches_plain(kernel, seed, width, host_lib):
    """25 seeded streams per case, 300 per kernel, at widths where streams
    run past C (clipped or zero reads) and past out_cap."""
    C, cap = width
    streams = _random_streams(1000 * seed + C + cap)
    rows = np.zeros((len(streams), C), np.uint8)
    clens = np.array([len(s) for s in streams], np.int32)
    for i, s in enumerate(streams):
        s = s[:C]
        rows[i, :len(s)] = np.frombuffer(s, np.uint8)
    win = np.random.default_rng(seed).integers(
        0, 256, 512, dtype=np.uint8).tobytes()
    got = _host(host_lib, kernel, rows, clens, cap, win)
    ref = _plain(kernel, rows, clens, cap, win)
    _assert_rows_same(ref, got, range(len(streams)))


def test_ring_smem_matches_the_header():
    """decode.RING_SMEM and ROW_PAD are csrc/lz4_decode_ring.cuh's."""
    src = open(f"{_build.CSRC}/lz4_decode_ring.cuh").read()
    defs = dict(re.findall(r"#define (LZ4T_RING_\w+) (\d+)", src))
    smem = re.search(r"#define LZ4T_RING_SMEM (.*)", src).group(1)
    for k, v in defs.items():
        smem = smem.replace(k, v)
    assert eval(smem) == decode.RING_SMEM
    assert int(defs["LZ4T_RING_PAD"]) == decode.ROW_PAD


def test_wrappers_take_the_widths_their_callers_pass():
    """The ring does not cost a shape that the batch layer or
    decode_block_host passes: K1's widest batch rows (96 KiB blocks, C =
    out_cap + 16), K3's 64 KiB rows with a 64 KiB window, and
    decode_block_host up to the longest stream that can decode ok (a longer
    one raises ErrDecompress, as K1's verdict would)."""
    cap = decode.BW_MAX_OUT
    out, n, ok = decode.decode_batch(
        torch.zeros((1, cap + decode.ROW_SLACK), dtype=torch.uint8),
        torch.ones((1,), dtype=torch.int32), cap)
    assert bool(ok[0]) and int(n[0]) == 0
    out, n, ok = decode.decode_batch_dict(
        torch.zeros((1, decode.MAX_OUT + decode.ROW_SLACK),
                    dtype=torch.uint8),
        torch.ones((1,), dtype=torch.int32),
        torch.zeros((decode.MAX_WINDOW,), dtype=torch.uint8),
        decode.MAX_WINDOW, decode.MAX_OUT)
    assert bool(ok[0])
    data = bytes(range(256)) * (cap // 256)
    longest = corpus.lz4_sequence(data)  # literals only, the most bytes
    assert len(longest) <= decode.max_stream(cap)
    assert decode.decode_block_host(longest, cap, device="cpu") == data
    pad = longest + bytes(decode.max_stream(cap) - len(longest))
    for s in (pad, pad + b"\x00"):  # trailing bytes: refused either way
        with pytest.raises(type(errors.ErrDecompress)) as e:
            decode.decode_block_host(s, cap, device="cpu")
        assert e.value is errors.ErrDecompress
