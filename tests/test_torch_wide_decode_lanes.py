"""K6a's parse-and-copy row body (csrc/lz4_decode_ring.cuh with the row and
the output in device memory): a parse thread (lz4t_parse_strict with
kCountBad over lz4t_dev_row, whose reads at or past C return 0) hands
sequences 32 at a time through a ring of 2,048 to copy warps that write
224 output bytes per step straight into the output row.

Its host build (lz4t_host_decode_wide: the copy warps' lanes as loops, the
parse waiting on a full ring by copying the oldest batch, read slots
poisoned) and the plain version (decode_batch_wide_plain) are held to the
JAX package's packed-word Pallas kernel _decode_kernel in interpret mode
(decode_batch_pallas at out_cap over 96 KiB) on
corpus.wide_decode_edge_rows at 128 KiB: short offsets, ring wraps, clen
past the row, streams that pass out_cap, bad literal runs whose n_out
passes it, and rows that run to C beside rows of nonzero bytes. At 4 MiB,
and on seeded random and damaged streams, the host build is held to the
plain version. The contract: the same ok and n_out per row, and the same
bytes [0, n_out) where ok holds (a bad literal run counts in n_out
uncopied). tests/test_torch_gpu.py holds the kernel itself to the plain
version on a GPU.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plz4_tpu.ops import decode_pallas
from plz4_tpu_torch import corpus, native
from plz4_tpu_torch.ops import _build, decode

from conftest import make_compressible

WIDE_NAMES = ["short-offsets", "ring-wrap", "clen-over-C", "out-cap",
              "bad-literal", "neighbours"]
BIG_NAMES = ["ring-wrap-4m", "clen-over-C-4m", "out-cap-4m", "big-4m"]


@functools.lru_cache(maxsize=None)
def _batches() -> dict:
    return corpus.wide_decode_edge_rows()


@pytest.fixture
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    return _build.load_host()


def _host(lib, rows, clens, cap):
    B, C = rows.shape
    out = np.zeros((B, cap), np.uint8)
    n = np.zeros(B, np.int32)
    ok = np.zeros(B, np.uint8)
    lib.lz4t_host_decode_wide(rows.ctypes.data, clens.ctypes.data,
                              out.ctypes.data, n.ctypes.data, ok.ctypes.data,
                              B, C, cap)
    return out, n, ok.astype(bool)


@functools.lru_cache(maxsize=None)
def _pallas(name: str):
    rows, clens, cap = _batches()[name]
    return tuple(np.asarray(x) for x in decode_pallas.decode_batch_pallas(
        jnp.asarray(rows), jnp.asarray(clens), out_cap=cap, interpret=True))


def _plain(rows, clens, cap):
    return tuple(t.numpy() for t in decode.decode_batch(
        torch.from_numpy(rows), torch.from_numpy(clens), cap))


_port_cache: dict = {}


def _port(impl: str, name: str, lib=None):
    key = (impl, name)
    if key not in _port_cache:
        rows, clens, cap = _batches()[name]
        _port_cache[key] = (_plain(rows, clens, cap) if impl == "plain"
                            else _host(lib, rows, clens, cap))
    return _port_cache[key]


def _assert_rows_same(ref, got, rows):
    (ro, rn, rk), (go, gn, gk) = ref, got
    for i in rows:
        assert int(gn[i]) == int(rn[i]), i
        assert bool(gk[i]) == bool(rk[i]), i
        if rk[i]:
            n = int(rn[i])
            assert go[i, :n].tobytes() == ro[i, :n].tobytes(), i


def test_batches_are_at_k6a_widths():
    b = _batches()
    assert sorted(b) == sorted(WIDE_NAMES + BIG_NAMES)
    for name in WIDE_NAMES:
        assert b[name][2] == corpus.WIDE_CAP > decode.BW_MAX_OUT
    for name in BIG_NAMES:
        assert b[name][2] == corpus.BIG_CAP == decode.MAX_WIDE_OUT


@pytest.mark.parametrize("name", WIDE_NAMES[1:])
@pytest.mark.parametrize("impl", ["plain", "g++"])
def test_edge_rows_match_pallas(impl, name, request):
    lib = request.getfixturevalue("host_lib") if impl == "g++" else None
    got = _port(impl, name, lib)
    _assert_rows_same(_pallas(name), got, range(len(got[1])))


@pytest.mark.parametrize("off", corpus.SHORT_OFFS)
@pytest.mark.parametrize("impl", ["plain", "g++"])
def test_short_offsets_match_pallas(impl, off, request):
    """Offsets 1-64 and match lengths 4-130 after 0-40 literals, chained:
    steps that repeat a period shorter than a step and read the step
    before. The first row of each offset starts after `off` literals; the
    second starts with a match at output position 0-40, refused where its
    offset passes it."""
    lib = request.getfixturevalue("host_lib") if impl == "g++" else None
    got = _port(impl, "short-offsets", lib)
    k = corpus.SHORT_OFFS.index(off)
    _assert_rows_same(_pallas("short-offsets"), got, [2 * k, 2 * k + 1])
    _, n, ok = got
    assert ok[2 * k]
    op = corpus.SHORT_OPS[k % len(corpus.SHORT_OPS)]
    if off > op:
        assert not ok[2 * k + 1] and int(n[2 * k + 1]) == op
    else:
        assert ok[2 * k + 1]


@pytest.mark.parametrize("name", BIG_NAMES)
def test_4mib_rows_match_plain(name, host_lib):
    _assert_rows_same(_port("plain", name), _port("g++", name, host_lib),
                      range(len(_batches()[name][1])))


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


def test_4mib_row_wraps_the_ring_and_sentinels_hold(host_lib):
    """big-4m's row has over 400,000 sequences (the ring of 2,048 wraps
    over 200 times) and decodes to its bytes; the sentinel rows after a
    bad literal run and a junk run decode to the same bytes; the bad
    literal run reports n_out past 4 MiB."""
    rows, clens, cap = _batches()["big-4m"]
    big = rows[0, :clens[0]].tobytes()
    assert _n_sequences(big) > 400_000
    out, n, ok = _port("g++", "big-4m", host_lib)
    want = native.decompress(big, cap)
    assert ok[[0, 2, 4, 7]].all() and not ok[[1, 3, 6]].any()
    for i in (0, 2, 4, 7):
        assert out[i, :n[i]].tobytes() == want
    assert int(n[1]) == 9 + cap + 4000
    assert int(n[6]) == 25 + 541


def test_bad_literal_verdicts(host_lib):
    """Bad literal runs count in n_out uncopied, past out_cap and past
    clen, and a junk run is read from a token at ip >= clen (its length
    bytes past clen, or 255s that run to C and end on the zeros past it);
    the sentinel row after each decodes to its full bytes."""
    rows, clens, cap = _batches()["bad-literal"]
    out, n, ok = _port("g++", "bad-literal", host_lib)
    C = rows.shape[1]
    assert not ok[0::2].any() and ok[1::2].all()
    assert n.tolist()[0::2] == [9 + cap + 4000, 36 + 400, 400, 25 + 541,
                                25 + 15 + 255 * (C - 6)]
    sent = out[1, :n[1]].tobytes()
    assert len(sent) > cap - 64
    for i in range(3, len(n), 2):
        assert out[i, :n[i]].tobytes() == sent


def test_neighbours_read_zeros_past_c(host_lib):
    """Rows whose streams run to C read zeros there, not the next row's
    nonzero bytes: a literal run that ends on C, match and literal length
    runs of 255s that reach C, a row whose clen passes C."""
    rows, clens, cap = _batches()["neighbours"]
    out, n, ok = _port("g++", "neighbours", host_lib)
    C = rows.shape[1]
    assert ok[0] and int(n[0]) == 254
    assert out[0, :254].tobytes() == rows[0, 2:].tobytes()
    m = 16 + 15 + 255 * (C - 20) + 4
    assert not ok[2] and int(n[2]) == m and not ok[4] and int(n[4]) == m
    assert ok[6] and int(n[6]) == 300
    assert out[6, :300].tobytes() == rows[6, 3:].tobytes() + bytes(47)
    # the parse reads the 4 or 5 zeros after the literals: a zero offset
    assert not ok[8] and int(n[8]) == 249
    assert not ok[10] and int(n[10]) == 250
    # the match length byte at C reads 0: 15 + 0 + 4 bytes at offset 263
    # (past the output: refused)
    assert not ok[12] and int(n[12]) == 252
    # zero literals to C - 4 (then a zero offset) and past C (clen 303)
    assert not ok[14] and int(n[14]) == 250
    assert ok[16] and int(n[16]) == 300
    assert out[16, :300].tobytes() == rows[16, 3:243].tobytes() + bytes(60)
    # match length runs of 255s to clen = C - 8 and C - 5
    assert not ok[18] and int(n[18]) == 1 + 15 + 255 * (C - 12) + 4
    assert not ok[20] and int(n[20]) == 1 + 15 + 255 * (C - 9) + 4
    for i in (22, 24):
        assert not ok[i] and int(n[i]) == 15 + 255 * (C - 1)


def _tail_fits(rows, clens):
    """csrc/lz4_decode_ring.cuh's lz4t_tail_fits for each row: it ends in 8
    zero bytes that its stream does not reach."""
    C = rows.shape[1]
    return (~rows[:, -8:].any(axis=1)) & (clens <= C - 8) & (C >= 8)


def test_edge_rows_take_both_readers():
    """K6a reads a row that ends in 8 zero bytes its stream does not reach
    without a guard (lz4t_tail_row) and any other row with a guard on each
    read (lz4t_dev_row): the edge rows take both, the rows beside nonzero
    rows and the bad literal rows too."""
    tail = {name: _tail_fits(rows, clens)
            for name, (rows, clens, _) in _batches().items()}
    for name in ("neighbours", "bad-literal"):
        assert tail[name].any() and not tail[name].all(), name
    assert sum(int(t.sum()) for t in tail.values()) > 150
    assert sum(int((~t).sum()) for t in tail.values()) > 20


def _random_streams(seed: int, n: int = 25) -> list[bytes]:
    """Random bytes, damaged native streams, and random sequences with
    random lengths and offsets, some bad (offsets past the output or 0,
    literal runs past the output cap or past the stream)."""
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
            lit_past = rng.random() < 0.4  # ends in a literal run past it
            for _ in range(int(rng.integers(1, 6 if lit_past else 400))):
                lits = rng.integers(0, 256, int(rng.integers(0, 20)),
                                    dtype=np.uint8).tobytes()
                ml = int(rng.integers(4, 40))
                bad = rng.random() < 0.02
                off = int(rng.integers(0, 70)) if bad else int(
                    rng.integers(1, min(op + len(lits), 300) + 1)) if (
                    op + len(lits)) else 1
                s += corpus.lz4_sequence(lits, off, ml)
                op += len(lits) + ml
            if lit_past:
                s += b"\xf0" + corpus._varint(
                    int(rng.integers(100_000, 600_000))) + b"q" * kind
            else:
                s += corpus.lz4_sequence(b"q" * (kind - 2))
            out.append(bytes(s))
    return out


@pytest.mark.parametrize("width", [(1024, 131072), (256, 131072),
                                   (4096, 262144)])
@pytest.mark.parametrize("seed", range(4))
def test_ring_body_matches_plain(seed, width, host_lib):
    """25 seeded streams per case, 300 in all, at widths where streams run
    past C (zero reads) and literal runs past out_cap or clen."""
    C, cap = width
    streams = _random_streams(1000 * seed + C)
    rows = np.zeros((len(streams), C), np.uint8)
    clens = np.array([len(s) for s in streams], np.int32)
    for i, s in enumerate(streams):
        s = s[:C]
        rows[i, :len(s)] = np.frombuffer(s, np.uint8)
    got = _host(host_lib, rows, clens, cap)
    ref = _plain(rows, clens, cap)
    _assert_rows_same(ref, got, range(len(streams)))
    # a literal run past out_cap, where C holds its length bytes
    assert (ref[1] > cap).any() or C < cap // 255
