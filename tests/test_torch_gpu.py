"""plz4_tpu_torch's CUDA kernels against their plain versions, on a GPU.

Every test here carries the `gpu` marker and skips where torch.cuda is
unavailable. The file imports neither JAX nor the JAX package (the
Pallas comparisons live in test_torch_encode.py, test_torch_decode.py,
test_torch_encode_window.py and test_torch_decode_window.py), so it runs
on a machine without JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

import plz4_tpu_torch
from plz4_tpu_torch import corpus, native
from plz4_tpu_torch.ops import (decode, encode, encode_deep, encode_mid,
                                encode_wide, xxh32)
from plz4_tpu_torch.parallel import large

N = 65536
C = N + decode.ROW_SLACK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _payloads() -> list[bytes]:
    rng = np.random.default_rng(17)
    text = corpus.silesia_like(8 * N)
    return [b"", b"a", b"abcabcabcabc", b"abcabcabcabca",
            b"hello world " * 12, b"\x00" * N,
            (rng.integers(0, 256, 7, dtype=np.uint8).tobytes()
             * (N // 7 + 1))[:N],
            rng.integers(0, 256, N, dtype=np.uint8).tobytes(),
            text[:4096]] + [text[i:i + N] for i in range(0, 8 * N, N)]


def _rows(payloads, width):
    rows = np.zeros((len(payloads), width), np.uint8)
    lens = np.array([len(p) for p in payloads], np.int32)
    for i, p in enumerate(payloads):
        rows[i, : len(p)] = np.frombuffer(p, np.uint8)
    return torch.from_numpy(rows), torch.from_numpy(lens)


@pytest.mark.gpu
def test_encode_kernel_matches_plain(cuda):
    rows, lens = _rows(_payloads(), N)
    before = encode.launches
    out, tot, ok = (t.cpu() for t in encode.encode_batch(rows.to(cuda),
                                                         lens.to(cuda)))
    assert encode.launches == before + 1
    p_out, p_tot, p_ok = encode.encode_batch_plain(rows, lens)
    assert torch.equal(tot, p_tot) and torch.equal(ok, p_ok)
    for i in range(rows.shape[0]):
        if p_ok[i]:
            t = int(p_tot[i])
            assert torch.equal(out[i, :t], p_out[i, :t])


@pytest.mark.gpu
def test_decode_kernel_matches_plain(cuda):
    streams = [native.compress(p, level=1) for p in _payloads()]
    streams = [s for s in streams if len(s) <= N]
    rng = np.random.default_rng(23)
    for k in range(16):
        s = bytearray(streams[-1 - k % 8])
        if k % 2:
            s = s[: int(rng.integers(1, len(s)))]
        else:
            s[int(rng.integers(len(s)))] ^= 0xFF
        streams.append(bytes(s))
    streams += [bytes([0x04, 50, 0]), bytes([0x04, 0, 0]), b"\xff" * 40]
    rows, clens = _rows(streams, C)
    before = decode.launches
    out, n, ok = (t.cpu() for t in decode.decode_batch(rows.to(cuda),
                                                       clens.to(cuda), N))
    assert decode.launches == before + 1
    p_out, p_n, p_ok = decode.decode_batch_plain(rows, clens, N)
    assert torch.equal(n, p_n) and torch.equal(ok, p_ok)
    for i in range(rows.shape[0]):
        assert torch.equal(out[i, : int(p_n[i])], p_out[i, : int(p_n[i])])


@pytest.mark.gpu
def test_device_frame_matches_plain_frame(cuda):
    data = corpus.silesia_like(6 * N + 1234)
    kw = dict(backend="device", level=1,
              block_size_idx=plz4_tpu_torch.BLOCK_IDX_64KB, device_batch=4)
    frame = plz4_tpu_torch.compress(data, device="cuda", **kw)
    assert frame == plz4_tpu_torch.compress(data, device="cpu", **kw)
    assert plz4_tpu_torch.decompress(frame, backend="device") == data
    assert plz4_tpu_torch.decompress(frame, backend="native") == data


def _same_rows(kern, plain, counts):
    """Exact agreement on the per-row counts and flags and on each row's
    bytes [0, count)."""
    ko, kc, kk = (t.cpu() for t in kern)
    po, pc, pk = plain
    assert torch.equal(kc, pc) and torch.equal(kk, pk)
    ko, po = ko.reshape(len(counts), -1), po.reshape(len(counts), -1)
    for i, c in enumerate(counts.tolist()):
        assert torch.equal(ko[i, :c], po[i, :c]), i


def _window_batches():
    """(operands, keywords) of the window encode kernels: two large blocks
    as grouped chunk rows (a 4-chunk block after a 1000-byte dictionary
    and a 2.5-chunk block with none; windows read in place, wstride 2),
    and rows with one window each (full, partial, empty; wstride 1)."""
    text = corpus.silesia_like(6 * N, seed=5)
    blocks = [text[:4 * N], text[4 * N:6 * N + N // 2]]
    a = torch.zeros((8, N), dtype=torch.uint8)
    ln = torch.zeros((8,), dtype=torch.int32)
    wl = torch.zeros((8,), dtype=torch.int32)
    da = torch.zeros((2, N), dtype=torch.uint8)
    large.stage_chunks(blocks, [text[-1000:], None], a.numpy().reshape(2, 4, N),
                       ln.numpy().reshape(2, 4), wl.numpy().reshape(2, 4),
                       da.numpy())
    rows, lens = _rows([text[:N], text[N:N + 5000], b"hello" * 40], N)
    wins = torch.from_numpy(np.frombuffer(text[2 * N:5 * N], np.uint8)
                            .reshape(3, N).copy())
    wlens = torch.tensor([N, 777, 0], dtype=torch.int32)
    return [((a, ln, da, wl), dict(wstride=2, chunks=4)),
            ((rows, lens, wins, wlens), dict())]


@pytest.mark.gpu
def test_encode_window_kernel_matches_plain(cuda):
    for (d, l, w, wlen), kw in _window_batches():
        before = encode.window_launches
        kern = encode.encode_batch_window(d.to(cuda), l.to(cuda), w.to(cuda),
                                          wlen.to(cuda), **kw)
        assert encode.window_launches == before + 1
        plain = encode.encode_batch_window_plain(d, l, w, wlen, **kw)
        _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))


def _fits(plain):
    """Each row's compared bytes: [0, total) wherever total < CAP, ok or
    not (the large-block path stitches a chunk that did not shrink)."""
    return torch.where(plain[1] < plain[0].shape[1], plain[1], 0)


@pytest.mark.gpu
def test_encode_kernels_edge_rows_match_plain(cuda):
    """K2a on the rows aimed at the greedy parse's steps (a search ending on
    every lane, at skip strides 1-3 and over 30, crowded buckets, runs,
    matches to matchlimit, short blocks), and K2b on copies 65,534-65,536
    bytes back from 64 KiB windows at preload strides 1 and 2."""
    plain_rows, windowed = corpus.greedy_edge_rows()
    rows, lens = _rows(list(plain_rows.values()), N)
    kern = encode.encode_batch(rows.to(cuda), lens.to(cuda))
    plain = encode.encode_batch_plain(rows, lens)
    _same_rows(kern, plain, _fits(plain))
    wrows, wl = _rows([b for b, _, _ in windowed.values()], N)
    wins = torch.from_numpy(np.stack([np.frombuffer(w, np.uint8)
                                      for _, w, _ in windowed.values()]))
    usable = torch.tensor([u for _, _, u in windowed.values()],
                          dtype=torch.int32)
    for wstride in (1, 2):
        kern = encode.encode_batch_window(
            wrows.to(cuda), wl.to(cuda), wins.to(cuda), usable.to(cuda),
            wstride)
        plain = encode.encode_batch_window_plain(wrows, wl, wins, usable,
                                                 wstride)
        _same_rows(kern, plain, _fits(plain))


@pytest.mark.gpu
def test_encode_kernels_write_streams_that_do_not_shrink(cuda):
    """Every row below the overflow sentinel carries the plain version's
    bytes [0, total), ok or not: K2a on plain rows (a random one among
    them), K2b on the chunk rows of blocks with a random chunk."""
    rows, lens = _rows(_payloads(), N)
    kern = encode.encode_batch(rows.to(cuda), lens.to(cuda))
    plain = encode.encode_batch_plain(rows, lens)
    assert bool(((plain[1] < plain[0].shape[1]) & ~plain[2]).any())
    _same_rows(kern, plain, _fits(plain))
    a = torch.zeros((8, N), dtype=torch.uint8)
    ln = torch.zeros((8,), dtype=torch.int32)
    wl = torch.zeros((8,), dtype=torch.int32)
    da = torch.zeros((2, N), dtype=torch.uint8)
    large.stage_chunks([_random_chunk_block()] * 2, [None, b"x" * 1000],
                       a.numpy().reshape(2, 4, N), ln.numpy().reshape(2, 4),
                       wl.numpy().reshape(2, 4), da.numpy())
    kw = dict(wstride=large.CHUNK_WSTRIDE, chunks=4)
    kern = encode.encode_batch_window(a.to(cuda), ln.to(cuda), da.to(cuda),
                                      wl.to(cuda), **kw)
    plain = encode.encode_batch_window_plain(a, ln, da, wl, **kw)
    assert bool(((plain[1] < plain[0].shape[1]) & ~plain[2]).any())
    _same_rows(kern, plain, _fits(plain))


@pytest.mark.gpu
@pytest.mark.parametrize("depth4", [False, True], ids=["K2c", "K2d"])
def test_encode_mid_kernel_matches_plain(cuda, depth4):
    """Plain rows, chunk rows and window rows; depth 4 after the 64 KiB
    windows keeps two of its tables in device memory."""
    rows, lens = _rows(_payloads(), N)
    before = encode_mid.launches
    kern = encode_mid.encode_batch_mid(rows.to(cuda), lens.to(cuda), depth4)
    assert encode_mid.launches == before + 1
    plain = encode_mid.encode_batch_mid_plain(rows, lens, depth4)
    _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))
    for (d, l, w, wlen), kw in _window_batches():
        before = encode_mid.window_launches
        kern = encode_mid.encode_batch_mid_window(
            d.to(cuda), l.to(cuda), w.to(cuda), wlen.to(cuda), depth4, **kw)
        assert encode_mid.window_launches == before + 1
        plain = encode_mid.encode_batch_mid_window_plain(d, l, w, wlen,
                                                         depth4, **kw)
        _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))


def _chain_edge_batches():
    """corpus.chain_edge_rows as operands: the plain rows, 8 KiB wide, and
    the window rows, 64 KiB wide after 64 KiB windows (depth 4 keeps two of
    its tables in device memory there)."""
    plain, windowed = corpus.chain_edge_rows()
    rows, lens = _rows(list(plain.values()), 8192)
    wrows, wlens = _rows([b for b, _, _ in windowed.values()], N)
    wins = torch.from_numpy(np.stack([np.frombuffer(w, np.uint8)
                                      for _, w, _ in windowed.values()]))
    usable = torch.tensor([u for _, _, u in windowed.values()],
                          dtype=torch.int32)
    return (rows, lens), (wrows, wlens, wins, usable)


@pytest.mark.gpu
@pytest.mark.parametrize("depth4", [False, True], ids=["K2c", "K2d"])
def test_encode_mid_kernel_edge_rows_match_plain(cuda, depth4):
    """The rows aimed at the warp-cooperative parse's steps, plain and
    after windows at preload strides 1 and 2."""
    (rows, lens), far = _chain_edge_batches()
    assert encode_mid.tables_spill(N, N, True)
    kern = encode_mid.encode_batch_mid(rows.to(cuda), lens.to(cuda), depth4)
    plain = encode_mid.encode_batch_mid_plain(rows, lens, depth4)
    _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))
    for wstride in (1, 2):
        kern = encode_mid.encode_batch_mid_window(
            *(x.to(cuda) for x in far), depth4, wstride)
        plain = encode_mid.encode_batch_mid_window_plain(*far, depth4,
                                                         wstride)
        _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))


def _random_chunk_block() -> bytes:
    """A 3.5-chunk block of text whose second 64 KiB chunk is random: that
    chunk does not shrink, and the large-block path stitches its stream."""
    text = corpus.silesia_like(3 * N, seed=6)
    noise = np.random.default_rng(23).integers(0, 256, N, dtype=np.uint8)
    return text[:N] + noise.tobytes() + text[N:2 * N + N // 2]


@pytest.mark.gpu
@pytest.mark.parametrize("depth4", [False, True], ids=["K2c", "K2d"])
def test_encode_mid_kernel_writes_streams_that_do_not_shrink(cuda, depth4):
    """Every row below the overflow sentinel carries the plain version's
    bytes [0, total), ok or not: plain rows (a random one among them) and
    the chunk rows of blocks with a random chunk."""
    rows, lens = _rows(_payloads(), N)
    CAP = encode.out_width(N)
    kern = encode_mid.encode_batch_mid(rows.to(cuda), lens.to(cuda), depth4)
    plain = encode_mid.encode_batch_mid_plain(rows, lens, depth4)
    fits = plain[1] < CAP
    assert bool((fits & ~plain[2]).any())
    _same_rows(kern, plain, torch.where(fits, plain[1], 0))
    a = torch.zeros((8, N), dtype=torch.uint8)
    ln = torch.zeros((8,), dtype=torch.int32)
    wl = torch.zeros((8,), dtype=torch.int32)
    da = torch.zeros((2, N), dtype=torch.uint8)
    large.stage_chunks([_random_chunk_block()] * 2, [None, b"x" * 1000],
                       a.numpy().reshape(2, 4, N), ln.numpy().reshape(2, 4),
                       wl.numpy().reshape(2, 4), da.numpy())
    kw = dict(wstride=large.CHUNK_WSTRIDE, chunks=4)
    kern = encode_mid.encode_batch_mid_window(
        a.to(cuda), ln.to(cuda), da.to(cuda), wl.to(cuda), depth4, **kw)
    plain = encode_mid.encode_batch_mid_window_plain(a, ln, da, wl, depth4,
                                                     **kw)
    fits = plain[1] < CAP
    assert bool((fits & ~plain[2]).any())
    _same_rows(kern, plain, torch.where(fits, plain[1], 0))


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 3, 8])
def test_device_frame_with_a_random_chunk_matches_plain_frame(cuda, level):
    """A 4 MiB-block frame whose one block has a random 64 KiB chunk: that
    chunk's literals are stitched into the block as the plain version
    stitches them."""
    data = _random_chunk_block()
    kw = dict(backend="device", level=level, device_batch=4)
    frame = plz4_tpu_torch.compress(data, device="cuda", **kw)
    assert frame == plz4_tpu_torch.compress(data, device="cpu", **kw)
    assert len(frame) < len(data)
    assert plz4_tpu_torch.decompress(frame, backend="device") == data
    assert plz4_tpu_torch.decompress(frame, backend="native") == data


@pytest.mark.gpu
@pytest.mark.parametrize("tries", [2, 32])
def test_encode_deep_kernel_matches_plain(cuda, tries):
    """Plain rows (2^15 heads), chunk rows and window rows (2^14 heads, the
    windows cut to their last 32 KiB; no preload stride)."""
    rows, lens = _rows(_payloads(), N)
    before = encode_deep.launches
    piped = encode_deep.pipelined_rows
    kern = encode_deep.encode_batch_deep(rows.to(cuda), lens.to(cuda), tries)
    assert encode_deep.launches == before + 1
    assert encode_deep.pipelined_rows == piped + rows.shape[0]
    plain = encode_deep.encode_batch_deep_plain(rows, lens, tries)
    _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))
    for (d, l, w, wlen), kw in _window_batches():
        kw.pop("wstride", None)
        before = encode_deep.window_launches
        piped = encode_deep.pipelined_rows
        kern = encode_deep.encode_batch_deep_window(
            d.to(cuda), l.to(cuda), w.to(cuda), wlen.to(cuda), tries, **kw)
        assert encode_deep.window_launches == before + 1
        assert encode_deep.pipelined_rows == piped
        plain = encode_deep.encode_batch_deep_window_plain(d, l, w, wlen,
                                                           tries, **kw)
        _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))


@pytest.mark.gpu
@pytest.mark.parametrize("tries", [2, 32])
def test_encode_deep_pipelined_base_rows_match_plain(cuda, tries):
    """The frame cell's 512 base blocks (benchmark/corpus.py) through the
    pipelined kernel of plain rows: ok, total and bytes as the plain
    version gives them, one launch, every row counted."""
    from benchmark import corpus as bench_corpus

    base = bench_corpus.silesia_bulk(512 * N)
    rows = torch.from_numpy(np.frombuffer(base[:512 * N], np.uint8)
                            .reshape(512, N).copy())
    lens = torch.full((512,), N, dtype=torch.int32)
    before, piped = encode_deep.launches, encode_deep.pipelined_rows
    kern = encode_deep.encode_batch_deep(rows.to(cuda), lens.to(cuda), tries)
    assert encode_deep.launches == before + 1
    assert encode_deep.pipelined_rows == piped + 512
    plain = encode_deep.encode_batch_deep_plain(rows, lens, tries)
    assert bool(plain[2].all())
    _same_rows(kern, plain, plain[1])


@pytest.mark.gpu
@pytest.mark.parametrize("tries", [2, 32])
def test_encode_deep_plain_kernel_chain_is_the_one_warp_chain(cuda, tries):
    """The pipelined kernel's split build (the table warps match each
    step's keys ahead of the build warp) leaves the chain that the table
    kernel's one-warp build leaves, in each kernel's delta scratch: the
    frame cell's 512 base blocks and the edge rows of _payloads()."""
    from benchmark import corpus as bench_corpus

    from plz4_tpu_torch.ops import _build

    base = bench_corpus.silesia_bulk(512 * N)
    edge, edge_lens = _rows(_payloads(), N)
    rows = torch.cat([torch.from_numpy(np.frombuffer(base[:512 * N], np.uint8)
                                       .reshape(512, N).copy()), edge])
    lens = torch.cat([torch.full((512,), N, dtype=torch.int32), edge_lens])
    d, ln = rows.to(cuda), lens.to(cuda)
    R = rows.shape[0]
    hash_log, Dc = encode_deep.deep_route(N, None)
    assert Dc == 0
    stream = torch.cuda.current_stream(cuda).cuda_stream
    chains = []
    for fn in ("lz4t_launch_plain", "lz4t_launch"):
        out, tot, ok = encode.empty_outputs(R, N, cuda)
        delta = torch.zeros((R, N + 8), dtype=torch.int16, device=cuda)
        if fn == "lz4t_launch_plain":
            ptrs = (d.data_ptr(), ln.data_ptr(), out.data_ptr(),
                    tot.data_ptr(), ok.data_ptr(), delta.data_ptr())
            ints = (R, N, out.shape[1], tries, hash_log)
        else:
            tab = torch.empty((R, N), dtype=torch.int32, device=cuda)
            ptrs = (d.data_ptr(), ln.data_ptr(), 0, 0, out.data_ptr(),
                    tot.data_ptr(), ok.data_ptr(), delta.data_ptr(),
                    tab.data_ptr())
            ints = (R, N, 0, 1, 0, out.shape[1], tries, hash_log)
        _build.launch("lz4_encode_deep", ptrs, ints, stream, fn=fn)
        chains.append((delta.cpu(), tot.cpu(), ok.cpu()))
    (split, st, sk), (one, ot, ok1) = chains
    for r in range(R):
        assert torch.equal(split[r], one[r]), r
    assert torch.equal(st, ot) and torch.equal(sk, ok1)
    assert bool(split[:512].ne(0).any())


@pytest.mark.gpu
def test_encode_deep_wider_plain_rows_take_the_table_kernel(cuda):
    """Plain rows wider than the chain ring (N > 65,536) keep the walk
    table in device memory: not pipelined, the same bytes."""
    width = N + 1024
    text = corpus.silesia_like(2 * width, seed=21)
    rows, lens = _rows([text[:width], text[width:2 * width - 77], b"\x00"
                        * width], width)
    before, piped = encode_deep.launches, encode_deep.pipelined_rows
    kern = encode_deep.encode_batch_deep(rows.to(cuda), lens.to(cuda), 32)
    assert encode_deep.launches == before + 1
    assert encode_deep.pipelined_rows == piped
    plain = encode_deep.encode_batch_deep_plain(rows, lens, 32)
    assert bool(plain[2].all())
    _same_rows(kern, plain, plain[1])


@pytest.mark.gpu
def test_decode_dict_kernel_matches_plain(cuda):
    dict_ = corpus.silesia_like(N, seed=9)
    streams = [native.compress(p, level=1, dict_=dict_) for p in _payloads()]
    streams = [s for s in streams if len(s) <= N]
    streams += [bytes([0x00, 0x04, 0x00, 0x40]) + b"abcd",  # ends at window
                bytes([0x00, 0xFF, 0xFF, 0x40]) + b"abcd"]  # offset 65535
    nv = len(streams)
    streams += [bytes([0x04, 0, 0]), b"\xff" * 40, streams[-3][:999]]
    rows, clens = _rows(streams, C)
    dbuf = torch.from_numpy(np.frombuffer(dict_, np.uint8).copy())
    for dlen in (N, 4096):
        before = decode.dict_launches
        kern = decode.decode_batch_dict(rows.to(cuda), clens.to(cuda),
                                        dbuf.to(cuda), dlen, N)
        assert decode.dict_launches == before + 1
        plain = decode.decode_batch_dict_plain(rows, clens, dbuf, dlen, N)
        _same_rows(kern, plain, plain[1])
        if dlen == N:
            assert plain[2][:nv].all() and not plain[2][nv:nv + 2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["short-offsets", "ring-wrap",
                                  "clen-over-C", "out-cap"])
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_decode_kernels_edge_batches_match_plain(cuda, kernel, name):
    """K1 and K3 on corpus.decode_edge_batches: short offsets at a row's
    start, rows that wrap the parse's ring of 2,048 sequences, clen past
    the row's width, streams that pass out_cap."""
    rows, clens, cap, win = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                             else x for x in
                             corpus.decode_edge_batches()[name])
    if kernel == "K1":
        before = decode.launches
        kern = decode.decode_batch(rows.to(cuda), clens.to(cuda), cap)
        assert decode.launches == before + 1
        plain = decode.decode_batch_plain(rows, clens, cap)
    else:
        d = torch.from_numpy(np.frombuffer(win, np.uint8).copy())
        before = decode.dict_launches
        kern = decode.decode_batch_dict(rows.to(cuda), clens.to(cuda),
                                        d.to(cuda), len(win), cap)
        assert decode.dict_launches == before + 1
        plain = decode.decode_batch_dict_plain(rows, clens, d, len(win), cap)
    _same_rows(kern, plain, plain[1])


@pytest.mark.gpu
def test_decode_kernel_widest_rows_match_plain(cuda):
    """K1 at 96 KiB blocks, the widest rows the batch layer passes: the
    most shared memory (the ring and 196,624 B of rows)."""
    cap = decode.BW_MAX_OUT
    text = corpus.silesia_like(3 * cap, seed=5)
    streams = [native.compress(text[i:i + cap], level=1)
               for i in range(0, 3 * cap, cap)]
    streams.append(streams[0][:len(streams[0]) // 2])
    rows, clens = _rows(streams, cap + decode.ROW_SLACK)
    kern = decode.decode_batch(rows.to(cuda), clens.to(cuda), cap)
    plain = decode.decode_batch_plain(rows, clens, cap)
    assert plain[2][:3].all() and not plain[2][3]
    _same_rows(kern, plain, plain[1])


@pytest.mark.gpu
def test_decode_records_kernel_matches_plain(cuda):
    text = corpus.silesia_like(8 * N, seed=11)
    dict_ = text[-3000:]
    blocks = [native.compress(text[:4 * N], level=1),
              native.compress(text[4 * N:8 * N], level=1, dict_=dict_)]
    items = [(b, native.chunk_split(b, large.CHUNK, max_out=4 * N))
             for b in blocks]
    K = 5
    r = np.zeros((2, K, large.CHUNK_IN), np.uint8)
    m = np.zeros((2, K, 7), np.int32)
    w = np.zeros((2, large.CHUNK), np.uint8)
    for b, (j, d) in enumerate([(0, None), (1, dict_)]):
        large.stage_records(items[j:j + 1], d, r[b:b + 1], m[b:b + 1],
                            w[b:b + 1])
    bad = r.copy(), m.copy()
    bad[0][0, 2, 100:110] ^= 0x5A  # flipped bytes in a record slice
    bad[1][1, 3, 0] -= 7  # a truncated record
    for rows, metas in [(r, m), bad]:
        args = [torch.from_numpy(x) for x in (rows, metas, w)]
        before = decode.record_launches
        kern = decode.decode_records_batch(*(x.to(cuda) for x in args))
        assert decode.record_launches == before + 1
        plain = decode.decode_records_batch_plain(*args)
        _same_rows(kern, plain, plain[1].reshape(-1))
    assert plain[2][0, :2].all() and plain[2][1, :3].all()


def _short_offset_records():
    """K5 records of one match each (offsets 1-64, lengths 4-130, starting
    at output positions 0-40, in-record or carried), two per block so that
    the second record's window is the first one's output."""
    W, CIN = 1024, 1280
    cases = [(op, off, ml, carried) for op in (0, 1, 7, 31, 32, 40)
             for off in range(1, 65) for ml in (4, 19, 31, 33, 64, 130)
             for carried in (False, True)]
    rows = np.zeros((len(cases), 2, CIN), np.uint8)
    metas = np.zeros((len(cases), 2, 7), np.int32)
    win0s = np.random.default_rng(31).integers(0, 256, (len(cases), W),
                                               dtype=np.uint8)
    for b, (op, off, ml, carried) in enumerate(cases):
        lits = bytes((37 * k + 11) & 255 for k in range(op))
        if carried:
            comp = lits + b"\x10z"
            meta = [len(comp), W, op, 0, off, ml, op + ml + 1]
        else:
            mv = ml - 4
            comp = bytes([(min(op, 15) << 4) | min(mv, 15)])
            comp += bytes([op - 15]) if op >= 15 else b""
            comp += lits + bytes([off, 0])
            comp += bytes([mv - 15]) if mv >= 15 else b""
            comp += b"\x10z"
            meta = [len(comp), W, 0, 0, 0, 0, op + ml + 1]
        rows[b, :, :len(comp)] = np.frombuffer(comp, np.uint8)
        metas[b, :] = meta
    return [torch.from_numpy(x) for x in (rows, metas, win0s)]


@pytest.mark.gpu
def test_decode_records_kernel_short_offsets_match_plain(cuda):
    args = _short_offset_records()
    kern = decode.decode_records_batch(*(x.to(cuda) for x in args))
    plain = decode.decode_records_batch_plain(*args)
    assert plain[2].all()
    assert torch.equal(kern[1].cpu(), plain[1])
    assert torch.equal(kern[2].cpu(), plain[2])
    assert torch.equal(kern[0].cpu(), plain[0])  # zero past n_out too


@pytest.mark.gpu
@pytest.mark.parametrize("tries", [2, 32])
def test_encode_deep_kernel_reuses_ring_slots_exactly(cuda, tries):
    """64 KiB blocks after 32 KiB windows (row positions past 65,536) of
    random bytes with repeats 65,504-65,537 bytes apart and a run."""
    rng = np.random.default_rng(0x2196)
    rows, wins = [], []
    for k in range(3):
        row = bytearray(rng.integers(0, 256, 3 * N // 2, dtype=np.uint8)
                        .tobytes())
        for j, d in enumerate((65504, 65505, 65520, 65534, 65535, 65536,
                               65537) * 3):
            q = 800 + 1000 * j + 37 * k
            pat = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            row[q:q + 16] = pat
            row[q + d:q + d + 16] = pat
        row[60000:72000] = b"\x07" * 12000  # a run across 65,536
        rows.append(bytes(row[N // 2:]))
        wins.append(bytes(N // 2) + bytes(row[:N // 2]))
    d, ln = _rows(rows, N)
    w, _ = _rows(wins, N)
    wl = torch.full((3,), N, dtype=torch.int32)
    kern = encode_deep.encode_batch_deep_window(
        d.to(cuda), ln.to(cuda), w.to(cuda), wl.to(cuda), tries)
    plain = encode_deep.encode_batch_deep_window_plain(d, ln, w, wl, tries)
    assert plain[2].all()
    _same_rows(kern, plain, plain[1])


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [
    dict(),
    dict(block_size_idx=plz4_tpu_torch.BLOCK_IDX_64KB,
         dictionary=corpus.silesia_like(N, seed=13)),
    dict(block_size_idx=plz4_tpu_torch.BLOCK_IDX_64KB, block_linked=True),
], ids=["4MB", "dict", "linked"])
def test_device_window_frame_matches_plain_frame(cuda, opts):
    data = corpus.silesia_like(5 * N + 4321)
    kw = dict(backend="device", level=1, device_batch=4) | opts
    frame = plz4_tpu_torch.compress(data, device="cuda", **kw)
    assert frame == plz4_tpu_torch.compress(data, device="cpu", **kw)
    d = opts.get("dictionary")
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     dictionary=d) == data
    assert plz4_tpu_torch.decompress(frame, backend="native",
                                     dictionary=d) == data


@pytest.mark.gpu
@pytest.mark.parametrize("level", [3, 8, 9, 12])
@pytest.mark.parametrize("block", ["64KB", "4MB"])
def test_device_level_frame_matches_plain_frame(cuda, level, block):
    data = corpus.silesia_like(5 * N + 4321)
    kw = dict(backend="device", level=level, device_batch=4)
    if block == "64KB":
        kw["block_size_idx"] = plz4_tpu_torch.BLOCK_IDX_64KB
    frame = plz4_tpu_torch.compress(data, device="cuda", **kw)
    assert frame == plz4_tpu_torch.compress(data, device="cpu", **kw)
    assert plz4_tpu_torch.decompress(frame, backend="device") == data
    assert plz4_tpu_torch.decompress(frame, backend="native") == data


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 0x9E3779B1])
def test_xxh32_kernel_matches_plain(cuda, seed):
    """K7 on main-path rows, edge lengths 0-40 and rows of an odd width."""
    text = corpus.silesia_like(8 * N)
    blocks = [text[i:i + N] for i in range(0, 8 * N, N)]
    blocks += [text[:n] for n in range(41)]
    for width in (N, N + 3):
        rows, lens = _rows(blocks, width)
        before = xxh32.launches
        got = xxh32.xxh32_batch(rows.to(cuda), lens.to(cuda), seed).cpu()
        assert xxh32.launches == before + 1
        assert torch.equal(got, xxh32.xxh32_batch_plain(rows, lens, seed))
        assert got.tolist() == [native.xxh32(b, seed) for b in blocks]


# K7's rows whose starts are not 16-byte aligned: widths of every residue
# mod 4 and mod 16 (65,860 is CAP of a 64 KiB row), lengths that end on
# and beside the staging ring's 4 KiB chunks
XXH_WIDTHS = [65537, 65538, 65539, 65544, 65548, 65860]
XXH_LENGTHS = list(range(41)) + [4095, 4096, 4097, 8191, 8192, 8193, 16383,
                                 16384, 16385, 65535, 65536]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 0x9E3779B1, 0x80000001])
def test_xxh32_kernel_unaligned_rows_match_plain(cuda, seed):
    """K7 on rows of every start alignment: each width, and the same rows
    at a storage offset of 3 bytes; one launch per call."""
    text = corpus.silesia_like(N + 64, seed=5)
    blocks = [text[:n] for n in XXH_LENGTHS]
    want = [native.xxh32(b, seed) for b in blocks]
    for width in XXH_WIDTHS:
        rows, lens = _rows(blocks, width)
        flat = torch.zeros(rows.numel() + 16, dtype=torch.uint8)
        flat[3:3 + rows.numel()] = rows.reshape(-1)
        for r in (rows, flat[3:3 + rows.numel()].view(rows.shape)):
            dev = torch.empty(r.numel() + 16, dtype=torch.uint8, device=cuda)
            off = r.storage_offset()
            dev[off:off + r.numel()] = r.reshape(-1).to(cuda)
            before = xxh32.launches
            got = xxh32.xxh32_batch(dev[off:off + r.numel()].view(r.shape),
                                    lens.to(cuda), seed).cpu()
            assert xxh32.launches == before + 1
            assert torch.equal(got, xxh32.xxh32_batch_plain(r, lens, seed))
            assert got.tolist() == want


def _wide_rows(width):
    text = corpus.silesia_like(3 * width, seed=9)
    rng = np.random.default_rng(29)
    return _rows([text[:width], text[width:2 * width - 777],
                  rng.integers(0, 256, width, dtype=np.uint8).tobytes(),
                  b"\x00" * width, b"", text[:5000]], width)


@pytest.mark.gpu
@pytest.mark.parametrize("mid", [False, True], ids=["greedy", "mid"])
@pytest.mark.parametrize("window", [False, True], ids=["plain", "window"])
def test_encode_wide_kernel_matches_plain(cuda, mid, window):
    """K6b at 256 KiB rows, plain and after full, partial and empty 64 KiB
    windows."""
    rows, lens = _wide_rows(4 * N)
    args = [rows, lens]
    if window:
        wins = torch.from_numpy(np.frombuffer(
            corpus.silesia_like(N, seed=3) * 6, np.uint8).reshape(6, N).copy())
        args += [wins, torch.tensor([N, 3000, 0, N, N, 12], dtype=torch.int32)]
    else:
        args += [None, None]
    counter = "mid_launches" if mid else "launches"
    before = getattr(encode_wide, counter)
    kern = encode_wide.encode_batch_wide(
        *[a.to(cuda) if a is not None else None for a in args], mid=mid)
    assert getattr(encode_wide, counter) == before + 1
    plain = encode_wide.encode_batch_wide_plain(*args, mid=mid)
    _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))
    assert bool(plain[2][0]) and not bool(plain[2][2])


@pytest.mark.gpu
@pytest.mark.parametrize("mid", [False, True], ids=["greedy", "mid"])
def test_encode_wide_kernel_edge_rows_match_plain(cuda, mid):
    """K6b on corpus.wide_edge_rows: the greedy or chain edge blocks at the
    first widths K6b takes, alone and at the end of full rows, plain and
    after 64 KiB windows; one launch per call."""
    (blocks, n), (wblocks, nw, wins, wlens) = corpus.wide_edge_rows(mid)
    counter = "mid_launches" if mid else "launches"
    for args in (list(_rows(blocks, n)) + [None, None],
                 list(_rows(wblocks, nw)) + [
                     torch.from_numpy(np.stack([np.frombuffer(w, np.uint8)
                                                for w in wins])),
                     torch.tensor(wlens, dtype=torch.int32)]):
        before = getattr(encode_wide, counter)
        kern = encode_wide.encode_batch_wide(
            *[a.to(cuda) if a is not None else None for a in args], mid=mid)
        assert getattr(encode_wide, counter) == before + 1
        plain = encode_wide.encode_batch_wide_plain(*args, mid=mid)
        _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))
        assert bool(plain[2].any())


@pytest.mark.gpu
def test_decode_wide_kernel_matches_plain(cuda):
    """K6a at 256 KiB blocks: native and K6b streams, corrupt and truncated
    ones, and a bad literal run whose n_out passes out_cap."""
    cap = 4 * N
    rows, lens = _wide_rows(cap)
    out, tot, ok = encode_wide.encode_batch_wide_plain(rows, lens)
    streams = [out[i, :tot[i]].numpy().tobytes() for i in range(len(ok))
               if ok[i]]
    streams += [native.compress(rows[i, :lens[i]].numpy().tobytes(), level=1)
                for i in range(len(lens))]
    rng = np.random.default_rng(31)
    for k in range(8):
        s = bytearray(streams[k % 3])
        if k % 2:
            s = s[: int(rng.integers(1, len(s)))]
        else:
            s[int(rng.integers(len(s)))] ^= 0xFF
        streams.append(bytes(s))
    big = cap + 4000
    streams += [bytes([0x14, 0x41, 1, 0, 0xF0]) + b"\xff" * (big // 255)
                + bytes([big % 255]) + b"b" * 64, bytes([0x04, 0, 0])]
    crow, clens = _rows(streams, max(len(s) for s in streams) + 16 & ~3)
    before = decode.wide_launches
    kern = decode.decode_batch(crow.to(cuda), clens.to(cuda), cap)
    assert decode.wide_launches == before + 1
    plain = decode.decode_batch_wide_plain(crow, clens, cap)
    _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))
    assert int(plain[1][-2]) > cap and not bool(plain[2][-2])


@functools.lru_cache(maxsize=None)
def _wide_decode_edges() -> dict:
    return corpus.wide_decode_edge_rows()


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "short-offsets", "ring-wrap", "clen-over-C", "out-cap", "bad-literal",
    "neighbours", "ring-wrap-4m", "clen-over-C-4m", "out-cap-4m", "big-4m"])
def test_decode_wide_kernel_edge_rows_match_plain(cuda, name):
    """K6a on corpus.wide_decode_edge_rows at 128 KiB and 4 MiB: short
    offsets, ring wraps (over 200 times in the 4 MiB row of 440,000
    sequences), clen past C, out_cap crossings, bad literal runs whose
    n_out passes out_cap, and rows that run to C (the next row's bytes are
    nonzero); the sentinel rows after the bad ones decode intact."""
    rows, clens, cap = _wide_decode_edges()[name]
    rows, clens = torch.from_numpy(rows), torch.from_numpy(clens)
    before = decode.wide_launches
    kern = decode.decode_batch(rows.to(cuda), clens.to(cuda), cap)
    assert decode.wide_launches == before + 1
    plain = decode.decode_batch_wide_plain(rows, clens, cap)
    _same_rows(kern, plain, torch.where(plain[2], plain[1], 0))
    if name in ("bad-literal", "big-4m"):
        ok = plain[2].tolist()
        sent = [i for i in range(1, len(ok)) if ok[i] and not ok[i - 1]]
        assert sent
        ko = kern[0].cpu()
        for i in sent:
            n = int(plain[1][i])
            assert torch.equal(ko[i, :n], ko[sent[0], :n])


@pytest.mark.gpu
@pytest.mark.parametrize("block", ["64KB", "4MB"])
def test_device_checksum_frame_matches_plain_frame(cuda, block):
    data = corpus.silesia_like(5 * N + 4321)
    kw = dict(backend="device", level=1, device_batch=4, block_checksum=True)
    if block == "64KB":
        kw["block_size_idx"] = plz4_tpu_torch.BLOCK_IDX_64KB
    frame = plz4_tpu_torch.compress(data, device="cuda", **kw)
    assert frame == plz4_tpu_torch.compress(data, device="cpu", **kw)
    assert plz4_tpu_torch.decompress(frame, backend="device") == data
    assert plz4_tpu_torch.decompress(frame, backend="native") == data


@pytest.mark.gpu
@pytest.mark.parametrize("entries", [1, 2])
@pytest.mark.parametrize("block", ["64KB", "4MB"])
def test_sharded_frame_on_one_gpu_equals_unsharded_frame(cuda, entries,
                                                         block):
    """A mesh of 1 or 2 entries on cuda:0, each with its own stream, gives
    the unsharded device frame, and decodes back through the mesh."""
    from plz4_tpu_torch.parallel import dist, mesh as mesh_mod

    data = corpus.silesia_like(9 * N + 4321)
    kw = dict(level=1, device_batch=4, block_checksum=True)
    if block == "64KB":
        kw["block_size_idx"] = plz4_tpu_torch.BLOCK_IDX_64KB
    else:
        data = corpus.silesia_like(9 << 20)
    mesh = mesh_mod.make_block_mesh([torch.device("cuda", 0)] * entries)
    assert len({id(e.stream) for e in mesh.entries}) == entries
    frame = dist.compress_sharded(data, mesh, **kw)
    assert frame == plz4_tpu_torch.compress(data, backend="device", **kw)
    assert dist.decompress_sharded(frame, mesh) == data
    assert plz4_tpu_torch.decompress(frame, backend="native") == data


@pytest.mark.gpu
def test_entry_points_run_on_cuda(cuda):
    from plz4_tpu_torch import entry

    step, (data, lens) = entry.entry()
    assert data.device.type == "cuda"
    before = (encode.launches, decode.launches)
    totals, compressible, flag = step(data, lens)
    assert (encode.launches, decode.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert bool(flag) and bool(compressible.all())
    cpu_step, cpu_args = entry.entry(device="cpu")
    assert torch.equal(totals.cpu(), cpu_step(*cpu_args)[0])
    entry.dryrun_multichip(2)


# --- the array path (A1, A2) and the CLI ------------------------------------


def _launch_counts():
    return (encode.launches, encode.window_launches, encode_mid.launches,
            encode_mid.window_launches, encode_deep.launches,
            encode_deep.window_launches, decode.launches,
            decode.dict_launches, decode.record_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 3, 9])
def test_array_encode_on_cuda_equals_cpu(cuda, level):
    from plz4_tpu_torch.ops import encode_array

    rows, lens = _rows(_payloads(), N)
    got = encode_array.encode_batch(rows.to(cuda), lens.to(cuda), level)
    want = encode_array.encode_batch(rows, lens, level)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    text = corpus.silesia_like(4 * N, seed=3)
    wins, wl = _rows([text[:N], text[N:N + 1000], b"", text[:17]], N)
    data, dl = _rows([text[N:2 * N], text[2 * N:3 * N], text[:500], b""], N)
    got = encode_array.encode_batch_dict(data.to(cuda), dl.to(cuda),
                                         wins.to(cuda), wl.to(cuda), level)
    want = encode_array.encode_batch_dict(data, dl, wins, wl, level)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_array_decode_on_cuda_equals_cpu(cuda):
    from plz4_tpu_torch.ops import decode_array

    streams = [native.compress(p, level=lv) for p in _payloads()
               for lv in (1, 12)]
    streams = [s for s in streams if len(s) <= C]
    rng = np.random.default_rng(29)
    for k in range(12):
        s = bytearray(streams[-1 - k % 8])
        if k % 2:
            s = s[: int(rng.integers(1, len(s)))]
        else:
            s[int(rng.integers(len(s)))] ^= 0xFF
        streams.append(bytes(s))
    streams += [bytes([0x04, 50, 0]), b"\xff" * 40]
    rows, clens = _rows(streams, C)
    got = decode_array.decode_batch(rows.to(cuda), clens.to(cuda), N)
    want = decode_array.decode_batch(rows, clens, N)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    dict_ = corpus.silesia_like(N, seed=4)
    ds = [native.compress(dict_[-3000:] + p[:2000], level=1, dict_=dict_)
          for p in _payloads()[1:8]]
    rows, clens = _rows(ds, C)
    dbuf = torch.from_numpy(np.frombuffer(dict_, np.uint8).copy())
    got = decode_array.decode_batch_dict(rows.to(cuda), clens.to(cuda),
                                         dbuf.to(cuda), N, N)
    want = decode_array.decode_batch_dict(rows, clens, dbuf, N, N)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want[2].all())


@pytest.mark.gpu
@pytest.mark.parametrize("block", ["64KB", "4MB"])
def test_array_path_frame_on_cuda_equals_cpu(cuda, block):
    data = corpus.silesia_like(3 * N + 4321)
    kw = dict(backend="device", level=1, array_path=True,
              block_checksum=True)
    if block == "64KB":
        kw["block_size_idx"] = plz4_tpu_torch.BLOCK_IDX_64KB
    before = _launch_counts()
    frame = plz4_tpu_torch.compress(data, **kw)
    assert plz4_tpu_torch.decompress(frame, **kw) == data
    assert _launch_counts() == before  # no encode or decode kernel ran
    assert frame == plz4_tpu_torch.compress(data, device="cpu", **kw)
    assert plz4_tpu_torch.decompress(frame, backend="native") == data


@pytest.mark.gpu
def test_entry_array_on_cuda_equals_cpu(cuda):
    from plz4_tpu_torch import entry

    step, args = entry.entry_array()
    assert args[0].device.type == "cuda"
    got = step(*args)
    cpu_step, cpu_args = entry.entry_array(device="cpu")
    for g, w in zip(got, cpu_step(*cpu_args)):
        assert torch.equal(g.cpu(), w)
    assert bool(got[2])


@pytest.mark.gpu
def test_cli_device_backend_in_a_subprocess(cuda, tmp_path):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = corpus.silesia_like(3 * N + 777)
    src = tmp_path / "d.bin"
    src.write_bytes(data)

    def run(*argv):
        p = subprocess.run([sys.executable, "-m", "plz4_tpu_torch", *argv],
                           cwd=root, capture_output=True, text=True,
                           timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        return p.stdout

    for flags in ([], ["--bs", "64KB", "--bx"]):
        run("--backend", "device", "compress", str(src), "-o",
            str(tmp_path / "o.lz4"), "-f", "-q", *flags)
        run("--backend", "device", "decompress", str(tmp_path / "o.lz4"),
            "-o", str(tmp_path / "r.bin"), "-f", "-q")
        assert (tmp_path / "r.bin").read_bytes() == data
        assert "OK: " in run("--backend", "device", "verify",
                             str(tmp_path / "o.lz4"))
    assert "device" in run("bakeoff", str(src), "--device", "-q")


@pytest.mark.gpu
def test_spans_count_the_rows_copied_back(cuda):
    """Three batches (128, 128 and 35 blocks, the last padded to 64 rows):
    each row comes back at its output width, with its total and flag."""
    from torch.profiler import ProfilerActivity, profile

    from plz4_tpu_torch import spans

    rng = np.random.default_rng(31)
    data = np.repeat(rng.integers(0, 16, (291 * N - 999) // 4,
                                  dtype=np.uint8), 4).tobytes()
    kw = dict(backend="device", device="cuda", level=12,
              block_size_idx=plz4_tpu_torch.BLOCK_IDX_64KB)
    frame = plz4_tpu_torch.compress(data, **kw)  # untraced warm call
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert plz4_tpu_torch.compress(data, **kw) == frame
    t = spans.totals()
    assert t["plz4.batch.enqueue"]["n"] == 3
    rows = 128 + 128 + 64
    assert t["plz4.batch.enqueue"]["d2h_bytes"] == rows * (
        encode.out_width(N) + 4 + 1)
    assert plz4_tpu_torch.decompress(frame) == data
