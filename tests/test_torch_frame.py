"""The port's main path as a whole: a 64 KiB level-1 device frame, and the
device options that the port covers, block checksums among them (the window
paths' frame parity is in test_torch_frame_window.py, the level ladder's in
test_torch_frame_levels.py).

The reference frame comes from the JAX package's real Pallas path, run on
the CPU in interpret mode (monkeypatched here; no JAX file changes). The
port's device frame, from the kernels' plain versions on device="cpu",
must be byte-identical to it, each package's device decoder must read the
other's frame, and the native codec must read both.
"""

import functools
import io

import pytest
import torch

import plz4_tpu
import plz4_tpu_torch
from plz4_tpu_torch import corpus, native
from plz4_tpu.ops import decode_pallas, encode_pallas
from plz4_tpu.parallel import batch as tpu_batch
from plz4_tpu_torch.parallel import batch

from conftest import make_compressible, make_incompressible

BS = plz4_tpu_torch.BLOCK_IDX_64KB
DATA = (make_compressible(4 * 65536 + 3000, seed=21)
        + make_incompressible(65536, seed=22) + b"short tail " * 30)
PORT = dict(backend="device", device="cpu", level=1, block_size_idx=BS,
            parallel=2, device_batch=2)


@pytest.fixture
def pallas_path(monkeypatch):
    """Route plz4_tpu's device backend through its Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(tpu_batch, "_use_pallas", lambda: True)
    monkeypatch.setattr(encode_pallas, "encode_batch_pallas", functools.partial(
        encode_pallas.encode_batch_pallas, interpret=True))
    monkeypatch.setattr(decode_pallas, "decode_batch_pallas", functools.partial(
        decode_pallas.decode_batch_pallas, interpret=True))


@functools.lru_cache(maxsize=None)
def _port_frame(content_checksum: bool) -> bytes:
    return plz4_tpu_torch.compress(DATA, content_checksum=content_checksum,
                                   **PORT)


@pytest.mark.parametrize("content_checksum", [True, False])
def test_frame_byte_identical_to_pallas_path(pallas_path, content_checksum):
    ref = plz4_tpu.compress(DATA, backend="device", level=1,
                            block_size_idx=BS, parallel=2,
                            content_checksum=content_checksum)
    got = _port_frame(content_checksum)
    assert got == ref
    # the incompressible block is stored raw: the frame is not all blocks
    assert len(got) < len(DATA)


@pytest.mark.parametrize("content_checksum", [True, False])
def test_cross_decoding(pallas_path, content_checksum):
    port = _port_frame(content_checksum)
    assert plz4_tpu.decompress(port, backend="device", parallel=2) == DATA
    assert plz4_tpu.decompress(port, backend="native") == DATA
    assert plz4_tpu_torch.decompress(port, backend="native") == DATA
    tpu = plz4_tpu.compress(DATA, backend="device", level=1,
                            block_size_idx=BS, parallel=2,
                            content_checksum=content_checksum)
    assert plz4_tpu_torch.decompress(
        tpu, backend="device", device="cpu", parallel=2,
        device_batch=2) == DATA


def test_native_frame_decodes_on_device():
    frame = plz4_tpu_torch.compress(DATA, backend="native", block_size_idx=BS)
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == DATA


def test_streaming_writer_reader_round_trip():
    dst = io.BytesIO()
    with plz4_tpu_torch.Writer(dst, **PORT) as w:
        for i in range(0, len(DATA), 10_000):
            w.write(DATA[i:i + 10_000])
    r = plz4_tpu_torch.Reader(io.BytesIO(dst.getvalue()), backend="device",
                              device="cpu")
    assert r.read() == DATA
    assert dst.getvalue() == _port_frame(True)


def test_corrupt_block_raises_on_device():
    frame = bytearray(_port_frame(False))
    # first block (after the 7-byte header and its size word): a literal
    # length that runs past the block
    frame[11:20] = b"\xf0" + b"\xff" * 8
    with pytest.raises(plz4_tpu_torch.errors.Lz4Error):
        plz4_tpu_torch.decompress(bytes(frame), backend="device",
                                  device="cpu")


def test_checksummed_frame_byte_identical_to_pallas_path(pallas_path):
    """Block checksums hashed on the device (K7's plain version here, the
    JAX package's xxh32_jax there) give the same frame."""
    ref = plz4_tpu.compress(DATA, backend="device", level=1,
                            block_size_idx=BS, parallel=2,
                            block_checksum=True)
    assert plz4_tpu_torch.compress(DATA, block_checksum=True, **PORT) == ref


WINDOW_DICT = b"dictionary " * 20 + DATA[:3000]
CHECKSUM_OPTS = [dict(), dict(block_size_idx=plz4_tpu_torch.BLOCK_IDX_4MB),
                 dict(dictionary=WINDOW_DICT), dict(block_linked=True)]
CHECKSUM_IDS = ["64KB", "4MB", "dict", "linked"]


@pytest.mark.parametrize("opts", CHECKSUM_OPTS, ids=CHECKSUM_IDS)
def test_block_checksum_frames_round_trip(opts):
    """Writer and Reader with block checksums on the device backend: every
    block carries its xxh32, both decoders read the frame, and a flipped
    byte in a block raises ErrBlockHash."""
    kw = dict(PORT) | dict(block_checksum=True) | opts
    dst = io.BytesIO()
    with plz4_tpu_torch.Writer(dst, **kw) as w:
        for i in range(0, len(DATA), 50_000):
            w.write(DATA[i:i + 50_000])
    frame = dst.getvalue()
    assert frame[4] & 0x10  # FLG: block checksums
    d = opts.get("dictionary")
    r = plz4_tpu_torch.Reader(io.BytesIO(frame), backend="device",
                              device="cpu", dictionary=d)
    assert r.read() == DATA
    assert plz4_tpu_torch.decompress(frame, backend="native",
                                     dictionary=d) == DATA
    assert frame == plz4_tpu_torch.compress(
        DATA, **(dict(PORT) | dict(block_checksum=True) | opts))
    bad = bytearray(frame)
    bad[len(frame) // 3] ^= 0x5A
    with pytest.raises(plz4_tpu_torch.errors.Lz4Error) as ei:
        plz4_tpu_torch.decompress(bytes(bad), backend="device", device="cpu",
                                  dictionary=d)
    assert ei.value is plz4_tpu_torch.errors.ErrBlockHash


def test_block_checksums_hash_on_device(monkeypatch):
    """At 64 KiB blocks the device path computes and verifies every block
    checksum on the device: zero host native.xxh32 calls per block on write
    and on read (the JAX package's tests/test_device_backend.py pin)."""
    calls = {"n": 0}
    real = native.xxh32

    def counting(data, seed=0):
        calls["n"] += 1
        return real(data, seed)

    monkeypatch.setattr(native, "xxh32", counting)
    data = make_compressible(200000, seed=61)
    kw = dict(PORT) | dict(block_checksum=True, content_checksum=False)
    frame = plz4_tpu_torch.compress(data, **kw)
    assert calls["n"] == 0, f"writer did {calls['n']} host block hashes"
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == data
    assert calls["n"] == 0, f"reader did {calls['n']} host block hashes"


@pytest.mark.parametrize("level", [3, 12], ids=["level3", "level12"])
def test_device_levels_round_trip(level):
    """Levels above 2 run on the device backend (the depth-2 chain K2c at
    level 3, the deep hash-chain finder K4 at level 12) and give smaller
    frames than level 1 that both decoders read; parity with the Pallas
    path is in test_torch_frame_levels.py."""
    frame = plz4_tpu_torch.compress(DATA, **(dict(PORT) | dict(level=level)))
    assert len(frame) < len(_port_frame(True))
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == DATA
    assert plz4_tpu_torch.decompress(frame, backend="native") == DATA


@pytest.mark.parametrize("opts", [
    dict(block_linked=True),
    dict(dictionary=WINDOW_DICT),
    dict(block_size_idx=plz4_tpu_torch.BLOCK_IDX_256KB),
    dict(block_size_idx=plz4_tpu_torch.BLOCK_IDX_4MB),
], ids=["linked", "dict", "256KB", "4MB"])
def test_covered_device_options_round_trip(opts):
    """Linked blocks, dictionaries and blocks over 64 KiB run on the device
    backend (K2b, K3, K5) and give frames that both decoders read."""
    frame = plz4_tpu_torch.compress(DATA, **(dict(PORT) | opts))
    d = opts.get("dictionary")
    assert len(frame) < len(DATA)
    assert plz4_tpu_torch.decompress(frame, backend="device", device="cpu",
                                     dictionary=d) == DATA
    assert plz4_tpu_torch.decompress(frame, backend="native",
                                     dictionary=d) == DATA


def test_default_block_size_round_trips_on_device():
    frame = plz4_tpu_torch.compress(DATA, backend="device", device="cpu")
    assert frame[5] >> 4 & 7 == plz4_tpu_torch.BLOCK_IDX_4MB  # BD byte
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == DATA
    assert plz4_tpu_torch.decompress(frame, backend="native") == DATA


@pytest.mark.parametrize("idx", [BS, plz4_tpu_torch.BLOCK_IDX_4MB],
                         ids=["64KB", "4MB"])
def test_device_reader_verifies_native_block_checksums(idx):
    """A native frame with block checksums: the device Reader verifies them
    (on the device for compressed blocks of at most 64 KiB, on the host for
    raw and large blocks) and refuses a block with a flipped byte."""
    frame = plz4_tpu_torch.compress(DATA, backend="native",
                                    block_size_idx=idx, block_checksum=True)
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == DATA
    for pos in (30, len(frame) - 200):  # a compressed and the raw tail block
        bad = bytearray(frame)
        bad[pos] ^= 0x01
        with pytest.raises(plz4_tpu_torch.errors.Lz4Error) as ei:
            plz4_tpu_torch.decompress(bytes(bad), backend="device",
                                      device="cpu")
        assert ei.value is plz4_tpu_torch.errors.ErrBlockHash


@pytest.mark.parametrize("idx", [plz4_tpu_torch.BLOCK_IDX_256KB,
                                 plz4_tpu_torch.BLOCK_IDX_1MB,
                                 plz4_tpu_torch.BLOCK_IDX_4MB],
                         ids=["256KB", "1MB", "4MB"])
def test_device_reader_decodes_native_frames(idx):
    frame = plz4_tpu_torch.compress(DATA, backend="native",
                                    block_size_idx=idx)
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == DATA


def test_device_reader_decodes_native_records_cut_after_a_match():
    """A native 256 KiB frame whose blocks split at a match that ends on a
    64 KiB record boundary: K5 (its plain version here) ends the record
    there."""
    data = corpus.silesia_like(1 << 20, seed=5)
    frame = plz4_tpu_torch.compress(data, backend="native", level=1,
                                    block_size_idx=plz4_tpu_torch
                                    .BLOCK_IDX_256KB)
    cuts = 0
    for i in range(0, len(data), 1 << 18):
        recs = native.chunk_split(native.compress(data[i:i + (1 << 18)],
                                                  level=1), 65536,
                                  max_out=1 << 18)
        cuts += sum(not recs[k, 2:6].any() for k in range(1, len(recs)))
    assert cuts
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == data


@pytest.mark.parametrize("idx", [BS, plz4_tpu_torch.BLOCK_IDX_1MB],
                         ids=["64KB", "1MB"])
def test_device_reader_decodes_dictionary_frame(idx):
    frame = plz4_tpu_torch.compress(DATA, backend="native",
                                    block_size_idx=idx,
                                    dictionary=WINDOW_DICT)
    r = plz4_tpu_torch.Reader(io.BytesIO(frame), backend="device",
                              device="cpu", dictionary=WINDOW_DICT)
    assert r.read() == DATA


def test_batch_layer_errors_leak_no_buffers(monkeypatch):
    """Every staging buffer a batch takes goes back to the pool, also when
    result() raises ErrBlockHash or ErrDecompress; a block over the block
    size raises before anything is taken."""
    taken, given = [], []
    take, give = batch._pool.take, batch._pool.give
    monkeypatch.setattr(batch._pool, "take",
                        lambda *a: taken.append(take(*a)) or taken[-1])
    monkeypatch.setattr(batch._pool, "give",
                        lambda t: given.append(t) or give(t))
    errors = plz4_tpu_torch.errors
    with pytest.raises(errors.Lz4Error):
        batch.encode_blocks_begin([b"x" * 70000], 65536, device="cpu")
    assert not taken
    blocks = [b"abc" * 100, make_incompressible(3000, seed=7), b""]
    res = batch.encode_blocks_begin(blocks, 65536, device="cpu",
                                    with_checksums=True).result()
    assert [c for _, _, c in res] == [native.xxh32(s) for s, _, _ in res]
    stored = [(s, raw) for s, raw, _ in res]
    sums = [c for _, _, c in res]
    assert batch.decode_blocks_begin(stored, 65536, checksums=sums,
                                     device="cpu").result() == blocks
    for bad_sums, bad_stored, err in (
            ([sums[0] ^ 1] + sums[1:], stored, errors.ErrBlockHash),
            (sums[:1] + [sums[1] ^ 1] + sums[2:], stored, errors.ErrBlockHash),
            (sums, [(b"\x40" + stored[0][0][1:], False)] + stored[1:],
             errors.ErrDecompress)):
        if err is errors.ErrDecompress:
            bad_sums = [native.xxh32(bad_stored[0][0])] + sums[1:]
        p = batch.decode_blocks_begin(bad_stored, 65536, checksums=bad_sums,
                                      device="cpu")
        with pytest.raises(errors.Lz4Error) as ei:
            p.result()
        assert ei.value is err
    # (on the CPU the plain versions' outputs join the pool too)
    assert len(taken) > 0
    assert {id(t) for t in taken} <= {id(t) for t in given}


def test_reader_closed_with_a_batch_in_flight_returns_every_buffer(
        monkeypatch):
    """pending_size=2 makes 2-block batches, so read(1) leaves a read-ahead
    batch dispatched and unconsumed; close() discards it, and every staging
    buffer taken goes back to the pool, as does a whole read."""
    taken, given = [], []
    take, give = batch._pool.take, batch._pool.give
    monkeypatch.setattr(batch._pool, "take",
                        lambda *a: taken.append(take(*a)) or taken[-1])
    monkeypatch.setattr(batch._pool, "give",
                        lambda t: given.append(t) or give(t))
    data = make_compressible(300_000, seed=55)
    frame = plz4_tpu_torch.compress(data, backend="native", level=1,
                                    block_size_idx=BS)
    r = plz4_tpu_torch.Reader(io.BytesIO(frame), backend="device",
                              device="cpu", pending_size=2)
    r.read(1)
    assert r._device_pending, "the read must leave a batch in flight"
    r.close()
    assert taken
    assert {id(t) for t in taken} <= {id(t) for t in given}
    assert plz4_tpu_torch.decompress(frame, backend="device",
                                     device="cpu") == data
    assert {id(t) for t in taken} <= {id(t) for t in given}


def test_incompressible_fallback_and_empty_rows():
    blocks = [b"", make_incompressible(4096, seed=5), b"ab" * 2000, b"z"]
    res = batch.encode_blocks_begin(blocks, 65536, device="cpu").result()
    assert res[0] == (b"", True)
    assert res[1] == (blocks[1], True)
    assert res[2][1] is False and len(res[2][0]) < 4000
    assert res[3] == (b"z", True)
    dec = batch.decode_blocks_begin(res, 65536, device="cpu").result()
    assert dec == blocks


def test_device_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the refusal only applies without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        plz4_tpu_torch.Writer(io.BytesIO(), backend="device",
                              block_size_idx=BS)
    with pytest.raises(RuntimeError, match="CUDA"):
        plz4_tpu_torch.Reader(io.BytesIO(b""), backend="device")
