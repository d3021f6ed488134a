"""The port's main path as a whole: a 64 KiB level-1 device frame, and the
device options that the port covers or still refuses (the window paths'
frame parity is in test_torch_frame_window.py, the level ladder's in
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


@pytest.mark.parametrize("opts,item", [
    (dict(block_checksum=True), "item 7"),
], ids=["block_checksum"])
def test_uncovered_device_options_raise(opts, item):
    kw = dict(PORT) | opts
    with pytest.raises(NotImplementedError, match=item):
        plz4_tpu_torch.compress(DATA, **kw)


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


WINDOW_DICT = b"dictionary " * 20 + DATA[:3000]


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


@pytest.mark.parametrize("opts,item", [
    (dict(block_checksum=True), "item 7"),
], ids=["block_checksum"])
def test_device_reader_refuses_uncovered_frames(opts, item):
    frame = plz4_tpu_torch.compress(DATA, backend="native",
                                    **(dict(block_size_idx=BS) | opts))
    with pytest.raises(NotImplementedError, match=item):
        plz4_tpu_torch.decompress(frame, backend="device", device="cpu")


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


def test_batch_layer_refusals_leak_no_buffers():
    blocks = [b"abc" * 100]
    with pytest.raises(NotImplementedError, match="item 7"):
        batch.encode_blocks_begin(blocks, 65536, device="cpu",
                                  with_checksums=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        batch.decode_blocks_begin([(b"\x00", False)], 65536,
                                  checksums=[0], device="cpu")
    with pytest.raises(plz4_tpu_torch.errors.Lz4Error):
        batch.encode_blocks_begin([b"x" * 70000], 65536, device="cpu")


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
