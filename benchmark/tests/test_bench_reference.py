"""The plain reference: it agrees with the format on valid streams, and it
rejects a corrupted frame and a corrupted row."""

import numpy as np
import pytest

from benchmark import corpus, lz4ref

BLOCK_IDX = 4  # 64 KiB


@pytest.fixture(scope="module")
def payload():
    return corpus.silesia_bulk(3 * 65536 + 777, seed=11)


def test_generator_draws_every_segment_kind(payload):
    assert len(payload) == 3 * 65536 + 777
    assert payload == corpus.silesia_bulk(len(payload), seed=11)
    assert payload != corpus.silesia_bulk(len(payload), seed=12)
    big = corpus.silesia_bulk(1 << 20, seed=11)
    assert big.startswith(payload[:65536])
    assert b" svc[" in big and b" ok\n2026-08-" in big  # records
    assert b". The " in big or b". A " in big  # text
    assert b"\0" * 64 in big  # sparse binary
    assert any(len(set(big[i:i + 4096])) > 200  # incompressible
               for i in range(0, len(big), 4096))


def test_xxh32_and_header():
    from plz4_tpu_torch import native

    data = bytes(range(256)) * 3
    for n in (0, 1, 15, 16, 17, 100, 768):
        assert lz4ref.xxh32(data[:n]) == native.xxh32(data[:n])
        assert lz4ref.xxh32(data[:n], 7) == native.xxh32(data[:n], 7)


@pytest.mark.parametrize("level", [1, 12])
def test_programs_frames_pass(payload, level):
    import plz4_tpu_torch as plz4

    frame = plz4.compress(payload, backend="device", device="cpu",
                          level=level, block_size_idx=BLOCK_IDX,
                          content_checksum=False)
    faults, blocks, raws = lz4ref.scan_frame(frame, payload, BLOCK_IDX)
    assert faults == {"headers": 0, "words": 0}
    assert len(blocks) == 4 and lz4ref.count_bad(blocks) == 0
    assert raws == []


def test_own_encoder_round_trips(payload):
    import plz4_tpu_torch as plz4

    frame = lz4ref.compress_frame(payload, BLOCK_IDX)
    assert plz4.decompress(frame) == payload
    faults, blocks, raws = lz4ref.scan_frame(frame, payload, BLOCK_IDX)
    assert faults == {"headers": 0, "words": 0}
    assert lz4ref.count_bad(blocks) == 0 and raws == []
    for n in (0, 1, 12, 13, 64):
        blk = payload[:n]
        assert lz4ref.decode_block(lz4ref.encode_block(blk), 64) == blk


def _flip(b: bytes, at: int) -> bytes:
    return b[:at] + bytes([b[at] ^ 0x55]) + b[at + 1:]


def _raw_first(frame: bytes, payload: bytes) -> bytes:
    """The frame with its first block stored raw: well formed, but a block
    that compresses given up on."""
    first = int.from_bytes(frame[7:11], "little")
    word = (65536 | lz4ref.RAW_FLAG).to_bytes(4, "little")
    return frame[:7] + word + payload[:65536] + frame[11 + first:]


@pytest.mark.parametrize("part", ["magic", "flg", "hc", "size_word",
                                  "block", "end_mark", "trailing",
                                  "truncated", "raw_block"])
def test_rejects_corrupted_frame(payload, part):
    frame = lz4ref.compress_frame(payload, BLOCK_IDX)
    first = int.from_bytes(frame[7:11], "little")
    bad = {"magic": lambda: _flip(frame, 0), "flg": lambda: _flip(frame, 4),
           "hc": lambda: _flip(frame, 6),
           "size_word": lambda: _flip(frame, 8),
           "block": lambda: _flip(frame, 11 + first // 2),
           "end_mark": lambda: frame[:-4] + b"\x01\0\0\0",
           "trailing": lambda: frame + b"\0",
           "truncated": lambda: frame[:-5],
           "raw_block": lambda: _raw_first(frame, payload)}[part]()
    faults, blocks, raws = lz4ref.scan_frame(bad, payload, BLOCK_IDX)
    assert (sum(faults.values()) + lz4ref.count_bad(blocks)
            + lz4ref.count_shrinkable(raws)) > 0


def test_raw_blocks_are_judged(payload):
    """A raw block of data that compresses counts; one of noise does not."""
    bad = _raw_first(lz4ref.compress_frame(payload, BLOCK_IDX), payload)
    faults, blocks, raws = lz4ref.scan_frame(bad, payload, BLOCK_IDX)
    assert faults == {"headers": 0, "words": 0}
    assert lz4ref.count_bad(blocks) == 0
    assert raws == [payload[:65536]] and lz4ref.count_shrinkable(raws) == 1
    noise = np.random.default_rng(5).integers(0, 256, 65536, np.uint8)
    assert lz4ref.count_shrinkable([noise.tobytes()]) == 0


def test_rejects_corrupted_row(payload):
    row = payload[:65536]
    good = lz4ref.encode_block(row)
    assert lz4ref.count_bad([(good, row, 65536)]) == 0
    rows = [_flip(good, k) for k in (0, 1, len(good) // 3, len(good) - 1)]
    rows += [good[:-1], good + b"\0", good[:len(good) // 2]]
    assert lz4ref.count_bad([(r, row, 65536) for r in rows]) == len(rows)


@pytest.mark.parametrize("stream, why", [
    (bytes([0x10, 0x61, 0x01, 0x00]), "match after the last literals"),
    (bytes([0x00, 0x05, 0x00, 0x00]), "offset before the block"),
    (bytes([0x1F, 0x61, 0x01, 0x00, 0xFF]), "length past the stream"),
    (b"", "empty stream"),
])
def test_rejects_bad_streams(stream, why):
    with pytest.raises(lz4ref.RefError):
        lz4ref.decode_block(stream, 1 << 16)


def test_rejects_match_near_the_end():
    # 'abcd' then a 4-byte match and 4 literals: the last 5 bytes are not
    # all literals
    stream = bytes([0x40]) + b"abcd" + bytes([4, 0, 0x40]) + b"wxyz"
    with pytest.raises(lz4ref.RefError):
        lz4ref.decode_block(stream, 64)
    ok = bytes([0x40]) + b"abcd" + bytes([4, 0, 0x80]) + b"stuvwxyz"
    assert lz4ref.decode_block(ok, 64) == b"abcdabcdstuvwxyz"


def test_rows_of_the_chunk_layout(payload):
    rows = [payload[i:i + 65536] for i in range(0, len(payload), 65536)]
    items = [(lz4ref.encode_block(r), r, 65536) for r in rows]
    assert lz4ref.count_bad(items) == 0
    items[1] = (items[0][0], rows[1], 65536)
    assert lz4ref.count_bad(items) == 1
    assert np.sum([len(s) for s, _, _ in items]) > 0
