"""Frames of linked 64 KiB blocks at K4's levels (9 and 12) through the
port's normal path on the CPU: plz4_tpu_torch.compress with
block_linked=True and backend="device" stages each block's window and
encodes it with K4's window variant (encode_batch_deep_window, its plain
version here). Each frame decodes through the benchmark's plain linked
reference (benchmark/lz4ref_linked.py) to its input, with sequences that
reach back into the blocks before them."""

import numpy as np
import pytest

import plz4_tpu_torch as plz4
from benchmark import lz4ref, lz4ref_linked
from plz4_tpu_torch.ops import encode_deep

from conftest import make_compressible, make_incompressible

N = 65536


def _payload(seed: int) -> bytes:
    """3-6 blocks of 64 KiB drawn from the seed, the last one short; with
    seed 2 the second block is incompressible (stored raw, and still the
    next block's window)."""
    rng = np.random.default_rng(seed)
    blocks = int(rng.integers(3, 7))
    n = (blocks - 1) * N + int(rng.integers(1000, N - 1000))
    data = bytearray(make_compressible(n, seed=100 + seed))
    if seed == 2:
        data[N:2 * N] = make_incompressible(N, seed=seed)
    return bytes(data)


@pytest.mark.parametrize("level", [9, 12])
@pytest.mark.parametrize("seed", [1, 2])
def test_linked_frame_decodes_through_the_reference(seed, level,
                                                    monkeypatch):
    data = _payload(seed)
    calls = []
    window = encode_deep.encode_batch_deep_window

    def spy(data, lens, *args, **kw):
        calls.append(data.shape[0])
        return window(data, lens, *args, **kw)

    monkeypatch.setattr(encode_deep, "encode_batch_deep_window", spy)
    frame = plz4.compress(data, backend="device", device="cpu", level=level,
                          block_size_idx=plz4.BLOCK_IDX_64KB,
                          block_linked=True, content_checksum=False)
    assert calls, "K4's window variant was not called"
    got, refs = lz4ref_linked.decode_frame(frame)
    assert got == data
    assert refs > 0
    faults, blocks, raws = lz4ref_linked.scan_frame(frame, data)
    assert faults == {"headers": 0, "words": 0}
    assert len(raws) == (seed == 2)
    judged = lz4ref_linked.judge([(0, *b) for b in blocks])
    assert sum(bad for _, bad, _ in judged) == 0
    assert sum(r for _, _, r in judged) == refs
    # judged alone, as independent blocks, the reaching sequences fail
    assert lz4ref.count_bad([b[:3] for b in blocks]) > 0
    assert plz4.decompress(frame) == data
