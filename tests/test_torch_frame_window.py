"""The port's window paths as a whole: device frames at 256 KiB, 1 MiB and
4 MiB blocks (64 KiB chunks through K2b, records through K5), with a
dictionary (K2b, K3) and with linked blocks (K2b).

The reference frames come from the JAX package's real Pallas path, run on
the CPU in interpret mode (monkeypatched here; no JAX file changes). Its
jitted batch functions are cleared around each test, so that a trace made
earlier in the worker on the XLA array path is not reused. The port's
device frames, from the kernels' plain versions on device="cpu", must be
byte-identical to the reference frames, each package's device decoder must
read the other's frame, and the native codec must read both.
"""

import functools

import pytest

import plz4_tpu
import plz4_tpu_torch
from plz4_tpu.ops import decode_pallas, encode_pallas
from plz4_tpu.parallel import batch as tpu_batch
from plz4_tpu.parallel import large as tpu_large
from plz4_tpu_torch.ops import decode, encode
from plz4_tpu_torch.parallel import large

from conftest import make_compressible, make_incompressible

KB256 = plz4_tpu_torch.BLOCK_IDX_256KB
KB64 = plz4_tpu_torch.BLOCK_IDX_64KB
# two 256 KiB blocks (the second partly incompressible) and a 30000-byte
# tail block, which takes the small path
DATA = (make_compressible(412144, seed=61) + make_incompressible(40000, seed=62)
        + make_compressible(102144, seed=63))
DICT = make_compressible(50000, seed=64)

CASES = {
    "256KB": dict(block_size_idx=KB256),
    "1MB": dict(block_size_idx=plz4_tpu_torch.BLOCK_IDX_1MB),
    "4MB": dict(),
    "256KB-dict": dict(block_size_idx=KB256, dictionary=DICT),
    "256KB-linked": dict(block_size_idx=KB256, block_linked=True),
    "dict": dict(block_size_idx=KB64, dictionary=DICT),
    "linked": dict(block_size_idx=KB64, block_linked=True),
}
DICTS = {name: kw.get("dictionary") for name, kw in CASES.items()}

_JITTED = (tpu_large._encode_large_batch, tpu_large._decode_large_batch,
           tpu_batch._decode_batch_dict_pallas)


@pytest.fixture
def pallas_path(monkeypatch):
    """Route plz4_tpu's device backend through its Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(tpu_batch, "_use_pallas", lambda: True)
    for mod, name in [(encode_pallas, "encode_batch_pallas"),
                      (encode_pallas, "encode_batch_pallas_dict"),
                      (decode_pallas, "decode_batch_pallas"),
                      (decode_pallas, "decode_block_pallas_dict"),
                      (decode_pallas, "decode_chunks_batch_pallas")]:
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))
    for f in _JITTED:
        f.clear_cache()
    yield
    for f in _JITTED:
        f.clear_cache()


@functools.lru_cache(maxsize=None)
def _port_frame(name: str) -> bytes:
    return plz4_tpu_torch.compress(DATA, backend="device", device="cpu",
                                   level=1, **CASES[name])


@functools.lru_cache(maxsize=None)
def _tpu_frame(name: str) -> bytes:
    """Called only under the pallas_path fixture."""
    return plz4_tpu.compress(DATA, backend="device", level=1, **CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_frame_byte_identical_to_pallas_path(pallas_path, name):
    got = _port_frame(name)
    assert got == _tpu_frame(name)
    assert len(got) < len(DATA)


@pytest.mark.parametrize("name", list(CASES))
def test_cross_decoding(pallas_path, monkeypatch, name):
    port, d = _port_frame(name), DICTS[name]
    if CASES[name].get("block_size_idx") != KB64:
        # large blocks: the JAX package's device decoder on its CPU route
        # (multi-record blocks on the host codec). Its Pallas K5 kernel
        # decodes one record of the 256 KiB frame wrongly (see
        # test_torch_decode_window.py, start-of-record overlap).
        monkeypatch.setattr(tpu_batch, "_use_pallas", lambda: False)
    assert plz4_tpu.decompress(port, backend="device", dictionary=d) == DATA
    assert plz4_tpu.decompress(port, backend="native", dictionary=d) == DATA
    assert plz4_tpu_torch.decompress(port, backend="native",
                                     dictionary=d) == DATA
    assert plz4_tpu_torch.decompress(_tpu_frame(name), backend="device",
                                     device="cpu", dictionary=d) == DATA


@pytest.mark.parametrize("name", ["256KB", "4MB", "256KB-dict"])
def test_large_frames_run_the_window_kernels(name, monkeypatch):
    """The port's large-block frames go through K2b as grouped chunk rows
    (wstride 2) and through K5 as records, never through the host valve."""
    calls = []

    def spy(fn, tag):
        def wrapped(*args, **kw):
            calls.append((tag, args[0].shape, args[4:]))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(encode, "encode_batch_window",
                        spy(encode.encode_batch_window, "K2b"))
    monkeypatch.setattr(decode, "decode_records_batch",
                        spy(decode.decode_records_batch, "K5"))
    valve = large.host_decodes
    frame = plz4_tpu_torch.compress(DATA, backend="device", device="cpu",
                                    level=1, **CASES[name])
    assert plz4_tpu_torch.decompress(frame, backend="device", device="cpu",
                                     dictionary=DICTS[name]) == DATA
    # 256 KiB: two large blocks of 4 chunks (the tail block is small); 4
    # MiB: the whole payload is one block of a 64-chunk class
    B, K = (1, 64) if name == "4MB" else (2, 4)
    assert ("K2b", (B * K, large.CHUNK), (large.CHUNK_WSTRIDE, K)) in calls
    assert [c[1] for c in calls if c[0] == "K5"] == [
        (B, K + 1, large.CHUNK_IN)]
    assert large.host_decodes == valve
