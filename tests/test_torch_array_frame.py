"""The array path through the frame engines (Options.array_path) on the CPU.

Off the TPU the JAX package's device backend runs its XLA array codec, so
plz4_tpu.compress(data, backend="device") must equal
plz4_tpu_torch.compress(data, backend="device", device="cpu",
array_path=True) byte for byte, and each frame must decode through either
package. Then the array rows of the JAX package's cross-implementation
matrix, over the port's codecs: A1, A2, native and the K2a/K1 plain
versions. And the routes: with array_path no encode or decode kernel
wrapper is called, block checksums stay on K7, and large blocks of several
records decode on the host.
"""

import pytest

import plz4_tpu
import plz4_tpu_torch
from plz4_tpu_torch import native
from plz4_tpu_torch.ops import decode, decode_array, encode, encode_array
from plz4_tpu_torch.ops import encode_deep, encode_mid, xxh32
from plz4_tpu_torch.parallel import large

from conftest import make_compressible, make_incompressible

DATA = (make_compressible(90_000, seed=70) + make_incompressible(3000, seed=71)
        + b"\x00" * 9000 + make_compressible(50_000, seed=72))
DICT = make_compressible(6000, seed=73)
B64, B256, B4M = (plz4_tpu_torch.BLOCK_IDX_64KB, plz4_tpu_torch.BLOCK_IDX_256KB,
                  plz4_tpu_torch.BLOCK_IDX_4MB)

CASES = {
    "64k": dict(block_size_idx=B64),
    "4m": dict(block_size_idx=B4M),
    "64k-dict": dict(block_size_idx=B64, dictionary=DICT),
    "64k-linked": dict(block_size_idx=B64, block_linked=True),
    "64k-checksums": dict(block_size_idx=B64, block_checksum=True),
    "256k-l9-checksums": dict(block_size_idx=B256, level=9,
                              block_checksum=True),
    "64k-l3-linked-dict": dict(block_size_idx=B64, level=3,
                               block_linked=True, dictionary=DICT),
}


def _port(data, **kw):
    return plz4_tpu_torch.compress(data, backend="device", device="cpu",
                                   array_path=True, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_array_frame_equals_the_jax_device_frame(case):
    kw = CASES[case]
    frame = _port(DATA, **kw)
    assert frame == plz4_tpu.compress(DATA, backend="device", **kw)
    d = kw.get("dictionary")
    assert plz4_tpu.decompress(frame, backend="device", dictionary=d) == DATA
    assert plz4_tpu_torch.decompress(frame, backend="device", device="cpu",
                                      array_path=True, dictionary=d) == DATA
    assert plz4_tpu_torch.decompress(frame, backend="native",
                                     dictionary=d) == DATA


def test_array_path_is_off_by_default():
    assert plz4_tpu_torch.Options().array_path is False
    kw = dict(block_size_idx=B64, backend="device", device="cpu")
    kernels = plz4_tpu_torch.compress(DATA, **kw)
    assert kernels == plz4_tpu_torch.compress(DATA, array_path=False, **kw)
    assert kernels != _port(DATA, block_size_idx=B64)


@pytest.mark.parametrize("backend", ["auto", "native"])
def test_array_path_needs_the_device_backend(backend):
    # the option would do nothing on the host codec, so it is refused
    with pytest.raises(ValueError, match="array_path"):
        plz4_tpu_torch.Options(backend=backend, array_path=True)
    with pytest.raises(ValueError, match="array_path"):
        plz4_tpu_torch.compress(DATA, backend=backend, array_path=True)


@pytest.fixture
def no_kernels(monkeypatch):
    """Every encode and decode kernel wrapper raises if called."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran on the array path")

    for mod, names in ((encode, ("encode_batch", "encode_batch_window")),
                       (encode_mid, ("encode_batch_mid",
                                     "encode_batch_mid_window")),
                       (encode_deep, ("encode_batch_deep",
                                      "encode_batch_deep_window")),
                       (decode, ("decode_batch", "decode_batch_dict",
                                 "decode_records_batch"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("case", ["64k", "4m", "64k-dict", "64k-checksums"])
def test_array_path_calls_no_kernel_wrapper(no_kernels, case):
    kw = CASES[case]
    frame = _port(DATA, **kw)
    assert plz4_tpu_torch.decompress(
        frame, backend="device", device="cpu", array_path=True,
        dictionary=kw.get("dictionary")) == DATA


def test_array_path_checksums_stay_on_k7(monkeypatch):
    calls = []
    real = xxh32.xxh32_batch

    def spy(data, lens, *a):
        calls.append(data.shape[0])
        return real(data, lens, *a)

    monkeypatch.setattr(xxh32, "xxh32_batch", spy)
    frame = _port(DATA, block_size_idx=B64, block_checksum=True)
    assert len(calls) == 2  # compressed candidates and raw rows
    assert plz4_tpu_torch.decompress(frame, backend="device", device="cpu",
                                     array_path=True) == DATA
    assert len(calls) == 3


def test_array_path_decodes_large_blocks_on_the_host():
    frame = _port(DATA, block_size_idx=B4M)
    before = large.host_decodes, large.array_host_decodes
    assert plz4_tpu_torch.decompress(frame, backend="device", device="cpu",
                                     array_path=True) == DATA
    # one 4 MiB block, many records; the valve's count stays as it was
    assert (large.host_decodes, large.array_host_decodes) == (
        before[0], before[1] + 1)


def test_array_path_over_a_mesh_equals_unsharded():
    from plz4_tpu_torch.parallel import dist, mesh as mesh_mod

    m = mesh_mod.make_block_mesh(["cpu"] * 3)
    kw = dict(block_size_idx=B64, level=1, array_path=True,
              block_checksum=True)
    frame = dist.compress_sharded(DATA, m, **kw)
    assert frame == _port(DATA, block_size_idx=B64, block_checksum=True)
    assert dist.decompress_sharded(frame, m, array_path=True) == DATA


# --- cross-implementation matrix (the array rows) ---------------------------

CORPUS = [
    ("text", make_compressible(6000, seed=90)),
    ("zeros", b"\x00" * 4000),
    ("period5", (make_incompressible(5, seed=91) * 1000)[:5000]),
    ("mixed", make_compressible(2000, seed=92)
     + make_incompressible(500, seed=93) + b"Z" * 800),
]

ENCODERS = {
    "native-l1": lambda d: native.compress(d, level=1),
    "native-l9": lambda d: native.compress(d, level=9),
    "native-l12": lambda d: native.compress(d, level=12),
    "array-l1": lambda d: encode_array.encode_block_host(d, device="cpu")
    or d,
    "array-l9": lambda d: encode_array.encode_block_host(d, 9, device="cpu")
    or d,
    "k2a-plain": lambda d: encode.encode_block_host(d, device="cpu") or d,
}

DECODERS = {
    "native": lambda c, n: native.decompress(c, n),
    "array": lambda c, n: decode_array.decode_block_host(
        c, out_cap=max(n, 16), device="cpu"),
    "k1-plain": lambda c, n: decode.decode_block_host(
        c, out_cap=max(n, 16), device="cpu"),
}


@pytest.mark.parametrize("enc_name", sorted(ENCODERS))
@pytest.mark.parametrize("corpus_name,data", CORPUS,
                         ids=[c[0] for c in CORPUS])
def test_matrix(enc_name, corpus_name, data):
    comp = ENCODERS[enc_name](data)
    assert comp != data  # every corpus entry compresses
    for dec_name, dec in DECODERS.items():
        out = dec(comp, len(data))
        assert out == data, f"{enc_name} -> {dec_name} mismatch"
