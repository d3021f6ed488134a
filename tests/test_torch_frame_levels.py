"""The port's device level ladder as a whole: frames at levels 3-12 (the
depth-2 chain K2c at 3-7, the depth-4 chain K2d at 8, the deep hash-chain
finder K4 at 9-12) at 64 KiB blocks, at 256 KiB blocks (64 KiB chunk rows),
with linked blocks (at levels 6, 9 and 12: K4's window rows at the last two)
and with a dictionary. Levels that share a kernel with a
level held to the reference here (4-7 with 3; 10 and 11 with 9 and 12, at
other walk budgets) are pinned by the batch layer's routing and by the
kernel parity files (test_torch_encode_mid.py, test_torch_encode_deep.py).

The reference frames come from the JAX package's real Pallas path, run on
the CPU in interpret mode (monkeypatched here; no JAX file changes), with
its jitted batch functions cleared around each test as in
test_torch_frame_window.py. The port's device frames, from the kernels'
plain versions on device="cpu", must be byte-identical to them, each
package's device decoder must read the other's frame, and the native codec
must read both.
"""

import functools

import pytest

import plz4_tpu
import plz4_tpu_torch
from plz4_tpu.ops import decode_pallas, encode_pallas
from plz4_tpu.parallel import batch as tpu_batch
from plz4_tpu.parallel import large as tpu_large
from plz4_tpu_torch.ops import encode, encode_deep, encode_mid
from plz4_tpu_torch.parallel import batch

from conftest import make_compressible, make_incompressible

KB64 = plz4_tpu_torch.BLOCK_IDX_64KB
KB256 = plz4_tpu_torch.BLOCK_IDX_256KB
# text with an incompressible stretch: four 64 KiB blocks (one of them
# stored raw), or one 256 KiB-class block of four chunk rows
DATA = (make_compressible(110000, seed=81)
        + make_incompressible(30000, seed=82)
        + make_compressible(60000, seed=83))
DICT = make_compressible(50000, seed=84)

CASES = {f"l{lv}": dict(level=lv, block_size_idx=KB64)
         for lv in (3, 8, 9, 12)}
CASES |= {
    "256KB-l8": dict(level=8, block_size_idx=KB256),
    "256KB-l9": dict(level=9, block_size_idx=KB256),
    "linked-l6": dict(level=6, block_size_idx=KB64, block_linked=True),
    "linked-l9": dict(level=9, block_size_idx=KB64, block_linked=True),
    "linked-l12": dict(level=12, block_size_idx=KB64, block_linked=True),
    "dict-l9": dict(level=9, block_size_idx=KB64, dictionary=DICT),
}
DICTS = {name: kw.get("dictionary") for name, kw in CASES.items()}

_PATCHED = [(encode_pallas, "encode_batch_pallas"),
            (encode_pallas, "encode_batch_pallas_dict"),
            (encode_pallas, "encode_batch_pallas_mid"),
            (encode_pallas, "encode_batch_pallas_mid_dict"),
            (encode_pallas, "encode_batch_pallas_deep"),
            (encode_pallas, "encode_batch_pallas_deep_dict"),
            (decode_pallas, "decode_batch_pallas"),
            (decode_pallas, "decode_block_pallas_dict"),
            (decode_pallas, "decode_chunks_batch_pallas")]
_JITTED = (tpu_large._encode_large_batch, tpu_large._decode_large_batch,
           tpu_batch._decode_batch_dict_pallas)


@pytest.fixture
def pallas_path(monkeypatch):
    """Route plz4_tpu's device backend through its Pallas kernels in
    interpret mode."""
    monkeypatch.setattr(tpu_batch, "_use_pallas", lambda: True)
    for mod, name in _PATCHED:
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))
    for f in _JITTED:
        f.clear_cache()
    yield
    for f in _JITTED:
        f.clear_cache()


@functools.lru_cache(maxsize=None)
def _port_frame(name: str) -> bytes:
    kw = CASES.get(name) or dict(level=int(name[1:]), block_size_idx=KB64)
    return plz4_tpu_torch.compress(DATA, backend="device", device="cpu",
                                   **kw)


@functools.lru_cache(maxsize=None)
def _tpu_frame(name: str) -> bytes:
    """Called only under the pallas_path fixture."""
    return plz4_tpu.compress(DATA, backend="device", **CASES[name])


@pytest.mark.parametrize("name", list(CASES))
def test_frame_byte_identical_to_pallas_path(pallas_path, name):
    got = _port_frame(name)
    assert got == _tpu_frame(name)
    assert len(got) < len(DATA)


@pytest.mark.parametrize("name", list(CASES))
def test_cross_decoding(pallas_path, monkeypatch, name):
    port, d = _port_frame(name), DICTS[name]
    if CASES[name]["block_size_idx"] != KB64:
        # large blocks: the JAX package's device decoder on its CPU route
        # (its Pallas K5 decodes some records wrongly; see
        # test_torch_decode_window.py)
        monkeypatch.setattr(tpu_batch, "_use_pallas", lambda: False)
    assert plz4_tpu.decompress(port, backend="device", dictionary=d) == DATA
    assert plz4_tpu.decompress(port, backend="native", dictionary=d) == DATA
    assert plz4_tpu_torch.decompress(port, backend="native",
                                     dictionary=d) == DATA
    assert plz4_tpu_torch.decompress(_tpu_frame(name), backend="device",
                                     device="cpu", dictionary=d) == DATA


def test_frame_sizes_follow_the_ladder():
    """Greedy (level 1), depth 2, depth 4 and deep frames shrink in that
    order; wider walk budgets never grow them; levels 3-7 share a kernel."""
    level1 = plz4_tpu_torch.compress(DATA, backend="device", device="cpu",
                                     level=1, block_size_idx=KB64)
    sizes = [len(level1)] + [len(_port_frame(f"l{lv}"))
                             for lv in (3, 8, 9, 10, 11, 12)]
    assert sizes[0] > sizes[1] > sizes[2] > sizes[3], sizes
    assert sizes[3] >= sizes[4] >= sizes[5] >= sizes[6], sizes
    assert len({len(_port_frame(f"l{lv}")) for lv in range(3, 8)}) == 1


def test_level_ladder_band_against_native_levels():
    """The ladder's sizes against the native levels, as the JAX package's
    device level test pins them: greedy tracks native level 1, the depth-2
    chain lands between native levels 2 and 1 and well above native level
    12, and the deep finder at walk budget 32 never beats native level 12;
    every block decodes through the native codec. A device level-12 frame
    is never smaller than the native level-12 frame."""
    from plz4_tpu_torch import native

    data = make_compressible(8000, seed=41)
    size = {}
    for lv in (1, 3, 8, 9, 12):
        blk = encode.encode_block_host(data, lv, device="cpu")
        assert native.decompress(blk, len(data)) == data
        size[lv] = len(blk)
    n1, n2, n12 = (len(native.compress(data, level=lv)) for lv in (1, 2, 12))
    assert abs(size[1] - n1) <= n1 * 0.02, (size[1], n1)
    assert n2 < size[3] < n1, (n2, size[3], n1)
    assert size[3] > n12 * 1.1, (size[3], n12)
    assert n12 <= size[12], (n12, size[12])
    frame12 = plz4_tpu_torch.compress(DATA, backend="native", level=12,
                                      block_size_idx=KB64)
    assert len(_port_frame("l12")) >= len(frame12)


@pytest.mark.parametrize("level,kernel", [
    (3, "K2c"), (5, "K2c"), (7, "K2c"), (8, "K2d"), (9, "K4"), (10, "K4"),
    (11, "K4"), (12, "K4")])
@pytest.mark.parametrize("window", [False, True], ids=["plain", "window"])
def test_batch_layer_routes_levels_to_their_kernel(level, kernel, window,
                                                   monkeypatch):
    """The batch layer's ladder: every level reaches its kernel's wrapper
    with its depth or walk budget, and no other encode wrapper."""
    calls = []

    def spy(mod, fn, tag):
        real = getattr(mod, fn)

        def wrapped(*args, **kw):
            calls.append((tag, kw.get("depth4"), kw.get("tries")))
            return real(*args, **kw)
        monkeypatch.setattr(mod, fn, wrapped)

    for mod, fn, tag in [(encode, "encode_batch", "K2a"),
                         (encode, "encode_batch_window", "K2b"),
                         (encode_mid, "encode_batch_mid", "K2c"),
                         (encode_mid, "encode_batch_mid_window", "K2c"),
                         (encode_deep, "encode_batch_deep", "K4"),
                         (encode_deep, "encode_batch_deep_window", "K4")]:
        spy(mod, fn, tag)
    blocks = [DATA[:5000], DATA[5000:9000]]
    res = batch.encode_blocks_begin(
        blocks, 65536, level=level, device="cpu",
        dicts=[DICT, b"x" * 10] if window else None).result()
    assert all(not raw for _, raw in res)
    if kernel == "K4":
        want = ("K4", None, batch._DEEP_TRIES[level])
    else:
        want = ("K2c", kernel == "K2d", None)
    assert calls == [want]
