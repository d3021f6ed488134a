"""The port's block sharding in one process: meshes of CPU entries (the
kernels' plain versions), compared with the unsharded device frames.

Ports tests/test_dist.py (on an 8-entry CPU mesh) and
tests/test_device_backend.py's test_device_sharded_mesh, and holds every
sharded frame byte-identical to the unsharded frame of the same options
(tests/test_dist.py only asks that it decodes). A decode batch split over
a mesh raises what the whole batch raises, and a sharded batch gives back
every staging buffer it took.
"""

import functools
import io

import pytest

import plz4_tpu_torch as plz4
from plz4_tpu_torch import errors, native
from plz4_tpu_torch.parallel import batch, dist, use_mesh
from plz4_tpu_torch.parallel import mesh as mesh_mod

from conftest import make_compressible, make_incompressible


@pytest.fixture(scope="module")
def mesh():
    return dist.pod_mesh(["cpu"] * 8)


def test_pod_mesh_shape(mesh):
    assert mesh.size == 8
    assert mesh.axis_names == (mesh_mod.BLOCK_AXIS,)
    assert [e.rank for e in mesh.entries] == [0] * 8
    assert not mesh.multiprocess


def test_sharded_roundtrip(mesh):
    data = make_compressible(360_000, seed=70)
    comp = dist.compress_sharded(data, mesh, block_size_idx=4, device="cpu")
    assert dist.decompress_sharded(comp, mesh) == data


def test_sharded_matches_host(mesh):
    """The sharded device frame is a valid frame the host path decodes, and
    vice versa."""
    data = make_compressible(300_000, seed=71)
    comp_dev = dist.compress_sharded(data, mesh, block_size_idx=4,
                                     content_checksum=False)
    assert plz4.decompress(comp_dev) == data
    comp_host = plz4.compress(data, block_size_idx=4,
                              content_checksum=False)
    assert dist.decompress_sharded(comp_host, mesh) == data


def test_sharded_incompressible(mesh):
    data = make_incompressible(300_000)
    comp = dist.compress_sharded(data, mesh, block_size_idx=4)
    assert dist.decompress_sharded(comp, mesh) == data


def test_init_distributed_single_host_noop():
    dist.init_distributed()  # must not raise or require a coordinator
    dist.init_distributed(num_processes=1)


def test_device_sharded_mesh(mesh):
    """Blocks sharded across the CPU mesh through the public API; the mesh
    decides the devices, so no device="cpu" is passed."""
    data = make_compressible(300_000, seed=55)
    with use_mesh(mesh):
        comp = plz4.compress(data, backend="device", block_size_idx=4)
        out = plz4.decompress(comp, backend="device")
    assert out == data


# ---- sharded frames equal the unsharded frame ------------------------------

DATA = (make_compressible(200_000, seed=91)
        + make_incompressible(30_000, seed=92)
        + make_compressible(100_000, seed=93))
DICT = make_compressible(40_000, seed=94)
CONFIGS = {
    "64KB-l1-content-checksum": dict(block_size_idx=4, level=1,
                                     content_checksum=True),
    "256KB": dict(block_size_idx=5, level=1),
    "4MB": dict(block_size_idx=7, level=1),
    "dict-block-checksums": dict(block_size_idx=4, level=1, dictionary=DICT,
                                 block_checksum=True),
    "linked": dict(block_size_idx=4, level=1, block_linked=True),
    "l3": dict(block_size_idx=4, level=3),
    "l8": dict(block_size_idx=4, level=8),
    "l9": dict(block_size_idx=4, level=9),
}


@functools.lru_cache(maxsize=None)
def _unsharded(name: str) -> bytes:
    frame = plz4.compress(DATA, backend="device", device="cpu",
                          **CONFIGS[name])
    d = CONFIGS[name].get("dictionary")
    assert plz4.decompress(frame, backend="native", dictionary=d) == DATA
    return frame


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_sharded_frame_equals_unsharded_frame(name, size):
    mesh = mesh_mod.make_block_mesh(["cpu"] * size)
    d = CONFIGS[name].get("dictionary")
    got = dist.compress_sharded(DATA, mesh, **CONFIGS[name])
    assert got == _unsharded(name)
    assert dist.decompress_sharded(got, mesh, dictionary=d) == DATA


# ---- raise order and buffers -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stored(block_size: int, n: int = 6):
    """n checksummed blocks (of 64 KiB, or 80 KB in a 256 KiB frame; the
    last one raw) as the writer stores them: [(bytes, raw)], [checksum]."""
    size = min(block_size, 80_000)
    blocks = [make_compressible(size, seed=100 + i)
              for i in range(n - 1)] + [make_incompressible(size // 2)]
    res = batch.encode_blocks_begin(blocks, block_size, device="cpu",
                                    with_checksums=True).result()
    assert res[-1][1] and not any(raw for _, raw, _ in res[:-1])
    return [(s, raw) for s, raw, _ in res], [c for _, _, c in res]


def _corrupt(stored, sums, i: int, kind: str):
    """Block i with a bad checksum ("hash"), or a stream that does not
    decode under a checksum that matches it ("stream")."""
    stored, sums = list(stored), list(sums)
    if kind == "hash":
        sums[i] ^= 1
    else:
        bad = b"\xff" * 40
        stored[i], sums[i] = (bad, False), native.xxh32(bad)
    return stored, sums


def _raised(fn):
    try:
        fn().result()
    except errors.Lz4Error as e:
        return e
    return None


@pytest.mark.parametrize("block_size", [65536, 1 << 18], ids=["64KB", "256KB"])
@pytest.mark.parametrize("layout", [
    # (block, corruption) pairs: a bad stream in an early slice, a bad hash
    # in a later one; the reverse; a raw block's hash; one of each alone
    ((0, "stream"), (4, "hash")),
    ((0, "hash"), (4, "stream")),
    ((1, "stream"), (5, "hash")),
    ((2, "stream"),),
    ((5, "hash"),)])
@pytest.mark.parametrize("size", [2, 3, 6])
def test_sharded_decode_raises_what_the_batch_raises(block_size, layout,
                                                     size):
    stored, sums = _stored(block_size)
    for i, kind in layout:
        stored, sums = _corrupt(stored, sums, i, kind)
    want = _raised(lambda: batch.decode_blocks_begin(
        stored, block_size, checksums=sums, device="cpu"))
    mesh = mesh_mod.make_block_mesh(["cpu"] * size)
    got = _raised(lambda: batch.decode_blocks_begin(
        stored, block_size, checksums=sums, device=mesh))
    assert want is not None and got is want
    if block_size == 65536 and any(k == "hash" for _, k in layout):
        assert want is errors.ErrBlockHash  # before ErrDecompress


def _count_pool(monkeypatch):
    taken, given = [], []
    take, give = batch._pool.take, batch._pool.give
    monkeypatch.setattr(batch._pool, "take",
                        lambda *a: taken.append(take(*a)) or taken[-1])
    monkeypatch.setattr(batch._pool, "give",
                        lambda t: given.append(t) or give(t))
    return taken, given


@pytest.mark.parametrize("block_size", [65536, 1 << 18], ids=["64KB", "256KB"])
def test_sharded_batches_return_every_buffer(monkeypatch, block_size):
    """A sharded batch discarded in flight, one whose result() raises in a
    slice, and a Reader closed with a sharded batch in flight give back
    every staging buffer they took."""
    stored, sums = _stored(block_size)
    taken, given = _count_pool(monkeypatch)
    mesh = mesh_mod.make_block_mesh(["cpu"] * 3)
    blocks = [make_compressible(block_size, seed=7 + i) for i in range(5)]
    batch.encode_blocks_begin(blocks, block_size, device=mesh).discard()
    batch.decode_blocks_begin(stored, block_size, checksums=sums,
                              device=mesh).discard()
    bad, bad_sums = _corrupt(stored, sums, 0, "stream")
    p = batch.decode_blocks_begin(bad, block_size, checksums=bad_sums,
                                  device=mesh)
    with pytest.raises(errors.Lz4Error):
        p.result()
    frame = plz4.compress(DATA, backend="native", block_size_idx=4)
    with use_mesh(mesh):
        r = plz4.Reader(io.BytesIO(frame), backend="device", pending_size=2)
        r.read(1)
        assert r._device_pending, "the read must leave a batch in flight"
        r.close()
    assert taken
    assert {id(t) for t in taken} <= {id(t) for t in given}


def test_explicit_device_overrides_the_active_mesh(monkeypatch):
    """A batch given a device runs unsharded under an active mesh (the
    slices themselves are such batches)."""
    calls = []
    real = batch._sharded
    monkeypatch.setattr(batch, "_sharded",
                        lambda *a: calls.append(a[1]) or real(*a))
    blocks = [make_compressible(4096, seed=i) for i in range(5)]
    with use_mesh(mesh_mod.make_block_mesh(["cpu"] * 2)):
        ref = batch.encode_blocks_begin(blocks, 65536, device="cpu").result()
        assert calls == []
        assert batch.encode_blocks_begin(blocks, 65536).result() == ref
    assert calls == [5]


def test_oversized_blocks_raise_before_sharding():
    mesh = mesh_mod.make_block_mesh(["cpu"] * 2)
    with pytest.raises(errors.Lz4Error) as ei:
        batch.encode_blocks_begin([b"a", b"x" * 70000], 65536, device=mesh)
    assert ei.value is errors.ErrSrcSize
    with pytest.raises(errors.Lz4Error) as ei:
        batch.decode_blocks_begin([(b"a", True), (b"x" * 70000, False)],
                                  65536, device=mesh)
    assert ei.value is errors.ErrBlockSizeOverflow


@pytest.mark.parametrize("n,m", [(0, 1), (1, 4), (5, 2), (7, 3), (8, 8),
                                 (9, 4), (130, 8)])
def test_shard_bounds_balance_as_array_split(n, m):
    import numpy as np

    mesh = mesh_mod.make_block_mesh(["cpu"] * m)
    want = [(int(s[0]), int(s[-1]) + 1) if len(s) else None
            for s in np.array_split(np.arange(n), m)]
    got = mesh_mod.shard_bounds(n, mesh)
    assert [b if b[1] > b[0] else None for b in got] == want
    assert got[0][0] == 0 and got[-1][1] == n
    assert mesh_mod.pad_batch_for_mesh(n, mesh) % m == 0
