"""The structure behind tests/test_scaling_efficiency.py's scaling relation,
on meshes of 1, 2, 4 and 8 CPU entries: the batch layer splits a batch into
one slice per entry, balanced (each holds floor(n/m) or ceil(n/m) blocks),
runs each slice on its own entry, and stages no slice with the whole batch
(no replicated work, no lost shard axis).

The wall-clock relation itself (batch-layer efficiency against the raw
kernel's) is not asserted here: on CPU entries the plain versions run one
after another, and a timing assertion on a shared CPU would be noise. It is
measured on the GPU by tools/bench_scaling_torch.py and chip_smoke.py.
"""

import pytest
import torch

from plz4_tpu_torch.parallel import batch, use_mesh
from plz4_tpu_torch.parallel import mesh as mesh_mod

from conftest import make_compressible

BLOCK = 4096
PER_ENTRY_BLOCKS = 4


def _spy(monkeypatch):
    """Record each dispatch: (staged rows, device)."""
    calls = []
    real = batch._dispatch

    def spy(kernel, host_args, dev, extra=()):
        calls.append((host_args[0].shape[0], dev))
        return real(kernel, host_args, dev, extra)

    monkeypatch.setattr(batch, "_dispatch", spy)
    return calls


@pytest.mark.parametrize("extra", [0, 3], ids=["even", "uneven"])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_each_entry_encodes_its_own_slice(monkeypatch, m, extra):
    n = PER_ENTRY_BLOCKS * m + extra
    blocks = [make_compressible(BLOCK, seed=i) for i in range(n)]
    ref = batch.encode_blocks_begin(blocks, BLOCK, device="cpu").result()
    # one CPU device index per entry, so a slice's device names its entry
    mesh = mesh_mod.make_block_mesh([torch.device("cpu", k)
                                     for k in range(m)])
    seen = []
    real_begin = batch.encode_blocks_begin

    def begin(blocks_, *a, **kw):
        seen.append((len(blocks_), kw.get("device"),
                     mesh_mod.active_mesh()))
        return real_begin(blocks_, *a, **kw)

    monkeypatch.setattr(batch, "encode_blocks_begin", begin)
    calls = _spy(monkeypatch)
    with use_mesh(mesh):
        got = batch.encode_blocks_begin(blocks, BLOCK).result()
    assert got == ref
    top, slices = seen[0], seen[1:]
    assert top == (n, None, mesh)
    sizes = [k for k, _, _ in slices]
    assert sum(sizes) == n and len(slices) == m
    assert set(sizes) <= {n // m, -(-n // m)}
    # each slice on its own entry's device, with the mesh switched off
    assert [d for _, d, _ in slices] == [e.device for e in mesh.entries]
    assert all(active is None for _, _, active in slices)
    assert [d for _, d in calls] == [e.device for e in mesh.entries]
    # no entry stages the whole batch (rows are staged in powers of two)
    if m > 1:
        assert all(rows < n for rows, _ in calls), calls
    assert sum(rows for rows, _ in calls) < 2 * n + m


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_each_entry_decodes_its_own_slice(monkeypatch, m):
    n = PER_ENTRY_BLOCKS * m
    blocks = [make_compressible(BLOCK, seed=i) for i in range(n)]
    stored = batch.encode_blocks_begin(blocks, BLOCK, device="cpu").result()
    mesh = mesh_mod.make_block_mesh([torch.device("cpu", k)
                                     for k in range(m)])
    calls = _spy(monkeypatch)
    assert batch.decode_blocks_begin(stored, BLOCK,
                                     device=mesh).result() == blocks
    assert [d for _, d in calls] == [e.device for e in mesh.entries]
    assert [rows for rows, _ in calls] == [PER_ENTRY_BLOCKS] * m
