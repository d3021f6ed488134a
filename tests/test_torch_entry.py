"""The port's entry points (plz4_tpu_torch/entry.py) on the CPU,
against the JAX package's __graft_entry__.py on JAX's CPU, and the device
example.

The JAX step runs the array path (encode_jax / decode_jax): entry_array()
runs the port's array path (A1 / A2), so its totals, compressible flags
and validity flag must equal the JAX step's exactly. entry() runs the
kernels, whose parse differs from the array path's, so its `totals`
differ; its `compressible` flags, its round trip and its validity flag
must be equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from plz4_tpu_torch import entry, native
from plz4_tpu_torch.parallel import mesh as mesh_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_step_matches_the_jax_entry():
    step, (data, lens) = entry.entry(device="cpu")
    assert data.device.type == "cpu" and data.shape == (4, entry.BLOCK)
    totals, compressible, flag = step(data, lens)
    jstep, jargs = graft.entry()
    jtotals, jcompressible, jflag = (np.asarray(x) for x in jstep(*jargs))
    # the same example batch
    assert (data.numpy() == np.asarray(jargs[0])).all()
    assert (lens.numpy() == np.asarray(jargs[1])).all()
    assert bool(flag) and bool(jflag)
    assert (compressible.numpy() == jcompressible).all()
    # the round trip: each row's encoded stream decodes to the row
    out, tot, _ = entry.batch_mod.dispatch_encode(data, lens, 1)
    assert (tot == totals).all()
    for i in range(4):
        row = bytes(data[i].numpy())
        assert native.decompress(out[i, :int(tot[i])].numpy().tobytes(),
                                 len(row)) == row
    *_, dec, n_out, ok, good = entry._round_trip(data, lens)
    assert (dec.numpy() == data.numpy()).all() and bool(good.all())


def test_entry_array_step_equals_the_jax_entry():
    step, (data, lens) = entry.entry_array(device="cpu")
    assert data.device.type == "cpu" and data.shape == (4, entry.BLOCK)
    totals, compressible, flag = step(data, lens)
    jstep, jargs = graft.entry()
    jtotals, jcompressible, jflag = (np.asarray(x) for x in jstep(*jargs))
    assert (data.numpy() == np.asarray(jargs[0])).all()
    assert (lens.numpy() == np.asarray(jargs[1])).all()
    assert totals.dtype == torch.int32 and (totals.numpy() == jtotals).all()
    assert (compressible.numpy() == jcompressible).all()
    assert bool(flag) == bool(jflag) is True


def test_entry_array_step_flags_a_row_that_does_not_come_back(monkeypatch):
    step, (data, lens) = entry.entry_array(device="cpu")
    real = entry.dec_arr.decode_batch

    def broken(comp, clens, cap):
        out, n, ok = real(comp, clens, cap)
        out[2, 11] ^= 1
        return out, n, ok

    monkeypatch.setattr(entry.dec_arr, "decode_batch", broken)
    assert not bool(step(data, lens)[2])


def test_entry_step_flags_a_row_that_does_not_come_back(monkeypatch):
    """The flag is the round trip's: a decode that disagrees clears it."""
    step, (data, lens) = entry.entry(device="cpu")
    real = entry.dec_ops.decode_batch

    def broken(comp, clens, cap):
        out, n, ok = real(comp, clens, cap)
        out[1, 7] ^= 1
        return out, n, ok

    monkeypatch.setattr(entry.dec_ops, "decode_batch", broken)
    assert not bool(step(data, lens)[2])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu(n):
    entry.dryrun_multichip(n, device="cpu")


def test_nothing_runs_on_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the refusal only applies without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_block_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry_array()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)


def test_device_example_runs_on_cpu(capsys):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import example_device_torch
    finally:
        sys.path.pop(0)
    example_device_torch.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: 4 entries" in out
    assert "fully interchangeable" in out
