"""The check that decides `correct` fails where it should: under each
cell's control (the program's linked path, where the configuration states
independent blocks) and with the timed path broken underneath, once for
each fault a cell can have. The harness's look for a chip is skipped: the
runs go through the kernels' plain versions on the CPU, at a tiny size.
(A cell on one chip has no exchange between chips to leave out.)"""

import json
import os

import pytest
import torch

from benchmark import controls, harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]


def _run(cell, root):
    result, _ = harness.run_cell(cell, 4242, 0.01, False, device="cpu",
                                 root=root)
    return result


@pytest.fixture
def program(monkeypatch):
    """The program's modules, with every attribute a test or a control
    sets put back afterwards."""
    import plz4_tpu_torch as plz4
    from plz4_tpu_torch.ops import decode
    from plz4_tpu_torch.parallel import batch

    monkeypatch.setattr(plz4, "compress", plz4.compress)
    monkeypatch.setattr(batch, "dispatch_encode", batch.dispatch_encode)
    monkeypatch.setattr(decode, "decode_batch", decode.decode_batch)
    return batch, decode


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, program, cell):
    assert _run(cell, tiny_root)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, program, cell):
    controls.switch_on(harness.load_spec(cell, tiny_root).traffic["driver"])
    result = _run(cell, tiny_root)
    assert not result["correct"]
    checks = result["checks"]
    assert checks.get("bad_headers", {}).get("value", 0) > 0 or (
        checks.get("bad_rows", {}).get("value", 0) > 0)


def _encode_unchanged(batch):
    def encode(data, lens, level):
        R, N = data.shape
        cap = (N + N // 255 + 64 + 3) & ~3
        out = torch.zeros((R, cap), dtype=torch.uint8)
        out[:, :N] = data
        return out, (lens - 1).clamp(min=1), torch.ones(R, dtype=torch.bool)
    batch.dispatch_encode = encode


def _encode_half(batch):
    encode = batch.dispatch_encode

    def half(data, lens, level):
        out, totals, ok = encode(data, lens, level)
        h = (data.shape[0] + 1) // 2
        out[h:] = 0
        totals[h:] = 1
        ok[h:] = True
        return out, totals, ok
    batch.dispatch_encode = half


def _encode_altered(batch):
    encode = batch.dispatch_encode

    def altered(data, lens, level):
        out, totals, ok = encode(data, lens, level)
        rows = torch.arange(out.shape[0])
        at = (totals // 2).clamp(max=out.shape[1] - 1).long()
        out[rows, at] ^= 0x55
        return out, totals, ok
    batch.dispatch_encode = altered


def _decode_unchanged(decode):
    def dec(comp, clens, out_cap):
        B = comp.shape[0]
        return (torch.zeros((B, out_cap), dtype=torch.uint8),
                torch.full((B,), out_cap, dtype=torch.int32),
                torch.ones(B, dtype=torch.bool))
    decode.decode_batch = dec


def _decode_altered(decode):
    orig = decode.decode_batch

    def dec(comp, clens, out_cap):
        out, n, ok = orig(comp, clens, out_cap)
        out[:, 0] ^= 0x55
        return out, n, ok
    decode.decode_batch = dec


FAULTS = {"encode_unchanged": _encode_unchanged, "encode_half": _encode_half,
          "encode_raw_half": lambda batch: controls.plant_raw_half(),
          "encode_altered": _encode_altered}
DECODE_FAULTS = {"decode_unchanged": _decode_unchanged,
                 "decode_altered": _decode_altered}


def _decoding(cell):
    """Whether the cell makes decode calls (reports a decompress rate)."""
    e2e = json.load(open(os.path.join(REPO, "BENCHMARK.json")))["end_to_end"]
    return any(m["name"].endswith("decompress_GBps")
               and cell in m.get("workloads", [cell]) for m in e2e)


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in sorted(FAULTS)
    + (sorted(DECODE_FAULTS) if _decoding(c) else [])])
def test_fault_is_not_correct(tiny_root, program, cell, fault):
    batch, decode = program
    if fault in DECODE_FAULTS:
        DECODE_FAULTS[fault](decode)
    else:
        FAULTS[fault](batch)
    assert not _run(cell, tiny_root)["correct"]
