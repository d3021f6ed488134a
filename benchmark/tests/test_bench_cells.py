"""Each cell end to end at a tiny size: on the CPU through the port's plain
versions (device="cpu"), and on the card through run.py."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CELLS = [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_cpu(tiny_root, cell, trace):
    result, card = harness.run_cell(cell, 2**31 + 12345, 0.01, trace,
                                    device="cpu", root=tiny_root)
    spec = harness.load_spec(cell, tiny_root)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"
    if trace:
        assert "breakdown" in result
        assert result["device"]["window_s"] > 0
        # no device ran: the readers of device time find nothing to read
        assert not any(k.startswith("device_idle_pct")
                       for k in result["metrics"])
    else:
        assert set(result["metrics"]) == {m["name"]
                                          for m in spec.end_to_end}
        assert result["metrics"]["ratio"]["value"] > 1


def test_same_seed_same_inputs(tiny_root):
    from benchmark import corpus

    spec = harness.load_spec(CELLS[0], tiny_root)
    a = corpus.objects(spec.traffic, 7)
    assert a == corpus.objects(spec.traffic, 7)
    assert a != corpus.objects(spec.traffic, 8)
    assert all(len(o) == spec.traffic["total_bytes"] for o in a)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3", "--seconds", "1", "--trace", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"]
    assert result["device"]["busy_s"] > 0
