"""The per-layer metrics that read the program's own spans
(plz4_tpu_torch.spans): read in the frame cell's traced runs, absent from
the resident cell's, and silent where the program has no spans."""

import json
import os
import sys

import pytest

from benchmark import harness, program_spans

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAMES, CHUNKS = "b4-best-silesia", "nvc-fast-silesia"
TIMES = ("api_self_ms_per_GiB", "writer_cut_ms_per_GiB",
         "writer_emit_ms_per_GiB", "batch_stage_ms_per_GiB",
         "batch_enqueue_ms_per_GiB", "batch_wait_ms_per_GiB",
         "batch_assemble_ms_per_GiB")
COUNTS = ("d2h_bytes_per_byte",)
SEED = 2**31 + 4242


def test_listed_for_the_frame_cell_alone():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in TIMES + COUNTS:
        m = per_layer[name]
        assert m["workloads"] == [FRAMES] and m["moves"] == "compress_GBps"
        assert m["source"] == ("program_counter" if name in COUNTS
                               else "program_span")


def test_frame_cell_reads_them_on_cpu(tiny_root):
    result, _ = harness.run_cell(FRAMES, SEED, 0.01, True, device="cpu",
                                 root=tiny_root)
    assert result["correct"]
    got = result["metrics"]
    for name in TIMES:
        assert got[name]["value"] >= 0, name
        assert got[name]["unit"] == "ms/GiB"
    assert got["d2h_bytes_per_byte"]["value"] == 0  # no copy on the CPU
    # the seven self times lie inside the benchmark's compress span
    assert sum(got[n]["value"] for n in TIMES) <= 1.01 * (
        got["engine_self_ms_per_GiB"]["value"]
        + got["batch_begin_ms_per_GiB"]["value"]
        + got["batch_result_ms_per_GiB"]["value"])


def test_resident_cell_reports_none_of_them(tiny_root):
    result, _ = harness.run_cell(CHUNKS, SEED, 0.01, True, device="cpu",
                                 root=tiny_root)
    assert result["correct"]
    assert not set(result["metrics"]) & set(TIMES + COUNTS)


def test_silent_without_the_spans_module(monkeypatch):
    """A program that predates its spans: every reader returns None."""
    monkeypatch.delitem(sys.modules, program_spans.MODULE, raising=False)
    run = harness.Run(FRAMES, "cpu")
    run.calls["compress"] = harness.Calls()
    run.calls["compress"].add(1.0, 2**30, 2**29)
    spec = harness.load_spec(FRAMES)
    for name in TIMES + COUNTS:
        mod = harness._module(spec.metric_file(name), "m_" + name)
        assert mod.read(run) is None, name


@pytest.mark.gpu
def test_card_reads_the_copy_back(card):
    """One traced window on the card: every row of a batch comes back at
    its output width (CAP + a total and a flag), about 1.014 bytes a byte
    for 64 KiB blocks."""
    import subprocess

    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", FRAMES, "--seed",
         str(SEED), "--seconds", "1", "--trace", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])["metrics"]
    assert set(TIMES + COUNTS) <= set(got)
    assert got["d2h_bytes_per_byte"]["value"] == pytest.approx(1.0143,
                                                               abs=0.002)
