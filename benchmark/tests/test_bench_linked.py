"""The linked-frame cell and the resident level-12 cell: the plain linked
reference (lz4ref_linked), the check of drivers/linked_frames.py against
faults planted under the program, and the metrics each cell reports. The
runs go through the kernels' plain versions on the CPU, at a tiny size."""

import json
import os

import pytest

from benchmark import corpus, harness, lz4ref, lz4ref_linked
from benchmark.drivers import linked_frames

from conftest import copy_benchmark

LINKED, RESIDENT = "linked-best-silesia", "nvc-best-silesia"
SEED = 2**31 + 4242
N = 65536


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark, the linked mix at four blocks (the last one
    partial), so that a block's window can be the wrong one."""
    dst = copy_benchmark(str(tmp_path_factory.mktemp("linked")))
    path = os.path.join(dst, "benchmark", "traffic",
                        "silesia-best-linked.json")
    with open(path) as f:
        t = json.load(f)
    t["total_bytes"] = 3 * N + 14336
    with open(path, "w") as f:
        json.dump(t, f)
    return dst


@pytest.fixture(scope="module")
def payload():
    return corpus.silesia_bulk(3 * N + 777, seed=11)


def test_reference_decodes_its_own_linked_frames(payload):
    frame = lz4ref_linked.compress_frame(payload)
    got, refs = lz4ref_linked.decode_frame(frame)
    assert got == payload and refs > 0
    faults, blocks, raws = lz4ref_linked.scan_frame(frame, payload)
    assert faults == {"headers": 0, "words": 0} and raws == []
    judged = lz4ref_linked.judge([(0, *b) for b in blocks])
    assert [bad for _, bad, _ in judged] == [0] * 4
    assert sum(r for _, _, r in judged) == refs
    # the reference's independent check refuses both the header and the
    # blocks that reach back
    faults, blocks, _ = lz4ref.scan_frame(frame, payload, 4)
    assert faults["headers"] == 1 and lz4ref.count_bad(blocks) > 0
    # an independent frame decodes, with no sequence reaching back
    indep = lz4ref.compress_frame(payload, 4)
    got, refs = lz4ref_linked.decode_frame(
        lz4ref_linked.header() + indep[7:])
    assert got == payload and refs == 0


def test_reference_refuses_a_wrong_history(payload):
    blk = payload[N:2 * N]
    comp = lz4ref_linked.encode_block(blk, payload[:N])
    got, refs = lz4ref_linked.decode_block(comp, N, payload[:N])
    assert got == blk and refs > 0
    wrong = payload[2 * N:3 * N]
    assert lz4ref_linked.judge([(0, comp, blk, N, wrong)])[0][1] == 1
    with pytest.raises(lz4ref.RefError):
        lz4ref_linked.decode_block(comp, N, payload[:100])


def test_window_work():
    assert linked_frames.window_work(0, N) == 0
    assert linked_frames.window_work(N, N) == N
    assert linked_frames.window_work(N + 1, N) == 2 * N + 1
    assert linked_frames.window_work(3 * N + 5, N) == 3 * N + 5 + 3 * N


def _run(root, trace=False):
    result, _ = harness.run_cell(LINKED, SEED, 0.01, trace, device="cpu",
                                 root=root)
    return result


@pytest.fixture
def program(monkeypatch):
    """The program's entries the faults replace, put back afterwards."""
    import plz4_tpu_torch as plz4
    from plz4_tpu_torch.parallel import batch

    monkeypatch.setattr(plz4, "compress", plz4.compress)
    monkeypatch.setattr(batch, "encode_blocks_begin",
                        batch.encode_blocks_begin)
    return plz4, batch


def test_sound_run_is_correct(root, program):
    result = _run(root)
    assert result["correct"], result["checks"]
    checks = result["checks"]
    assert checks["window_refs"]["value"] >= 1
    assert checks["frames_checked"]["value"] >= 1


def _independent(plz4, batch):
    compress = plz4.compress

    def indep(data, **opts):
        return compress(data, **dict(opts, block_linked=False))
    plz4.compress = indep


def _window_before(plz4, batch):
    """Each block encoded after the window of the block before it."""
    begin = batch.encode_blocks_begin
    last = [None]

    def shifted(blocks, block_size, *args, dicts=None, **kw):
        if dicts is not None:
            dicts, last[0] = [last[0]] + list(dicts[:-1]), dicts[-1]
        return begin(blocks, block_size, *args, dicts=dicts, **kw)
    batch.encode_blocks_begin = shifted


def _windows_dropped(plz4, batch):
    begin = batch.encode_blocks_begin

    def dropped(blocks, block_size, *args, dicts=None, **kw):
        return begin(blocks, block_size, *args, dicts=None, **kw)
    batch.encode_blocks_begin = dropped


@pytest.mark.parametrize("fault, check", [
    (_independent, "bad_headers"), (_window_before, "bad_blocks"),
    (_windows_dropped, "window_refs")])
def test_planted_fault_breaks_its_limit(root, program, fault, check):
    fault(*program)
    result = _run(root)
    assert not result["correct"]
    c = result["checks"][check]
    assert not (c["value"] <= c["limit"] if c["rule"] == "<="
                else c["value"] >= c["limit"]), result["checks"]


def test_work_counts_the_windows(root, program, monkeypatch):
    runs = []
    real = harness.Run

    def keep(*a, **k):
        runs.append(real(*a, **k))
        return runs[-1]

    monkeypatch.setattr(harness, "Run", keep)
    assert _run(root)["correct"]
    c = runs[0].calls["compress"]
    assert c.n >= 1
    assert c.work_in == c.n * linked_frames.window_work(3 * N + 14336, N)


EXPECTED = {
    LINKED: ({"compress_GBps", "ratio", "setup_s"},
             {"host_cpu_s_per_GiB", "launches_per_GiB.frames",
              "frame_encode_roofline", "device_idle_pct.frames",
              "api_self_ms_per_GiB", "writer_cut_ms_per_GiB",
              "writer_emit_ms_per_GiB", "batch_stage_ms_per_GiB",
              "batch_enqueue_ms_per_GiB", "batch_wait_ms_per_GiB",
              "batch_assemble_ms_per_GiB", "d2h_bytes_per_byte",
              "writer_window_ms_per_GiB", "batch_stage_window_ms_per_GiB",
              "h2d_bytes_per_byte"}),
    RESIDENT: ({"chunk_compress_GBps", "chunk_decompress_GBps", "ratio",
                "setup_s"},
               {"launches_per_GiB.chunks", "chunk_encode_roofline",
                "chunk_decode_roofline", "device_idle_pct.chunks"}),
}


@pytest.mark.parametrize("cell", list(EXPECTED))
def test_cell_loads_by_name_with_its_metrics(cell):
    spec = harness.load_spec(cell)
    e2e, per_layer = EXPECTED[cell]
    assert {m["name"] for m in spec.end_to_end} == e2e
    assert {m["name"] for m in spec.per_layer} == per_layer
    for m in spec.end_to_end + spec.per_layer:
        assert os.path.isfile(spec.metric_file(m["name"]))
    assert spec.chips == 1 and spec.traffic["level"] == 12
    if cell == LINKED:
        assert spec.config["options"]["block_linked"] is True
        assert spec.traffic["driver"] == "linked_frames"
    else:
        assert spec.traffic["driver"] == "chunks"


def test_traced_linked_run_reads_the_window_metrics(root, program):
    result = _run(root, trace=True)
    assert result["correct"]
    got = result["metrics"]
    for name in ("writer_window_ms_per_GiB",
                 "batch_stage_window_ms_per_GiB"):
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms/GiB"
    assert got["h2d_bytes_per_byte"]["value"] == 0  # no copy on the CPU
    assert got["d2h_bytes_per_byte"]["value"] == 0


def test_resident_level12_cell_is_correct(tiny_root):
    result, _ = harness.run_cell(RESIDENT, SEED, 0.01, False, device="cpu",
                                 root=tiny_root)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == EXPECTED[RESIDENT][0]
