"""plz4_tpu_torch.spans: the codec's own spans on the device frame-compress
path, recorded only while a torch profiler records, on the CPU through the
kernels' plain versions."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plz4_tpu_torch as plz4
from plz4_tpu_torch import spans

N = 65536
BATCH = 4  # rows a device batch: 10 blocks make 3 batches (4, 4, 2)
BATCHES = 3
# the spans of one batch, and those of one call apart from its batches
PER_BATCH = ("batch.begin", "batch.stage", "batch.enqueue", "writer.drain",
             "batch.result", "batch.wait", "batch.assemble")
PER_CALL = ("compress", "writer.write", "writer.close")
BLOCKS = 10
# linked blocks add the window's spans: one a block, one a batch
WINDOW_SPANS = {"writer.window": BLOCKS, "batch.stage_window": BATCHES}
# each span's parent on this path; batch.begin and writer.drain run in
# writer.write while batches fill, the last ones in writer.close
PARENTS = {"compress": {None}, "writer.write": {"compress"},
           "writer.close": {"compress"},
           "batch.begin": {"writer.write", "writer.close"},
           "writer.drain": {"writer.write", "writer.close"},
           "writer.window": {"writer.write", "writer.close"},
           "batch.stage": {"batch.begin"}, "batch.enqueue": {"batch.begin"},
           "batch.stage_window": {"batch.stage"},
           "batch.result": {"writer.drain"},
           "batch.wait": {"batch.result"},
           "batch.assemble": {"batch.result"}}
OPTIONS = {"plain": {}, "linked": {"block_linked": True},
           "checksums": {"block_checksum": True}}


@pytest.fixture(scope="module")
def data():
    """Ten 64 KiB blocks, the last one partial, half of them compressible."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 8, (9 * N + 4321) // 4, dtype=np.uint8)
    out = np.repeat(words, 4)
    out[: 2 * N] = rng.integers(0, 256, 2 * N, dtype=np.uint8)
    return out.tobytes()


def _compress(data, **kw):
    return plz4.compress(data, backend="device", device="cpu", level=1,
                         block_size_idx=plz4.BLOCK_IDX_64KB,
                         device_batch=BATCH, **kw)


def _short(name):
    assert name.startswith(spans.PREFIX)
    return name[len(spans.PREFIX):]


def test_off_records_nothing(data, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spans.reset()
    frame = _compress(data)
    assert plz4.decompress(frame) == data
    assert spans.totals() == {} and spans.records() == []


def test_off_span_is_one_shared_object():
    a, b = spans.span("x"), spans.span("y", n=1)
    assert a is b
    with a as s:
        s.add(n=2)
    assert spans.totals() == {}


def test_linked_off_records_nothing(data, monkeypatch):
    """Linked blocks' window spans record nothing without a profiler."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spans.reset()
    frame = _compress(data, block_linked=True)
    assert plz4.decompress(frame) == data
    assert spans.totals() == {} and spans.records() == []


@pytest.mark.parametrize("opts", OPTIONS.values(), ids=list(OPTIONS))
def test_window_spans_fire_for_linked_blocks_alone(data, opts):
    """A linked compress records writer.window once a block and
    batch.stage_window once a batch; an independent one records neither."""
    _compress(data, **opts)
    with profile(activities=[ProfilerActivity.CPU]):
        _compress(data, **opts)
    t = spans.totals()
    got = {name: t[spans.PREFIX + name]["n"] for name in WINDOW_SPANS
           if spans.PREFIX + name in t}
    assert got == (WINDOW_SPANS if opts.get("block_linked") else {})
    for name in got:
        assert 0 <= t[spans.PREFIX + name]["self_seconds"] <= t[
            "plz4.compress"]["seconds"]


@pytest.mark.parametrize("opts", OPTIONS.values(), ids=list(OPTIONS))
def test_traced_call_records_the_tree(data, opts):
    frame = _compress(data, **opts)  # untraced: the recording starts anew
    with profile(activities=[ProfilerActivity.CPU]):
        frames = [_compress(data, **opts) for _ in range(2)]
    assert frames == [frame, frame]
    windows = WINDOW_SPANS if opts.get("block_linked") else {}
    recs = spans.records()
    by_id = {r["id"]: r for r in recs}
    calls = {r["call"] for r in recs}
    assert len(calls) == 2
    for call in calls:
        mine = [r for r in recs if r["call"] == call]
        names = [_short(r["name"]) for r in mine]
        assert sorted(set(names)) == sorted(PER_CALL + PER_BATCH
                                            + tuple(windows))
        for name in PER_CALL:
            assert names.count(name) == 1
        for name in PER_BATCH:
            assert names.count(name) == BATCHES, name
        for name, n in windows.items():
            assert names.count(name) == n, name
        root = [r for r in mine if r["parent"] is None]
        assert len(root) == 1 and root[0]["id"] == call
        assert _short(root[0]["name"]) == "compress"
        for r in mine:
            parent = (None if r["parent"] is None
                      else _short(by_id[r["parent"]]["name"]))
            assert parent in PARENTS[_short(r["name"])], (r["name"], parent)
            if r["parent"] is not None:
                p = by_id[r["parent"]]
                assert (p["start_ns"] <= r["start_ns"] <= r["end_ns"]
                        <= p["end_ns"])
    t = spans.totals()
    assert {_short(k) for k in t} == set(PER_CALL + PER_BATCH
                                         + tuple(windows))
    assert t["plz4.compress"]["n"] == 2
    assert t["plz4.batch.enqueue"]["n"] == 2 * BATCHES
    # nothing copied to the card or back
    assert t["plz4.batch.enqueue"]["h2d_bytes"] == 0
    assert t["plz4.batch.enqueue"]["d2h_bytes"] == 0


TAIL = 4000  # a short last block
CUTS = {"bytes": (bytes, 9 * N, 0), "bytearray": (bytearray, 9 * N, 9 * N),
        "bytes_tail": (bytes, 9 * N + TAIL, TAIL)}


@pytest.mark.parametrize("kind,n,cut", CUTS.values(), ids=list(CUTS))
def test_writer_write_counts_the_bytes_its_cut_copies(data, kind, n, cut):
    """writer.write's cut_bytes: 0 for full blocks of bytes (handed on as
    views), every byte of a bytearray's, and a short last block's (staged)."""
    src = kind(data[:n])
    _compress(src)
    with profile(activities=[ProfilerActivity.CPU]):
        frame = _compress(src)
    assert spans.totals()["plz4.writer.write"]["cut_bytes"] == cut
    assert plz4.decompress(frame) == data[:n]


def test_self_times_sum_to_the_root(data):
    _compress(data)
    with profile(activities=[ProfilerActivity.CPU]):
        _compress(data)
    t = spans.totals()
    root = t["plz4.compress"]["seconds"]
    total_self = sum(v["self_seconds"] for v in t.values())
    assert total_self == pytest.approx(root, rel=0.01)
    for name, v in t.items():
        assert 0 <= v["self_seconds"] <= v["seconds"], name


def test_chrome_trace_holds_each_span_nested_alike(data, tmp_path):
    _compress(data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _compress(data)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    evs = sorted((e for e in events if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith(spans.PREFIX)),
                 key=lambda e: (e["ts"], -e["dur"]))
    recs = sorted(spans.records(),
                  key=lambda r: (r["start_ns"], -r["end_ns"]))
    assert [e["name"] for e in evs] == [r["name"] for r in recs]
    ev = {r["id"]: e for r, e in zip(recs, evs)}
    for r in recs:
        if r["parent"] is not None:
            e, p = ev[r["id"]], ev[r["parent"]]
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def test_a_session_after_an_untraced_call_starts_cleared(data):
    _compress(data)
    with profile(activities=[ProfilerActivity.CPU]):
        _compress(data)
    first = spans.totals()
    assert first["plz4.compress"]["n"] == 1
    _compress(data)  # untraced: the aggregates are stale
    assert spans.totals() == first  # kept until a span records again
    with profile(activities=[ProfilerActivity.CPU]):
        _compress(data)
        _compress(data)
    t = spans.totals()
    assert t["plz4.compress"]["n"] == 2
    assert t["plz4.batch.begin"]["n"] == 2 * BATCHES
    assert len({r["call"] for r in spans.records()}) == 2


def test_decode_batches_fire_the_result_spans(data):
    frame = _compress(data)
    plz4.decompress(frame, backend="device", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        assert plz4.decompress(frame, backend="device", device="cpu") == data
    names = {_short(k) for k in spans.totals()}
    assert {"batch.result", "batch.wait", "batch.assemble"} <= names
    assert not names & {"compress", "writer.write", "batch.begin"}


def test_other_threads_neither_record_nor_clear(data):
    """The profiler records the thread that started it: four threads
    running untraced spans meanwhile leave its recording whole."""
    threads, loops = 4, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stop = threading.Event()

    def work(k):
        while not stop.is_set():
            for _ in range(loops):
                with spans.span(f"t{k}.a"):
                    with spans.span(f"t{k}.b"):
                        pass

    _compress(data)
    ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for t in ts:
                t.start()
            _compress(data)
            for _ in range(2 * loops):
                with spans.span("main.a"):
                    with spans.span("main.b"):
                        pass
    finally:
        stop.set()
        for t in ts:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    t = spans.totals()
    assert t["plz4.compress"]["n"] == 1
    assert t["plz4.batch.begin"]["n"] == BATCHES
    assert t["plz4.main.a"]["n"] == t["plz4.main.b"]["n"] == 2 * loops
    assert not any(".t" in name for name in t)
    by_id = {r["id"]: r for r in spans.records()}
    for r in by_id.values():
        assert r["parent"] is None or by_id[r["parent"]]["call"] == r["call"]
