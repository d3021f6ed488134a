"""The reduction of a profiler trace: the device's busy time as the union
of its intervals, kernels by the call span that launched them, idle gaps
by what the host was doing."""

import pytest

from benchmark import tracing


def _host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "bench:" + name,
            "ts": ts, "dur": dur}


def _dev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce():
    events = [
        _host("window", 0, 1000),
        _host("compress", 100, 400), _host("batch_begin", 110, 40),
        _host("batch_result", 400, 90), _host("decompress", 600, 300),
        _dev("k4", 150, 200), _dev("k4", 300, 100),  # overlap: 150-400
        _dev("copy", 450, 20, "gpu_memcpy"), _dev("k1", 650, 100),
        _dev("outside", 1200, 50),
        {"ph": "X", "cat": "cpu_op", "name": "aten::where", "ts": 0,
         "dur": 5},
    ]
    t = tracing.reduce_trace(events, ("compress", "decompress"))
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx((250 + 20 + 100) * 1e-6)
    assert t["kernel_s"] == pytest.approx({"compress": 300e-6,
                                           "decompress": 100e-6})
    assert t["device_ops"][0] == ["k4", pytest.approx(300e-6)]
    idle = dict(t["idle_gaps"])
    # each gap split where a span starts or ends
    assert idle == pytest.approx({"between_calls": 300e-6,
                                  "compress.self": 20e-6,
                                  "compress.batch_begin": 40e-6,
                                  "compress.batch_result": 70e-6,
                                  "decompress.self": 200e-6})
    assert sum(idle.values()) + t["busy_s"] == pytest.approx(t["window_s"])


def _launch(ts, corr, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "dur": 5, "args": {"correlation": corr}}


def test_kernels_count_by_their_launch():
    """The card's clock sits off the host's: a kernel counts for the call
    that launched it, wherever its own timestamp falls."""
    def dev(name, ts, dur, corr):
        return dict(_dev(name, ts, dur), args={"correlation": corr})

    events = [
        _host("window", 0, 1000),
        _host("compress", 100, 300), _host("decompress", 500, 200),
        _launch(110, 1), dev("k2a", 450, 200, 1),  # lands in no span
        _launch(510, 2, "cuda_driver"), dev("k1", 720, 50, 2),
        _launch(520, 3), dev("k1", 200, 30, 3),  # lands in compress
        dev("no_launch", 150, 10, 9),  # no launch: its own start
    ]
    t = tracing.reduce_trace(events, ("compress", "decompress"))
    assert t["kernel_s"] == pytest.approx({"compress": 210e-6,
                                           "decompress": 80e-6})


def test_no_window_no_summary():
    assert tracing.reduce_trace([_dev("k", 0, 1)], ("compress",)) is None
