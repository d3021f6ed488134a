"""Spans around the calls into the program's layers, and the profiler's
trace of the measured window.

The benchmark's own files wrap the program's entry points in spans: a
call (compress, decompress), and inside it the layers a driver wraps
(batch_begin, batch_result). A span's seconds count once however deeply
it nests in itself. With tracing on, each span is also a
torch.profiler.record_function, so the trace puts the host's spans and
the card's kernels and copies on one clock; summary() reduces that
trace to what the per-layer metrics and the breakdown read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

PREFIX = "bench:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")  # the host's launch calls
TOP = 10  # entries in each list of the breakdown
NAME = 120  # characters kept of a device operation's name


class Tracer:
    def __init__(self, enabled: bool, cuda: bool) -> None:
        self.enabled = enabled
        self.cuda = cuda
        self.seconds: dict[str, float] = defaultdict(float)
        self._stack: list[str] = []  # the spans open (one thread calls)
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        stack = self._stack
        outer = name not in stack
        stack.append(name)
        rf = contextlib.nullcontext()
        if self.enabled:
            from torch.profiler import record_function

            rf = record_function(PREFIX + name)
        t = time.perf_counter()
        try:
            with rf:
                yield
        finally:
            if outer:
                self.seconds[name] += time.perf_counter() - t
            stack.pop()

    @contextlib.contextmanager
    def window(self):
        """The measured window; under the profiler when tracing."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        with self._prof:
            with self.span("window"):
                yield

    def summary(self, calls: tuple[str, ...]) -> dict | None:
        """The trace of the window, reduced: window_s, busy_s (the union
        of the card's kernel and copy intervals), kernel_s by call kind
        (kernels launched inside a call span of that kind),
        device_ops and idle_gaps (the breakdown's lists)."""
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return reduce_trace(events, calls)


def _intervals(events, name: str) -> list[tuple[float, float]]:
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e["name"] == PREFIX + name)


def _containing(spans, starts, t: float) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and spans[k][0] <= t <= spans[k][1]


def reduce_trace(events: list, calls: tuple[str, ...]) -> dict | None:
    """See Tracer.summary. Times in the trace are microseconds. A kernel
    counts for the call whose span holds its launch: the host's runtime
    or driver call of the same correlation id, on the host's clock (the
    card's timestamps can sit tens of ms off the host's; they name only
    kernels without a launch in the trace)."""
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIX)]
    dev = [e for e in events if e.get("ph") == "X"
           and str(e.get("cat", "")).lower() in DEVICE_CATS]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X"
                and str(e.get("cat", "")).lower() in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    win = _intervals(host, "window")
    if not win:
        return None
    w0, w1 = win[0]
    spans = {}
    for e in host:
        name = e["name"][len(PREFIX):]
        if name != "window":
            spans.setdefault(name, []).append((e["ts"], e["ts"] + e["dur"]))
    for v in spans.values():
        v.sort()
    starts = {k: [a for a, _ in v] for k, v in spans.items()}

    def call_of(t: float) -> str | None:
        for c in calls:
            if c in spans and _containing(spans[c], starts[c], t):
                return c
        return None

    kernel_s: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    ivs = []
    for e in dev:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        ivs.append((a, b))
        by_name[e["name"][:NAME]] += (b - a) / 1e6
        c = call_of(launched.get(e.get("args", {}).get("correlation"),
                                 e["ts"]))
        if c is not None and str(e.get("cat", "")).lower() == "kernel":
            kernel_s[c] += e["dur"] / 1e6
    ivs.sort()
    busy = 0.0
    gaps = []
    cur = w0
    for a, b in ivs:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps.append((cur, w1))
    inner = [k for k in spans if k not in calls]
    edges = sorted({t for v in spans.values() for iv in v for t in iv})
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        # split the gap where a span starts or ends, and name each piece
        # by the spans it lies in
        cut = edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)]
        for x, y in zip([a] + cut, cut + [b]):
            mid = (x + y) / 2
            c = call_of(mid)
            label = "between_calls" if c is None else c + ".self"
            if c is not None:
                for k in inner:
                    if _containing(spans[k], starts[k], mid):
                        label = f"{c}.{k}"
                        break
            idle[label] += (y - x) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernel_s": dict(kernel_s),
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]}
