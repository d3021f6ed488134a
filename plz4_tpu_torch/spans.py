"""The codec's own spans: where a compress call spends its host time.

Tracing is on exactly while a torch profiler records, and costs a flag
check per span otherwise. To trace, run any torch.profiler.profile around
the calls:

    from torch.profiler import ProfilerActivity, profile
    from plz4_tpu_torch import spans

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        plz4_tpu_torch.compress(data, backend="device", block_size_idx=4)
    spans.totals()  # {"plz4.writer.write": {"n", "seconds", ...}, ...}

and read the plz4.* events in the profiler's trace (each span is a
torch.profiler.record_function, on the trace's clock with the kernels and
copies it enqueued, nested under whatever the caller traces) or
spans.totals() and spans.records().

A span's self time is its duration less the time its child spans cover.
totals() keeps, per name, the spans' number, total and self seconds and
their summed counts; records() the last RECORDS spans in full: name, start
and end (time.perf_counter_ns), the enclosing span, the id of the root
span (for compress(), the call) and the counts.

The profiler records the thread that started it, and so do the spans: a
span in another thread finds tracing off. One recording is one profiler
session: a span that finds tracing off marks its thread's aggregates
stale, and the thread's next span that finds it on clears them first. So
a call made untraced just before a profiler starts (a warm-up) leaves the
session's totals holding that session's spans alone, whatever other
threads run meanwhile.

The spans, by the layer they sit in (each name is "plz4." + the name):

    compress        api.compress; its self time is the Options, the
                    one-shot check, the Writer's construction and
                    getvalue()
    writer.write    FrameWriter._write: the block cut; counts cut_bytes,
                    the bytes it copies out of the caller's buffer (0 for
                    a full block of a bytes input on the device path,
                    which is handed on as a view)
    writer.window   linked blocks: the 64 KiB window's snapshot for a
                    block and its advance over the block (a child of
                    writer.write, or of writer.close for the last block)
    writer.drain    one device batch's results framed and written
    writer.close    flush and trailer
    batch.begin     parallel.batch.encode_blocks_begin
    batch.stage     the rows copied into pinned staging tensors
    batch.stage_window
                    a batch with windows (linked blocks, a dictionary):
                    the windows copied into their own staging tensor
    batch.enqueue   the copies to the card, the launches and the copies
                    back; counts h2d_bytes and d2h_bytes, the bytes
                    copied to the card and back (0 on the CPU, where
                    nothing is copied)
    batch.result    Pending.result
    batch.wait      the host blocked on the batch's event
    batch.assemble  the batch's steps: stored bytes and raw decisions

The batch.result, wait and assemble spans fire for decode batches too.

The kernel wrappers' launch counters (the `*launches` globals in ops/) are
apart from this module and stay as they are.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch

PREFIX = "plz4."
RECORDS = 1 << 16  # full records kept for export

_profiling = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_ids = itertools.count(1)
_totals: dict[str, dict] = {}
_records: deque = deque(maxlen=RECORDS)


class _Thread(threading.local):
    def __init__(self) -> None:
        self.stack: list = []  # the thread's open spans
        self.stale = True  # a span ran untraced since one recorded


_local = _Thread()


class _Off:
    """The span with tracing off: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "root", "start",
                 "child_ns", "_rf")

    def __init__(self, name: str, counts: dict) -> None:
        self.name = PREFIX + name
        self.counts = counts
        self.child_ns = 0

    def add(self, **counts) -> None:
        """Add to the span's counts (known only once its work ran)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        stack = _local.stack
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent else None
        self.root = parent.root if parent else self.id
        stack.append(self)
        # the span's own cost, the record_function's too, is its own time
        self.start = time.perf_counter_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        stack = _local.stack
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        with _lock:
            t = _totals.get(self.name)
            if t is None:
                t = _totals[self.name] = {"n": 0, "ns": 0, "self_ns": 0}
            t["n"] += 1
            t["ns"] += dur
            t["self_ns"] += dur - self.child_ns
            for k, v in self.counts.items():
                t[k] = t.get(k, 0) + v
            _records.append({"name": self.name, "start_ns": self.start,
                             "end_ns": end, "id": self.id,
                             "parent": self.parent, "call": self.root,
                             "counts": dict(self.counts)})


def span(name: str, **counts):
    """A context manager timing one piece of work under "plz4." + name,
    with counts to sum (the returned object's add() adds more). With
    tracing off it is one shared object that does nothing."""
    if not _profiling():
        _local.stale = True
        return _OFF
    if _local.stale:
        reset()
        _local.stale = False
    return _Span(name, counts)


def totals() -> dict:
    """{name: {"n", "seconds", "self_seconds", <count>: sum}} over the
    current recording."""
    with _lock:
        return {name: {"n": t["n"], "seconds": t["ns"] / 1e9,
                       "self_seconds": t["self_ns"] / 1e9,
                       **{k: v for k, v in t.items()
                          if k not in ("n", "ns", "self_ns")}}
                for name, t in _totals.items()}


def records() -> list[dict]:
    """The last RECORDS spans of the current recording, in the order they
    ended: name, start_ns, end_ns, id, parent (the enclosing span's id),
    call (the root span's id) and counts."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Forget the current recording."""
    with _lock:
        _totals.clear()
        _records.clear()
