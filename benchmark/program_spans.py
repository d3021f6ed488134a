"""The program's own spans (plz4_tpu_torch.spans), for the metric readers.

The program records its spans while a torch profiler records, and the
harness runs the profiler around the measured window alone, after an
untraced warm call: so the program's recording is the window's. Each
reader returns None where the program has no spans module loaded (one
that predates it) or the span never fired.
"""

from __future__ import annotations

import sys

from . import readers

MODULE = "plz4_tpu_torch.spans"


def _total(name: str) -> dict | None:
    mod = sys.modules.get(MODULE)
    if mod is None:
        return None
    t = mod.totals().get("plz4." + name)
    return t if t and t["n"] else None


def self_ms_per_gib(run, name: str):
    """The self time of the program's span `name`, in ms per GiB
    compressed."""
    t = _total(name)
    if t is None:
        return None
    return readers.per_gib(run, 1e3 * t["self_seconds"])


def count_per_byte(run, name: str, count: str):
    """A count summed over the program's span `name`, per byte given to
    the window's compress calls."""
    t = _total(name)
    c = run.calls.get("compress")
    if t is None or count not in t or not c or not c.bytes_in:
        return None
    return t[count] / c.bytes_in
