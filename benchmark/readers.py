"""What the metric readers (metrics/<name>.py) share: each metric file
names its reading here, so that two names of one quantity, split by the
cells they are read in, read it alike. Each returns None where the run
has nothing to read."""

from __future__ import annotations

from . import roofline


def rate(run, kind: str, field: str):
    """GB per second of one kind of call: `field` bytes over the calls'
    wall time."""
    c = run.calls.get(kind)
    if not c or not c.seconds:
        return None
    return getattr(c, field) / c.seconds / 1e9


def ratio(run):
    c = run.calls.get("compress")
    if not c or not c.bytes_out:
        return None
    return c.bytes_in / c.bytes_out


def per_gib(run, value):
    """value (seconds, or a count) per GiB compressed."""
    gib = run.gib()
    if value is None or not gib:
        return None
    return value / gib


def span_ms_per_gib(run, name: str):
    if name not in run.spans:
        return None
    return per_gib(run, run.spans[name] * 1e3)


def launches_per_gib(run):
    return per_gib(run, run.launches or None)


def kernel_roofline(run, kind: str):
    """The least time the window's calls of one kind need (their work's
    bytes read once and written once, over the card's memory bandwidth)
    over the device time of every kernel launched inside those calls, in
    percent. Kernels count by the call that launched them, not by name."""
    c = run.calls.get(kind)
    k = run.trace and run.trace["kernel_s"].get(kind)
    if not c or not k:
        return None
    return 100 * roofline.byte_bound_s(c.work_in, c.work_out,
                                       run.device_kind) / k


def device_idle_pct(run):
    """The share of the traced window in which no kernel and no copy ran
    on the card, in percent."""
    t = run.trace
    if not t or not t["busy_s"]:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])
