"""device_idle_pct (device_idle_pct.frames, device_idle_pct.chunks): the
share of the traced window in which no kernel and no copy ran on the card
(one less the union of the trace's device intervals over the window), in
percent."""

from benchmark import readers


def read(run):
    return readers.device_idle_pct(run)
