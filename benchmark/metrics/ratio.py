"""ratio: uncompressed bytes over stored bytes, over all output of the
window's compress calls (frames whole; rows at their total, raw rows at
their raw size)."""

from benchmark import readers


def read(run):
    return readers.ratio(run)
