"""compress_GBps: uncompressed bytes over the wall time of the window's
frame compress calls, each of which returned the frame."""

from benchmark import readers


def read(run):
    return readers.rate(run, "compress", "bytes_in")
