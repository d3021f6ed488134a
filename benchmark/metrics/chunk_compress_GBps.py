"""chunk_compress_GBps: uncompressed bytes over the wall time of the
window's batched chunk encode calls, each ended by a synchronize."""

from benchmark import readers


def read(run):
    return readers.rate(run, "compress", "bytes_in")
