"""chunk_decompress_GBps: the bytes restored over the wall time of the
window's batched chunk decode calls, each ended by a synchronize."""

from benchmark import readers


def read(run):
    return readers.rate(run, "decompress", "bytes_out")
