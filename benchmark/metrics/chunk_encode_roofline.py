"""chunk_encode_roofline: the byte bound of the window's chunk encode
calls over the device time of the kernels launched inside them, in
percent (readers.kernel_roofline)."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline(run, "compress")
