"""chunk_decode_roofline: the byte bound of the window's chunk decode
calls (the compressed rows read once, the chunks they restore written
once) over the device time of the kernels launched inside them, in percent
(readers.kernel_roofline)."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline(run, "decompress")
