"""h2d_bytes_per_byte: the bytes the batch layer copies to the card (the
h2d_bytes count of the program's plz4.batch.enqueue spans: rows, lengths
and windows, at the staging tensors' full width) per byte given to the
window's compress calls; 0 on the CPU, where nothing is copied."""

from benchmark import program_spans


def read(run):
    return program_spans.count_per_byte(run, "batch.enqueue", "h2d_bytes")
