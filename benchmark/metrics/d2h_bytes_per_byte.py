"""d2h_bytes_per_byte: the bytes the batch layer copies back from the card
(the d2h_bytes count of the program's plz4.batch.enqueue spans) per byte
given to the window's compress calls. Every row comes back at its full
output width, whatever its total; 0 on the CPU, where nothing is copied."""

from benchmark import program_spans


def read(run):
    return program_spans.count_per_byte(run, "batch.enqueue", "d2h_bytes")
