"""batch_assemble_ms_per_GiB: the self time of the program's
plz4.batch.assemble span (each block's stored bytes and raw decision), in
ms per GiB compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "batch.assemble")
