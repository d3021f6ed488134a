"""writer_emit_ms_per_GiB: the self time of the program's plz4.writer.drain
span (each block's size word and payload framed and written, less the
batch's result), in ms per GiB compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "writer.drain")
