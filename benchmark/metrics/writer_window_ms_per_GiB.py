"""writer_window_ms_per_GiB: the self time of the program's
plz4.writer.window span (linked blocks: the Writer's snapshot of the
64 KiB window for each block and its advance over the block), in ms per
GiB compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "writer.window")
