"""writer_cut_ms_per_GiB: the self time of the program's plz4.writer.write
span (the Writer's block cut: a copy per block, the stage), in ms per GiB
compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "writer.write")
