"""cut_bytes_per_byte: the bytes the Writer's block cut copies out of the
caller's buffer (the cut_bytes count of the program's plz4.writer.write
spans: full blocks copied, and bytes appended to the stage) per byte given
to the window's compress calls. A full block of a bytes input, handed on as
a view, counts 0."""

from benchmark import program_spans


def read(run):
    return program_spans.count_per_byte(run, "writer.write", "cut_bytes")
