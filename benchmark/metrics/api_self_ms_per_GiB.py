"""api_self_ms_per_GiB: the self time of the program's plz4.compress span
(api.compress less the Writer's spans: the Options, the one-shot check,
the Writer's construction, the copy of the finished frame), in ms per GiB
compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "compress")
