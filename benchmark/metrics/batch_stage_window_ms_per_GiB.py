"""batch_stage_window_ms_per_GiB: the self time of the program's
plz4.batch.stage_window span (a batch's windows copied into their pinned
staging tensor, inside plz4.batch.stage), in ms per GiB compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "batch.stage_window")
