"""batch_stage_ms_per_GiB: the self time of the program's plz4.batch.stage
span (the rows copied into pinned staging tensors), in ms per GiB
compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "batch.stage")
