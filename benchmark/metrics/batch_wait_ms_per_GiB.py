"""batch_wait_ms_per_GiB: the self time of the program's plz4.batch.wait span
(the host blocked on a batch's event), in ms per GiB compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "batch.wait")
