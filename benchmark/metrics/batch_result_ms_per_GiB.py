"""batch_result_ms_per_GiB: host time inside parallel.batch.Pending.result
(the wait on the batch's event, then assembly), in ms per GiB compressed."""

from benchmark import readers


def read(run):
    return readers.span_ms_per_gib(run, "batch_result")
