"""batch_enqueue_ms_per_GiB: the self time of the program's
plz4.batch.enqueue span (the copies to the card, the launches, the copies
back and the event, enqueued), in ms per GiB compressed."""

from benchmark import program_spans


def read(run):
    return program_spans.self_ms_per_gib(run, "batch.enqueue")
