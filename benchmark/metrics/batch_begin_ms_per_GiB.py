"""batch_begin_ms_per_GiB: host time inside
parallel.batch.encode_blocks_begin (staging, the copy to the card, the
launches), in ms per GiB compressed."""

from benchmark import readers


def read(run):
    return readers.span_ms_per_gib(run, "batch_begin")
