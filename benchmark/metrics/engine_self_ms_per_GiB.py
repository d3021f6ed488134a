"""engine_self_ms_per_GiB: host time inside the compress calls less the
time inside the batch layer's spans (batch_begin, batch_result), in ms per
GiB compressed: the API and engine layer's own time."""

from benchmark import readers


def read(run):
    if "batch_begin" not in run.spans:
        return None
    return readers.per_gib(run, 1e3 * (
        run.spans["compress"] - run.spans["batch_begin"]
        - run.spans.get("batch_result", 0.0)))
