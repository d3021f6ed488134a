"""Frames: whole objects through plz4_tpu_torch.compress, one call after
another from one caller (a closed loop). The configuration's options and
the traffic's level go to every call; each call returns the frame's bytes,
so it has waited for the card.

With tracing on, the batch layer's two entries that the Writer calls are
wrapped in spans: parallel.batch.encode_blocks_begin (staging, the copy to
the card, the launches) and parallel.batch.Pending.result (the wait on the
batch's event, then assembly).

The check: for each object, one of its frames, drawn from the seed, is
judged whole by the plain reference (lz4ref.scan_frame, and every
compressed block decoded and compared with the object); of the blocks
those frames store raw, up to harness.RAW_SAMPLE drawn from the seed are
encoded by the reference, which must not shrink them.
"""

from __future__ import annotations

import sys
import time
import traceback

from benchmark import harness, lz4ref
from benchmark.corpus import seed_rng


class Driver:
    def __init__(self, spec, objects, seed, device, tracer, run) -> None:
        import plz4_tpu_torch as plz4

        self._compress = plz4.compress
        opts = spec.config["options"]
        self.opts = dict(opts, level=spec.traffic["level"], device=device)
        self.block_size_idx = opts["block_size_idx"]
        self.objects = objects
        self.tracer = tracer
        self.calls = run.calls.setdefault("compress", harness.Calls())
        self.workers = spec.traffic["check_workers"]
        self.rng = seed_rng(seed, 1)
        self.seed = seed
        self.kept: dict[int, bytes] = {}
        self.seen = [0] * len(objects)
        self.i = 0
        self.attempted = self.failed = 0
        self._undo = self._wrap_batch() if tracer.enabled else None

    def _wrap_batch(self):
        from plz4_tpu_torch.parallel import batch

        begin, result = batch.encode_blocks_begin, batch.Pending.result
        span = self.tracer.span

        def encode_blocks_begin(*args, **kwargs):
            with span("batch_begin"):
                return begin(*args, **kwargs)

        def pending_result(pending):
            with span("batch_result"):
                return result(pending)

        batch.encode_blocks_begin = encode_blocks_begin
        batch.Pending.result = pending_result

        def undo():
            batch.encode_blocks_begin = begin
            batch.Pending.result = result
        return undo

    def warm(self) -> None:
        self._compress(self.objects[0], **self.opts)

    def step(self) -> None:
        k = self.i % len(self.objects)
        self.i += 1
        obj = self.objects[k]
        self.attempted += 1
        with self.tracer.span("compress"):
            t = time.perf_counter()
            try:
                frame = self._compress(obj, **self.opts)
            except Exception:  # a failed call is counted, and the run goes on
                self.failed += 1
                traceback.print_exc(file=sys.stderr)
                return
            dt = time.perf_counter() - t
        self.calls.add(dt, len(obj), len(frame))
        self.seen[k] += 1
        if self.rng.random() * self.seen[k] < 1:  # a reservoir of one
            self.kept[k] = frame

    def release(self) -> None:
        if self._undo is not None:
            self._undo()

    def check(self) -> dict:
        faults = {"headers": 0, "words": 0}
        items, raws = [], []
        for k, frame in sorted(self.kept.items()):
            f, blocks, raw = lz4ref.scan_frame(frame, self.objects[k],
                                               self.block_size_idx)
            for key in faults:
                faults[key] += f[key]
            items += blocks
            raws += raw
        raws = harness.sample(seed_rng(self.seed, 2), raws,
                              harness.RAW_SAMPLE)
        bad, shrinkable, program = harness.reference_bad(
            items, self.workers, raws)
        c = harness.check
        return {"bad_headers": c(faults["headers"], 0),
                "bad_words": c(faults["words"], 0),
                "bad_blocks": c(bad, 0),
                "raw_shrinkable": c(shrinkable, 0),
                "frames_checked": c(len(self.kept), min(
                    len(self.objects), self.attempted), ">="),
                "ref_loads_program": c(program, 0)}
