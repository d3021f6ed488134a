"""Linked frames: the frames driver's window (drivers/frames.py: whole
objects through plz4_tpu_torch.compress, one call after another from one
caller) under a configuration of linked blocks, with its own check.

A call's work (harness.Calls' work_in, the byte bound's input) counts each
block's bytes and the window the format lets it read: min(64 KiB, the
frame's bytes before it). So frame_encode_roofline's yardstick is the same
work whatever implements it.

The check: for each object, one of its frames, drawn from the seed, is
judged by the plain linked reference (lz4ref_linked): the header with
B.Indep clear, each size word, and every compressed block decoded after
the object's 64 KiB before it and compared with the object. window_refs
is the fewest sequences, over the frames checked, that reach before their
own block's start: a frame that only claims to be linked reads 0. Of the
blocks those frames store raw, up to harness.RAW_SAMPLE drawn from the
seed are encoded by the reference, which must not shrink them.
"""

from __future__ import annotations

from benchmark import harness, lz4ref, lz4ref_linked
from benchmark.corpus import seed_rng
from benchmark.drivers import frames


def window_work(n: int, block: int) -> int:
    """The bytes a frame of n bytes in blocks of `block` lets its blocks
    read: each block's own and min(64 KiB, the bytes before it)."""
    return n + sum(min(lz4ref_linked.HISTORY, p)
                   for p in range(block, n, block))


class LinkedCalls(harness.Calls):
    """Calls whose work_in counts the windows the blocks may read."""

    block: int = lz4ref.BLOCK_SIZES[lz4ref_linked.BLOCK_IDX]

    def add(self, seconds, bytes_in, bytes_out, work_in=None,
            work_out=None) -> None:
        super().add(seconds, bytes_in, bytes_out,
                    window_work(bytes_in, self.block)
                    if work_in is None else work_in, work_out)


class Driver(frames.Driver):
    def __init__(self, spec, objects, seed, device, tracer, run) -> None:
        calls = run.calls.setdefault("compress", LinkedCalls())
        calls.block = lz4ref.BLOCK_SIZES[spec.config["options"][
            "block_size_idx"]]
        super().__init__(spec, objects, seed, device, tracer, run)

    def check(self) -> dict:
        faults = {"headers": 0, "words": 0}
        items, raws = [], []
        for k, frame in sorted(self.kept.items()):
            f, blocks, raw = lz4ref_linked.scan_frame(
                frame, self.objects[k], self.block_size_idx)
            for key in faults:
                faults[key] += f[key]
            items += [(k, *b) for b in blocks]
            raws += raw
        raws = harness.sample(seed_rng(self.seed, 2), raws,
                              harness.RAW_SAMPLE)
        judged, shrinkable, mods = lz4ref_linked.judge_in_pool(
            items, self.workers, raws)
        refs = dict.fromkeys(self.kept, 0)
        for k, _, r in judged:
            refs[k] += r
        c = harness.check
        return {"bad_headers": c(faults["headers"], 0),
                "bad_words": c(faults["words"], 0),
                "bad_blocks": c(sum(b for _, b, _ in judged), 0),
                "raw_shrinkable": c(shrinkable, 0),
                "frames_checked": c(len(self.kept), min(
                    len(self.objects), self.attempted), ">="),
                "window_refs": c(min(refs.values(), default=0), 1, ">="),
                "ref_loads_program": c(sum(
                    m in harness.FORBIDDEN + (harness.PROGRAM,)
                    for m in mods), 0)}
