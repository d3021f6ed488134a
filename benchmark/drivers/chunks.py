"""Resident chunk batches, in the layout of NVIDIA nvCOMP's batched LZ4:
the object lives in device memory as (B, chunk) rows, the last one
zero-padded, and each iteration makes one batched encode call over every
row and one batched decode call over the encoded rows, each followed by a
synchronize. They are the calls plz4_tpu_torch.entry.entry()'s step
makes: parallel.batch.dispatch_encode(data, lens, level), then
ops.decode.decode_batch(comp, clens, chunk) on the encoded rows, with the
raw row where a chunk did not shrink. Building the decode input is the
caller's, between the two timed calls.

The check: of one iteration drawn from the seed, every decoded row is
compared with its chunk on the card, and every row flagged compressible
is decoded from exactly its first total bytes by the plain reference
(lz4ref.decode_block) and compared with its chunk. Of the rows not
flagged compressible (kept raw), up to harness.RAW_SAMPLE drawn from the
seed are encoded by the reference, which must not shrink them.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from benchmark import harness
from benchmark.corpus import seed_rng


class Driver:
    def __init__(self, spec, objects, seed, device, tracer, run) -> None:
        import torch
        import torch.nn.functional as F
        from plz4_tpu_torch.ops import decode
        from plz4_tpu_torch.parallel import batch

        self.torch = torch
        self._encode = batch.dispatch_encode
        self._decode = decode.decode_batch
        self.slack = decode.ROW_SLACK
        self.cuda = torch.device(device).type == "cuda"
        self.level = spec.traffic["level"]
        N = self.chunk = spec.config["chunk_bytes"]
        obj = objects[0]
        B = -(-len(obj) // N)
        rows = np.zeros((B, N), dtype=np.uint8)
        rows.reshape(-1)[:len(obj)] = np.frombuffer(obj, dtype=np.uint8)
        lens = np.full((B,), N, dtype=np.int32)
        lens[-1] = len(obj) - (B - 1) * N
        self.rows, self.hlens = rows, lens
        self.data = torch.from_numpy(rows).to(device)
        self.lens = torch.from_numpy(lens).to(device)
        self.raw = F.pad(self.data, (0, self.slack))  # raw rows to decode
        self.tracer = tracer
        self.enc = run.calls.setdefault("compress", harness.Calls())
        self.dec = run.calls.setdefault("decompress", harness.Calls())
        self.workers = spec.traffic["check_workers"]
        self.rng = seed_rng(seed, 1)
        self.seed = seed
        self.kept = None
        self.seen = 0
        self.attempted = self.failed = 0

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _iterate(self):
        """One encode call and one decode call: (outputs, encode seconds,
        decode seconds, stored bytes, compressed bytes decoded, bytes they
        decode to)."""
        torch = self.torch
        with self.tracer.span("compress"):
            t = time.perf_counter()
            out, totals, ok = self._encode(self.data, self.lens, self.level)
            self._sync()
            t_enc = time.perf_counter() - t
        compressible = ok & (totals < self.lens)
        comp = torch.where(compressible[:, None],
                           out[:, :self.chunk + self.slack], self.raw)
        clens = torch.where(compressible, totals, self.lens)
        sums = torch.stack([clens.sum(), torch.where(
            compressible, totals, 0).sum(), torch.where(
            compressible, self.lens, 0).sum()]).tolist()
        with self.tracer.span("decompress"):
            t = time.perf_counter()
            dec, n_out, ok_dec = self._decode(comp, clens, self.chunk)
            self._sync()
            t_dec = time.perf_counter() - t
        return ((out, totals, compressible, dec, n_out, ok_dec), t_enc,
                t_dec, *sums)

    def warm(self) -> None:
        self._iterate()

    def step(self) -> None:
        self.attempted += 2
        try:
            outs, t_enc, t_dec, stored, comp_in, comp_out = self._iterate()
        except Exception:  # a failed call is counted, and the run goes on
            self.failed += 2
            traceback.print_exc(file=sys.stderr)
            return
        n = int(self.hlens.sum())
        self.enc.add(t_enc, n, stored)
        self.dec.add(t_dec, stored, n, comp_in, comp_out)
        self.seen += 1
        if self.rng.random() * self.seen < 1:  # a reservoir of one
            self.kept = outs

    def release(self) -> None:
        self._encode = self._decode = None
        self.raw = None
        if self.cuda:
            self.torch.cuda.empty_cache()

    def check(self) -> dict:
        torch = self.torch
        out, totals, compressible, dec, n_out, ok_dec = self.kept
        pos = torch.arange(self.chunk, device=dec.device)
        same = ((dec == self.data) | (pos[None, :] >= self.lens[:, None]))
        good = ~compressible | (ok_dec & (n_out == self.lens)
                                & same.all(dim=1))
        bad_decoded = int((~good).sum())
        flags = compressible.cpu().numpy()
        tot = totals.cpu().numpy()
        streams = out.cpu().numpy()
        items = [(streams[i, :tot[i]].tobytes(),
                  self.rows[i, :self.hlens[i]].tobytes(), self.chunk)
                 for i in np.flatnonzero(flags)]
        raws = [self.rows[i, :self.hlens[i]].tobytes() for i in
                harness.sample(seed_rng(self.seed, 2),
                               np.flatnonzero(~flags), harness.RAW_SAMPLE)]
        bad, shrinkable, program = harness.reference_bad(
            items, self.workers, raws)
        c = harness.check
        return {"bad_rows": c(bad, 0), "bad_decoded": c(bad_decoded, 0),
                "raw_shrinkable": c(shrinkable, 0),
                "ref_loads_program": c(program, 0)}
