"""The controls of the check that decides `correct`, and the runs that read
them on the card:

    python3 benchmark/controls.py --workload <cell> --seeds 7,8,9
        [--seconds 3] [--fault raw_half]

A control is the program with its own linked-block path switched on where
the configuration states independent blocks: the one guarantee it breaks
is that no match reaches outside its block, the step that would tempt a
later change (a better ratio for free). In frame cells every compress call
runs with block_linked=True; in resident chunk cells the encode call runs
the window kernels over the chunks, each chunk's window the chunk before
it (parallel.batch.dispatch_encode_dict with chunks = all rows). The check
has to read the control as not correct.

With --fault raw_half the run reads a planted fault instead of the
control: the encode call's compressible flag cleared on the second half
of each batch's rows, which the caller then keeps raw (a kernel that gives
up on half the rows, or a grid that covers half of them). That reading is
the upper one of raw_shrinkable, which no control moves.

Each seed's numbers compared go to standard output as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def switch_on(driver: str) -> None:
    """Put the program's linked path in place of the cell's entry."""
    import torch

    import plz4_tpu_torch as plz4
    from plz4_tpu_torch.parallel import batch

    if driver == "frames":
        compress = plz4.compress

        def linked(data, **opts):
            return compress(data, **dict(opts, block_linked=True))
        plz4.compress = linked
    elif driver == "chunks":
        encode_dict = batch.dispatch_encode_dict

        def linked(data, lens, level):
            R, N = data.shape
            windows = torch.zeros((1, N), dtype=torch.uint8,
                                  device=data.device)
            wlens = torch.full((R,), N, dtype=torch.int32,
                               device=data.device)
            wlens[0] = 0
            return encode_dict(data, lens, windows, wlens, level, 1, R)
        batch.dispatch_encode = linked
    else:
        raise ValueError(f"no control for driver {driver}")


def plant_raw_half() -> None:
    """The encode call's flag cleared on the second half of its rows."""
    from plz4_tpu_torch.parallel import batch

    encode = batch.dispatch_encode

    def raw_half(data, lens, level):
        out, totals, ok = encode(data, lens, level)
        ok[(data.shape[0] + 1) // 2:] = False
        return out, totals, ok
    batch.dispatch_encode = raw_half


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3)
    ap.add_argument("--fault", choices=("raw_half",))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    if args.fault:
        plant_raw_half()
    else:
        switch_on(harness.load_spec(args.workload).traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(args.workload, seed, args.seconds,
                                     False)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "run": args.fault or "control",
                          "correct": result["correct"],
                          "failed": result["failed"],
                          "checks": {k: c["value"] for k, c in
                                     result["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
