"""The benchmark's one command:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

It runs one cell of BENCHMARK.json on the machine it is started on: set-up
(torch and CUDA, the kernels from the program's build cache, the payload
from the seed, one warm call at the cell's shapes), then the measured
window, then the check of the window's answers against the plain
reference. Its last line on standard output is one JSON object: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics, read from a profiler trace of the window. nvidia-smi's line on
the card comes on the line before it. The numbers compared, each beside
its limit, are the last lines on standard error and the result's last key.

It exits 2 without a result where no CUDA device is visible or fewer than
the cell asks for, and 3 where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    spec = harness.load_spec(args.workload)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); "
              f"{visible} visible", file=sys.stderr)
        return 2
    result, card = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", t0=T0)
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(harness.FORBIDDEN))
    if found:
        print(f"loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"card: {card}")  # the card, set-up by phase, the check
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['rule']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
