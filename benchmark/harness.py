"""The benchmark's general part: it finds a cell's files by name, makes the
payload from the seed, drives the cell's driver through set-up and the
measured window, reads the metrics and judges the window's answers.

A cell is benchmark/workloads/<cell>.json, naming a configuration
(benchmark/configs/<name>.json) and a traffic mix
(benchmark/traffic/<name>.json). The mix names its driver
(benchmark/drivers/<name>.py), the module that holds the program's entry
points a window drives. Each metric is benchmark/metrics/<name>.py, whose
read(run) returns the number or None where it finds nothing to read; a
metric split by the cells it is read in (<name>.<kind>, as
device_idle_pct.frames) may share the file of its stem, <name>.py.
Which metrics a cell reports is BENCHMARK.json's: an end-to-end metric
without a workloads list is every cell's, a per-layer one without it is
every cell's that reports the metric it moves.
"""

from __future__ import annotations

import importlib.util
import json
import multiprocessing
import os
import resource
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field

from . import corpus, lz4ref
from .tracing import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = "benchmark"
# the program's kernel wrappers, whose module counters `*launches` count
# kernel launches
COUNTER_MODULES = ("encode", "encode_mid", "encode_deep", "encode_wide",
                   "decode", "xxh32")
CALLS = ("compress", "decompress")
# modules that neither a run nor the reference may load (top-level names,
# compared whole), and the program, which the reference may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "plz4_tpu")
PROGRAM = "plz4_tpu_torch"
# blocks or rows kept raw that the reference encodes, at most, per run
RAW_SAMPLE = 64


@dataclass
class Calls:
    """The window's calls of one kind: their count and seconds, the bytes
    a user gives and gets (bytes_in, bytes_out), and the bytes the work
    needs to read and write (work_in, work_out, for the byte bound)."""
    n: int = 0
    seconds: float = 0.0
    bytes_in: int = 0
    bytes_out: int = 0
    work_in: int = 0
    work_out: int = 0

    def add(self, seconds: float, bytes_in: int, bytes_out: int,
            work_in: int | None = None, work_out: int | None = None) -> None:
        self.n += 1
        self.seconds += seconds
        self.bytes_in += bytes_in
        self.bytes_out += bytes_out
        self.work_in += bytes_in if work_in is None else work_in
        self.work_out += bytes_out if work_out is None else work_out


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: str
    device_kind: str
    setup_s: float = 0.0
    calls: dict = field(default_factory=dict)  # kind -> Calls
    spans: dict = field(default_factory=dict)  # span -> seconds
    launches: int = 0  # kernel launches in the window
    cpu_s: float = 0.0  # the process's CPU seconds in the window
    trace: dict | None = None  # tracing.reduce_trace's summary
    setup_parts: dict = field(default_factory=dict)  # phase -> seconds

    def gib(self) -> float:
        c = self.calls.get("compress")
        return c.bytes_in / 2**30 if c and c.bytes_in else 0.0


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Spec:
    cell: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, BENCH_DIR, *parts)

    def metric_file(self, name: str) -> str:
        """metrics/<name>.py, or else that of the name's stem."""
        own = self.path("metrics", name + ".py")
        if os.path.isfile(own):
            return own
        return self.path("metrics", name.split(".")[0] + ".py")


def load_spec(cell: str, root: str = ROOT) -> Spec:
    """The cell's files, found by name, and its metrics in BENCHMARK.json."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    wl = _json(os.path.join(root, BENCH_DIR, "workloads", cell + ".json"))
    entry = [w for w in bench["workloads"] if w["name"] == cell]
    if (len(entry) != 1 or entry[0]["config"] != wl["config"]
            or entry[0]["traffic"] != wl["traffic"]):
        raise ValueError(f"cell {cell}: BENCHMARK.json and "
                         f"workloads/{cell}.json disagree")
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Spec(cell, entry[0]["chips"],
                _json(os.path.join(root, BENCH_DIR, "configs",
                                   wl["config"] + ".json")),
                _json(os.path.join(root, BENCH_DIR, "traffic",
                                   wl["traffic"] + ".json")),
                e2e, per_layer, root)


def launches() -> int:
    """The sum of the program's launch counters."""
    total = 0
    for name in COUNTER_MODULES:
        mod = sys.modules.get("plz4_tpu_torch.ops." + name)
        if mod is not None:
            total += sum(v for k, v in vars(mod).items()
                         if k.endswith("launches") and isinstance(v, int))
    return total


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def card_line() -> str:
    """nvidia-smi's name, clocks, power draw and limit, and temperature."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def reference_bad(items: list, workers: int, raws: list = (),
                  per_task: int = 32):
    """Judge the program's output by the reference in a pool of spawned
    processes: decode each (stream, expected, out_cap) item, and encode
    each block or row the program kept raw. Returns (how many items did
    not decode to what they should, how many raw blocks the reference
    shrinks, how many of the modules the reference's processes loaded are
    the program's or JAX's)."""
    tasks = [items[i:i + per_task] for i in range(0, len(items), per_task)]
    raw_tasks = [raws[i:i + 4] for i in range(0, len(raws), 4)]
    n = max(1, min(workers, os.cpu_count() or 1,
                   len(tasks) + len(raw_tasks)))
    # spawned, so that they start from a fresh import and share nothing
    # with the program's process; a worker that dies raises here
    with ProcessPoolExecutor(n, multiprocessing.get_context("spawn")) as ex:
        shrink = ex.map(lz4ref.count_shrinkable, raw_tasks)
        bad = sum(ex.map(lz4ref.count_bad, tasks))
        shrinkable = sum(shrink)
        mods = ex.submit(lz4ref.loaded_modules).result()
    return bad, shrinkable, sum(m in FORBIDDEN + (PROGRAM,) for m in mods)


def sample(rng, items: list, k: int) -> list:
    """At most k of items, drawn by rng, in their order."""
    if len(items) <= k:
        return list(items)
    return [items[i] for i in sorted(rng.choice(len(items), k,
                                                replace=False))]


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT,
             t0: float | None = None) -> tuple[dict, str]:
    """One run of a cell: set-up, the window, the metrics, the check.
    Returns the result line's object, whose last key, checks, holds each
    number compared as {"value", "limit", "rule"}, and a line on the run:
    nvidia-smi's on the card, read at the window's close, the seconds of
    each phase of set-up and those of the check."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_spec(cell, root)
    import torch

    marks = [("start", t0), ("torch", time.perf_counter())]
    cuda = torch.device(device).type == "cuda"
    tracer = Tracer(trace, cuda)
    drv = _module(spec.path("drivers", spec.traffic["driver"] + ".py"),
                  "bench_driver_" + spec.traffic["driver"])
    if cuda:
        torch.cuda.init()
    run = Run(cell, torch.cuda.get_device_name(0) if cuda else "cpu")
    marks.append(("cuda", time.perf_counter()))
    objects = corpus.objects(spec.traffic, seed)
    marks.append(("payload", time.perf_counter()))
    driver = drv.Driver(spec, objects, seed, device, tracer, run)
    marks.append(("driver", time.perf_counter()))
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm", time.perf_counter()))
    run.setup_s = marks[-1][1] - t0
    run.setup_parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    tracer.seconds.clear()
    n0, c0 = launches(), _cpu_s()
    with tracer.window():
        t_end = time.perf_counter() + seconds
        while True:
            driver.step()
            if time.perf_counter() >= t_end:
                break
    run.cpu_s = _cpu_s() - c0
    run.launches = launches() - n0
    card = (card_line() if cuda else "cpu") + "; set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in run.setup_parts.items())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.spans = dict(tracer.seconds)
    run.trace = tracer.summary(CALLS)
    driver.release()
    t = time.perf_counter()
    checks = driver.check()
    card += f"; check {time.perf_counter() - t:.3f} s"
    correct = driver.failed == 0 and all(_holds(c) for c in checks.values())
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = _module(spec.metric_file(m["name"]),
                    "bench_metric_" + m["name"].replace(".", "_")).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_kind,
           "count": spec.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": driver.attempted,
              "failed": driver.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    return result, card


def _holds(c: dict) -> bool:
    return (c["value"] <= c["limit"] if c["rule"] == "<="
            else c["value"] >= c["limit"])


def check(value: float, limit: float, rule: str = "<=") -> dict:
    return {"value": value, "limit": limit, "rule": rule}
