"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and entries in BENCHMARK.json) run without an edit to any file
of the harness."""

import json
import os

from benchmark import harness


def test_new_files_are_found(tiny_root, tmp_path):
    import shutil

    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "benchmark"),
                    os.path.join(root, "benchmark"))
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    b = os.path.join(root, "benchmark")

    def put(rel, obj):
        with open(os.path.join(b, rel), "w") as f:
            f.write(obj if isinstance(obj, str) else json.dumps(obj))

    cfg = json.load(open(os.path.join(b, "configs", "nvcomp-lz4-64k.json")))
    put("configs/chunks-16k.json", dict(cfg, chunk_bytes=16384))
    traffic = json.load(open(os.path.join(b, "traffic", "silesia-fast.json")))
    put("traffic/silesia-fast-l12.json", dict(traffic, level=12))
    put("workloads/c16-best.json", {"config": "chunks-16k",
                                    "traffic": "silesia-fast-l12"})
    put("metrics/rows_per_call.py",
        '"""rows_per_call: a new per-layer metric."""\n\n\n'
        "def read(run):\n"
        "    c = run.calls['compress']\n"
        "    return c.bytes_in / c.n / 16384\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "chunks-16k", "source": "test",
                             "file": "benchmark/configs/chunks-16k.json",
                             "reduced": ["chunk_bytes"], "why": "test"})
    bench["workloads"].append({"name": "c16-best", "config": "chunks-16k",
                               "traffic": "silesia-fast-l12", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "chunk_compress_GBps":
            m["workloads"].append("c16-best")
    bench["per_layer"].append({"name": "rows_per_call", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "batch layer",
                               "moves": "chunk_compress_GBps",
                               "workloads": ["c16-best"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    result, _ = harness.run_cell("c16-best", 5, 0.01, True, device="cpu",
                                 root=root)
    assert result["correct"]
    assert result["metrics"]["rows_per_call"]["value"] == (
        traffic["total_bytes"] / 16384)
    result, _ = harness.run_cell("c16-best", 5, 0.01, False, device="cpu",
                                 root=root)
    # chunk_decompress_GBps lists its cells, and this one is not among them
    assert set(result["metrics"]) == {"chunk_compress_GBps", "ratio",
                                      "setup_s"}
