"""BENCHMARK.json keeps to the benchmark's contract: its keys, the
characters of every name and unit, the files it names, and its metrics."""

import json
import os
import re

import pytest

from benchmark import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
TEXT = re.compile(r"[^\t\n\r]{1,200}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for section, keys in KEYS.items():
        for entry in bench[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry


def test_names_and_units(bench):
    names = []
    for section in KEYS:
        for entry in bench[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"),
                          entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert TEXT.match(entry[key]), entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("config", "traffic"):
                if key in entry:
                    assert NAME.match(entry[key]), entry[key]
            for key in entry.get("reduced", []):
                assert NAME.match(key), key
    assert len(names) == len(set(names))
    for word in bench["command"]:
        assert TEXT.match(word)


def test_files_named(bench):
    for p in bench["paths"]:
        assert PATH.match(p) and os.path.isdir(os.path.join(REPO, p))
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    b = os.path.join(REPO, "benchmark")
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        with open(os.path.join(b, "workloads", w["name"] + ".json")) as f:
            wl = json.load(f)
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert os.path.isfile(os.path.join(b, "traffic",
                                           w["traffic"] + ".json"))
    spec = harness.load_spec(bench["workloads"][0]["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(spec.metric_file(m["name"]))
    for dirpath, _, files in os.walk(b):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            if "__pycache__" not in rel:
                assert PATH.match(rel), rel


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"compress_GBps", "chunk_compress_GBps",
                        "chunk_decompress_GBps", "ratio", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert len(bench["per_layer"]) == 11
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 << 10
