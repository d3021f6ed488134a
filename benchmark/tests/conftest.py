"""Fixtures of the benchmark's own tests: a copy of the benchmark with its
traffic cut to a tiny size, run on the CPU through the kernels' plain
versions, and the card's marker.

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
# two blocks, the last one partial, as the real payload's last block is
TINY = {"base_bytes": 4 * 65536, "total_bytes": 65536 + 14336,
        "check_workers": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU; skips where torch.cuda is "
        "unavailable")


def copy_benchmark(dst: str) -> str:
    """A copy of BENCHMARK.json and benchmark/ under dst, with every traffic
    mix cut to TINY; returns dst."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    tdir = os.path.join(dst, "benchmark", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            t = json.load(f)
        t.update(TINY)
        with open(path, "w") as f:
            json.dump(t, f)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return copy_benchmark(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
