"""Neither a run nor the reference loads JAX or the JAX package (top-level
module names compared whole: plz4_tpu_torch is not plz4_tpu), and the
reference loads nothing of the program."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(
    open(os.path.join(REPO, "BENCHMARK.json")))["workloads"]]

DRY_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
from benchmark import harness
r, _ = harness.run_cell({cell!r}, 9, 0.01, {trace}, device="cpu",
                        root={root!r})
print(json.dumps([r["correct"], sorted({{m.split(".")[0]
                                         for m in sys.modules}})]))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
from benchmark import lz4ref
s = lz4ref.encode_block(b"abcd" * 100)
assert lz4ref.decode_block(s, 400) == b"abcd" * 100
print(json.dumps(lz4ref.loaded_modules()))
"""


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_loads_no_jax(tiny_root, cell):
    correct, mods = _modules(DRY_RUN.format(repo=REPO, cell=cell,
                                            trace=True, root=tiny_root))
    assert correct
    assert "plz4_tpu_torch" in mods  # the program ran
    assert not set(mods) & set(harness.FORBIDDEN)


def test_reference_loads_no_program():
    mods = _modules(REFERENCE.format(repo=REPO))
    assert not set(mods) & set(harness.FORBIDDEN + (harness.PROGRAM,))
    assert "torch" not in mods


def test_names_compared_whole():
    assert "plz4_tpu" in harness.FORBIDDEN
    assert "plz4_tpu_torch".split(".")[0] not in harness.FORBIDDEN
