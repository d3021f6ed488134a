"""The port stands alone: importing every plz4_tpu_torch module loads
neither JAX nor any module of the JAX package, and the parse constants it
keeps its own copies of equal the Pallas kernel's."""

import json
import os
import subprocess
import sys

import numpy as np

from plz4_tpu.ops import decode_pallas, encode_pallas
from plz4_tpu.parallel import large as tpu_large
from plz4_tpu_torch.ops import decode, encode
from plz4_tpu_torch.parallel import large

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import plz4_tpu_torch
names = ["plz4_tpu_torch"]
for m in pkgutil.walk_packages(plz4_tpu_torch.__path__, "plz4_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "plz4_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("plz4_tpu_torch.ops.encode", "plz4_tpu_torch.ops.decode",
                "plz4_tpu_torch.ops.encode_wide", "plz4_tpu_torch.ops.xxh32",
                "plz4_tpu_torch.parallel.batch",
                "plz4_tpu_torch.parallel.large", "plz4_tpu_torch.api",
                "plz4_tpu_torch.native", "plz4_tpu_torch.engine.writer",
                "plz4_tpu_torch.parallel.mesh", "plz4_tpu_torch.parallel.dist",
                "plz4_tpu_torch.entry", "plz4_tpu_torch.cli",
                "plz4_tpu_torch.__main__", "plz4_tpu_torch.sparse",
                "plz4_tpu_torch.wpool", "plz4_tpu_torch.native.upstream",
                "plz4_tpu_torch.ops.encode_array",
                "plz4_tpu_torch.ops.decode_array"):
        assert mod in res["imported"]


def test_parse_constants_match_pallas():
    assert encode.HASH_LOG == encode_pallas.HASH_LOG
    assert np.int32(np.uint32(encode.HASH_MUL)) == encode_pallas.HASH_MUL
    assert encode.SKIP_STRENGTH == encode_pallas.SKIP_STRENGTH
    assert encode.MAX_DISTANCE == encode_pallas.MAX_DISTANCE


def test_row_widths_match_pallas():
    # out_width is the Pallas wrapper's CAP; decode rows carry the batch
    # layer's 16 bytes of slack; both kernels stay on the byte-wide path
    for n in (64, 256, 4096, 65536):
        assert encode.out_width(n) == (n + n // 255 + 64 + 3) & ~3
    assert encode.out_width(65536) == 65860
    assert decode.ROW_SLACK == 16
    assert decode.MAX_OUT <= decode_pallas._BW_MAX_OUT
    assert encode_pallas._bw_fits(encode.MAX_ROW + 8,
                                  encode.out_width(encode.MAX_ROW), mid=False)


def test_large_block_geometry_matches_jax_package():
    # chunk span, record input cap and chunk-window preload stride
    assert large.CHUNK == tpu_large.CHUNK == encode.MAX_ROW
    assert large.CHUNK_IN == tpu_large.CHUNK_IN
    assert large.CHUNK_WSTRIDE == 2
    # K5 stages a record slice and two record outputs in shared memory
    assert large.CHUNK_IN + 2 * large.CHUNK <= decode.MAX_SMEM


def test_csrc_constants_match_python():
    src = open(os.path.join(ROOT, "plz4_tpu_torch", "csrc",
                            "lz4_common.cuh")).read()
    for name, val in [("HASH_LOG", encode.HASH_LOG),
                      ("HASH_MUL", f"{encode.HASH_MUL}u"),
                      ("MAX_DISTANCE", encode.MAX_DISTANCE),
                      ("SKIP_STRENGTH", encode.SKIP_STRENGTH)]:
        assert f"#define LZ4T_{name} {val}\n" in src
