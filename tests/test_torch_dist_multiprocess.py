"""The port's block sharding across processes: 2 and 4 ranks joined over
torch.distributed (gloo, localhost), each owning CPU mesh entries (the
kernels' plain versions); the port of tests/test_dist_multiprocess.py.

Every rank holds the whole host batch, runs the slices of its own entries
and gathers the other ranks' results, so every rank writes the whole
frame: every rank's frame must equal every other's and the unsharded
frame. A corrupt block in a slice that rank 0 does not own must raise the
same error on every rank, and no rank may hang (each process runs under a
timeout).
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent("""
    import hashlib, sys

    coord, pid, nproc, nent = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), int(sys.argv[4]))

    import numpy as np
    import torch.distributed as tdist

    import plz4_tpu_torch as plz4
    from plz4_tpu_torch.parallel import dist

    dist.init_distributed(coordinator_address=coord, num_processes=nproc,
                          process_id=pid)
    assert tdist.get_world_size() == nproc
    mesh = dist.pod_mesh(["cpu"] * nent)
    assert mesh.size == nproc * nent and mesh.multiprocess, mesh
    assert [e.rank for e in mesh.entries] == sorted(
        r for r in range(nproc) for _ in range(nent))

    rng = np.random.default_rng(42)
    words = [bytes(rng.integers(97, 123, 8, dtype=np.uint8))
             for _ in range(64)]
    text = b" ".join(words[int(rng.integers(64))] for _ in range(40000))
    # two incompressible 64 KiB blocks (the 3rd and 4th) are stored raw:
    # their payload is a view of the input, and crosses ranks all the same
    noise = rng.integers(0, 256, 2 * 65536, dtype=np.uint8).tobytes()
    data = text[:2 * 65536] + noise + text[2 * 65536:]

    # option matrix: plain 64 KiB; checksummed; 256 KiB blocks (the
    # chunked large-block path sharded across ranks)
    configs = [
        dict(block_size_idx=4, level=1, content_checksum=True),
        dict(block_size_idx=4, level=3, block_checksum=True,
             content_checksum=False),
        dict(block_size_idx=5, level=1, content_checksum=False),
    ]
    if nproc == 2:
        configs = configs[:1]  # the 2-process test is the fast smoke tier
    for ci, kw in enumerate(configs):
        comp = dist.compress_sharded(data, mesh, **kw)
        out = dist.decompress_sharded(comp, mesh)
        assert out == data, f"multi-process roundtrip mismatch (cfg {ci})"
        ref = plz4.compress(data, backend="device", device="cpu", **kw)
        print(f"RESULT {pid} {ci} {hashlib.sha256(comp).hexdigest()} "
              f"{len(comp)} {hashlib.sha256(ref).hexdigest()}", flush=True)

    # a flipped byte in the last block: a slice of rank 1 (2 ranks) or 2
    # (4 ranks) fails, and every rank raises its error
    comp = dist.compress_sharded(data, mesh, block_size_idx=4,
                                 block_checksum=True, content_checksum=False)
    bad = bytearray(comp)
    bad[-12] ^= 0x20
    try:
        dist.decompress_sharded(bytes(bad), mesh)
        raised = None
    except plz4.errors.Lz4Error as e:
        raised = next(n for n, v in vars(plz4.errors).items() if v is e)
    print(f"RAISED {pid} {raised} gathers {mesh.gathers}", flush=True)
    tdist.destroy_process_group()
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_matrix(tmp_path, nproc: int, nent: int, n_configs: int):
    coord = f"localhost:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid), str(nproc),
             str(nent)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(nproc)
    ]
    results: dict = {}
    raised: dict = {}
    try:
        for pid, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                pytest.fail(f"process {pid} timed out")
            assert p.returncode == 0, (
                f"process {pid} failed:\nstdout:\n{out}\nstderr:\n"
                f"{err[-4000:]}")
            for line in out.splitlines():
                if line.startswith("RESULT"):
                    _, rpid, ci, sha, clen, ref = line.split()
                    results.setdefault(int(ci), {})[int(rpid)] = (sha, clen)
                    assert sha == ref, (pid, ci, "not the unsharded frame")
                elif line.startswith("RAISED"):
                    raised[pid] = line.split()[2]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    assert set(results) == set(range(n_configs)), results
    for ci, by_pid in results.items():
        assert set(by_pid) == set(range(nproc)), (ci, by_pid)
        # every rank writes the identical frame
        assert len(set(by_pid.values())) == 1, (ci, by_pid)
    assert raised == {pid: "ErrBlockHash" for pid in range(nproc)}, raised


def test_two_process_mesh_roundtrip(tmp_path):
    _run_matrix(tmp_path, nproc=2, nent=4, n_configs=1)


def test_four_process_matrix(tmp_path):
    """4 ranks x 2 entries = an 8-entry mesh; the matrix includes the
    large-block chunked path."""
    _run_matrix(tmp_path, nproc=4, nent=2, n_configs=3)
