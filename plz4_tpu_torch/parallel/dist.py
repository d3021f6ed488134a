"""Multi-process orchestration over torch.distributed.

Reference analog: the in-process Go channel fan-out (SURVEY.md §2.6, §5.8)
— here blocks shard data-parallel across the devices of several
processes:

  * `init_distributed()` joins the process group (one call per process;
    a no-op for a single process). The backend is gloo, also on GPUs:
    what crosses ranks is assembled host bytes, and NCCL would refuse two
    ranks on one GPU.
  * `pod_mesh()` builds the 1-D "blocks" mesh over every rank's devices,
    in rank order.
  * `compress_sharded` / `decompress_sharded` run the frame codec with the
    block batch split over that mesh. Every rank holds the whole host
    batch and runs the slices of its own entries; at assembly the slices'
    results cross ranks in one all_gather_object (`gather_outcomes`), so
    every rank writes the whole frame (the reference writeLoop reorder
    analog, async/writer.go:284-381).

Serial passes (content xxh32, linked-block decode) stay host-side, exactly
like the reference's dedicated hasher goroutine and its forced NParallel=1
linked decode (async/hash.go, rdr/rdr.go:338-341).
"""

from __future__ import annotations

import datetime
import io
import time
import traceback
from typing import Optional

import torch
import torch.distributed as tdist

from .. import errors as zerr
from .. import opts as opts_mod
from . import mesh as mesh_mod

# the limit on every collective of the process group: a gather of a whole
# batch's results takes well under a second
TIMEOUT_S = 120.0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the gloo process group at coordinator_address ("host:port").
    Call once per process before building a multi-process mesh; a single
    process may skip it."""
    if num_processes is None or num_processes <= 1:
        return
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def pod_mesh(local_devices=None) -> mesh_mod.BlockMesh:
    """1-D blocks mesh with one entry per (rank, local device), in rank
    order. local_devices defaults to every visible GPU; each rank names
    its own, and the lists cross ranks once here."""
    local = [str(torch.device(d)) for d in (
        mesh_mod.visible_gpus() if local_devices is None else local_devices)]
    if not (tdist.is_available() and tdist.is_initialized()):
        return mesh_mod.BlockMesh(local)
    every: list = [None] * tdist.get_world_size()
    tdist.all_gather_object(every, local)
    devices = [d for devs in every for d in devs]
    ranks = [r for r, devs in enumerate(every) for _ in devs]
    return mesh_mod.BlockMesh(devices, ranks, rank=tdist.get_rank())


def _marker(e: BaseException):
    """A picklable stand-in for a slice's error: the codec's errors are
    singletons, sent by name and raised as themselves on every rank."""
    for name, v in vars(zerr).items():
        if v is e:
            return ("codec", name)
    return ("other", "".join(traceback.format_exception(e)))


def _raise_of(marker, rank: int):
    kind, what = marker
    if kind == "codec":
        return getattr(zerr, what)
    return RuntimeError(f"a block slice failed on rank {rank}:\n{what}")


def _picklable(results: list) -> list:
    """A slice's results with each memoryview made bytes: a block stored
    raw is the block itself, which the Writer may cut as a view of the
    caller's bytes, and a view cannot be pickled."""
    return [tuple(bytes(x) if isinstance(x, memoryview) else x for x in r)
            if isinstance(r, tuple)
            else bytes(r) if isinstance(r, memoryview) else r
            for r in results]


def gather_outcomes(mesh: mesh_mod.BlockMesh, outcomes: dict) -> dict:
    """All-gather the slice outcomes {slice: (None, results) or (key,
    error)} of every rank, so that every rank holds every slice's results
    and raises the same first error. No rank raises before this call."""
    mine = {k: (key, _marker(r) if key is not None else _picklable(r))
            for k, (key, r) in outcomes.items()}
    every: list = [None] * tdist.get_world_size()
    t0 = time.perf_counter()
    tdist.all_gather_object(every, mine)
    mesh.gather_seconds += time.perf_counter() - t0
    mesh.gathers += 1
    merged = {}
    for rank, part in enumerate(every):
        for k, (key, r) in part.items():
            merged[k] = (key, _raise_of(r, rank) if key is not None else r)
    return merged


def compress_sharded(data: bytes, mesh=None, **kw) -> bytes:
    """One-shot frame compression with blocks sharded over `mesh`
    (default: pod_mesh(), every rank's GPUs)."""
    from ..engine.writer import FrameWriter

    mesh = mesh if mesh is not None else pod_mesh()
    out = io.BytesIO()
    kw.setdefault("backend", "device")
    with mesh_mod.use_mesh(mesh):
        w = FrameWriter(out, opts_mod.Options(**kw))
        try:
            w.write(data)
        finally:
            w.close()
    return out.getvalue()


def decompress_sharded(data: bytes, mesh=None, **kw) -> bytes:
    """One-shot frame decompression with blocks sharded over `mesh`."""
    from ..engine.reader import FrameReader

    mesh = mesh if mesh is not None else pod_mesh()
    kw.setdefault("backend", "device")
    with mesh_mod.use_mesh(mesh):
        r = FrameReader(io.BytesIO(data), opts_mod.Options(**kw))
        try:
            return r.read()
        finally:
            r.close()
