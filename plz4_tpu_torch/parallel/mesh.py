"""Device meshes for sharded block codec execution.

Blocks are the data-parallel unit (the reference's NParallel worker fan-out,
async/writer.go:232-282, maps to a batch split over devices). A block mesh
is an ordered list of entries, each a torch.device with its own CUDA stream
(None on the CPU) and the rank of the process that owns it. The batch layer
(batch.py) splits a batch of blocks into one contiguous slice per entry,
runs each slice through the single-device path on its entry's device and
stream, and reassembles the results in frame order; blocks are
independent, so nothing crosses entries in the hot path. Across processes
(dist.py) each rank runs the slices of its own entries and the results
cross ranks once, at assembly.

The same GPU may appear in several entries: each entry's stream is its
own, so slices on one GPU overlap as far as the GPU lets them. The JAX
package's batch_sharding / replicated (NamedShardings of its jax Mesh) have
no counterpart: a slice is placed by its entry's device, not by a sharding
annotation.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import torch

BLOCK_AXIS = "blocks"

_state = threading.local()


@dataclass(frozen=True)
class Entry:
    """One slot of a mesh: a device, the stream its slices run on (None on
    the CPU and for another rank's entries) and its owning rank."""
    device: torch.device
    stream: Optional[torch.cuda.Stream]
    rank: int = 0


class BlockMesh:
    """A 1-D mesh over the 'blocks' axis: an ordered list of Entry. `rank`
    is the rank of the calling process; entries of other ranks run in
    their own processes."""

    axis_names = (BLOCK_AXIS,)

    def __init__(self, devices, ranks=None, rank: int = 0) -> None:
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a block mesh needs at least one device")
        ranks = [0] * len(devices) if ranks is None else list(ranks)
        if len(ranks) != len(devices):
            raise ValueError("one rank per device")
        entries = []
        for d, r in zip(devices, ranks):
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {d}")
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            stream = (torch.cuda.Stream(device=d)
                      if d.type == "cuda" and r == rank else None)
            entries.append(Entry(d, stream, r))
        self.entries: tuple[Entry, ...] = tuple(entries)
        self.rank = rank
        # seconds spent in cross-rank result gathers, and their count
        self.gather_seconds = 0.0
        self.gathers = 0

    @property
    def size(self) -> int:
        return len(self.entries)

    @property
    def multiprocess(self) -> bool:
        """True when some entry belongs to another rank."""
        return any(e.rank != self.rank for e in self.entries)

    def __repr__(self) -> str:
        return (f"BlockMesh({[str(e.device) for e in self.entries]}, "
                f"ranks={[e.rank for e in self.entries]}, rank={self.rank})")


def visible_gpus() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none (nothing falls
    back to the CPU: ask for CPU entries by name)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a block mesh over the visible GPUs needs a CUDA GPU; pass "
            'devices=["cpu", ...] for CPU entries')
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_block_mesh(devices=None) -> BlockMesh:
    """1-D mesh over the given devices (torch.device or strings; one may
    repeat), or over every visible GPU."""
    return BlockMesh(visible_gpus() if devices is None else devices)


def set_mesh(mesh: Optional[BlockMesh]) -> None:
    _state.mesh = mesh


def active_mesh() -> Optional[BlockMesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[BlockMesh]):
    prev = active_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def pad_batch_for_mesh(b: int, mesh: Optional[BlockMesh]) -> int:
    """b rounded up to a multiple of the mesh size (the JAX package pads
    its batch so that it divides evenly across devices)."""
    if mesh is None:
        return b
    n = mesh.size
    return ((b + n - 1) // n) * n


def shard_bounds(b: int, mesh: BlockMesh) -> list[tuple[int, int]]:
    """[start, stop) of each entry's contiguous slice of b blocks, balanced
    as numpy.array_split balances: each slice holds ceil(b/m) blocks, less
    one in as many trailing entries as the JAX package's padding would add
    rows."""
    m = mesh.size
    hi = pad_batch_for_mesh(b, mesh) // m
    n_hi = m - (pad_batch_for_mesh(b, mesh) - b)
    bounds, start = [], 0
    for k in range(m):
        stop = start + (hi if k < n_hi else hi - 1)
        bounds.append((start, stop))
        start = stop
    return bounds
