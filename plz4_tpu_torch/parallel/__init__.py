"""Device parallelism: block batching (batch.py, large.py), sharding over a
block mesh (mesh.py) and across processes (dist.py).

Reference analog: the Go channel/goroutine fan-out (SURVEY.md §2.6) —
re-expressed as batches split over the entries of a block mesh, with
blocks data-parallel across devices and processes.
"""

from .mesh import active_mesh, set_mesh, use_mesh  # noqa: F401
