"""Shared worker pool (reference: internal/pkg/wpool/wpool.go).

A process-wide pool that multiple Readers/Writers can share instead of each
spawning its own executor (reference: WithWorkerPool, plz4_opts.go:107-111).
Features mirrored from the reference: dynamic min/max workers, idle-worker
drain on a GC tick, FIFO task queue, panic (exception) isolation, and
idempotent close (wpool/wpool.go:26-305).
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future


class WorkerPool:
    """Dynamic thread pool with idle reaping.

    submit(fn, *args) -> Future. Workers spawn on demand up to max_workers
    and exit after idling longer than max_idle (checked every gc_interval).
    """

    def __init__(
        self,
        min_workers: int = 0,
        max_workers: int = 8,
        max_idle: float = 30.0,
        gc_interval: float = 10.0,
    ) -> None:
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        self._min = max(0, min_workers)
        self._max = max(self._min, max_workers)
        self._max_idle = max_idle
        self._gc_interval = gc_interval
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._workers = 0
        self._idle = 0
        self._closed = False
        self._last_active: dict[int, float] = {}
        self._gc_thread: threading.Thread | None = None
        for _ in range(self._min):
            self._spawn_locked()

    # ------------------------------------------------------------------
    def submit(self, fn, *args, **kw) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("worker pool closed")
            self._queue.append((fut, fn, args, kw))
            if self._idle == 0 and self._workers < self._max:
                self._spawn_locked()
            self._cond.notify()
            self._ensure_gc_locked()
        return fut

    def close(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if wait:
            while True:
                with self._lock:
                    if self._workers == 0:
                        break
                time.sleep(0.01)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": self._workers,
                "idle": self._idle,
                "queued": len(self._queue),
                "closed": self._closed,
            }

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self.close()
        return False

    # ------------------------------------------------------------------
    def _spawn_locked(self) -> None:
        self._workers += 1
        t = threading.Thread(target=self._run, daemon=True,
                             name="plz4-wpool")
        t.start()

    def _ensure_gc_locked(self) -> None:
        if self._gc_thread is None or not self._gc_thread.is_alive():
            self._gc_thread = threading.Thread(
                target=self._gc_loop, daemon=True, name="plz4-wpool-gc")
            self._gc_thread.start()

    def _run(self) -> None:
        ident = threading.get_ident()
        retired = False
        try:
            while True:
                with self._lock:
                    self._idle += 1
                    self._last_active[ident] = time.monotonic()
                    while not self._queue and not self._closed:
                        if not self._cond.wait(timeout=self._gc_interval):
                            # Idle timeout: retire if above the floor.
                            # Two races are closed here: (a) a task
                            # submitted while this waiter was timing out
                            # (its notify was consumed by the dead wait) —
                            # re-check the queue under the lock before
                            # retiring, else the task is stranded with no
                            # worker; (b) concurrent retirements dropping
                            # below min_workers — decrement _workers in
                            # the SAME locked region as the decision, not
                            # in the finally, so the next retiree sees the
                            # updated count.
                            idle_for = (time.monotonic()
                                        - self._last_active[ident])
                            if (not self._queue
                                    and idle_for >= self._max_idle
                                    and self._workers > self._min):
                                self._idle -= 1
                                self._workers -= 1
                                self._last_active.pop(ident, None)
                                retired = True
                                return
                    self._idle -= 1
                    if self._closed and not self._queue:
                        return
                    fut, fn, args, kw = self._queue.popleft()
                    self._last_active[ident] = time.monotonic()
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn(*args, **kw))
                except BaseException as e:  # panic isolation
                    # (reference: recover() + log, wpool/wpool.go:297-305)
                    fut.set_exception(e)
                    traceback.clear_frames(e.__traceback__)
        finally:
            if not retired:
                with self._lock:
                    self._workers -= 1
                    self._last_active.pop(ident, None)

    def _gc_loop(self) -> None:
        while True:
            time.sleep(self._gc_interval)
            with self._lock:
                if self._closed and self._workers == 0:
                    return
                # wake idle workers so they can re-evaluate their idle age
                self._cond.notify_all()


_default_pool: WorkerPool | None = None
_default_lock = threading.Lock()


def default_pool() -> WorkerPool:
    """Lazily-created process-wide pool (reference: the default stub spawns
    raw goroutines, opts/opts.go:97-104 — here a shared bounded pool)."""
    global _default_pool
    with _default_lock:
        if _default_pool is None or _default_pool.stats["closed"]:
            import os

            _default_pool = WorkerPool(max_workers=os.cpu_count() or 4)
        return _default_pool
