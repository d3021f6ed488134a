"""plz4_tpu_torch.wpool: the JAX package's worker pool tests against the
port's copy (reference analog: wpool/wpool_test.go lifecycle, GC,
panic recovery, submit/close races, and WithWorkerPool integration)."""

import threading
import time

import pytest

import plz4_tpu_torch as plz4
from plz4_tpu_torch.wpool import WorkerPool, default_pool

from conftest import make_compressible


def test_basic_submit():
    with WorkerPool(max_workers=4) as p:
        futs = [p.submit(lambda x: x * 2, i) for i in range(20)]
        assert [f.result() for f in futs] == [i * 2 for i in range(20)]


def test_exception_isolation():
    with WorkerPool(max_workers=2) as p:
        def boom():
            raise ValueError("task crash")

        f1 = p.submit(boom)
        f2 = p.submit(lambda: 42)
        with pytest.raises(ValueError):
            f1.result()
        assert f2.result() == 42  # pool survives a crashing task


def test_worker_scaling():
    p = WorkerPool(min_workers=0, max_workers=4)
    try:
        evt = threading.Event()
        futs = [p.submit(evt.wait, 2.0) for _ in range(8)]
        time.sleep(0.2)
        assert 1 <= p.stats["workers"] <= 4
        evt.set()
        for f in futs:
            f.result()
    finally:
        p.close()
    assert p.stats["workers"] == 0


def test_idle_reaping():
    p = WorkerPool(min_workers=1, max_workers=4, max_idle=0.1,
                   gc_interval=0.05)
    try:
        futs = [p.submit(time.sleep, 0.05) for _ in range(8)]
        for f in futs:
            f.result()
        deadline = time.time() + 3.0
        while time.time() < deadline and p.stats["workers"] > 1:
            time.sleep(0.05)
        assert p.stats["workers"] == 1  # reaped down to the floor
    finally:
        p.close()


def test_submit_during_idle_retirement_not_stranded():
    """Regression: a task submitted in a worker's idle-timeout window must
    not be stranded (the retiring worker's wait consumed the notify; it
    now re-checks the queue under the lock before retiring)."""
    p = WorkerPool(min_workers=0, max_workers=1, max_idle=0.02,
                   gc_interval=0.01)
    try:
        for _ in range(60):
            fut = p.submit(lambda: 42)
            assert fut.result(timeout=5.0) == 42
            time.sleep(0.015)  # land submits inside the timeout window
    finally:
        p.close()


def test_concurrent_retirement_respects_floor():
    """Regression: back-to-back idle retirements could drop below
    min_workers (decrement happened outside the decision's lock scope)."""
    p = WorkerPool(min_workers=1, max_workers=4, max_idle=0.02,
                   gc_interval=0.01)
    try:
        futs = [p.submit(time.sleep, 0.03) for _ in range(8)]
        for f in futs:
            f.result()
        time.sleep(0.5)  # let every extra worker hit the idle timeout
        assert p.stats["workers"] >= 1
    finally:
        p.close()


def test_close_idempotent_and_rejects():
    p = WorkerPool(max_workers=2)
    p.submit(lambda: 1).result()
    p.close()
    p.close()
    with pytest.raises(RuntimeError):
        p.submit(lambda: 2)


def test_submit_close_race():
    p = WorkerPool(max_workers=4)
    stop = threading.Event()
    errors = []

    def submitter():
        while not stop.is_set():
            try:
                p.submit(lambda: 1)
            except RuntimeError:
                return
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=submitter) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    p.close(wait=False)
    stop.set()
    for t in threads:
        t.join()
    assert not errors


def test_shared_pool_with_codec():
    payload = make_compressible(300_000, seed=21)
    with WorkerPool(max_workers=4) as pool:
        comp = plz4.compress(payload, parallel=4, worker_pool=pool,
                             block_size_idx=plz4.BLOCK_IDX_64KB)
        out = plz4.decompress(comp, parallel=4, worker_pool=pool)
    assert out == payload


def test_default_pool_recreated_after_close():
    p = default_pool()
    p.submit(lambda: 1).result()
    p.close()
    p2 = default_pool()
    assert p2 is not p
    assert p2.submit(lambda: 7).result() == 7
    p2.close()


def test_worker_threads_keep_their_name():
    with WorkerPool(max_workers=2) as p:
        assert p.submit(lambda: threading.current_thread().name).result() \
            == "plz4-wpool"


def test_shared_pool_with_device_codec():
    payload = make_compressible(150_000, seed=22)
    kw = dict(parallel=2, block_size_idx=plz4.BLOCK_IDX_64KB,
              backend="device", device="cpu")
    with WorkerPool(max_workers=2) as pool:
        comp = plz4.compress(payload, worker_pool=pool, **kw)
        out = plz4.decompress(comp, worker_pool=pool, **kw)
    assert out == payload
    assert comp == plz4.compress(payload, **kw)
