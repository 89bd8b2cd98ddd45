"""Worker pool: bounded job queue + worker threads backing the async APIs.

Port of ``ctranslate2_tpu/runtime/pool.py`` (reference:
include/ctranslate2/thread_pool.h:16-115, replica_pool.h:19-300).
``inter_threads`` maps to the number of workers; workers overlap host work
(tokenization, batch assembly, result unpacking) with device compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Optional


def resolve_max_queued_batches(kwargs: dict, max_queued_batches: int) -> int:
    """Resolve the ctor arg, honoring the legacy ``max_queue_size`` alias
    (0 = unbounded, vs the reference convention's 0 = automatic)."""
    if "max_queue_size" in kwargs:
        legacy = kwargs["max_queue_size"]
        return -1 if legacy == 0 else legacy
    return max_queued_batches


class WorkerPool:
    """Fixed set of worker threads draining a bounded FIFO job queue.

    ``submit`` blocks while ``max_queued_batches`` jobs are pending
    (reference value convention, replica_pool.h:252-255: 0 = automatic,
    4 per worker; -1 = unlimited; >0 = that bound).
    """

    def __init__(self, num_workers: int = 1, max_queued_batches: int = 0):
        if max_queued_batches == 0:
            maxsize = 4 * max(1, num_workers)
        elif max_queued_batches < 0:
            maxsize = 0  # unbounded
        else:
            maxsize = max_queued_batches
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._closed = False
        self._active = 0
        self._lock = threading.Lock()
        self._workers = []
        for i in range(max(1, num_workers)):
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"ct2tpu-torch-worker-{i}")
            t.start()
            self._workers.append(t)

    @property
    def num_workers(self) -> int:
        return len(self._workers)

    @property
    def num_queued_batches(self) -> int:
        return self._queue.qsize()

    @property
    def num_active_batches(self) -> int:
        with self._lock:
            return self._active + self._queue.qsize()

    def submit(self, fn: Callable, /, *args, **kwargs) -> Future:
        """Queue ``fn(*args, **kwargs)``; the Future resolves with its
        return value or exception."""
        if self._closed:
            raise RuntimeError("The worker pool is closed")
        future: Future = Future()
        self._queue.put((future, fn, args, kwargs))
        return future

    def close(self, timeout: Optional[float] = 5.0):
        if self._closed:
            return
        self._closed = True
        for _ in self._workers:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                break
        for w in self._workers:
            w.join(timeout=timeout)

    def __del__(self):
        try:
            self.close(timeout=0.1)
        except Exception:
            pass

    def _run(self):
        while True:
            try:
                job = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if job is None:
                return
            future, fn, args, kwargs = job
            if not future.set_running_or_notify_cancel():
                continue
            with self._lock:
                self._active += 1
            try:
                future.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001
                future.set_exception(e)
            finally:
                with self._lock:
                    self._active -= 1
