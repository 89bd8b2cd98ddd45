"""Worker pool: bounded job queue + worker threads backing the async APIs.

Port of ``ctranslate2_tpu/runtime/pool.py`` (reference:
include/ctranslate2/thread_pool.h:16-115, replica_pool.h:19-300).
``inter_threads`` workers a model replica; workers overlap host work
(tokenization, batch assembly, result unpacking) with device compute.
Each worker knows its index (``current_worker_index``), by which a task
object picks the replica that runs the job.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import torch

_worker_tls = threading.local()


def current_worker_index() -> Optional[int]:
    """Index of the WorkerPool thread running the caller, or None when
    called from outside any pool (e.g. the user's thread)."""
    return getattr(_worker_tls, "index", None)


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
    4 per worker; -1 = unlimited; >0 = that bound). ``device`` is one
    device or one a replica, and ``streams`` one CUDA stream a replica:
    worker ``i`` takes entry ``i % len`` of each. With a CUDA device a
    worker makes it its current device before its first job (a new thread
    has no current CUDA context; cuBLAS warns and takes card 0's), and with
    a stream it runs every job on that stream. Such a job is ordered
    against its submitter's streams (those current, in the submitting
    thread, on the pool's devices): it first waits for the work queued
    there, which made its inputs; its future resolves once its own work is
    done; and every card tensor it returns is recorded on the submitter's
    stream, so the caching allocator hands its block to no other stream
    while the submitter may still read it.
    """

    def __init__(self, num_workers: int = 1, max_queued_batches: int = 0,
                 device=None, streams: Optional[Sequence] = None):
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
        self._stream_devices = sorted({s.device for s in streams or ()},
                                      key=str)
        devices = list(device) if isinstance(device, (list, tuple)) else [device]
        self._workers = []
        for i in range(max(1, num_workers)):
            stream = streams[i % len(streams)] if streams else None
            t = threading.Thread(target=self._run, daemon=True,
                                 args=(i, devices[i % len(devices)], stream),
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
        callers = {d: torch.cuda.current_stream(d) for d in self._stream_devices}
        self._queue.put((future, fn, args, kwargs, callers))
        return future

    def map_ordered(self, fn: Callable, items: Sequence) -> List:
        """Submits one job an item and waits; the results keep the items'
        order."""
        futures = [self.submit(fn, item) for item in items]
        return [f.result() for f in futures]

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

    def _run(self, index: int, device, stream):
        _worker_tls.index = index
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(device)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            self._serve(stream)

    def _serve(self, stream):
        while True:
            try:
                job = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if job is None:
                return
            self._execute(*job, stream)
            # A job's function is a bound method of its Translator or
            # Generator: held in this frame while the thread waits, it would
            # keep that model, and its weights on the card, alive.
            del job

    def _execute(self, future: Future, fn: Callable, args, kwargs, callers,
                 stream):
        if not future.set_running_or_notify_cancel():
            return
        with self._lock:
            self._active += 1
        try:
            if stream is None:
                result = fn(*args, **kwargs)
            else:
                result = _run_on_stream(stream, callers, fn, args, kwargs)
            future.set_result(result)
        except BaseException as e:  # noqa: BLE001
            future.set_exception(e)
        finally:
            with self._lock:
                self._active -= 1


def _run_on_stream(stream, callers: dict, fn: Callable, args, kwargs):
    """``fn(*args, **kwargs)`` on ``stream`` (the current one), after the
    work queued on the submitter's streams ``callers`` (a stream a device).
    Returns once the job's device work is done, even when it raises: the
    job's inputs may be freed, and their blocks reused, as soon as it
    returns. Its card tensors are recorded on the submitter's stream of
    their device."""
    for s in callers.values():
        stream.wait_stream(s)
    try:
        result = fn(*args, **kwargs)
    finally:
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
    for t in _card_tensors(result):
        caller = callers.get(t.device)
        if caller is not None:
            t.record_stream(caller)
    return result


def _card_tensors(node):
    """The CUDA tensors in ``node``: itself, or within its lists, tuples,
    dicts and dataclass fields. A list of plain values (token strings, ids,
    scores) is skipped at its first entry."""
    if torch.is_tensor(node):
        if node.is_cuda:
            yield node
    elif isinstance(node, (list, tuple)):
        if node and not isinstance(node[0], (str, bytes, int, float)):
            for v in node:
                yield from _card_tensors(v)
    elif isinstance(node, dict):
        for v in node.values():
            yield from _card_tensors(v)
    elif dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            yield from _card_tensors(getattr(node, f.name))
