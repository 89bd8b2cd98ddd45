"""Micro-batching serving scheduler.

Port of ``ctranslate2_tpu/runtime/scheduler.py`` (reference:
include/ctranslate2/replica_pool.h:19-367,
src/buffered_translation_wrapper.cc:5-111): requests accumulate in a
bounded queue; a scheduler thread takes up to ``max_batch_size`` of them
(waiting at most ``batch_timeout_ms`` once one is pending), groups the
requests that share decoding options and runs each group as one batch
call. Results resolve per-request futures.

The queue is the native core's ``RequestQueue`` (a bounded MPMC queue
that waits for a batch without the GIL); ``_PyQueue`` is its plain
version, in Python, with the same semantics.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

from .. import native


class _PyQueue:
    """A bounded FIFO: ``put`` blocks while ``max_size`` items wait (0:
    unbounded); ``collect`` returns up to ``max_items`` once ``min_items``
    are there or ``timeout_ms`` has passed."""

    def __init__(self, max_size: int = 0):
        self._items = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._max = max_size
        self._closed = False

    def put(self, item):
        with self._cv:
            while self._max > 0 and len(self._items) >= self._max and not self._closed:
                self._cv.wait()
            self._items.append(item)
            self._cv.notify_all()

    def collect(self, max_items: int, timeout_ms: float, min_items: int = 1):
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while len(self._items) < min_items and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    break
            out = []
            while self._items and (max_items <= 0 or len(out) < max_items):
                out.append(self._items.popleft())
            self._cv.notify_all()
            return out

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def size(self):
        with self._lock:
            return len(self._items)


def _frozen(value):
    """A hashable form of an option's value: lists (a target prefix) as
    tuples. (The JAX package hashes the values as given: a list there ends
    its scheduler thread, and every request after it waits forever.)"""
    if isinstance(value, (list, tuple)):
        return tuple(_frozen(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _frozen(v)) for k, v in value.items()))
    return value


class _Request:
    __slots__ = ("example", "options_key", "options", "future")

    def __init__(self, example, options_key, options):
        self.example = example
        self.options_key = options_key
        self.options = options
        self.future = Future()


class ServingScheduler:
    """Futures-based micro-batching front-end over ``run_batch(examples,
    options) -> results``, one result an example."""

    def __init__(
        self,
        run_batch: Callable[[List, dict], List],
        max_batch_size: int = 32,
        batch_timeout_ms: float = 5.0,
        max_queue_size: int = 0,
    ):
        self._run_batch = run_batch
        self._max_batch_size = max_batch_size
        self._timeout_ms = batch_timeout_ms
        self._queue = native.RequestQueue(max_queue_size)
        self._active = 0
        self._active_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ct2tpu-torch-scheduler")
        self._thread.start()

    def submit(self, example, **options) -> Future:
        """Queues one example; requests whose options are equal share a
        batch. An option whose value cannot be compared raises here."""
        if self._closed:
            raise RuntimeError("Scheduler is closed")
        key = tuple(sorted((k, _frozen(v)) for k, v in options.items()))
        hash(key)
        req = _Request(example, key, options)
        self._queue.put(req)
        return req.future

    @property
    def num_queued(self) -> int:
        return self._queue.size()

    @property
    def num_active_batches(self) -> int:
        with self._active_lock:
            return self._active

    def close(self):
        self._closed = True
        self._queue.close()
        self._thread.join(timeout=5)

    def _loop(self):
        while True:
            requests = self._queue.collect(self._max_batch_size, self._timeout_ms)
            if not requests:
                if self._closed:
                    return
                continue
            # A batch shares its options: one group per options signature.
            groups: Dict[tuple, List[_Request]] = {}
            for r in requests:
                groups.setdefault(r.options_key, []).append(r)
            for group in groups.values():
                with self._active_lock:
                    self._active += 1
                try:
                    results = self._run_batch(
                        [r.example for r in group], dict(group[0].options))
                    for r, res in zip(group, results):
                        r.future.set_result(res)
                except BaseException as e:  # noqa: BLE001
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)
                finally:
                    with self._active_lock:
                        self._active -= 1


def translation_scheduler(translator, **kwargs) -> ServingScheduler:
    """A ``ServingScheduler`` over ``translator.translate_batch``; an
    example is a source, ``target_prefix`` an option of its own."""
    def run(examples, options):
        prefixes = options.pop("target_prefix", None)
        return translator.translate_batch(examples, prefixes, **options)

    return ServingScheduler(run, **kwargs)


def generation_scheduler(generator, **kwargs) -> ServingScheduler:
    """A ``ServingScheduler`` over ``generator.generate_batch``."""
    def run(examples, options):
        return generator.generate_batch(examples, **options)

    return ServingScheduler(run, **kwargs)


class BufferedTranslationWrapper:
    """Single-request micro-batching facade over a ``Translator``
    (reference: BufferedTranslationWrapper,
    src/buffered_translation_wrapper.cc:5-111: a background thread gathers
    single ``translate_async`` calls into batches, flushed on size or
    timeout). A target prefix rides with its example
    (buffered_translation_wrapper.cc:36-47); requests with other decoding
    options run as separate groups."""

    def __init__(
        self,
        translator,
        max_batch_size: int = 32,
        batch_timeout_in_micros: int = 5000,
        max_queue_size: int = 0,
    ):
        def run(examples, options):
            sources = [e[0] for e in examples]
            prefixes = [e[1] for e in examples]
            if all(p is None for p in prefixes):
                prefixes = None
            return translator.translate_batch(sources, prefixes, **options)

        self._scheduler = ServingScheduler(
            run,
            max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_in_micros / 1000.0,
            max_queue_size=max_queue_size,
        )

    def translate_async(self, source: Sequence[str],
                        target_prefix: Optional[Sequence[str]] = None,
                        **options) -> Future:
        """Queues ONE example; the Future resolves to its TranslationResult
        (reference translate_async, buffered_translation_wrapper.cc:20-66)."""
        return self._scheduler.submit(
            (tuple(source), tuple(target_prefix) if target_prefix else None),
            **options)

    @property
    def num_queued(self) -> int:
        return self._scheduler.num_queued

    @property
    def num_active_batches(self) -> int:
        return self._scheduler.num_active_batches

    def close(self):
        self._scheduler.close()
