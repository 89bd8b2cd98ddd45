"""Iterable and token-streaming API sugar (parity with reference:
python/ctranslate2/extensions.py).

Port of ``ctranslate2_tpu/runtime/extensions.py``:
``translate_iterable`` / ``generate_iterable`` / ``score_iterable`` read
examples in batches and submit the next batches while the first one's
results are consumed; ``translate_tokens`` / ``generate_tokens`` run a
callback-driven call on a worker thread and hand its step results out as
an iterator; ``async_generate_tokens`` exposes the same as an asyncio
iterator.
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import queue
import threading
from typing import AsyncIterable, Iterable, Iterator, List, Optional

import torch

from .results import GenerationStepResult


def _batch_iterator(iterables, max_batch_size: int):
    iterators = [iter(it) for it in iterables]
    while True:
        batch = list(itertools.islice(zip(*iterators), max_batch_size))
        if not batch:
            return
        yield [list(streams) for streams in zip(*batch)]


def _pipelined(submit, batch_stream, lookahead: int) -> Iterator:
    """Overlap the submission of batches N+1..N+lookahead with the
    consumption of batch N (reference futures-queue pipeline:
    extensions.py:527-560). ``submit`` returns a list of AsyncResult for
    one batch."""
    pending = collections.deque()
    stream = iter(batch_stream)
    exhausted = False
    while True:
        while not exhausted and len(pending) <= max(1, lookahead):
            try:
                pending.append(submit(next(stream)))
            except StopIteration:
                exhausted = True
        if not pending:
            return
        for r in pending.popleft():
            yield r.result()


def _lookahead_for(obj) -> int:
    pool = getattr(obj, "_pool", None)
    return (pool.num_workers if pool is not None else 1) + 1


def translate_iterable(translator, source: Iterable[List[str]],
                       target_prefix: Optional[Iterable[List[str]]] = None,
                       max_batch_size: int = 32, batch_type: str = "examples",
                       **kwargs) -> Iterator:
    """Translate an iterable of tokenized examples, pipelined (reference:
    extensions.py:20-83 and the futures queue at 527-560)."""
    streams = [source] if target_prefix is None else [source, target_prefix]

    def submit(batch):
        return translator.translate_batch(
            batch[0], batch[1] if len(batch) > 1 else None,
            max_batch_size=0, batch_type=batch_type, asynchronous=True, **kwargs)

    yield from _pipelined(submit, _batch_iterator(streams, max_batch_size),
                          _lookahead_for(translator))


def generate_iterable(generator, start_tokens: Iterable[List[str]],
                      max_batch_size: int = 32, batch_type: str = "examples",
                      **kwargs) -> Iterator:
    """Generate from an iterable of prompts, pipelined (reference:
    extensions.py:86-137)."""

    def submit(batch):
        return generator.generate_batch(
            batch[0], max_batch_size=0, batch_type=batch_type, asynchronous=True,
            **kwargs)

    yield from _pipelined(submit, _batch_iterator([start_tokens], max_batch_size),
                          _lookahead_for(generator))


def score_iterable(scorer, source: Iterable[List[str]],
                   target: Optional[Iterable[List[str]]] = None,
                   max_batch_size: int = 64, **kwargs) -> Iterator:
    """Score an iterable of examples, pipelined (reference:
    extensions.py:140-196): ``source`` and ``target`` for a Translator, the
    token sequences alone for a Generator."""
    streams = [source] if target is None else [source, target]

    def submit(batch):
        if len(batch) > 1:
            return scorer.score_batch(batch[0], batch[1],
                                      asynchronous=True, **kwargs)
        return scorer.score_batch(batch[0], asynchronous=True, **kwargs)

    yield from _pipelined(submit, _batch_iterator(streams, max_batch_size),
                          _lookahead_for(scorer))


class _StepResultIterator:
    """Runs a callback-driven call on a worker thread and hands its step
    results out as an iterator (reference: extensions.py:473-525).

    ``close()`` makes the next callback return True, which ends the call's
    row, drains the queue and joins the thread; it does nothing once the
    stream has ended. The worker waits for the model's ``device`` before it
    ends, so a closed stream leaves no work queued on the card."""

    _END = object()

    def __init__(self, run_fn, device):
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._error = None
        self._ended = False

        def callback(step_result: GenerationStepResult) -> bool:
            self._queue.put(step_result)
            return self._stop.is_set()

        def worker():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                run_fn(callback)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            except BaseException as e:  # noqa: BLE001
                self._error = e
            finally:
                self._queue.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="ct2tpu-torch-token-stream")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._ended:
            raise StopIteration
        item = self._queue.get()
        if item is self._END:
            self._ended = True
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self):
        if self._ended:
            return
        self._stop.set()
        while self._queue.get() is not self._END:
            pass
        self._ended = True
        self._thread.join()


def generate_tokens(generator, prompt: List[str],
                    **kwargs) -> Iterator[GenerationStepResult]:
    """Stream the generated tokens one by one (reference:
    extensions.py:280-348): a greedy call whose step callback feeds the
    iterator (the host decode loop)."""
    kwargs.pop("beam_size", None)

    def run(callback):
        generator.generate_batch([prompt], beam_size=1, callback=callback, **kwargs)

    return _StepResultIterator(run, generator.model.device)


def translate_tokens(translator, source: List[str],
                     target_prefix: Optional[List[str]] = None,
                     **kwargs) -> Iterator[GenerationStepResult]:
    """Stream the translated tokens one by one (reference:
    extensions.py:199-277)."""
    kwargs.pop("beam_size", None)

    def run(callback):
        translator.translate_batch(
            [source], [target_prefix] if target_prefix else None,
            beam_size=1, callback=callback, **kwargs)

    return _StepResultIterator(run, translator.model.device)


async def async_generate_tokens(generator, prompt: List[str],
                                **kwargs) -> AsyncIterable[GenerationStepResult]:
    """The asyncio form of ``generate_tokens`` (reference:
    extensions.py:351-470): each step is awaited off the event loop. A
    consumer that stops early (or is cancelled) ends the call."""
    loop = asyncio.get_running_loop()
    it = generate_tokens(generator, prompt, **kwargs)
    try:
        while True:
            step = await loop.run_in_executor(None, next, it, None)
            if step is None:
                return
            yield step
    finally:
        await loop.run_in_executor(None, it.close)
