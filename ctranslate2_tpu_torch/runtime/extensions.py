"""Iterable API sugar (parity with reference:
python/ctranslate2/extensions.py).

Port of the part of ``ctranslate2_tpu/runtime/extensions.py`` that
``score_iterable`` needs: examples are read in batches, and the next
batches are submitted while the first one's results are consumed. The
translate, generate and token-streaming helpers are not ported yet.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, List, Optional


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
