"""Host-side batching: length-sorted rebatching and shape bucketing.

Reproduces the reference semantics — sort by length descending so similar
lengths share a batch (reference: src/batch_reader.cc:174-227), split by
``max_batch_size`` in examples or tokens — and pads shapes to coarse buckets,
as the JAX package does, so both packages see the same padded inputs.
"""

from __future__ import annotations

import collections
import numbers
from typing import List, Sequence, Tuple


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def bucket_length(n: int, multiple: int = 16, minimum: int = 16) -> int:
    return max(round_up(n, multiple), minimum)


def rebatch_input(
    lengths: Sequence[int],
    max_batch_size: int = 0,
    batch_type: str = "examples",
) -> List[List[int]]:
    """Return batches of example indices, longest-first within and across
    batches (reference: src/batch_reader.cc:174-227), by the native core's
    ``rebatch`` (a stable sort: equal lengths keep their order)."""
    from ..native import rebatch

    return rebatch([int(n) for n in lengths], max_batch_size, batch_type)


def rebatch_input_plain(
    lengths: Sequence[int],
    max_batch_size: int = 0,
    batch_type: str = "examples",
) -> List[List[int]]:
    """``rebatch_input``'s plain version, in Python."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    if max_batch_size <= 0:
        return [order] if order else []

    batches: List[List[int]] = []
    current: List[int] = []
    current_longest = 0
    for idx in order:
        if batch_type == "tokens":
            # Padding-aware: cost of adding this example is the padded size.
            longest = max(current_longest, lengths[idx])
            if current and longest * (len(current) + 1) > max_batch_size:
                batches.append(current)
                current = []
                current_longest = 0
            current.append(idx)
            current_longest = max(current_longest, lengths[idx])
        else:
            current.append(idx)
            if len(current) >= max_batch_size:
                batches.append(current)
                current = []
    if current:
        batches.append(current)
    return batches


def pad_batch(
    ids: Sequence[Sequence[int]],
    pad_id: int = 0,
    length_multiple: int = 1,
    min_length: int = 1,
) -> Tuple[List[List[int]], List[int]]:
    """Pad ragged id lists to a common (bucketed) length.

    Returns (padded, lengths).
    """
    lengths = [len(x) for x in ids]
    max_len = max(max(lengths), min_length)
    max_len = round_up(max_len, length_multiple)
    padded = [list(x) + [pad_id] * (max_len - len(x)) for x in ids]
    return padded, lengths


def default_read_batch_size(read_batch_size: int, max_batch_size: int):
    """The reference's read-window default: 16 batches' worth, or the batch
    itself at batch size 1 (replica_pool.h:210-211). None for an unbounded
    window (``max_batch_size`` 0)."""
    if read_batch_size > 0:
        return read_batch_size
    size = max_batch_size if max_batch_size == 1 else max_batch_size * 16
    return size if size > 0 else None


def consume_stream(read_window, submit, write, max_pending: int = 0):
    """The reference's consume_batches loop (replica_pool.h:191-226): read a
    window of examples, submit it asynchronously, and write the finished
    results in submission order, so reading, computing and writing overlap.

    ``read_window()`` returns the next window (falsy at the end);
    ``submit`` maps a window to a sequence of AsyncResults; ``write`` takes
    one resolved result. ``max_pending`` (> 0) bounds the results in flight
    by waiting on the oldest: the reference's max_queued_batches
    backpressure. On an error the results in flight settle before it
    propagates, so no worker is left computing for a closed file.
    """
    pending = collections.deque()

    def drain(blocking):
        while pending and (blocking or pending[0].done()):
            write(pending.popleft().result())

    try:
        while True:
            window = read_window()
            if not window:
                break
            pending.extend(submit(window))
            drain(blocking=False)
            while max_pending and len(pending) > max_pending:
                write(pending.popleft().result())
        drain(blocking=True)
    except BaseException:
        while pending:
            try:
                pending.popleft().result()
            except Exception:
                pass
        raise


def normalize_input_ids(inputs, vocab, lengths=None):
    """Coerce a forward_batch input (a batch of token strings, a batch of
    token ids, or a dense id array or tensor: the reference's BatchTokens /
    BatchIds / StorageView variants) into a list of id lists.

    ``lengths`` (only meaningful for a dense array, which carries no
    natural per-row length) trims each row to its true length, so padding
    is not attended or scored as real tokens.
    """
    if hasattr(inputs, "shape"):
        rows = inputs.tolist()
        if lengths is not None:
            rows = [row[:int(n)] for row, n in zip(rows, lengths)]
        return rows
    if lengths is not None:
        raise ValueError(
            "lengths is only accepted with a dense id array input")
    return [[int(t) if isinstance(t, numbers.Integral) else vocab.to_id(t)
             for t in seq]
            for seq in inputs]
