"""Host-side batching: length-sorted rebatching and shape bucketing.

Reproduces the reference semantics — sort by length descending so similar
lengths share a batch (reference: src/batch_reader.cc:174-227), split by
``max_batch_size`` in examples or tokens — and pads shapes to coarse buckets,
as the JAX package does, so both packages see the same padded inputs.
"""

from __future__ import annotations

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
    batches (reference: src/batch_reader.cc:174-227)."""
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
