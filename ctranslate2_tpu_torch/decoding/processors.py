"""Vectorized logits processors (the ones the device loops apply).

Port of ``ctranslate2_tpu/decoding/processors.py``: masked tensor ops on
the device, no per-step host synchronization. Whisper's timestamp rules
are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

DISABLE = -3.4e38 / 4  # matches "lowest" semantics without producing NaNs


def _token_mask(token_ids, vocab_size: int, device):
    """[V] bool mask of ``token_ids``, built on the device from scalar
    compares: indexing with a host list would copy it to the card and
    wait for the queued work every step."""
    cols = torch.arange(vocab_size, device=device)
    mask = cols == token_ids[0]
    for t in token_ids[1:]:
        mask |= cols == t
    return mask


def disable_tokens(logits, token_ids: Tuple[int, ...]):
    """Statically disable a fixed token set."""
    if not token_ids:
        return logits
    mask = _token_mask(token_ids, logits.shape[-1], logits.device)
    return torch.where(mask, DISABLE, logits)


def disable_tokens_if(logits, token_ids: Tuple[int, ...], cond):
    """Disable a fixed token set for rows where ``cond`` ([N] bool) holds."""
    if not token_ids:
        return logits
    mask = _token_mask(token_ids, logits.shape[-1], logits.device)
    return torch.where(cond[:, None] & mask[None, :], DISABLE, logits)


def _scatter_any(N: int, V: int, index, flags):
    """[N, V] bool: out[r, index[r, j]] |= flags[r, j]."""
    out = torch.zeros((N, V), dtype=torch.int32, device=index.device)
    out.scatter_add_(1, index.long(), flags.to(torch.int32))
    return out > 0


def repetition_penalty(logits, alive_seq, seq_len: int, penalty: float):
    """Penalize tokens already generated
    (reference: src/decoding_utils.cc RepetitionPenalty::apply): positive
    logits are divided by the penalty, negative multiplied.

    ``alive_seq``: [N, L] history buffer; entries >= seq_len ignored.
    """
    N, V = logits.shape
    L = alive_seq.shape[1]
    valid = (torch.arange(L, device=logits.device)[None, :] < seq_len).expand(N, L)
    seen = _scatter_any(N, V, alive_seq, valid)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def no_repeat_ngram(logits, alive_seq, seq_len: int, ngram_size: int):
    """Ban tokens that would complete an already-seen n-gram
    (reference: src/decoding_utils.cc NoRepeatNgram::apply)."""
    N, V = logits.shape
    L = alive_seq.shape[1]
    n = ngram_size
    if L < n:
        return logits
    device = logits.device
    tail_pos = (seq_len - (n - 1) + torch.arange(n - 1, device=device)).clamp(0, L - 1)
    tail = alive_seq[:, tail_pos]  # [N, n-1]
    j = torch.arange(L - n + 1, device=device)
    idx = j[:, None] + torch.arange(n - 1, device=device)[None, :]  # [W, n-1]
    windows = alive_seq[:, idx]  # [N, W, n-1]
    matches = (windows == tail[:, None, :]).all(dim=-1)  # [N, W]
    in_range = (j + (n - 1)) < seq_len
    matches = matches & in_range[None, :] & (seq_len >= n)
    banned_tokens = alive_seq[:, j + (n - 1)]  # [N, W]
    ban = _scatter_any(N, V, banned_tokens, matches)
    return torch.where(ban, DISABLE, logits)


def suppress_sequences_mask(logits, alive_seq, seq_len: int,
                            sequences: Tuple[Tuple[int, ...], ...]):
    """Ban the final token of any user-suppressed sequence whose previous
    tokens match the tail of the history
    (reference: src/decoding_utils.cc SuppressSequences)."""
    logits = disable_tokens(logits, tuple(s[0] for s in sequences if len(s) == 1))
    N, V = logits.shape
    L = alive_seq.shape[1]
    device = logits.device
    for seq in sequences:
        if len(seq) < 2:
            continue
        k = len(seq) - 1
        if k > L:
            continue
        prev = torch.as_tensor(seq[:-1], dtype=alive_seq.dtype, device=device)
        pos = (seq_len - k + torch.arange(k, device=device)).clamp(0, L - 1)
        tail = alive_seq[:, pos]
        match = (tail == prev[None, :]).all(dim=-1) & (seq_len >= k)
        hit = match[:, None] & (torch.arange(V, device=device) == seq[-1])[None, :]
        logits = torch.where(hit, DISABLE, logits)
    return logits
