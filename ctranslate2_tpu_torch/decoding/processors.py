"""Vectorized logits processors (the ones the device loops apply).

Port of ``ctranslate2_tpu/decoding/processors.py``: masked tensor ops on
the device, no per-step host synchronization.
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


def repetition_penalty_per_row(logits, seen, penalties):
    """RepetitionPenalty with a penalty a row (the reference's per-call
    options, include/ctranslate2/translation.h:11-86): ``seen`` [N, V]
    bool presence, ``penalties`` float [N] (1.0 rows are an exact no-op)."""
    p = penalties[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen, penalized, logits)


def no_repeat_ngram_per_row(logits, hist, seq_len, ngram_sizes, max_n: int):
    """NoRepeatNgram with an n-gram size a row (0 turns a row off; sizes up
    to ``max_n``). ``hist`` [N, L] each row's generated tokens, ``seq_len``
    int [N] (or an int) how many.

    End-position form: token ``hist[e]`` is banned for row r iff
    ``hist[e - k] == hist[len - k]`` for every k in 1..n_r-1, the window
    wholly inside the generated tokens; the bans of ``no_repeat_ngram``
    when all rows share one size."""
    N, V = logits.shape
    L = hist.shape[1]
    if max_n < 2:
        return logits
    device = logits.device
    n = ngram_sizes.long()
    if not torch.is_tensor(seq_len):
        seq_len = torch.full((N,), seq_len, dtype=torch.long, device=device)
    seq_len = seq_len.long()
    e = torch.arange(L, device=device)
    k = torch.arange(1, max_n, device=device)
    he = hist[:, (e[:, None] - k[None, :]).clamp(0, L - 1)]  # [N, L, K]
    ht = hist.gather(1, (seq_len[:, None] - k[None, :]).clamp(0, L - 1))  # [N, K]
    lag_off = k[None, None, :] >= n[:, None, None]  # lags past n - 1 match
    match = ((he == ht[:, None, :]) | lag_off).all(dim=-1)  # [N, L]
    valid = ((e[None, :] >= n[:, None] - 1) & (e[None, :] < seq_len[:, None])
             & (seq_len[:, None] >= n[:, None]) & (n[:, None] >= 2))
    ban = _scatter_any(N, V, hist, match & valid)
    return torch.where(ban, DISABLE, logits)


def token_table_mask(token_table, vocab_size: int):
    """[N, V] bool: row r's ids in row r of an [N, W] id table (-1 entries
    drop)."""
    return _scatter_any(token_table.shape[0], vocab_size, token_table.clamp(min=0),
                        token_table >= 0)


def presence_per_row(history, lengths, vocab_size: int):
    """[N, V] bool: the ids among the first ``lengths[r]`` entries of row r
    of ``history`` [N, L]."""
    N, L = history.shape
    valid = torch.arange(L, device=history.device)[None, :] < lengths[:, None]
    return _scatter_any(N, vocab_size, history, valid)


def disable_tokens_per_row(logits, token_table):
    """Disable a token set a row, given as an [N, W] id table (-1 entries
    drop; W == 0 is a no-op)."""
    if token_table.shape[1] == 0:
        return logits
    return torch.where(token_table_mask(token_table, logits.shape[1]), DISABLE, logits)


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


def whisper_timestamp_rules(logits, alive_seq, gen_len, sample_begin,
                            eot_id: int, no_timestamps_id: int,
                            timestamp_begin_id: int, timestamp_end_id: int,
                            max_initial_timestamp_id: int):
    """Whisper's timestamp rules on the device (reference:
    src/models/whisper.cc:742-865 ApplyTimestampRules):

    - <|notimestamps|> is always disabled;
    - at the very first sample (no forced text) only timestamps up to
      ``max_initial_timestamp_id`` are allowed;
    - timestamps come in pairs (except before the end token);
    - timestamps never decrease;
    - where the timestamps' total probability beats every text token, a
      timestamp is forced.

    ``logits`` [N, V] float32, ``alive_seq`` [N, L] the tokens so far,
    ``gen_len`` the step and ``sample_begin`` the forced (prefix) steps:
    each an int (every row alike) or an int [N] tensor (a row each, as the
    continuous batchers give them). The log-sum-exp over the timestamps and
    the best text token are compared in float32, as in the JAX package.
    """
    N, V = logits.shape
    L = alive_seq.shape[1]
    device = logits.device
    l = logits
    tok = torch.arange(V, device=device)[None, :]
    is_ts_vocab = tok >= timestamp_begin_id
    gen_len, sample_begin = (
        x.to(device=device, dtype=torch.long).expand(N) if torch.is_tensor(x)
        else torch.full((N,), int(x), dtype=torch.long, device=device)
        for x in (gen_len, sample_begin))

    l = torch.where(tok == no_timestamps_id, DISABLE, l)

    # The first step: only timestamps, up to max_initial.
    at_init = (gen_len == 0) & (sample_begin == 0)
    init_mask = (tok < timestamp_begin_id) | (tok > max_initial_timestamp_id)
    l = torch.where(at_init[:, None] & init_mask, DISABLE, l)

    applies = gen_len > sample_begin
    rows = torch.arange(N, device=device)
    last = alive_seq[rows, (gen_len - 1).clamp(0, L - 1)]
    penult_raw = alive_seq[rows, (gen_len - 2).clamp(0, L - 1)]
    penult = torch.where(gen_len - 1 > sample_begin, penult_raw, last)
    last_is_ts = last >= timestamp_begin_id
    pen_is_ts = penult >= timestamp_begin_id

    # Pairs.
    rule_a = applies & last_is_ts & pen_is_ts
    l = torch.where(rule_a[:, None] & is_ts_vocab, DISABLE, l)
    rule_b = applies & last_is_ts & ~pen_is_ts
    mask_b = (tok < eot_id) | (is_ts_vocab & (tok < last[:, None]))
    l = torch.where(rule_b[:, None] & mask_b, DISABLE, l)

    # Non-decreasing timestamps.
    pos = torch.arange(L, device=device)[None, :]
    in_window = (pos < gen_len[:, None]) & (pos >= sample_begin[:, None])
    is_ts_hist = (alive_seq >= timestamp_begin_id) & in_window
    latest_pos = torch.where(is_ts_hist, pos, -1).max(dim=1).values
    has_ts = latest_pos >= 0
    latest_tok = alive_seq[rows, latest_pos.clamp(0, L - 1)]
    rule_c = applies & ~last_is_ts & has_ts
    mask_c = is_ts_vocab & (tok <= latest_tok[:, None])
    l = torch.where(rule_c[:, None] & mask_c, DISABLE, l)

    # Probability: the timestamps' total against the best text token.
    check = applies & (rule_b | ~last_is_ts)
    lp = torch.log_softmax(l.float(), dim=-1)
    max_text = torch.where(tok < timestamp_begin_id, lp, -torch.inf).max(dim=1).values
    ts_lse = torch.logsumexp(torch.where(is_ts_vocab, lp, -torch.inf), dim=1)
    force_ts = check & (ts_lse > max_text)
    return torch.where(force_ts[:, None] & (tok < timestamp_begin_id), DISABLE, l)
