"""Teacher-forced scoring shared by ``Translator.score_batch`` and
``Generator.score_batch`` / ``forward_batch`` (reference:
src/scoring.cc:5-68, src/models/language_model.cc:279-299): one uncached
decoder pass over whole sequences, then float32 log-softmax."""

from __future__ import annotations

from typing import List

import torch

from ..models import transformer as T
from .batching import pad_batch


def teacher_forced_scores(model, full_ids, mem_kv=None,
                          mem_bias=None) -> List[List[float]]:
    """The log-prob of each next token of every row of ``full_ids`` under
    one uncached decoder pass over all but its last position: rows padded
    to a multiple of 8 (at least 8), float32 log-softmax of the logits,
    gathered at the next token. Returns, per row, the scores of the padded
    width's positions (the caller keeps its row's)."""
    padded, lengths = pad_batch(full_ids, length_multiple=8, min_length=8)
    ids = torch.tensor(padded, dtype=torch.long, device=model.device)
    lengths = torch.tensor(lengths, dtype=torch.long, device=model.device)
    logits = teacher_forced_logits(model, ids[:, :-1], lengths - 1, mem_kv,
                                   mem_bias)
    return next_token_log_probs(logits, ids[:, 1:]).tolist()


def teacher_forced_logits(model, ids, lengths, mem_kv=None, mem_bias=None):
    """Logits [B, T, V] of one uncached decoder pass over ``ids`` [B, T]
    with per-row ``lengths`` [B]."""
    consts = model.ensure_consts(ids.shape[1])
    logits, _ = T.decoder_forward(
        model.arch, model.params, consts, ids, 0, None, mem_kv,
        mem_bias, lengths=lengths,
        quantize_acts=model.policy.quantize_activations,
        out_dtype=model.out_dtype)
    return logits


def next_token_log_probs(logits, next_ids):
    """float32 ``log_softmax(logits)`` gathered at ``next_ids``: [B, T, V]
    and [B, T] -> [B, T] float32. The log-softmax is taken one batch row at
    a time, so that only one row of the float32 [B, T, V] tensor is held
    at once (1 GB for a row of 2,055 positions over 128,256 words)."""
    out = torch.empty(next_ids.shape, dtype=torch.float32, device=logits.device)
    for row in range(logits.shape[0]):
        log_probs = torch.log_softmax(logits[row].float(), dim=-1)
        out[row] = log_probs.gather(-1, next_ids[row, :, None])[:, 0]
    return out
