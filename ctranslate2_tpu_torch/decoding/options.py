"""Decoding options and result structures (API parity with the reference:
include/ctranslate2/decoding.h:44-89, include/ctranslate2/translation.h:11-86,
include/ctranslate2/generation.h:14-78)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class DecodingOptions:
    beam_size: int = 1
    patience: float = 1.0
    length_penalty: float = 1.0
    coverage_penalty: float = 0.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    prefix_bias_beta: float = 0.0
    suppress_sequences: Sequence[Sequence[int]] = ()
    suppress_tokens: Sequence[int] = ()
    suppress_tokens_begin: Sequence[int] = ()
    return_end_token: bool = False  # keep EOS in the output hypothesis
    # Reference include_eos_in_hypotheses (decoding.h:154): when True the
    # terminating EOS counts toward the score-normalization length even
    # though it is stripped from the output unless return_end_token.
    include_eos_in_hypotheses: bool = True
    max_length: int = 256
    min_length: int = 0
    sampling_topk: int = 1
    sampling_topp: float = 1.0
    sampling_temperature: float = 1.0
    num_hypotheses: int = 1
    return_scores: bool = False
    return_attention: bool = False
    return_logits_vocab: bool = False
    return_prefix: bool = True  # include target prefix / prompt in result
    return_alternatives: bool = False
    min_alternative_expansion_prob: float = 0.0
    seed: int = 0  # the random sampler's stream
    # Lossless self-speculative decoding in the greedy device loop
    # (prompt-lookup drafting; >1 enables): each iteration verifies a
    # K-token chunk and accepts the matched prefix + one bonus token.
    speculation_k: int = 0
    # Whisper's timestamp rules (eot, no_timestamps, timestamp_begin,
    # timestamp_end, max_initial_timestamp), or None.
    whisper_ts: Optional[Tuple[int, int, int, int, int]] = None


@dataclass
class DecodingStepResult:
    """One emitted token of the greedy host loop, for a step callback."""
    step: int
    batch_id: int
    token_id: int
    hypothesis_id: int = 0
    score: Optional[float] = None
    is_last: bool = False
    token: Optional[str] = None
    log_probs: Optional[object] = None


@dataclass
class DecodingResult:
    hypotheses: List[List[int]] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    attention: List[List[List[float]]] = field(default_factory=list)
    logits: List[object] = field(default_factory=list)
