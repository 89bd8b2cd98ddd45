"""Decoding options and result structures (API parity with the reference:
include/ctranslate2/decoding.h:44-89, include/ctranslate2/translation.h:11-86).
Options that only unported paths read (coverage penalty, prefix bias,
attention and logits output, alternatives) come with their slices;
``Translator.translate_batch`` rejects them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence


@dataclass
class DecodingOptions:
    beam_size: int = 1
    patience: float = 1.0
    length_penalty: float = 1.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
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
    return_prefix: bool = True  # include target prefix / prompt in result
    seed: int = 0  # the random sampler's stream


@dataclass
class DecodingResult:
    hypotheses: List[List[int]] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
