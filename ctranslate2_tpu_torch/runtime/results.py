"""User-facing result types (parity with reference:
include/ctranslate2/translation.h:88-130). The generation and scoring
results come with their slices."""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class TranslationResult:
    hypotheses: List[List[str]] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    attention: List[List[List[float]]] = field(default_factory=list)
    # Vocab logits per hypothesis (reference `return_logits_vocab`:
    # python/cpp/translation_result.cc:20-21). Beam search keeps the
    # finishing step only (reference src/decoding.cc:633-635); greedy
    # keeps every decoded step.
    logits: List[List[object]] = field(default_factory=list)

    def output(self) -> List[str]:
        if not self.hypotheses:
            raise RuntimeError("This result is empty")
        return self.hypotheses[0]

    def score(self) -> float:
        if not self.scores:
            raise RuntimeError("This result has no scores")
        return self.scores[0]

    @property
    def num_hypotheses(self) -> int:
        return len(self.hypotheses)

    @property
    def has_scores(self) -> bool:
        return bool(self.scores)

    @property
    def has_attention(self) -> bool:
        return bool(self.attention)

    def __repr__(self):
        return (f"TranslationResult(hypotheses={self.hypotheses!r}, "
                f"scores={self.scores!r})")


class AsyncResult:
    """Future-backed async handle (reference: the pybind AsyncTranslation /
    AsyncGeneration wrappers over std::future,
    python/cpp/translator.cc + include/ctranslate2/replica_pool.h:173-189).

    Wraps either a plain value (already-computed results, e.g. empty
    sources) or a ``concurrent.futures.Future`` whose value is a list of
    results, of which this handle selects ``index``.
    """

    __slots__ = ("_source", "_index")

    def __init__(self, source, index: Optional[int] = None):
        self._source = source
        self._index = index

    def result(self, timeout: Optional[float] = None):
        src = self._source
        if isinstance(src, Future):
            src = src.result(timeout=timeout)
        return src if self._index is None else src[self._index]

    def done(self) -> bool:
        src = self._source
        return not isinstance(src, Future) or src.done()

    def __repr__(self):
        return f"AsyncResult(done={self.done()})"
