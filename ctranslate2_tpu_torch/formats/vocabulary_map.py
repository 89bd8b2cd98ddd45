"""Vocabulary map (vmap): n-gram source -> candidate target-id rules.

Format and lookup semantics mirror the reference
(reference: src/vocabulary_map.cc:7-77): each ``vmap.txt`` line is
``<source ngram>\\t<candidate tokens separated by spaces>``; the empty-key
rule lists always-allowed tokens; unk/bos/eos are always candidates.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set

from .vocabulary import Vocabulary


class VocabularyMap:
    def __init__(self, rules: List[Dict[str, List[int]]], fixed: Set[int],
                 vocabulary_size: int):
        self._rules = rules  # index h = (h+1)-gram rules
        self._fixed = fixed
        self.vocabulary_size = vocabulary_size

    @classmethod
    def load(cls, path: str, vocabulary: Vocabulary) -> "VocabularyMap":
        with open(path, encoding="utf-8") as f:
            return cls.from_lines(f, vocabulary)

    @classmethod
    def from_lines(cls, lines, vocabulary: Vocabulary) -> "VocabularyMap":
        """Build from an iterable of vmap lines (file object or list)."""
        rules: List[Dict[str, List[int]]] = []
        for line in lines:
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                key, values_str = line.split("\t", 1)
            else:
                key, values_str = line, ""
            values = [vocabulary.to_id(t) for t in values_str.split(" ") if t]
            ngram = key.count(" ") + 1
            while len(rules) < ngram:
                rules.append({})
            rules[ngram - 1][key] = values

        fixed = {vocabulary.unk_id, vocabulary.bos_id, vocabulary.eos_id}
        if rules and "" in rules[0]:
            fixed.update(rules[0][""])
        return cls(rules, fixed, len(vocabulary))

    def get_candidates(
        self,
        source_tokens: Sequence[Sequence[str]],
        target_prefix_ids: Sequence[Sequence[int]] = (),
    ) -> List[int]:
        candidates = set(self._fixed)
        for tokens in source_tokens:
            for i in range(len(tokens)):
                accu = ""
                for h in range(len(self._rules)):
                    if i + h >= len(tokens):
                        break
                    accu = tokens[i + h] if h == 0 else accu + " " + tokens[i + h]
                    values = self._rules[h].get(accu)
                    if values:
                        candidates.update(values)
        for ids in target_prefix_ids:
            candidates.update(ids)
        return sorted(candidates)
