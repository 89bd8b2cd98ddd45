"""Token <-> id vocabulary, compatible with CTranslate2 model directories.

Supports text files (one token per line, uniform trailing-CR stripping) and
JSON list files (reference: src/vocabulary.cc:9-34), with the same
duplicate-token and unk-append semantics (reference: src/vocabulary.cc:36-54).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence


@dataclass
class VocabularyInfo:
    unk_token: str = "<unk>"
    bos_token: str = "<s>"
    eos_token: str = "</s>"


class Vocabulary:
    def __init__(self, tokens: Sequence[str], info: Optional[VocabularyInfo] = None):
        self._info = info or VocabularyInfo()
        self._id_to_token: List[str] = []
        self._token_to_id: Dict[str, int] = {}
        for token in tokens:
            self._add(token)
        if self._info.unk_token not in self._token_to_id:
            self._add(self._info.unk_token)

    def _add(self, token: str) -> None:
        # First occurrence wins for token->id; every line still gets an id.
        self._token_to_id.setdefault(token, len(self._id_to_token))
        self._id_to_token.append(token)

    @classmethod
    def from_text_file(cls, path: str, info: Optional[VocabularyInfo] = None) -> "Vocabulary":
        with open(path, encoding="utf-8", newline="") as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        # Strip one trailing CR per line only if every line has one.
        if lines and all(line.endswith("\r") for line in lines):
            lines = [line[:-1] for line in lines]
        return cls(lines, info)

    @classmethod
    def from_json_file(cls, path: str, info: Optional[VocabularyInfo] = None) -> "Vocabulary":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), info)

    @classmethod
    def load(cls, directory: str, name: str, info: Optional[VocabularyInfo] = None
             ) -> Optional["Vocabulary"]:
        """Load ``<name>.json`` or ``<name>.txt`` from a model directory."""
        json_path = os.path.join(directory, name + ".json")
        if os.path.isfile(json_path):
            return cls.from_json_file(json_path, info)
        txt_path = os.path.join(directory, name + ".txt")
        if os.path.isfile(txt_path):
            return cls.from_text_file(txt_path, info)
        return None

    @classmethod
    def from_text_bytes(cls, data: bytes, info: Optional[VocabularyInfo] = None
                        ) -> "Vocabulary":
        lines = data.decode("utf-8").split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        if lines and all(line.endswith("\r") for line in lines):
            lines = [line[:-1] for line in lines]
        return cls(lines, info)

    @classmethod
    def load_from_files(cls, files, name: str,
                        info: Optional[VocabularyInfo] = None
                        ) -> Optional["Vocabulary"]:
        """In-memory analog of :meth:`load` over a ``{filename: content}``
        mapping (reference: files= model loading)."""
        from .model_file import file_content_bytes

        if name + ".json" in files:
            data = file_content_bytes(files[name + ".json"])
            return cls(json.loads(data), info)
        if name + ".txt" in files:
            return cls.from_text_bytes(
                file_content_bytes(files[name + ".txt"]), info)
        return None

    # ---- basic access ----

    def __len__(self) -> int:
        return len(self._id_to_token)

    def __contains__(self, token: str) -> bool:
        return token in self._token_to_id

    @property
    def unk_token(self) -> str:
        return self._info.unk_token

    @property
    def bos_token(self) -> str:
        return self._info.bos_token

    @property
    def eos_token(self) -> str:
        return self._info.eos_token

    @property
    def unk_id(self) -> int:
        return self._token_to_id[self._info.unk_token]

    @property
    def bos_id(self) -> int:
        return self.to_id(self._info.bos_token)

    @property
    def eos_id(self) -> int:
        return self.to_id(self._info.eos_token)

    def to_id(self, token: str, allow_unk: bool = True) -> int:
        idx = self._token_to_id.get(token)
        if idx is None:
            if not allow_unk and token != self._info.unk_token:
                raise ValueError(f"Token {token!r} is not in the vocabulary")
            return self._token_to_id[self._info.unk_token]
        return idx

    def to_token(self, idx: int) -> str:
        if not 0 <= idx < len(self._id_to_token):
            raise ValueError(f"Invalid token ID {idx}")
        return self._id_to_token[idx]

    # ---- batch conversions ----

    def tokens_to_ids(
        self,
        batch: Sequence[Sequence[str]],
        max_length: int = 0,
        add_bos: bool = False,
        add_eos: bool = False,
        prefix: Sequence[str] = (),
        suffix: Sequence[str] = (),
    ) -> List[List[int]]:
        prefix_ids = [self.to_id(t) for t in prefix]
        suffix_ids = [self.to_id(t) for t in suffix]
        if add_bos:
            prefix_ids = [self.to_id(self._info.bos_token)] + prefix_ids
        if add_eos:
            suffix_ids = suffix_ids + [self.to_id(self._info.eos_token)]
        out = []
        for tokens in batch:
            ids = [self.to_id(t) for t in tokens]
            if max_length and len(ids) + len(prefix_ids) + len(suffix_ids) > max_length:
                ids = ids[: max_length - len(prefix_ids) - len(suffix_ids)]
            out.append(prefix_ids + ids + suffix_ids)
        return out

    def ids_to_tokens(self, batch: Sequence[Sequence[int]]) -> List[List[str]]:
        return [[self.to_token(i) for i in ids] for ids in batch]
