"""Encoder: the encoder-only task API
(parity with reference: include/ctranslate2/encoder.h:9-25,
src/models/language_model.cc:340-403).

Runs an encoder-only model (BERT-style ``TransformerEncoderSpec``) or the
encoder of a sequence-to-sequence model on one CUDA card by default, or
on the CPU when ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import transformer as T
from ..models.loader import LoadedModel
from ..models.params import ParamsBuilder
from ..ops.activations import get_activation
from ..ops.linear import linear
from .base import TaskAPIMixin, move_tree
from .batching import normalize_input_ids, pad_batch
from .results import AsyncResult

# The pooler's activation when the model names none: tanh, BERT's.
TANH = 5


@dataclass
class EncoderForwardOutput:
    last_hidden_state: object  # [B, T, D] on the model's device
    pooler_output: Optional[object] = None  # [B, D], where the model has a pooler


class Encoder(TaskAPIMixin):
    """Encoder forward passes on one device.

    ``device`` is ``"cuda"`` (the default; raises without CUDA) or
    ``"cpu"``. ``flash_attention=True`` sends every attention to the flash
    kernel on the card, whatever its length.
    """

    def __init__(
        self,
        model_path: str,
        device: Optional[str] = None,
        compute_type: str = "default",
        device_index=0,
        inter_threads: int = 1,
        intra_threads: int = 0,
        max_queued_batches: int = 0,
        **kwargs,
    ):
        self.model: LoadedModel = self._load_model(
            model_path, compute_type, device, device_index, kwargs)
        if self.model.arch.encoder is None:
            raise ValueError(
                f"The model at {model_path} does not have an encoder")
        self._apply_flash_flag(kwargs)
        self._init_replicas(device, device_index)
        self._start_pool(inter_threads, max_queued_batches, kwargs)
        pooler = self._load_pooler()
        self._poolers = [None if pooler is None else
                         (move_tree(pooler[0], m.device), pooler[1])
                         for m in self._all_models()]

    @property
    def _pooler(self):
        """The calling thread's replica's pooler, or None."""
        return self._poolers[self._replica_index()]

    def _load_pooler(self):
        """(params, activation) of the BERT-style pooler, a dense layer on
        the first token, or None. The scope is the reference's
        ``pooler_dense`` (transformer_spec.py:797) or ``pooler``, the name
        earlier converters wrote."""
        mf = self.model.mf
        scope = next((s for s in ("pooler_dense", "pooler")
                      if mf.get(s + "/weight") is not None), None)
        if scope is None:
            return None
        params = ParamsBuilder(mf, self.model.policy, self.model.device).linear(scope)
        return params, get_activation(int(mf.attribute("pooler_activation", TANH)))

    def _unload_extra(self, to_cpu: bool) -> None:
        # The pooler's weights live beside the model's params.
        if self._poolers[0] is not None:
            params, activation = self._poolers[0]
            self._unloaded_pooler = (move_tree(params, "cpu") if to_cpu else None,
                                     activation)
            self._poolers = [None] * len(self._poolers)

    def _load_extra(self) -> None:
        kept = getattr(self, "_unloaded_pooler", None)
        if kept is not None:
            moved = {}
            for m in self._all_models():
                if m.device not in moved:
                    moved[m.device] = (move_tree(kept[0], m.device), kept[1])
            self._poolers = [moved[m.device] for m in self._all_models()]
            self._unloaded_pooler = None

    def forward_batch_async(self, inputs, lengths=None, token_type_ids=None):
        """``forward_batch`` on the worker pool (reference:
        include/ctranslate2/encoder.h:9-25)."""
        return AsyncResult(self._pool.submit(
            self.forward_batch, inputs, lengths=lengths,
            token_type_ids=token_type_ids))

    def forward_batch(self, inputs, lengths=None,
                      token_type_ids: Optional[Sequence[Sequence[int]]] = None
                      ) -> EncoderForwardOutput:
        """``inputs``: a batch of token strings, a batch of token ids, or a
        dense id array or tensor (the reference's BatchTokens / BatchIds /
        StorageView variants, python/cpp/encoder.cc:15-40); ``lengths``
        gives a dense array's true row lengths. Rows are padded to a
        multiple of 8 (at least 8)."""
        model = self.model
        vocab = (model.source_vocabularies[0] if model.source_vocabularies
                 else model.target_vocabulary)
        ids = normalize_input_ids(inputs, vocab, lengths)
        padded, lengths = pad_batch(ids, length_multiple=8, min_length=8)
        device = model.device
        ids_t = torch.tensor(padded, dtype=torch.long, device=device)
        lengths_t = torch.tensor(lengths, dtype=torch.long, device=device)
        # Multi-feature encoders (BERT-style token types) take the type ids
        # as a second embedding feature, zeros where absent (reference:
        # src/models/language_model.cc:371-381).
        if model.arch.encoder.embeddings.num_features > 1:
            types = np.zeros((len(padded), len(padded[0])), np.int64)
            for i, row in enumerate(token_type_ids or ()):
                types[i, :len(row)] = row
            ids_t = (ids_t, torch.from_numpy(types).to(device))
        qa = model.policy.quantize_activations
        consts = model.ensure_consts(len(padded[0]))
        out = T.encoder_forward(model.arch, model.params, consts, ids_t,
                                lengths_t, quantize_acts=qa,
                                out_dtype=model.out_dtype)
        pooler_output = None
        if self._pooler is not None:
            params, activation = self._pooler
            pooler_output = linear(params, out[:, 0], activation=activation,
                                   quantize_activations=qa)
        return EncoderForwardOutput(out, pooler_output)
