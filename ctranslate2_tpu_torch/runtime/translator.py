"""Translator: the sequence-to-sequence task API
(parity with reference: include/ctranslate2/translator.h:26-345,
src/models/sequence_to_sequence.cc:304-470).

Runs on one CUDA card by default, or on the CPU when ``device="cpu"``.
``score_batch``, ``translate_file``, ``use_vmap`` and the options that
need a host-side decode loop are not ported yet.
"""

from __future__ import annotations

import sys
from concurrent.futures import Future
from typing import List, Optional, Sequence

import torch

from ..decoding.engine import DecodingEngine
from ..decoding.options import DecodingOptions
from ..models import transformer as T
from ..models.loader import LoadedModel, load_model, resolve_device
from .base import TaskAPIMixin
from .batching import bucket_length, pad_batch, rebatch_input
from .pool import WorkerPool, resolve_max_queued_batches
from .results import AsyncResult, TranslationResult

# Source-factor separator (reference: include/ctranslate2/utils.h:33).
FEATURES_SEPARATOR = "￨"


def extract_features(batch, num_features: int,
                     separator: str = FEATURES_SEPARATOR):
    """Split ``tok￨f1￨...`` factored tokens into per-feature token streams
    ([F][B][T]) (reference: src/utils.cc:158-190)."""
    if num_features == 1:
        return [[list(tokens) for tokens in batch]]
    features = [[] for _ in range(num_features)]
    for tokens in batch:
        for stream in features:
            stream.append([])
        for token in tokens:
            fields = token.split(separator)
            if len(fields) != num_features:
                raise ValueError(
                    f"Expected {num_features} input features, but token "
                    f"'{token}' has {len(fields)} features")
            for i, field in enumerate(fields):
                features[i][-1].append(field)
    return features


class Translator(TaskAPIMixin):
    """Sequence-to-sequence translation on one device.

    ``device`` is ``"cuda"`` (the default; raises without CUDA) or
    ``"cpu"``. ``inter_threads`` sets the number of worker threads that
    run batches; ``intra_threads`` is accepted for API parity and left to
    PyTorch's own thread setting.
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
        if kwargs.get("tensor_parallel"):
            raise NotImplementedError("tensor parallelism is not ported yet")
        self.model: LoadedModel = load_model(
            model_path, compute_type=compute_type, files=kwargs.get("files"),
            device=resolve_device(device, device_index))
        if not self.model.is_sequence_to_sequence:
            raise ValueError(
                f"The model at {model_path} is not an encoder-decoder model "
                "that can be used with Translator")
        T.check_supported(self.model.arch)
        self._pool = WorkerPool(
            num_workers=max(1, inter_threads),
            max_queued_batches=resolve_max_queued_batches(
                kwargs, max_queued_batches))
        self.engine = DecodingEngine(self.model)

    @property
    def _source_vocab(self):
        return self.model.source_vocabularies[0]

    @property
    def _target_vocab(self):
        return self.model.target_vocabulary

    def _source_feature_streams(self, source: Sequence[Sequence[str]]):
        """Split ``￨``-factored tokens once, validating the vocabulary
        count (reference: src/models/sequence_to_sequence.cc:144-166)."""
        num_features = self.model.arch.encoder.embeddings.num_features
        if len(self.model.source_vocabularies) != num_features:
            raise RuntimeError(
                f"The encoder expects {num_features} input features, but "
                f"{len(self.model.source_vocabularies)} source vocabularies "
                "are loaded")
        return extract_features(source, num_features)

    def _ids_from_streams(self, streams, max_input_length: int):
        cfg = self.model.config
        return [
            vocab.tokens_to_ids(
                stream,
                max_length=max_input_length,
                add_bos=bool(cfg.get("add_source_bos", False)),
                add_eos=bool(cfg.get("add_source_eos", False)),
            )
            for vocab, stream in zip(self.model.source_vocabularies, streams)
        ]

    def _decoder_start_id(self) -> Optional[int]:
        start = self.model.config.get("decoder_start_token", "<s>")
        if start is None:
            return None
        return self._target_vocab.to_id(start)

    # ------------------------------------------------------------------

    def translate_batch(
        self,
        source: Sequence[Sequence[str]],
        target_prefix: Optional[Sequence[Optional[Sequence[str]]]] = None,
        *,
        max_batch_size: int = 0,
        batch_type: str = "examples",
        asynchronous: bool = False,
        beam_size: int = 2,
        patience: float = 1.0,
        num_hypotheses: int = 1,
        length_penalty: float = 1.0,
        coverage_penalty: float = 0.0,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        disable_unk: bool = False,
        suppress_sequences: Sequence[Sequence[str]] = (),
        end_token=None,
        return_end_token: bool = False,
        prefix_bias_beta: float = 0.0,
        max_input_length: int = 1024,
        max_decoding_length: int = 256,
        min_decoding_length: int = 1,
        use_vmap: bool = False,
        return_scores: bool = False,
        return_logits_vocab: bool = False,
        return_attention: bool = False,
        return_alternatives: bool = False,
        min_alternative_expansion_prob: float = 0.0,
        sampling_topk: int = 1,
        sampling_topp: float = 1.0,
        sampling_temperature: float = 1.0,
        replace_unknowns: bool = False,
        callback=None,
    ) -> List[TranslationResult]:
        if len(source) == 0:
            return []
        unported = [name for name, on in (
            ("use_vmap", use_vmap), ("replace_unknowns", replace_unknowns),
            ("callback", callback is not None),
            ("return_attention", return_attention),
            ("return_alternatives", return_alternatives),
            ("return_logits_vocab", return_logits_vocab),
            ("coverage_penalty", coverage_penalty != 0),
            ("prefix_bias_beta", prefix_bias_beta > 0),
            ("random sampling", sampling_topk != 1 or sampling_topp < 1.0),
        ) if on]
        if unported:
            raise NotImplementedError("not ported yet: " + ", ".join(unported))
        try:
            # Reference wording (src/decoding.cc:1036-1039).
            if min_decoding_length > max_decoding_length:
                raise ValueError(
                    "The minimum decoding length is greater than the "
                    "maximum decoding length")
            if max_decoding_length == 0:
                raise ValueError("The maximum decoding length must be > 0")
        except ValueError:
            if not asynchronous:
                raise
            failed = Future()
            failed.set_exception(sys.exc_info()[1])
            return [AsyncResult(failed, 0) for _ in source]

        tv = self._target_vocab
        end_ids = self._resolve_end_token(end_token)
        options = DecodingOptions(
            beam_size=beam_size,
            patience=patience,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            suppress_tokens=((tv.unk_id,) if disable_unk else ()),
            suppress_sequences=tuple(
                tuple(tv.to_id(t, allow_unk=False) for t in seq)
                for seq in suppress_sequences
            ),
            return_end_token=return_end_token,
            max_length=max_decoding_length,
            min_length=min_decoding_length,
            num_hypotheses=num_hypotheses,
            return_scores=return_scores,
            return_prefix=True,
        )

        results: List[Optional[TranslationResult]] = [None] * len(source)
        # Empty-source rows are resolved without running the model
        # (reference: src/models/sequence_to_sequence.cc:432-470).
        compute_idx = []
        for i, src in enumerate(source):
            if len(src) == 0:
                results[i] = self._empty_source_result(
                    target_prefix[i] if target_prefix else None, options)
            else:
                compute_idx.append(i)

        batches = rebatch_input(
            [len(source[i]) for i in compute_idx], max_batch_size, batch_type)
        async_results = [None if r is None else AsyncResult(r) for r in results]
        futures = []
        for batch in batches:
            idx = [compute_idx[j] for j in batch]
            batch_prefix = ([target_prefix[i] for i in idx]
                            if target_prefix else None)
            future = self._pool.submit(
                self._translate_padded, [source[i] for i in idx],
                batch_prefix, options, max_input_length, end_ids)
            futures.append((idx, future))
            for pos, i in enumerate(idx):
                async_results[i] = AsyncResult(future, pos)

        if asynchronous:
            return async_results
        for idx, future in futures:
            out = future.result()
            for pos, i in enumerate(idx):
                results[i] = out[pos]
        return results

    def _resolve_end_token(self, end_token) -> tuple:
        tv = self._target_vocab
        if end_token is None or end_token == "":
            return (tv.eos_id,)
        if isinstance(end_token, str):
            return (tv.to_id(end_token, allow_unk=False),)
        ids = [t if isinstance(t, int) else tv.to_id(t, allow_unk=False)
               for t in end_token]
        return tuple(ids) if ids else (tv.eos_id,)

    @staticmethod
    def _empty_source_result(prefix, options):
        hypothesis: List[str] = list(prefix)[: options.max_length] if prefix else []
        r = TranslationResult()
        for _ in range(options.num_hypotheses):
            r.hypotheses.append(list(hypothesis))
            if options.return_scores:
                r.scores.append(0.0)
        return r

    def _pad_feature_ids(self, feature_ids):
        """Pad [F][B][T] feature id batches to one bucketed length.

        Returns (ids, lengths) on the model's device: ids is a single [B, S]
        tensor for F == 1 or a tuple of per-feature tensors."""
        device = self.model.device
        arrays = []
        lengths = None
        S = None
        for stream in feature_ids:
            p, l = pad_batch(stream, length_multiple=1)
            if lengths is None:
                lengths, S = l, bucket_length(len(p[0]), 8)
            p = [row + [0] * (S - len(row)) for row in p]
            arrays.append(torch.tensor(p, dtype=torch.long, device=device))
        ids = arrays[0] if len(arrays) == 1 else tuple(arrays)
        return ids, torch.tensor(lengths, dtype=torch.long, device=device)

    def _translate_padded(self, source, target_prefix, options,
                          max_input_length, end_ids):
        tv = self._target_vocab
        streams = self._source_feature_streams(source)
        feature_ids = self._ids_from_streams(streams, max_input_length)
        enc_ids, enc_lengths = self._pad_feature_ids(feature_ids)

        start_id = self._decoder_start_id()
        prefix_ids = None
        if target_prefix is not None and any(p for p in target_prefix):
            prefix_ids = [(tv.tokens_to_ids([p])[0] if p else [])
                          for p in target_prefix]
        if start_id is None:
            if prefix_ids is None or any(not p for p in prefix_ids):
                raise ValueError(
                    "The model requires a target prefix as the decoder start token")
            start_ids = [p[0] for p in prefix_ids]
            prefix_ids = [p[1:] for p in prefix_ids]
        else:
            start_ids = [start_id] * len(source)

        dec_results = self.engine.decode(
            start_ids, options, encoder_inputs=(enc_ids, enc_lengths),
            prefix_ids=prefix_ids, end_ids=end_ids)
        return [
            TranslationResult(
                hypotheses=[[tv.to_token(t) for t in h] for h in dr.hypotheses],
                scores=dr.scores if options.return_scores else [])
            for dr in dec_results
        ]
