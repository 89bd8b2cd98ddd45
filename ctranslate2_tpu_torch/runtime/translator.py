"""Translator: the sequence-to-sequence task API
(parity with reference: include/ctranslate2/translator.h:26-345,
src/models/sequence_to_sequence.cc:304-470).

Runs on one CUDA card by default, or on the CPU when ``device="cpu"``.
``translate_batch`` (beam or greedy, argmax or random sampling, with every
option: attention and ``replace_unknowns``, the coverage penalty,
prefix-biased decoding, vocabulary logits, alternatives, a vocabulary map
and step callbacks), ``score_batch``, the file helpers ``translate_file``
and ``score_file``, and the streaming helpers ``translate_iterable``,
``score_iterable`` and ``translate_tokens`` (``generate_tokens``) are
ported.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import dataclasses

import numpy as np
import torch

from ..decoding.engine import DecodingEngine
from ..decoding.options import DecodingOptions
from ..formats.vocabulary_map import VocabularyMap
from ..models import transformer as T
from ..models.loader import LoadedModel
from ..ops import attention as attn_ops
from .base import TaskAPIMixin
from .batching import (bucket_length, consume_stream, default_read_batch_size,
                       pad_batch)
from .results import (AsyncResult, ExecutionStats, GenerationStepResult,
                      ScoringResult, TranslationResult)
from .scoring import teacher_forced_scores

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
        self.model: LoadedModel = self._load_model(
            model_path, compute_type, device, device_index, kwargs)
        if not self.model.is_sequence_to_sequence:
            raise ValueError(
                f"The model at {model_path} is not an encoder-decoder model "
                "that can be used with Translator")
        self._apply_flash_flag(kwargs)
        self.engine = DecodingEngine(self.model)
        self._init_replicas(device, device_index, DecodingEngine)
        self._start_pool(inter_threads, max_queued_batches, kwargs)
        self._vmap = (None if self.model.vmap_lines is None else
                      VocabularyMap.from_lines(self.model.vmap_lines,
                                               self.model.target_vocabulary))

    @property
    def num_translators(self) -> int:
        return self._pool.num_workers

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

    def _make_source_ids(self, source: Sequence[Sequence[str]],
                         max_input_length: int):
        """(Possibly ``￨``-factored) source tokens as per-feature id
        batches, [F][B][T]."""
        return self._ids_from_streams(
            self._source_feature_streams(source), max_input_length)

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
        try:
            # Reference wording (src/decoding.cc:1036-1054).
            if min_decoding_length > max_decoding_length:
                raise ValueError(
                    "The minimum decoding length is greater than the "
                    "maximum decoding length")
            if max_decoding_length == 0:
                raise ValueError("The maximum decoding length must be > 0")
            if prefix_bias_beta >= 1:
                raise ValueError("The beta value in biased decoding must be < 1")
            if prefix_bias_beta > 0 and return_alternatives:
                raise ValueError("Biased decoding is not compatible with the "
                                 "return_alternatives mode")
            if callback is not None and prefix_bias_beta > 0:
                raise ValueError("The callback function is not compatible "
                                 "with prefix_bias_beta > 0")
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
            coverage_penalty=coverage_penalty,
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
            sampling_topk=sampling_topk,
            sampling_topp=sampling_topp,
            sampling_temperature=sampling_temperature,
            num_hypotheses=num_hypotheses,
            return_scores=return_scores,
            return_logits_vocab=return_logits_vocab,
            return_attention=return_attention or replace_unknowns,
            return_prefix=True,
            return_alternatives=return_alternatives,
            min_alternative_expansion_prob=min_alternative_expansion_prob,
            prefix_bias_beta=prefix_bias_beta,
        )

        results: List[Optional[TranslationResult]] = [None] * len(source)
        # Empty-source rows are resolved without running the model
        # (reference: src/models/sequence_to_sequence.cc:432-470).
        compute_idx = []
        for i, src in enumerate(source):
            if len(src) == 0:
                results[i] = self._empty_source_result(
                    target_prefix[i] if target_prefix else None, options,
                    return_attention)
            else:
                compute_idx.append(i)

        def run(rows):
            return self._translate_padded(
                [source[i] for i in rows],
                [target_prefix[i] for i in rows] if target_prefix else None,
                options, max_input_length, end_ids, replace_unknowns,
                return_attention, callback, use_vmap, rows)

        return self._run_batches(results, compute_idx,
                                 [len(source[i]) for i in compute_idx],
                                 max_batch_size, batch_type, run, asynchronous,
                                 "Translator.translate_batch",
                                 split=sampling_topk == 1 and callback is None)

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
    def _empty_source_result(prefix, options, return_attention):
        hypothesis: List[str] = list(prefix)[: options.max_length] if prefix else []
        r = TranslationResult()
        for _ in range(options.num_hypotheses):
            r.hypotheses.append(list(hypothesis))
            if options.return_scores:
                r.scores.append(0.0)
            if return_attention:
                r.attention.append([[] for _ in hypothesis])
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

    def _restricted_output_params(self, candidates, size_multiple: int = 256):
        """The params with an output projection cut to the ``candidates``
        (reference update_output_layer: src/layers/decoder.cc:72-139,
        Dense::select_weights: src/layers/common.cc:313-337), padded to a
        multiple of ``size_multiple`` with columns of bias -1e10. Returns
        (params, to_output {id: restricted id}, to_original [restricted id
        -> id])."""
        ids = list(candidates)
        pad = -len(ids) % size_multiple
        ids += [0] * pad
        proj = self.model.params["decoder"]["projection"]
        device = self.model.device
        idx = torch.tensor(ids, dtype=torch.long, device=device)
        split = proj.get("tp")
        inside = None
        if split is not None:
            # A vocabulary shard (tensor parallelism): the candidates it
            # holds, zero columns for the others, the ranks' products summed
            # (a row-parallel linear over a replicated input).
            from ..parallel.sharding import Split, shard_ids

            rows = proj["wq"].shape[0] if "wq" in proj else proj["w"].shape[1]
            idx, inside = shard_ids(split, idx, rows)
        if "w" in proj:  # float: w (in, out)
            w = proj["w"].index_select(1, idx)
            new_proj = {"w": w if inside is None else w * inside[None, :].to(w.dtype)}
        else:  # W8A8: wq (out, in), one scale an output
            wq = proj["wq"].index_select(0, idx)
            new_proj = {"wq": wq if inside is None else wq * inside[:, None].to(wq.dtype),
                        "scale": proj["scale"].index_select(0, idx)}
        bias = (proj["b"].float().index_select(0, idx) if "b" in proj
                else torch.zeros(len(ids), dtype=torch.float32, device=device))
        if inside is not None:
            bias = split.comm.all_sum(torch.where(inside, bias, torch.zeros_like(bias)))
            new_proj["tp"] = Split("row", split.comm)
        if pad:
            bias[len(ids) - pad:] = -1e10
        new_proj["b"] = bias
        params = dict(self.model.params)
        params["decoder"] = dict(params["decoder"], projection=new_proj)
        to_output = {}
        for i, orig in enumerate(ids):
            to_output.setdefault(orig, i)
        return params, to_output, ids

    def _translate_padded(self, source, target_prefix, options, max_input_length,
                          end_ids, replace_unknowns, return_attention, callback,
                          use_vmap, batch_ids):
        tv = self._target_vocab
        streams = self._source_feature_streams(source)
        feature_ids = self._ids_from_streams(streams, max_input_length)
        source_ids = feature_ids[0]
        # Factored models report and replace with the main feature's tokens
        # (reference: sequence_to_sequence.cc:396).
        source_tokens = streams[0]
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

        step_callback = None
        if callback is not None:
            def step_callback(sr):
                # The example's index in the call: sub-batches are sorted
                # by length (reference: src/decoding.cc:899-901).
                return callback(GenerationStepResult(
                    step=sr.step,
                    batch_id=batch_ids[sr.batch_id], token_id=sr.token_id,
                    hypothesis_id=sr.hypothesis_id, token=tv.to_token(sr.token_id),
                    score=sr.score, is_last=sr.is_last))

        # The output layer cut to the vocabulary map's candidates.
        run_params = to_original = token_map = None
        if use_vmap and self._vmap is not None:
            candidates = self._vmap.get_candidates(
                [list(s) for s in source_tokens], prefix_ids or [])
            run_params, to_output, to_original = (
                self._restricted_output_params(candidates))
            token_map = torch.tensor(to_original, dtype=torch.long)
            start_ids = [to_output[i] for i in start_ids]
            if prefix_ids is not None:
                prefix_ids = [[to_output[t] for t in p if t in to_output]
                              for p in prefix_ids]
            end_ids = tuple(to_output[e] for e in end_ids if e in to_output)
            options = dataclasses.replace(
                options,
                suppress_tokens=tuple(to_output[t] for t in options.suppress_tokens
                                      if t in to_output),
                suppress_sequences=tuple(
                    tuple(to_output[t] for t in seq if t in to_output)
                    for seq in options.suppress_sequences))

        if options.return_alternatives:
            # Encode the batch once; each example's alternatives read its
            # own row of the memory.
            model = self.model
            qa = model.policy.quantize_activations
            main_ids = enc_ids[0] if isinstance(enc_ids, tuple) else enc_ids
            consts = model.ensure_consts(main_ids.shape[1])
            memory = T.encoder_forward(model.arch, model.params, consts, enc_ids,
                                       enc_lengths, quantize_acts=qa,
                                       out_dtype=model.out_dtype)
            mem_kv = T.precompute_memory(model.arch, model.params, memory,
                                         quantize_acts=qa)
            mem_bias = attn_ops.length_mask_bias(enc_lengths, memory.shape[1])
            dec_results = [
                self.engine.decode_alternatives(
                    [start_ids[i]] + (list(prefix_ids[i]) if prefix_ids else []),
                    options,
                    memory=([None if kv is None else
                             {n: a[i:i + 1] for n, a in kv.items()} for kv in mem_kv],
                            mem_bias[i:i + 1]),
                    end_ids=end_ids, params=run_params, token_map=token_map)
                for i in range(len(source))]
        else:
            dec_results = self.engine.decode(
                start_ids, options, encoder_inputs=(enc_ids, enc_lengths),
                prefix_ids=prefix_ids, end_ids=end_ids, params=run_params,
                step_callback=step_callback, token_map=token_map)

        if to_original is not None:
            for dr in dec_results:
                dr.hypotheses = [[to_original[t] for t in h] for h in dr.hypotheses]

        cfg = self.model.config
        out = []
        for i, dr in enumerate(dec_results):
            hyps = [[tv.to_token(t) for t in h] for h in dr.hypotheses]
            attention = []
            src_len = len(source_ids[i])
            for h, attn in enumerate(dr.attention):
                # Rows over the source's own tokens, without the added BOS
                # or EOS (reference: sequence_to_sequence.cc:396-430).
                rows = []
                for vec in attn:
                    vec = list(vec[:src_len])
                    if cfg.get("add_source_bos"):
                        vec = vec[1:]
                    if cfg.get("add_source_eos"):
                        vec = vec[:-1]
                    vec = vec[:len(source[i])]
                    rows.append(vec + [0.0] * (len(source[i]) - len(vec)))
                attention.append(rows)
                if replace_unknowns:
                    for t, tok in enumerate(hyps[h]):
                        if tok == tv.unk_token and t < len(rows):
                            hyps[h][t] = source_tokens[i][int(np.argmax(rows[t]))]
            out.append(TranslationResult(
                hypotheses=hyps,
                scores=dr.scores if options.return_scores else [],
                attention=attention if return_attention else [],
                logits=dr.logits if options.return_logits_vocab else []))
        return out

    # ------------------------------------------------------------------
    # Streaming sugar (reference: python/ctranslate2/extensions.py).
    # ------------------------------------------------------------------

    def translate_iterable(self, source, target_prefix=None, max_batch_size=32,
                           batch_type="examples", **kwargs):
        from .extensions import translate_iterable

        return translate_iterable(self, source, target_prefix, max_batch_size,
                                  batch_type, **kwargs)

    def translate_tokens(self, source, target_prefix=None, **kwargs):
        from .extensions import translate_tokens

        if kwargs.pop("return_log_prob", False):
            kwargs["return_scores"] = True
        return translate_tokens(self, source, target_prefix, **kwargs)

    # The reference's name for token streaming on a translator
    # (python/ctranslate2/extensions.py translator_generate_tokens).
    generate_tokens = translate_tokens

    # ------------------------------------------------------------------
    # Files (reference: include/ctranslate2/translator.h:68-211,
    # python/cpp/translator.cc translate_file / score_file).
    # ------------------------------------------------------------------

    def translate_file(self, source_path: str, output_path: str,
                       target_path: Optional[str] = None,
                       max_batch_size: int = 32, read_batch_size: int = 0,
                       batch_type: str = "examples", with_scores: bool = False,
                       source_tokenize_fn=None, target_tokenize_fn=None,
                       target_detokenize_fn=None, **kwargs) -> ExecutionStats:
        """Translate a tokenized text file (or, with the tokenize and
        detokenize callbacks, a raw one), one output line a hypothesis,
        ``"{score} ||| {line}"`` with ``with_scores``. Windows of
        ``read_batch_size`` lines are submitted asynchronously through the
        worker pool and written in order; ``target_path`` gives each line a
        target prefix."""
        if bool(source_tokenize_fn) != bool(target_detokenize_fn):
            raise ValueError("source_tokenize_fn and target_detokenize_fn should "
                             "both be set or none at all")
        if target_path and source_tokenize_fn and not target_tokenize_fn:
            raise ValueError("target_tokenize_fn should be set when passing a "
                             "target file")
        start = time.time()
        stats = ExecutionStats()
        src_tok = source_tokenize_fn or str.split
        tgt_tok = target_tokenize_fn or str.split
        detok = target_detokenize_fn or " ".join
        if with_scores:
            kwargs.setdefault("return_scores", True)
        read_batch_size = default_read_batch_size(read_batch_size, max_batch_size)

        with contextlib.ExitStack() as stack:
            fin = stack.enter_context(open(source_path, encoding="utf-8"))
            fin_tgt = (stack.enter_context(open(target_path, encoding="utf-8"))
                       if target_path is not None else None)
            fout = stack.enter_context(open(output_path, "w", encoding="utf-8"))

            def read_window():
                window = list(itertools.islice(fin, read_batch_size))
                if not window:
                    if fin_tgt is not None and fin_tgt.readline():
                        raise ValueError("source and target files do not have "
                                         "the same number of lines")
                    return None
                lines = [src_tok(line.rstrip("\n")) for line in window]
                prefix = None
                if fin_tgt is not None:
                    tgt_window = list(itertools.islice(fin_tgt, len(window)))
                    if len(tgt_window) != len(window):
                        raise ValueError("source and target files do not have "
                                         "the same number of lines")
                    prefix = [tgt_tok(line.rstrip("\n")) for line in tgt_window]
                return lines, prefix

            def submit(window):
                lines, prefix = window
                return self.translate_batch(
                    lines, target_prefix=prefix, max_batch_size=max_batch_size,
                    batch_type=batch_type, asynchronous=True, **kwargs)

            def write(r):
                hypotheses = r.hypotheses or [[]]
                stats.num_tokens += len(hypotheses[0])
                stats.num_examples += 1
                for n, tokens in enumerate(hypotheses):
                    line = detok(tokens)
                    if with_scores:
                        line = f"{r.scores[n] if r.scores else 0} ||| {line}"
                    fout.write(line + "\n")

            consume_stream(read_window, submit, write,
                           max_pending=4 * (read_batch_size or 0))
        stats.total_time_in_ms = (time.time() - start) * 1000.0
        return stats

    def score_file(self, source_path: str, target_path: str, output_path: str,
                   max_batch_size: int = 32, read_batch_size: int = 0,
                   batch_type: str = "examples", with_tokens_score: bool = False,
                   **kwargs) -> ExecutionStats:
        """Score a parallel pair of tokenized files, one
        ``"{mean:.6f} ||| tokens"`` line an example (``" ||| "`` and each
        token's score added with ``with_tokens_score``), streamed as
        ``translate_file`` streams."""
        start = time.time()
        stats = ExecutionStats()
        read_batch_size = default_read_batch_size(read_batch_size, max_batch_size)

        with open(source_path, encoding="utf-8") as fsrc, \
                open(target_path, encoding="utf-8") as ftgt, \
                open(output_path, "w", encoding="utf-8") as fout:

            def read_window():
                src_window = list(itertools.islice(fsrc, read_batch_size))
                if not src_window:
                    if ftgt.readline():
                        raise ValueError("source and target files do not have "
                                         "the same number of lines")
                    return None
                tgt_window = list(itertools.islice(ftgt, len(src_window)))
                if len(tgt_window) != len(src_window):
                    raise ValueError("source and target files do not have the "
                                     "same number of lines")
                return src_window, tgt_window

            def submit(window):
                src_window, tgt_window = window
                return self.score_batch(
                    [line.split() for line in src_window],
                    [line.split() for line in tgt_window],
                    max_batch_size=max_batch_size, batch_type=batch_type,
                    asynchronous=True, **kwargs)

            def write(r):
                stats.num_tokens += len(r.tokens)
                stats.num_examples += 1
                mean = (sum(r.tokens_score) / len(r.tokens_score)
                        if r.tokens_score else 0.0)
                line = f"{mean:.6f} ||| {' '.join(r.tokens)}"
                if with_tokens_score:
                    line += " ||| " + " ".join(f"{s:.6f}" for s in r.tokens_score)
                fout.write(line + "\n")

            consume_stream(read_window, submit, write,
                           max_pending=4 * (read_batch_size or 0))
        stats.total_time_in_ms = (time.time() - start) * 1000.0
        return stats

    # ------------------------------------------------------------------
    # Scoring (reference: src/scoring.cc:5-68).
    # ------------------------------------------------------------------

    def score_iterable(self, source, target, max_batch_size: int = 64,
                       **kwargs):
        from .extensions import score_iterable

        return score_iterable(self, source, target, max_batch_size, **kwargs)

    def score_batch(
        self,
        source: Sequence[Sequence[str]],
        target: Sequence[Sequence[str]],
        *,
        max_batch_size: int = 0,
        batch_type: str = "examples",
        max_input_length: int = 1024,
        offset: int = 0,
        asynchronous: bool = False,
    ) -> List[ScoringResult]:
        """The log-prob of every target token (and of the final EOS) given
        the source. ``offset`` is accepted and ignored, as in the JAX
        package."""
        tv = self._target_vocab
        start_id = self._decoder_start_id()
        results: List[Optional[ScoringResult]] = [None] * len(source)

        # Empty sources score 0.0 on every target token without running
        # the model.
        compute_idx = []
        for i in range(len(source)):
            if len(self._make_source_ids([source[i]], max_input_length)[0][0]) == 0:
                ids = tv.tokens_to_ids([target[i]], max_input_length)[0]
                results[i] = ScoringResult(tokens=[tv.to_token(t) for t in ids],
                                           tokens_score=[0.0] * len(ids))
            else:
                compute_idx.append(i)

        def run(rows):
            return self._score_padded([source[i] for i in rows],
                                      [target[i] for i in rows], max_input_length,
                                      start_id)

        return self._run_batches(results, compute_idx,
                                 [len(source[i]) for i in compute_idx],
                                 max_batch_size, batch_type, run, asynchronous,
                                 "Translator.score_batch")

    def _score_padded(self, source, target, max_input_length, start_id):
        model = self.model
        tv = self._target_vocab
        qa = model.policy.quantize_activations
        enc_ids, enc_lengths = self._pad_feature_ids(
            self._make_source_ids(source, max_input_length))
        main_ids = enc_ids[0] if isinstance(enc_ids, tuple) else enc_ids
        consts = model.ensure_consts(main_ids.shape[1])
        memory = T.encoder_forward(model.arch, model.params, consts,
                                   enc_ids, enc_lengths, quantize_acts=qa,
                                   out_dtype=model.out_dtype)
        mem_kv = T.precompute_memory(model.arch, model.params, memory,
                                     quantize_acts=qa)
        mem_bias = attn_ops.length_mask_bias(enc_lengths, memory.shape[1])

        # The full target sequence: start + tokens + EOS.
        full_ids = []
        for t in target:
            ids = tv.tokens_to_ids([t], max_input_length)[0]
            full_ids.append(([start_id] if start_id is not None else [])
                            + ids + [tv.eos_id])
        scores = teacher_forced_scores(model, full_ids, mem_kv, mem_bias)
        return [ScoringResult(tokens=[tv.to_token(t) for t in seq[1:]],
                              tokens_score=scores[i][:len(seq) - 1])
                for i, seq in enumerate(full_ids)]

