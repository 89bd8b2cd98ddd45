"""Generator: the decoder-only LM task API
(parity with reference: include/ctranslate2/generator.h:10-39,
src/models/language_model.cc:105-300).

Runs on one CUDA card by default, or on the CPU when ``device="cpu"``.
``generate_batch`` (beam or greedy, argmax or random sampling, with a
static prompt prefilled once and cached, step callbacks, alternatives and
vocabulary logits), ``score_batch``, ``forward_batch`` and the streaming
helpers ``generate_iterable``, ``generate_tokens``,
``async_generate_tokens`` and ``score_iterable`` are ported, and so is
lossless prompt-lookup speculation in greedy search (``speculation_k``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..decoding.engine import DecodingEngine, _round_up
from ..decoding.options import DecodingOptions
from ..models import transformer as T
from ..models.loader import LoadedModel
from .base import TaskAPIMixin
from .batching import normalize_input_ids, pad_batch
from .results import GenerationResult, GenerationStepResult, ScoringResult
from .scoring import teacher_forced_logits, teacher_forced_scores


class Generator(TaskAPIMixin):
    """Text generation with a decoder-only model on one device.

    ``device`` is ``"cuda"`` (the default; raises without CUDA) or
    ``"cpu"``. ``flash_attention=True`` sends every uncached prefill to the
    flash kernel on the card, whatever its length.
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
        if not self.model.is_decoder_only:
            raise ValueError(
                f"The model at {model_path} is not a decoder-only model "
                "that can be used with Generator")
        self._apply_flash_flag(kwargs)
        self.engine = DecodingEngine(self.model)
        self._init_replicas(device, device_index, DecodingEngine)
        self._start_pool(inter_threads, max_queued_batches, kwargs)
        # Prefilled static prompts: (token ids, ring, replica) -> (1-row
        # cache, capacity) (reference: include/ctranslate2/layers/decoder.h:102-110).
        self._static_prompt_cache: Dict[Tuple[Tuple[int, ...], bool], tuple] = {}
        self._static_prompt_lock = threading.Lock()

    @property
    def num_generators(self) -> int:
        return self._pool.num_workers

    def _unload_extra(self, to_cpu: bool) -> None:
        # The prefilled static prompts hold K/V computed from the weights.
        with self._static_prompt_lock:
            self._static_prompt_cache.clear()

    @property
    def _vocab(self):
        return self.model.target_vocabulary

    # ------------------------------------------------------------------

    def generate_batch(
        self,
        start_tokens: Sequence[Sequence[str]],
        *,
        max_batch_size: int = 0,
        batch_type: str = "examples",
        asynchronous: bool = False,
        beam_size: int = 1,
        patience: float = 1.0,
        num_hypotheses: int = 1,
        length_penalty: float = 1.0,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        disable_unk: bool = False,
        suppress_sequences: Sequence[Sequence[str]] = (),
        end_token=None,
        return_end_token: bool = False,
        max_length: int = 512,
        min_length: int = 0,
        sampling_topk: int = 1,
        sampling_topp: float = 1.0,
        sampling_temperature: float = 1.0,
        return_scores: bool = False,
        return_logits_vocab: bool = False,
        return_alternatives: bool = False,
        min_alternative_expansion_prob: float = 0.0,
        static_prompt: Optional[Sequence[str]] = None,
        cache_static_prompt: bool = True,
        include_prompt_in_result: bool = True,
        callback=None,
        seed: int = 0,
        speculation_k: int = 0,
    ) -> List[GenerationResult]:
        if len(start_tokens) == 0:
            return []
        if any(len(s) == 0 for s in start_tokens):
            raise ValueError("Generator expects at least one start token per example")
        if speculation_k > 1:
            # Lossless self-speculation in the greedy device loop: lossless
            # under the argmax only, and the alive-seq logits processors
            # need the sequential step order.
            if beam_size != 1:
                raise ValueError("speculation_k requires beam_size=1")
            if not (sampling_topk == 1 and sampling_topp >= 1.0):
                raise NotImplementedError(
                    "speculation requires greedy decoding (losslessness of "
                    "draft verification is only guaranteed under argmax)")
            if (repetition_penalty != 1.0 or no_repeat_ngram_size
                    or suppress_sequences):
                raise NotImplementedError(
                    "speculation_k is not supported with "
                    "repetition_penalty/no_repeat_ngram_size/"
                    "suppress_sequences in generate_batch; use the "
                    "ContinuousBatcher for those")
            if callback is not None or return_alternatives:
                raise ValueError(
                    "speculation_k is not compatible with callback or "
                    "return_alternatives")
            T.check_speculation_window(self.model.arch, speculation_k)

        v = self._vocab
        end_ids = self._resolve_end_token(end_token)
        options = DecodingOptions(
            beam_size=beam_size,
            patience=patience,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            suppress_tokens=((v.unk_id,) if disable_unk else ()),
            suppress_sequences=tuple(
                tuple(v.to_id(t, allow_unk=False) for t in seq)
                for seq in suppress_sequences
            ),
            return_end_token=return_end_token,
            max_length=max_length,
            min_length=min_length,
            sampling_topk=sampling_topk,
            sampling_topp=sampling_topp,
            sampling_temperature=sampling_temperature,
            num_hypotheses=num_hypotheses,
            return_scores=return_scores,
            return_logits_vocab=return_logits_vocab,
            return_prefix=True,
            return_alternatives=return_alternatives,
            min_alternative_expansion_prob=min_alternative_expansion_prob,
            seed=seed,
            speculation_k=speculation_k,
        )

        def run(rows):
            return self._generate([start_tokens[i] for i in rows], options,
                                  end_ids, include_prompt_in_result,
                                  static_prompt, cache_static_prompt, callback,
                                  rows)

        return self._run_batches([None] * len(start_tokens),
                                 list(range(len(start_tokens))),
                                 [len(s) for s in start_tokens], max_batch_size,
                                 batch_type, run, asynchronous,
                                 "Generator.generate_batch",
                                 split=sampling_topk == 1 and callback is None)

    def _resolve_end_token(self, end_token) -> tuple:
        v = self._vocab
        if end_token is None or end_token == "":
            return (v.eos_id,)
        if isinstance(end_token, str):
            return (v.to_id(end_token, allow_unk=False),)
        ids = [t if isinstance(t, int) else v.to_id(t, allow_unk=False)
               for t in end_token]
        return tuple(ids) if ids else (v.eos_id,)

    # ------------------------------------------------------------------

    def _prefill(self, ids_list: List[List[int]], cache, start_step: int):
        """Forward a uniform-length prompt chunk into the cache, in place.
        A sliding-window model's prompt runs in chunks split at multiples of
        its ring block (the reference's chunked prefill,
        src/layers/transformer.cc:735-792), so a ring cache only ever takes
        window-aligned writes."""
        model = self.model
        ids = torch.tensor(ids_list, dtype=torch.long, device=model.device)
        for off, size in T.split_prefill_chunks(start_step, ids.shape[1],
                                                T.ring_block(model.arch)):
            rel = off - start_step
            T.decoder_forward(
                model.arch, model.params, model.consts, ids[:, rel:rel + size],
                off, cache, quantize_acts=model.policy.quantize_activations,
                out_dtype=model.out_dtype, return_logits=False,
                # The first chunk of an empty cache attends only its own T
                # positions (O(T^2) prefill, flash-eligible).
                fresh_prefill=(off == 0))
        return cache

    def _static_prompt(self, ids: Tuple[int, ...], capacity: int, use_cache: bool,
                       ring: bool):
        """A 1-row cache holding the static prompt ``ids`` at positions
        [0, len(ids)), of at most ``capacity`` slots (ring buffers for the
        windowed layers with ``ring``; keyed by it, since a ring cannot
        serve beam search): the cached one when ``use_cache`` and one is
        there, else a new prefill (cached when ``use_cache``). Never written
        by a decode: callers copy it."""
        model = self.model
        key = (ids, ring, self._replica_index())
        if use_cache:
            with self._static_prompt_lock:
                cached = self._static_prompt_cache.get(key)
            if cached is not None and cached[1] <= capacity:
                return cached[0]
        cache = self._prefill([list(ids)], T.init_self_cache(
            model.arch, 1, capacity, dtype=model.kv_dtype, device=model.device,
            ring=ring), 0)
        if use_cache:
            with self._static_prompt_lock:
                self._static_prompt_cache[key] = (cache, capacity)
        return cache

    def _generate(self, start_tokens, options, end_ids, include_prompt_in_result,
                  static_prompt, cache_static_prompt, callback, batch_ids):
        model = self.model
        v = self._vocab
        B = len(start_tokens)
        start_ids = [[v.to_id(t) for t in tokens] for tokens in start_tokens]

        start_step = 0
        max_prompt = max(len(s) for s in start_ids)
        static_len = len(static_prompt) if static_prompt else 0
        spec_k = options.speculation_k
        capacity = _round_up(static_len + max_prompt + options.max_length + 1
                             + (spec_k if spec_k > 1 else 0), 64)
        model.ensure_consts(capacity)
        rows = B * options.beam_size if options.beam_size > 1 else B
        # Ring KV buffers (O(window) memory) serve one-token greedy steps of
        # a windowed model; beam search's chain-mask attention needs linear
        # caches.
        use_ring = options.beam_size == 1 and T.ring_capacity(model.arch) > 0

        sp_cache = None
        if static_prompt:
            # Reference: src/models/language_model.cc:186-215.
            sp_cache = self._static_prompt(
                tuple(v.to_id(t) for t in static_prompt), capacity,
                cache_static_prompt, use_ring)
            start_step += static_len

        def new_cache(n):
            """``n`` rows: copies of the static prompt's, or empty."""
            if sp_cache is not None:
                return T.cache_grow(T.cache_repeat_rows(sp_cache, n), n, capacity,
                                    arch=model.arch)
            return T.init_self_cache(model.arch, n, capacity, dtype=model.kv_dtype,
                                     device=model.device, ring=use_ring)

        # When nothing is prefilled the decode loop creates the cache
        # itself (which enables the chain-mask beam attention).
        cache = new_cache(rows) if sp_cache is not None else None
        return_prefix = options.return_prefix
        if not include_prompt_in_result:
            forward_length = min(len(s) for s in start_ids) - 1
            if forward_length > 0:
                prompt_chunk = [s[:forward_length] for s in start_ids]
                start_ids = [s[forward_length:] for s in start_ids]
                # Prefill the un-replicated rows, then tile them per beam.
                cache = self._prefill(prompt_chunk, new_cache(B), start_step)
                if options.beam_size > 1:
                    cache = T.cache_repeat_rows(cache, options.beam_size)
                start_step += forward_length
                return_prefix = False

        options = dataclasses.replace(options, return_prefix=return_prefix)
        first_ids = [s[0] for s in start_ids]
        prefix_ids = [s[1:] for s in start_ids]
        if not any(prefix_ids):
            prefix_ids = None

        step_callback = None
        if callback is not None:
            def step_callback(sr):
                # The example's index in the call (sub-batches are sorted
                # by length).
                return callback(GenerationStepResult(
                    step=sr.step,
                    batch_id=batch_ids[sr.batch_id], token_id=sr.token_id,
                    hypothesis_id=sr.hypothesis_id, token=v.to_token(sr.token_id),
                    score=sr.score, logits=sr.log_probs, is_last=sr.is_last))

        if options.return_alternatives:
            dec_results = [self.engine.decode_alternatives(
                start_ids[i], options, start_step=start_step, end_ids=end_ids,
                cache=T.cache_slice_rows(cache, i, 1)) for i in range(B)]
        else:
            dec_results = self.engine.decode(
                first_ids, options, cache=cache, start_step=start_step,
                prefix_ids=prefix_ids, end_ids=end_ids, capacity=capacity,
                step_callback=step_callback)

        out = []
        for i, dr in enumerate(dec_results):
            hyps = dr.hypotheses
            # Forward the start token to the output when it is not BOS
            # (reference: src/models/language_model.cc:258-263).
            if include_prompt_in_result and start_ids[i][0] != v.bos_id:
                hyps = [[start_ids[i][0]] + h for h in hyps]
            out.append(GenerationResult(
                sequences=[[v.to_token(t) for t in h] for h in hyps],
                sequences_ids=[list(h) for h in hyps],
                scores=dr.scores,
                logits=dr.logits if options.return_logits_vocab else []))
        return out

    # ------------------------------------------------------------------

    def score_iterable(self, tokens, max_batch_size: int = 64, **kwargs):
        from .extensions import score_iterable

        return score_iterable(self, tokens, None, max_batch_size, **kwargs)

    def score_batch(
        self,
        tokens: Sequence[Sequence[str]],
        *,
        max_batch_size: int = 0,
        batch_type: str = "examples",
        max_input_length: int = 1024,
        offset: int = 0,
        asynchronous: bool = False,
    ) -> List[ScoringResult]:
        """The log-prob of every token after the first given the ones
        before it, from token ``offset`` on; rows of fewer than 2 tokens
        score nothing."""
        results: List[Optional[ScoringResult]] = [
            None if len(t) >= 2 else ScoringResult() for t in tokens]
        compute_idx = [i for i, t in enumerate(tokens) if len(t) >= 2]
        def run(rows):
            return self._score_rows([tokens[i] for i in rows], max_input_length,
                                    offset)

        return self._run_batches(results, compute_idx,
                                 [len(tokens[i]) for i in compute_idx],
                                 max_batch_size, batch_type, run, asynchronous,
                                 "Generator.score_batch")

    def _score_rows(self, rows, max_input_length, offset):
        v = self._vocab
        ids = [[v.to_id(t) for t in row][:max_input_length] for row in rows]
        scores = teacher_forced_scores(self.model, ids)
        return [ScoringResult(
                    tokens=[v.to_token(t) for t in row[1 + max(offset, 0):]],
                    tokens_score=scores[i][max(offset, 0):len(row) - 1])
                for i, row in enumerate(ids)]

    def forward_batch(self, inputs, lengths=None,
                      return_log_probs: bool = False):
        """Full-sequence logits [B, T, V] (reference:
        src/models/language_model.cc:279-299), T the longest row padded to
        a multiple of 8 (at least 8), on the model's device; float32
        log-probs with ``return_log_probs``.

        ``inputs``: a batch of token strings, a batch of token ids, or a
        dense id array or tensor (the reference's BatchTokens / BatchIds /
        StorageView variants, python/cpp/generator.cc:99-115); ``lengths``
        gives a dense array's true row lengths."""
        model = self.model
        ids = normalize_input_ids(inputs, self._vocab, lengths)
        padded, lengths = pad_batch(ids, length_multiple=8, min_length=8)
        logits = teacher_forced_logits(
            model, torch.tensor(padded, dtype=torch.long, device=model.device),
            torch.tensor(lengths, dtype=torch.long, device=model.device))
        if return_log_probs:
            return torch.log_softmax(logits.float(), dim=-1)
        return logits

    # ------------------------------------------------------------------
    # Streaming sugar (reference: python/ctranslate2/extensions.py).
    # ------------------------------------------------------------------

    def generate_iterable(self, start_tokens, max_batch_size=32,
                          batch_type="examples", **kwargs):
        from .extensions import generate_iterable

        return generate_iterable(self, start_tokens, max_batch_size, batch_type,
                                 **kwargs)

    def generate_tokens(self, prompt, **kwargs):
        from .extensions import generate_tokens

        if kwargs.pop("return_log_prob", False):
            kwargs["return_scores"] = True
        return generate_tokens(self, prompt, **kwargs)

    def async_generate_tokens(self, prompt, **kwargs):
        from .extensions import async_generate_tokens

        return async_generate_tokens(self, prompt, **kwargs)
