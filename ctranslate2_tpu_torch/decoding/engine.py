"""Beam / greedy decoding engine.

Port of ``ctranslate2_tpu/decoding/engine.py`` restricted to its
whole-generation device loops (reference: src/decoding.cc:411-974), with
argmax or random sampling. The options that need the JAX package's host
loop (attention output, coverage penalty, prefix-biased decoding,
vocabulary logits, alternatives) are rejected by
``Translator.translate_batch`` until their slice.

As in the JAX package, random sampling (``sampling_topk != 1`` or
``sampling_topp < 1``; a temperature alone samples nothing) applies to
greedy search, whose ``num_hypotheses > 1`` then decodes that many
replicas of each row; beam search always takes the best candidates
(the JAX package's ``_beam_search`` builds its signature with the argmax
sampler, so no entry point reaches its beam loop's Gumbel-max branch,
which the port leaves out until one does).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.transformer import cache_repeat_rows
from . import device_loop, sampling
from .options import DecodingOptions, DecodingResult


@dataclass(frozen=True)
class StepSig:
    """Static signature of a decode loop."""

    end_ids: Tuple[int, ...]
    suppress_ids: Tuple[int, ...]
    begin_suppress_ids: Tuple[int, ...]
    suppress_sequences: Tuple[Tuple[int, ...], ...]
    repetition_penalty: float
    no_repeat_ngram_size: int
    use_alive_seq: bool
    greedy_sampler: bool = True  # argmax; False: random sampling
    sampling_topk: int = 1
    sampling_topp: float = 1.0
    sampling_temperature: float = 1.0


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class DecodingEngine:
    """Runs the decode loops for one loaded model."""

    def __init__(self, model):
        self.model = model

    def decode(
        self,
        start_ids: Sequence[int],
        options: DecodingOptions,
        *,
        encoder_inputs=None,  # (src_ids [B, S], src_lengths [B]): fused
        # encode; None for a decoder-only model
        cache=None,  # prefilled self cache (generator prompt prefill)
        start_step: int = 0,
        prefix_ids: Optional[Sequence[Optional[Sequence[int]]]] = None,
        end_ids: Sequence[int] = (),
        capacity: Optional[int] = None,
        params=None,
    ) -> List[DecodingResult]:
        if params is None:
            params = self.model.params
        if options.min_length > options.max_length:
            raise ValueError("The minimum decoding length is greater than "
                             "the maximum decoding length")
        if options.max_length == 0:
            raise ValueError("The maximum decoding length must be > 0")
        search = (self._beam_search if options.beam_size > 1
                  else self._greedy_search)
        return search(start_ids, options, encoder_inputs or (None, None),
                      prefix_ids, end_ids, start_step, params, cache, capacity)

    # ------------------------------------------------------------------

    def _setup(self, options, prefix_ids, start_step, capacity):
        max_prefix = 0
        if prefix_ids is not None:
            max_prefix = max((len(p) if p else 0) for p in prefix_ids)
        max_step = options.max_length + (
            max_prefix if not options.return_prefix else 0)
        if capacity is None:
            capacity = _round_up(max(start_step + max_step, 16), 64)
        consts = self.model.ensure_consts(capacity)
        return max_step, capacity, consts

    @staticmethod
    def _make_sig(options: DecodingOptions, end_ids,
                  greedy_sampler: bool = True) -> StepSig:
        return StepSig(
            end_ids=tuple(end_ids),
            suppress_ids=tuple(options.suppress_tokens),
            begin_suppress_ids=tuple(options.suppress_tokens_begin),
            suppress_sequences=tuple(tuple(s) for s in options.suppress_sequences),
            repetition_penalty=options.repetition_penalty,
            no_repeat_ngram_size=options.no_repeat_ngram_size,
            use_alive_seq=(options.repetition_penalty != 1.0
                           or options.no_repeat_ngram_size > 0
                           or bool(options.suppress_sequences)),
            greedy_sampler=greedy_sampler,
            sampling_topk=options.sampling_topk,
            sampling_topp=options.sampling_topp,
            sampling_temperature=options.sampling_temperature,
        )

    @staticmethod
    def _finalize(result: DecodingResult, num_hypotheses, length_penalty,
                  return_scores, norm_lengths):
        """Normalize scores and sort hypotheses
        (reference: src/decoding.cc:176-254)."""
        for i in range(len(result.scores)):
            length = max(norm_lengths[i], 1)
            result.scores[i] = result.scores[i] / math.pow(length, length_penalty)
        order = sorted(range(len(result.scores)),
                       key=lambda i: -result.scores[i])[:num_hypotheses]
        result.hypotheses = [result.hypotheses[i] for i in order]
        result.scores = [result.scores[i] for i in order] if return_scores else []
        return result

    @staticmethod
    def _prefix_rows(prefix_ids, B):
        prefix_lengths = [0] * B
        P = 0
        if prefix_ids is not None:
            prefix_lengths = [len(p) if p else 0 for p in prefix_ids]
            P = _round_up(max(max(prefix_lengths), 1), 8)
        prefix_arr = np.zeros((B, max(P, 1)), np.int64)
        if prefix_ids is not None:
            for i, p in enumerate(prefix_ids):
                if p:
                    prefix_arr[i, :len(p)] = p
        return prefix_lengths, P, prefix_arr

    # ------------------------------------------------------------------
    # Beam search (the JAX package's _beam_search -> _beam_device_loop).
    # ------------------------------------------------------------------

    def _beam_search(self, start_ids, options, encoder_inputs, prefix_ids,
                     end_ids, start_step, params, cache, capacity):
        B = len(start_ids)
        K = options.beam_size
        max_step, capacity, consts = self._setup(
            options, prefix_ids, start_step, capacity)
        sig = self._make_sig(options, end_ids)
        prefix_lengths, _, prefix_arr = self._prefix_rows(prefix_ids, B)
        min_steps = [(prefix_lengths[i] if not options.return_prefix else 0)
                     + options.min_length for i in range(B)]

        control = np.zeros((B, 3 + K + prefix_arr.shape[1]), np.int64)
        control[:, 0] = prefix_lengths
        control[:, 1] = min_steps
        control[:, 3:3 + K] = np.asarray(start_ids, np.int64)[:, None]
        control[:, 3 + K:] = prefix_arr
        seqs, lens, scores = device_loop.beam_loop(
            self.model, params, consts, sig, max_steps=max_step,
            capacity=capacity, beam_size=K,
            num_hyp=options.num_hypotheses,
            max_candidates=max(1, round(K * options.patience)),
            length_penalty=options.length_penalty,
            return_prefix=options.return_prefix,
            include_eos=options.return_end_token,
            count_eos=options.include_eos_in_hypotheses,
            max_length=options.max_length,
            allow_early_exit=options.length_penalty == 0,
            has_prefix=prefix_ids is not None,
            control=torch.from_numpy(control), start_pos=start_step,
            encoder_ids=encoder_inputs[0], encoder_lengths=encoder_inputs[1],
            cache=cache)
        seqs, lens, scores = seqs.numpy(), lens.numpy(), scores.numpy()

        results = []
        for i in range(B):
            r = DecodingResult()
            start = 0 if options.return_prefix else prefix_lengths[i]
            for j in np.argsort(-scores[i], kind="stable"):
                if not np.isfinite(scores[i, j]):
                    continue
                r.hypotheses.append([int(t) for t in seqs[i, j, start:lens[i, j]]])
                r.scores.append(float(scores[i, j]))
            r.hypotheses = r.hypotheses[:options.num_hypotheses]
            r.scores = r.scores[:options.num_hypotheses] if options.return_scores else []
            results.append(r)
        return results

    # ------------------------------------------------------------------
    # Greedy search (the JAX package's _greedy_search -> _greedy_device_loop).
    # ------------------------------------------------------------------

    def _greedy_search(self, start_ids, options, encoder_inputs, prefix_ids,
                       end_ids, start_step, params, cache, capacity):
        is_random = not (options.sampling_topk == 1
                         and options.sampling_topp >= 1.0)
        # Several hypotheses under random sampling: that many replicas of
        # each row (reference: src/decoding.cc:753-814). The encoder runs
        # once per source: the decoder's cross-attention reads a source's
        # memory for all of its replicas, as it does for a beam.
        replicas = options.num_hypotheses if (
            options.num_hypotheses > 1 and is_random) else 1
        B0 = len(start_ids)
        if replicas > 1:
            start_ids = [s for s in start_ids for _ in range(replicas)]
            if prefix_ids is not None:
                prefix_ids = [p for p in prefix_ids for _ in range(replicas)]
            if cache is not None:
                cache = cache_repeat_rows(cache, replicas)
        B = len(start_ids)
        end_set = set(end_ids)
        max_step, capacity, consts = self._setup(
            options, prefix_ids, start_step, capacity)
        sig = self._make_sig(options, end_ids, greedy_sampler=not is_random)
        prefix_lengths, P, prefix_arr = self._prefix_rows(prefix_ids, B)
        min_steps = [(prefix_lengths[i] if not options.return_prefix else 0)
                     + options.min_length for i in range(B)]

        control = np.zeros((B, 3 + prefix_arr.shape[1]), np.int64)
        control[:, 0] = prefix_lengths
        control[:, 1] = min_steps
        control[:, 2] = np.asarray(start_ids, np.int64)
        control[:, 3:] = prefix_arr
        buf, num_steps, scores = device_loop.greedy_loop(
            self.model, params, consts, sig, max_steps=max_step,
            capacity=capacity, has_prefix=P > 0,
            control=torch.from_numpy(control), start_pos=start_step,
            encoder_ids=encoder_inputs[0], encoder_lengths=encoder_inputs[1],
            cache=cache, noise=(sampling.noise_source(options.seed, self.model.device)
                                if is_random else None))
        buf, num_steps, scores = buf.numpy(), num_steps.numpy(), scores.numpy()

        results = []
        for i in range(B):
            plen = prefix_lengths[i]
            limit = options.max_length + (0 if options.return_prefix else plen)
            n = min(int(num_steps[i]), limit)
            tokens = [int(t) for t in buf[i, :n]]
            ended_eos = bool(tokens) and tokens[-1] in end_set
            norm_len = n - (0 if options.return_prefix else plen)
            if ended_eos and not options.include_eos_in_hypotheses:
                norm_len -= 1
            if ended_eos and not options.return_end_token:
                tokens = tokens[:-1]
            if not options.return_prefix:
                tokens = tokens[plen:]
            r = DecodingResult(hypotheses=[tokens], scores=[float(scores[i])])
            self._finalize(r, 1, options.length_penalty, True,
                           norm_lengths=[max(norm_len, 1)])
            results.append(r)

        if replicas > 1:
            merged = [DecodingResult() for _ in range(B0)]
            for i, r in enumerate(results):
                m = merged[i // replicas]
                m.hypotheses.append(r.hypotheses[0])
                m.scores.append(r.scores[0])
            for m in merged:
                order = sorted(range(len(m.scores)), key=lambda i: -m.scores[i])
                m.hypotheses = [m.hypotheses[i] for i in order]
                m.scores = [m.scores[i] for i in order]
            results = merged
        if not options.return_scores:
            for r in results:
                r.scores = []
        return results
