"""Beam / greedy decoding engine.

Port of ``ctranslate2_tpu/decoding/engine.py`` restricted to its
whole-generation device loops (reference: src/decoding.cc:411-974). The
options that need the JAX package's host loop (attention output, coverage
penalty, prefix-biased decoding, vocabulary logits, alternatives) and
random sampling are rejected by ``Translator.translate_batch`` until their
slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import device_loop
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
        encoder_inputs,  # (src_ids [B, S], src_lengths [B]): fused encode
        prefix_ids: Optional[Sequence[Optional[Sequence[int]]]] = None,
        end_ids: Sequence[int] = (),
        start_step: int = 0,
        params=None,
    ) -> List[DecodingResult]:
        if params is None:
            params = self.model.params
        if options.min_length > options.max_length:
            raise ValueError("The minimum decoding length is greater than "
                             "the maximum decoding length")
        if options.max_length == 0:
            raise ValueError("The maximum decoding length must be > 0")
        if options.beam_size > 1:
            return self._beam_search(start_ids, options, encoder_inputs,
                                     prefix_ids, end_ids, start_step, params)
        return self._greedy_search(start_ids, options, encoder_inputs,
                                   prefix_ids, end_ids, start_step, params)

    # ------------------------------------------------------------------

    def _setup(self, options, prefix_ids, start_step):
        max_prefix = 0
        if prefix_ids is not None:
            max_prefix = max((len(p) if p else 0) for p in prefix_ids)
        max_step = options.max_length + (
            max_prefix if not options.return_prefix else 0)
        capacity = _round_up(max(start_step + max_step, 16), 64)
        consts = self.model.ensure_consts(capacity)
        return max_step, capacity, consts

    @staticmethod
    def _make_sig(options: DecodingOptions, end_ids) -> StepSig:
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
                     end_ids, start_step, params):
        B = len(start_ids)
        K = options.beam_size
        max_step, capacity, consts = self._setup(options, prefix_ids, start_step)
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
            encoder_ids=encoder_inputs[0], encoder_lengths=encoder_inputs[1])
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
                       end_ids, start_step, params):
        B = len(start_ids)
        end_set = set(end_ids)
        max_step, capacity, consts = self._setup(options, prefix_ids, start_step)
        sig = self._make_sig(options, end_ids)
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
            encoder_ids=encoder_inputs[0], encoder_lengths=encoder_inputs[1])
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
            self._finalize(r, 1, options.length_penalty, options.return_scores,
                           norm_lengths=[max(norm_len, 1)])
            results.append(r)
        return results
