"""Beam / greedy decoding engine.

Port of ``ctranslate2_tpu/decoding/engine.py`` (reference:
src/decoding.cc:411-974, 1122-1293). Two kinds of loop:

- the whole-generation device loops (``device_loop.py``), whose state
  stays on the device; they serve every call that needs nothing from the
  host between steps;
- the host loops (``_beam_host_loop``, ``_greedy_host_loop``), which read
  each step's candidates on the host, in one copy a step, for the options
  that need them: cross-attention output and the coverage penalty,
  vocabulary logits, prefix-biased decoding and step callbacks. Every
  step is one call of ``decode_step``, a function of tensors (the decoder
  forward, the logits processors, log-softmax, the prefix-bias
  interpolation, then the beam's top-2K or the sampler); the host reads
  its outputs between steps, never inside it. The beam host loop reorders
  the cache through the fused gather kernel every step.

``decode_alternatives`` returns the alternatives at the first position
after a target prefix (reference: src/decoding.cc:1122-1293).

As in the JAX package, random sampling (``sampling_topk != 1`` or
``sampling_topp < 1``; a temperature alone samples nothing) applies to
greedy search, whose ``num_hypotheses > 1`` then decodes that many
replicas of each row; beam search always takes the best candidates
(the JAX package's ``_beam_search`` builds its signature with the argmax
sampler, so no entry point reaches its beam loop's Gumbel-max branch,
which the port leaves out until one does).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import transformer as T
from ..ops import attention as attn_ops
from . import device_loop, sampling
from .options import DecodingOptions, DecodingResult, DecodingStepResult

NEG = -1e10


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
    return_attention: bool = False  # the alignment layer's cross-attention
    use_bias_token: bool = False  # prefix-biased decoding
    prefix_bias_beta: float = 0.0
    # Whisper's timestamp rules: (eot, no_timestamps, timestamp_begin,
    # timestamp_end, max_initial_timestamp), or None.
    whisper_ts: Optional[Tuple[int, int, int, int, int]] = None


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def decode_step(model, params, consts, sig: StepSig, tokens, pos: int, cache,
                memory, *, step: int, disable_end, beam_size: int = 0,
                scores=None, alive_seq=None, bias_tokens=None, noise=None):
    """One decode step of the host loops, a function of tensors.

    ``tokens`` [N] (already mapped through a vocabulary restriction's
    token map), ``cache`` written in place at ``pos``, ``memory`` the
    (mem_kv, mem_bias) of an encoder-decoder model or (None, None),
    ``disable_end`` bool [N], ``alive_seq`` [N, L] for the processors that
    read history, ``bias_tokens`` long [N] (the prefix token to bias toward,
    -1 where the row has diverged), ``noise`` a function of a shape that
    returns the random sampler's Gumbel noise. Returns (ids, scores,
    attention, log_probs, logits): with a ``beam_size`` the 2 x beam best
    candidates of each batch row's beams, ids [B, 2K] flat over (beam,
    vocabulary), ``scores`` [N] (the beams' accumulated scores) added;
    otherwise one pick a row, ids and log-probs [N]. ``attention`` is
    [N, 1, S] or None, ``logits`` the processed logits [N, V] before the
    log-softmax.
    """
    mem_kv, mem_bias = memory
    out = T.decoder_forward(
        model.arch, params, consts, tokens[:, None], pos, cache, mem_kv, mem_bias,
        quantize_acts=model.policy.quantize_activations, out_dtype=model.out_dtype,
        return_attention=sig.return_attention)
    attention = out[2] if sig.return_attention else None
    l = out[0][:, -1].float()  # [N, V]
    l = device_loop.apply_processors(sig, l, step, disable_end, alive_seq)
    log_probs = torch.log_softmax(l, dim=-1)
    N, V = log_probs.shape

    if sig.use_bias_token:
        # Prefix-biased decoding (reference: src/decoding.cc:256-353):
        # interpolate the distribution toward the prefix token on the rows
        # that have not diverged.
        beta = sig.prefix_bias_beta
        onehot = torch.nn.functional.one_hot(bias_tokens.clamp(min=0), V).float()
        biased = (1.0 - beta) * torch.exp(log_probs) + beta * onehot
        log_probs = torch.where((bias_tokens >= 0)[:, None],
                                torch.log(biased.clamp(min=1e-20)), log_probs)

    if beam_size:
        total = log_probs + scores[:, None]
        top_scores, top_ids = sampling.small_top_k(
            total.reshape(N // beam_size, beam_size * V), 2 * beam_size)
        return top_ids, top_scores, attention, log_probs, l
    if sig.greedy_sampler:
        ids, s = sampling.greedy_tokens(log_probs)
    else:
        ids, s = sampling.sample_tokens(
            log_probs, noise(sampling.sample_noise_shape(N, V, sig.sampling_topk)),
            topk=sig.sampling_topk, topp=sig.sampling_topp,
            temperature=sig.sampling_temperature)
    return ids, s, attention, log_probs, l


def _read_step(parts):
    """The step's outputs on the host in one copy: ``parts`` is a list of
    tensors (int tensors travel as int32 bits inside the float32 copy).
    Returns numpy arrays of the parts' shapes, ints as int32."""
    flat = [p.to(torch.int32).view(torch.float32).reshape(-1)
            if not p.is_floating_point() else p.float().reshape(-1)
            for p in parts]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for p, f in zip(parts, flat):
        a = host[at:at + f.numel()].reshape(p.shape)
        out.append(a if p.is_floating_point() else a.view(np.int32))
        at += f.numel()
    return out


def _upload(device, *columns):
    """Host columns (numbers of one length) to the device in one copy, as
    int32 (float32 columns travel as their bits); returns int32 tensors."""
    host = np.stack([np.asarray(c).astype(np.float32).view(np.int32)
                     if np.asarray(c).dtype.kind == "f"
                     else np.asarray(c, np.int32) for c in columns])
    return torch.from_numpy(host).to(device)


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
        memory=None,  # precomputed (mem_kv, mem_bias) instead
        cache=None,  # prefilled self cache (generator prompt prefill)
        start_step: int = 0,
        prefix_ids: Optional[Sequence[Optional[Sequence[int]]]] = None,
        end_ids: Sequence[int] = (),
        capacity: Optional[int] = None,
        params=None,
        step_callback=None,
        token_map=None,  # long [V']: restricted id -> vocabulary id
    ) -> List[DecodingResult]:
        if params is None:
            params = self.model.params
        if options.min_length > options.max_length:
            raise ValueError("The minimum decoding length is greater than "
                             "the maximum decoding length")
        if options.max_length == 0:
            raise ValueError("The maximum decoding length must be > 0")
        # Prefix-biased decoding always runs the beam strategy, even at
        # beam_size=1 (reference: make_search_strategy,
        # src/decoding.cc:1076-1088).
        if options.beam_size > 1 or (
                options.prefix_bias_beta > 0 and prefix_ids is not None):
            return self._beam_search(start_ids, options, encoder_inputs, memory,
                                     prefix_ids, end_ids, start_step, params,
                                     cache, capacity, token_map)
        return self._greedy_search(start_ids, options, encoder_inputs, memory,
                                   prefix_ids, end_ids, start_step, params,
                                   cache, capacity, token_map, step_callback)

    # ------------------------------------------------------------------

    def _setup(self, options, prefix_ids, start_step, capacity, hard_prefix):
        max_prefix = 0
        if prefix_ids is not None:
            max_prefix = max((len(p) if p else 0) for p in prefix_ids)
        max_step = options.max_length + (
            max_prefix if hard_prefix and not options.return_prefix else 0)
        if capacity is None:
            # A verify chunk writes up to speculation_k - 1 slots past a
            # row's last token: they stay inside the buffer.
            capacity = _round_up(
                max(start_step + max_step + options.speculation_k, 16), 64)
        consts = self.model.ensure_consts(capacity)
        return max_step, capacity, consts

    def _memory(self, params, consts, encoder_inputs, memory):
        """(mem_kv, mem_bias): ``memory`` as given, or the fused encode and
        cross-KV projection of ``encoder_inputs``, or (None, None) for a
        decoder-only model."""
        if memory is not None:
            return memory
        if encoder_inputs is None:
            return None, None
        model = self.model
        ids, lengths = encoder_inputs
        qa = model.policy.quantize_activations
        encoded = T.encoder_forward(model.arch, params, consts, ids, lengths,
                                    quantize_acts=qa, out_dtype=model.out_dtype)
        mem_kv = T.precompute_memory(model.arch, params, encoded, quantize_acts=qa)
        return mem_kv, attn_ops.length_mask_bias(lengths, encoded.shape[1])

    @staticmethod
    def _make_sig(options: DecodingOptions, end_ids, greedy_sampler: bool = True,
                  use_bias: bool = False) -> StepSig:
        return StepSig(
            end_ids=tuple(end_ids),
            suppress_ids=tuple(options.suppress_tokens),
            begin_suppress_ids=tuple(options.suppress_tokens_begin),
            suppress_sequences=tuple(tuple(s) for s in options.suppress_sequences),
            repetition_penalty=options.repetition_penalty,
            no_repeat_ngram_size=options.no_repeat_ngram_size,
            use_alive_seq=(options.repetition_penalty != 1.0
                           or options.no_repeat_ngram_size > 0
                           or bool(options.suppress_sequences)
                           or options.whisper_ts is not None),
            greedy_sampler=greedy_sampler,
            sampling_topk=options.sampling_topk,
            sampling_topp=options.sampling_topp,
            sampling_temperature=options.sampling_temperature,
            return_attention=(options.return_attention
                              or options.coverage_penalty != 0),
            use_bias_token=use_bias,
            prefix_bias_beta=options.prefix_bias_beta if use_bias else 0.0,
            whisper_ts=options.whisper_ts,
        )

    @staticmethod
    def _finalize(result: DecodingResult, num_hypotheses, length_penalty,
                  coverage_penalty, return_scores, return_attention,
                  norm_lengths):
        """Normalize scores, add the coverage penalty and sort hypotheses
        (reference: src/decoding.cc:176-254). ``norm_lengths`` carries the
        reference's hypothesis length at finalize time, which counts the
        terminating EOS when include_eos_in_hypotheses (the default) even
        though the hypotheses are already stripped per return_end_token."""
        for i in range(len(result.scores)):
            length = max(norm_lengths[i], 1)
            score = result.scores[i] / math.pow(length, length_penalty)
            if coverage_penalty != 0 and result.attention:
                coverage = np.asarray(result.attention[i]).sum(axis=0)
                penalty = np.log(np.minimum(coverage[coverage > 0], 1.0)).sum()
                score += coverage_penalty * penalty
            result.scores[i] = score
        order = sorted(range(len(result.scores)),
                       key=lambda i: -result.scores[i])[:num_hypotheses]
        result.hypotheses = [result.hypotheses[i] for i in order]
        result.scores = [result.scores[i] for i in order] if return_scores else []
        result.attention = ([result.attention[i] for i in order]
                            if return_attention and result.attention else [])
        result.logits = ([result.logits[i] for i in order if i < len(result.logits)]
                         if result.logits else [])
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

    def _host_cache(self, cache, rows, capacity, ring: bool = False):
        """The host loops' self cache: the caller's (already of ``rows``
        rows and ``capacity`` slots), or a new one (ring buffers for the
        windowed layers with ``ring``: greedy search)."""
        model = self.model
        if cache is not None:
            return cache
        return T.init_self_cache(model.arch, rows, capacity, dtype=model.kv_dtype,
                                 device=model.device, ring=ring)

    # ------------------------------------------------------------------
    # Beam search.
    # ------------------------------------------------------------------

    def _beam_search(self, start_ids, options, encoder_inputs, memory, prefix_ids,
                     end_ids, start_step, params, cache, capacity, token_map):
        B = len(start_ids)
        K = options.beam_size
        hard_prefix = prefix_ids is not None and options.prefix_bias_beta <= 0
        use_bias = (prefix_ids is not None and any(p for p in prefix_ids)
                    and options.prefix_bias_beta > 0)
        max_step, capacity, consts = self._setup(
            options, prefix_ids, start_step, capacity, hard_prefix)
        sig = self._make_sig(options, end_ids, use_bias=use_bias)
        memory = self._memory(params, consts, encoder_inputs, memory)
        if cache is not None:
            cache = T.cache_grow(cache, B * K, capacity, arch=self.model.arch)
        if (sig.return_attention or options.return_logits_vocab or use_bias):
            return self._beam_host_loop(
                start_ids, options, sig, memory,
                prefix_ids if hard_prefix else None, prefix_ids if use_bias else None,
                end_ids, start_step, params, consts, cache, capacity, max_step,
                token_map)
        if not hard_prefix:
            prefix_ids = None
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
            memory=memory, cache=cache, token_map=token_map)
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

    def _beam_host_loop(self, start_ids, options, sig, memory, prefix_ids,
                        bias_ids, end_ids, start_step, params, consts, cache,
                        capacity, max_step, token_map):
        """Beam search with the candidate bookkeeping on the host (the JAX
        package's ``_beam_search`` host loop; reference:
        src/decoding.cc:411-720): hard-prefix override, EOS harvesting with
        secondary promotion, early exit off under a length or coverage
        penalty, divergence from a biasing prefix tracked by beam slot. One
        read of the step's candidates (with attention and logits when
        asked) and one upload of the reorder a step."""
        model = self.model
        device = model.device
        B = len(start_ids)
        K = options.beam_size
        K2 = 2 * K
        N = B * K
        num_hyp = options.num_hypotheses
        max_candidates = max(1, round(K * options.patience))
        cache = self._host_cache(cache, N, capacity)
        fed_map = None if token_map is None else token_map.to(device)
        alive_seq = (torch.zeros((N, max_step), dtype=torch.long, device=device)
                     if sig.use_alive_seq else None)

        tokens = torch.as_tensor(np.repeat(np.asarray(start_ids, np.int64), K),
                                 device=device)
        scores_np = np.zeros(N, np.float32)
        scores_np[np.arange(N) % K != 0] = NEG  # only beam 0 active at step 0
        scores = torch.from_numpy(scores_np).to(device)

        history = np.zeros((N, 0), np.int64)
        attn_history: List[List[np.ndarray]] = [[] for _ in range(N)]
        results = [DecodingResult() for _ in range(B)]
        norm_lengths: List[List[int]] = [[] for _ in range(B)]
        top_beam_finished = [False] * B
        batch_active = [True] * B
        allow_early_exit = (options.length_penalty == 0
                            and options.coverage_penalty == 0)
        end_set = set(end_ids)
        prefix_lengths = ([len(p) if p else 0 for p in prefix_ids]
                          if prefix_ids is not None else [0] * B)
        # Divergence from the biasing prefix, by beam slot (reference:
        # src/decoding.cc:326-345).
        bias_prefix = ([list(p) if p else [] for p in bias_ids]
                       if bias_ids is not None else None)
        diverged = np.zeros((B, K), bool)

        def bias_row(step):
            bt = np.full(N, -1, np.int64)
            for i in range(B):
                p = bias_prefix[i]
                if step < len(p):
                    for k in range(K):
                        if not diverged[i, k]:
                            bt[i * K + k] = p[step]
            return bt

        def disable_row(step):
            return np.repeat(np.asarray(
                [step < (0 if options.return_prefix else prefix_lengths[i])
                 + options.min_length for i in range(B)]), K)

        disable_end = torch.from_numpy(disable_row(0)).to(device)
        bias_tokens = (torch.from_numpy(bias_row(0)).to(device)
                       if bias_prefix is not None else None)

        for step in range(max_step):
            fed = tokens if fed_map is None else fed_map[tokens]
            ids_d, scores_d, attn_d, _, l_d = decode_step(
                model, params, consts, sig, fed, start_step + step, cache, memory,
                step=step, disable_end=disable_end, beam_size=K, scores=scores,
                alive_seq=alive_seq, bias_tokens=bias_tokens)
            V = l_d.shape[-1]
            parts = [ids_d, scores_d]
            if attn_d is not None:
                parts.append(attn_d[:, 0])
            if options.return_logits_vocab:
                parts.append(l_d)
            host = _read_step(parts)
            topk_flat = host[0].astype(np.int64)
            topk_scores = host[1].copy()
            attn_step = host[2] if attn_d is not None else None
            logits_step = host[-1] if options.return_logits_vocab else None
            words = topk_flat % V
            origins = topk_flat // V

            # Hard prefix override (reference: src/decoding.cc:21-67).
            if prefix_ids is not None:
                for i in range(B):
                    plen = prefix_lengths[i]
                    if step > plen or not batch_active[i]:
                        continue
                    for k in range(K2):
                        if step < plen:
                            words[i, k] = prefix_ids[i][step]
                            topk_scores[i, k] = 0.0 if k == 0 else NEG
                            origins[i, k] = 0
                        elif k > 0 and words[i, k] in end_set:
                            words[i, k] = 0
                            topk_scores[i, k] = NEG

            new_rows = np.arange(N, dtype=np.int64)
            new_tokens = np.zeros(N, np.int64)
            new_scores = np.full(N, NEG, np.float32)
            any_active = False
            for i in range(B):
                if not batch_active[i]:
                    continue
                plen = prefix_lengths[i]
                last_step = step + 1 == options.max_length + (
                    0 if options.return_prefix else plen)
                result = results[i]
                secondary = K
                for k in range(K):
                    word = int(words[i, k])
                    next_j = k
                    if (word in end_set and step >= plen) or last_step:
                        if k == 0:
                            top_beam_finished[i] = True
                        ignore_last = word in end_set and not options.return_end_token
                        start = 0 if options.return_prefix else plen
                        end = step if ignore_last else step + 1
                        # Score normalization counts EOS per
                        # include_eos_in_hypotheses (reference strips EOS
                        # only after finalize, sequence_to_sequence.cc:383).
                        norm_end = (step if (word in end_set and
                                             not options.include_eos_in_hypotheses)
                                    else step + 1)
                        row = i * K + int(origins[i, k])
                        full = [int(t) for t in history[row]] + [word]
                        result.scores.append(float(topk_scores[i, k]))
                        norm_lengths[i].append(max(norm_end - start, 1))
                        result.hypotheses.append(full[start:end])
                        if attn_step is not None:
                            full_attn = attn_history[row] + [attn_step[row]]
                            result.attention.append(
                                [a.tolist() for a in full_attn[start:end]])
                        if logits_step is not None:
                            # Beam search keeps only the step that finished
                            # the hypothesis (reference:
                            # src/decoding.cc:633-635).
                            result.logits.append([logits_step[row].copy()])
                        # Promote a secondary candidate.
                        for j in range(secondary, K2):
                            if int(words[i, j]) not in end_set:
                                next_j = j
                                secondary = j + 1
                                break
                    slot = i * K + k
                    new_rows[slot] = i * K + int(origins[i, next_j])
                    new_tokens[slot] = int(words[i, next_j])
                    new_scores[slot] = float(topk_scores[i, next_j])

                if last_step:
                    finished = True
                elif allow_early_exit:
                    finished = top_beam_finished[i] and len(result.hypotheses) >= num_hyp
                else:
                    finished = len(result.hypotheses) >= max_candidates
                if finished:
                    batch_active[i] = False
                    self._finalize(result, num_hyp, options.length_penalty,
                                   options.coverage_penalty, options.return_scores,
                                   options.return_attention, norm_lengths[i])
                else:
                    any_active = True

            # Divergence from the SELECTED beam tokens (reference:
            # get_beams_divergence_from_prefix, src/decoding.cc:326-345).
            if bias_prefix is not None:
                for i in range(B):
                    p = bias_prefix[i]
                    for k in range(K):
                        diverged[i, k] = (step >= len(p) or diverged[i, k]
                                          or int(new_tokens[i * K + k]) != p[step])
            if not any_active:
                break

            columns = [new_rows, new_tokens, new_scores, disable_row(step + 1)]
            if bias_prefix is not None:
                columns.append(bias_row(step + 1))
            up = _upload(device, *columns)
            rows = up[0]
            tokens = up[1].long()
            scores = up[2].view(torch.float32)
            disable_end = up[3].bool()
            if bias_prefix is not None:
                bias_tokens = up[4].long()
            cache = T.cache_gather_rows(cache, rows)
            if alive_seq is not None:
                alive_seq = alive_seq[rows.long()]
                alive_seq[:, step] = tokens
            history = np.concatenate([history[new_rows], new_tokens[:, None]], axis=1)
            if attn_step is not None:
                attn_history = [attn_history[r] + [attn_step[r]] for r in new_rows]

        for i in range(B):  # a batch that never finished
            if batch_active[i]:
                self._finalize(results[i], num_hyp, options.length_penalty,
                               options.coverage_penalty, options.return_scores,
                               options.return_attention, norm_lengths[i])
        return results

    # ------------------------------------------------------------------
    # Greedy search.
    # ------------------------------------------------------------------

    def _greedy_search(self, start_ids, options, encoder_inputs, memory,
                       prefix_ids, end_ids, start_step, params, cache, capacity,
                       token_map, step_callback):
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
                cache = T.cache_repeat_rows(cache, replicas)
        B = len(start_ids)
        max_step, capacity, consts = self._setup(
            options, prefix_ids, start_step, capacity, True)
        if cache is not None:
            cache = T.cache_grow(cache, B, capacity, arch=self.model.arch)
        sig = self._make_sig(options, end_ids, greedy_sampler=not is_random)
        memory = self._memory(params, consts, encoder_inputs, memory)
        noise = (sampling.noise_source(options.seed, self.model.device)
                 if is_random else None)

        if (step_callback is not None or sig.return_attention
                or options.return_logits_vocab):
            results = self._greedy_host_loop(
                start_ids, options, sig, memory, prefix_ids, end_ids, start_step,
                params, consts, cache, capacity, max_step, token_map, step_callback,
                noise, replicas)
        else:
            results = self._greedy_device(
                start_ids, options, sig, memory, prefix_ids, end_ids, start_step,
                params, consts, cache, capacity, max_step, token_map, noise)

        if replicas > 1:
            merged = [DecodingResult() for _ in range(B0)]
            for i, r in enumerate(results):
                m = merged[i // replicas]
                m.hypotheses.append(r.hypotheses[0])
                m.scores.append(r.scores[0])
                if options.return_attention:
                    m.attention.append(r.attention[0])
                if r.logits:
                    m.logits.append(r.logits[0])
            for m in merged:
                order = sorted(range(len(m.scores)), key=lambda i: -m.scores[i])
                m.hypotheses = [m.hypotheses[i] for i in order]
                m.scores = [m.scores[i] for i in order]
                m.attention = [m.attention[i] for i in order] if m.attention else []
                m.logits = [m.logits[i] for i in order] if m.logits else []
            results = merged
        for r in results:
            if not options.return_scores:
                r.scores = []
            if not options.return_attention:
                r.attention = []
        return results

    def _greedy_device(self, start_ids, options, sig, memory, prefix_ids, end_ids,
                       start_step, params, consts, cache, capacity, max_step,
                       token_map, noise):
        """Greedy search in the device loop (the JAX package's
        ``_greedy_device_loop``)."""
        B = len(start_ids)
        end_set = set(end_ids)
        prefix_lengths, P, prefix_arr = self._prefix_rows(prefix_ids, B)
        min_steps = [(prefix_lengths[i] if not options.return_prefix else 0)
                     + options.min_length for i in range(B)]

        control = np.zeros((B, 3 + prefix_arr.shape[1]), np.int64)
        control[:, 0] = prefix_lengths
        control[:, 1] = min_steps
        control[:, 2] = np.asarray(start_ids, np.int64)
        control[:, 3:] = prefix_arr
        # Lossless self-speculation (prompt-lookup drafts verified in
        # T = speculation_k chunks): greedy decoder-only runs with no
        # alive-seq logits processors (the Generator validates the rest).
        spec_k = options.speculation_k
        use_spec = (spec_k > 1 and sig.greedy_sampler and not sig.use_alive_seq
                    and token_map is None and memory[0] is None)
        if use_spec:
            if cache is None:
                # The loop's own cache: the JAX package's capacity, with
                # the speculation margin.
                capacity = _round_up(max(start_step + max_step + spec_k, 16), 64)
                consts = self.model.ensure_consts(capacity)
            buf, num_steps, scores = device_loop.spec_greedy_loop(
                self.model, params, consts, sig, max_steps=max_step,
                capacity=capacity, spec_k=spec_k, has_prefix=P > 0,
                control=torch.from_numpy(control), start_pos=start_step, cache=cache)
        else:
            buf, num_steps, scores = device_loop.greedy_loop(
                self.model, params, consts, sig, max_steps=max_step,
                capacity=capacity, has_prefix=P > 0,
                control=torch.from_numpy(control), start_pos=start_step,
                memory=memory, cache=cache, noise=noise, token_map=token_map)
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
            self._finalize(r, 1, options.length_penalty, 0.0, True, False,
                           norm_lengths=[max(norm_len, 1)])
            results.append(r)
        return results

    def _greedy_host_loop(self, start_ids, options, sig, memory, prefix_ids,
                          end_ids, start_step, params, consts, cache, capacity,
                          max_step, token_map, step_callback, noise, replicas):
        """Greedy search with a host read every step (the JAX package's
        ``_greedy_search`` host loop): cross-attention rows, every step's
        vocabulary logits, and a step callback, whose True ends its row.
        One read of the step's picks (with attention and logits when asked)
        and one upload a step."""
        model = self.model
        device = model.device
        B = len(start_ids)
        cache = self._host_cache(cache, B, capacity, ring=True)
        fed_map = None if token_map is None else token_map.to(device)
        alive_seq = (torch.zeros((B, max_step), dtype=torch.long, device=device)
                     if sig.use_alive_seq else None)
        tokens_np = np.asarray(start_ids, np.int64)
        tokens = torch.from_numpy(tokens_np).to(device)
        results = [DecodingResult(hypotheses=[[]], scores=[0.0], attention=[[]])
                   for _ in range(B)]
        active = np.ones(B, bool)
        norm_counts = [0] * B  # reference hypothesis length at finalize
        end_set = set(end_ids)
        prefix_lengths = ([len(p) if p else 0 for p in prefix_ids]
                          if prefix_ids is not None else [0] * B)

        def disable_row(step):
            return np.asarray([step < (prefix_lengths[i] if not options.return_prefix
                                       else 0) + options.min_length
                               for i in range(B)])

        disable_end = torch.from_numpy(disable_row(0)).to(device)
        for step in range(max_step):
            fed = tokens if fed_map is None else fed_map[tokens]
            ids_d, scores_d, attn_d, _, l_d = decode_step(
                model, params, consts, sig, fed, start_step + step, cache, memory,
                step=step, disable_end=disable_end, alive_seq=alive_seq,
                noise=None if noise is None else (
                    lambda shape, step=step: noise(step, shape, device)))
            parts = [ids_d, scores_d]
            if attn_d is not None:
                parts.append(attn_d[:, 0])
            if options.return_logits_vocab:
                parts.append(l_d)
            host = _read_step(parts)
            ids = host[0].astype(np.int64)
            step_scores = host[1].copy()
            attn_step = host[2] if attn_d is not None else None
            logits_step = host[-1] if options.return_logits_vocab else None

            if prefix_ids is not None:  # hard prefix forcing
                for i in range(B):
                    if step < prefix_lengths[i]:
                        ids[i] = prefix_ids[i][step]
                        step_scores[i] = 0.0

            all_done = True
            for i in range(B):
                if not active[i]:
                    continue
                word = int(ids[i])
                plen = prefix_lengths[i]
                result = results[i]
                if logits_step is not None:
                    # Greedy search keeps every decoded step's logits
                    # (reference: src/decoding.cc:905-908).
                    if not result.logits:
                        result.logits.append([])
                    result.logits[0].append(logits_step[i].copy())
                emitted = options.return_prefix or step >= plen
                if emitted:
                    if word not in end_set or options.return_end_token:
                        result.hypotheses[0].append(word)
                        if attn_step is not None:
                            result.attention[0].append(attn_step[i].tolist())
                    if word not in end_set or options.include_eos_in_hypotheses:
                        norm_counts[i] += 1
                result.scores[0] += float(step_scores[i])
                finished = ((word in end_set and step >= plen)
                            or step + 1 == options.max_length + (
                                0 if options.return_prefix else plen))
                if step_callback is not None and emitted:
                    if step_callback(DecodingStepResult(
                            step=step, batch_id=i // replicas, token_id=word,
                            hypothesis_id=i % replicas,
                            score=(float(step_scores[i]) if options.return_scores
                                   else None),
                            is_last=finished,
                            log_probs=(logits_step[i].copy()
                                       if logits_step is not None else None))):
                        finished = True
                if finished:
                    active[i] = False
                    self._finalize(result, 1, options.length_penalty,
                                   options.coverage_penalty, True,
                                   options.return_attention,
                                   norm_lengths=[max(norm_counts[i], 1)])
                else:
                    all_done = False
                    tokens_np[i] = word
            if all_done:
                break
            up = _upload(device, tokens_np, ids, disable_row(step + 1))
            tokens = up[0].long()
            disable_end = up[2].bool()
            if alive_seq is not None:
                alive_seq[:, step] = up[1].long()
        return results

    # ------------------------------------------------------------------
    # Alternatives at the first unconstrained position
    # (reference: src/decoding.cc:1122-1293).
    # ------------------------------------------------------------------

    def decode_alternatives(
        self,
        start_tokens: Sequence[int],  # [start] + prefix for ONE example
        options: DecodingOptions,
        *,
        memory=None,  # (mem_kv, mem_bias) of this example, or None
        start_step: int = 0,
        end_ids: Sequence[int] = (),
        cache=None,  # optional prefilled 1-row cache
        params=None,
        token_map=None,
    ) -> DecodingResult:
        """The ``num_hypotheses`` most likely tokens after the prefix, each
        expanded once and continued by ``decode``: hypotheses start with
        the prefix and part at its first free position. An expansion below
        ``min_alternative_expansion_prob`` ends the list."""
        model = self.model
        device = model.device
        if params is None:
            params = model.params
        tmap = None if token_map is None else token_map.cpu().numpy()

        def to_orig(ids):
            return list(ids) if tmap is None else [int(tmap[t]) for t in ids]

        num_hyp = options.num_hypotheses
        result = DecodingResult()
        start_tokens = list(start_tokens)
        if not start_tokens:
            raise ValueError("One input has no decoder start token")
        if len(start_tokens) > options.max_length + 1:
            start_tokens = start_tokens[:options.max_length + 1]
        prefix_length = len(start_tokens) - 1

        capacity = _round_up(start_step + options.max_length + 8, 64)
        consts = model.ensure_consts(capacity)
        memory = memory or (None, None)
        built_fresh = cache is None and start_step == 0
        if cache is None:
            cache = T.init_self_cache(model.arch, 1, capacity, dtype=model.kv_dtype,
                                      device=device)
        else:
            cache = T.cache_grow(cache, cache[0]["k"].shape[0], capacity,
                                 arch=model.arch)

        pos = start_step
        qa = model.policy.quantize_activations
        if prefix_length > 0:
            ids = torch.as_tensor([to_orig(start_tokens[:-1])], dtype=torch.long,
                                  device=device)
            T.decoder_forward(model.arch, params, consts, ids, pos, cache, *memory,
                              quantize_acts=qa, out_dtype=model.out_dtype,
                              return_logits=False, fresh_prefill=built_fresh)
            pos += prefix_length
            result.hypotheses = [list(start_tokens[1:]) for _ in range(num_hyp)]
            result.scores = [0.0] * num_hyp
            if prefix_length == options.max_length:
                if not options.return_scores:
                    result.scores = []
                return result
        else:
            result.hypotheses = [[] for _ in range(num_hyp)]
            result.scores = [0.0] * num_hyp

        # One-step expansion: the num_hypotheses most likely next tokens.
        sig = self._make_sig(dataclasses.replace(options, return_attention=False,
                                                 coverage_penalty=0.0), end_ids)
        tok = torch.as_tensor(to_orig([start_tokens[-1]]), dtype=torch.long,
                              device=device)
        disable_end = torch.full((1,), pos - start_step < options.min_length,
                                 dtype=torch.bool, device=device)
        alive = (torch.zeros((1, 1), dtype=torch.long, device=device)
                 if sig.use_alive_seq else None)
        _, _, _, log_probs, _ = decode_step(
            model, params, consts, sig, tok, pos, cache, memory, step=0,
            disable_end=disable_end, alive_seq=alive)
        lp = log_probs[0].float().cpu().numpy()
        top = np.argsort(-lp)[:num_hyp]

        expanded = []
        for j, w in enumerate(top):
            if float(np.exp(lp[w])) < options.min_alternative_expansion_prob:
                break
            result.hypotheses[j].append(int(w))
            result.scores[j] = float(lp[w])
            expanded.append(int(w))
        num_alt = len(expanded)
        result.hypotheses = result.hypotheses[:num_alt]
        result.scores = result.scores[:num_alt]
        pos += 1
        if pos - start_step >= options.max_length or num_alt == 0:
            if not options.return_scores:
                result.scores = []
            return result

        # Continue each alternative on its own copy of the cache.
        cont = dataclasses.replace(
            options, num_hypotheses=1,
            max_length=max(options.max_length - (pos - start_step), 1),
            min_length=max(options.min_length - (pos - start_step), 0),
            return_scores=True, return_prefix=True, return_alternatives=False)
        suffixes = self.decode(
            expanded, cont, memory=memory, cache=T.cache_repeat_rows(cache, num_alt), start_step=pos,
            end_ids=end_ids, capacity=capacity, params=params, token_map=token_map)
        for j, suffix in enumerate(suffixes):
            # The reference adds the (normalized) suffix score as it is
            # (reference: src/decoding.cc:1270-1273).
            if suffix.scores:
                result.scores[j] += suffix.scores[0]
            result.hypotheses[j].extend(suffix.hypotheses[0])
        if not options.return_scores:
            result.scores = []
        return result

