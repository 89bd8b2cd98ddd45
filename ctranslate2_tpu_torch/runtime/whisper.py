"""Whisper: the speech-to-text task API (parity with reference:
src/models/whisper.cc, include/ctranslate2/models/whisper.h).

Port of ``ctranslate2_tpu/runtime/whisper.py``: ``encode``, ``generate``
(beam or greedy, timestamps by Whisper's rules, a ``<|startofprev|>``
prompt prefilled once into the cache, the no-speech probability),
``detect_language`` and ``align`` (cross-attention of the alignment heads,
median filter and dynamic time warping in numpy, as in the JAX package).
Runs on one CUDA card by default, or on the CPU when ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decoding.engine import DecodingEngine, _round_up
from ..decoding.options import DecodingOptions
from ..models import transformer as T
from ..models.loader import LoadedModel
from ..ops import attention as attn_ops
from .base import TaskAPIMixin
from .results import AsyncResult


@dataclass
class WhisperGenerationResult:
    sequences: List[List[str]] = field(default_factory=list)
    sequences_ids: List[List[int]] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    # Per-step vocabulary logits (reference ``return_logits_vocab``:
    # include/ctranslate2/models/whisper.h:46,64).
    logits: List[List[object]] = field(default_factory=list)
    no_speech_prob: float = 0.0

    @property
    def num_sequences(self) -> int:
        return len(self.sequences)


@dataclass
class WhisperAlignmentResult:
    alignments: List[Tuple[int, int]] = field(default_factory=list)
    text_token_probs: List[float] = field(default_factory=list)


def negative_dtw(matrix: np.ndarray) -> List[Tuple[int, int]]:
    """Dynamic time warping over -cost with backtrace (reference:
    src/dtw.cc:8-81)."""
    n, m = matrix.shape
    cost = np.full((n + 1, m + 1), np.inf, np.float32)
    trace = np.full((n + 1, m + 1), -1, np.int8)
    cost[0, 0] = 0.0
    for j in range(1, m + 1):
        for i in range(1, n + 1):
            c_diag = cost[i - 1, j - 1]
            c_up = cost[i - 1, j]
            c_left = cost[i, j - 1]
            if c_diag < c_up and c_diag < c_left:
                c, t = c_diag, 0
            elif c_up < c_diag and c_up < c_left:
                c, t = c_up, 1
            else:
                c, t = c_left, 2
            cost[i, j] = -matrix[i - 1, j - 1] + c
            trace[i, j] = t
    trace[0, :m + 1] = 2
    trace[:n + 1, 0] = 1

    result = []
    i, j = n, m
    while i > 0 or j > 0:
        result.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    result.reverse()
    return result


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Sliding median over the last axis with reflected edges (reference:
    src/ops/median_filter.cc)."""
    pad = width // 2
    padded = np.concatenate(
        [x[..., 1:pad + 1][..., ::-1], x, x[..., -pad - 1:-1][..., ::-1]], axis=-1)
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1)


class Whisper(TaskAPIMixin):
    """Whisper on one device. ``device`` is ``"cuda"`` (the default; raises
    without CUDA) or ``"cpu"``; ``flash_attention=True`` sends the encoder's
    attention to the flash kernel on the card whatever its length."""

    def __init__(self, model_path: str, device: Optional[str] = None,
                 compute_type: str = "default", device_index=0,
                 inter_threads: int = 1, intra_threads: int = 0,
                 max_queued_batches: int = 0, **kwargs):
        self.model: LoadedModel = self._load_model(
            model_path, compute_type, device, device_index, kwargs)
        enc = self.model.arch.encoder
        if enc is None or not enc.num_conv_layers or self.model.arch.decoder is None:
            raise ValueError(f"The model at {model_path} is not a Whisper model")
        self._apply_flash_flag(kwargs)
        self.engine = DecodingEngine(self.model)
        self._init_replicas(device, device_index, DecodingEngine)
        self._start_pool(inter_threads, max_queued_batches, kwargs)

        v = self.model.target_vocabulary
        self._sot_id = v.bos_id
        self._eot_id = v.eos_id
        self._no_timestamps_id = v.to_id("<|notimestamps|>")
        self._no_speech_id = v.to_id("<|nospeech|>")
        if self._no_speech_id == v.unk_id:
            self._no_speech_id = v.to_id("<|nocaptions|>")
        self._is_multilingual = v.to_id("") != v.unk_id
        self._num_languages = self._no_speech_id - self._sot_id - 5

    @property
    def is_multilingual(self) -> bool:
        return self._is_multilingual

    @property
    def n_mels(self) -> int:
        return self.model.params["encoder"]["convs"][0]["w"].shape[1]

    @property
    def num_languages(self) -> int:
        return self._num_languages

    @property
    def _vocab(self):
        return self.model.target_vocabulary

    # ------------------------------------------------------------------

    def encode(self, features, to_cpu: bool = False):
        """Encode mel features [B, n_mels, T] into [B, T // 2, d_model]
        (reference: whisper.cc:81-120); on the CPU with ``to_cpu``."""
        model = self.model
        out = T.speech_encoder_forward(
            model.arch, model.params, model.consts,
            torch.as_tensor(features).to(model.device),
            quantize_acts=model.policy.quantize_activations, out_dtype=model.out_dtype)
        return out.cpu() if to_cpu else out

    def _maybe_encode(self, features):
        """Features already encoded ([B, frames, d_model]) pass as they are,
        in the activation type; mel features are encoded."""
        features = torch.as_tensor(features).to(self.model.device)
        d_model = self.model.params["encoder"]["layer_norm"]["gamma"].shape[0]
        if (features.ndim == 3 and features.shape[2] == d_model
                and features.shape[1] != self.n_mels):
            return features.to(self.model.out_dtype)
        return self.encode(features)

    def _memory(self, memory):
        """The decoder's (cross K/V, memory bias) for the encoder output."""
        model = self.model
        mem_kv = T.precompute_memory(model.arch, model.params, memory,
                                     quantize_acts=model.policy.quantize_activations)
        lengths = torch.full((memory.shape[0],), memory.shape[1], dtype=torch.long,
                             device=memory.device)
        return mem_kv, attn_ops.length_mask_bias(lengths, memory.shape[1])

    def _no_speech_probs(self, logits):
        probs = torch.softmax(logits.float(), dim=-1)
        return probs[:, self._no_speech_id].cpu().numpy()

    # ------------------------------------------------------------------

    def generate(self, features, prompts: Sequence[Sequence], *,
                 asynchronous: bool = False, **options) -> List[WhisperGenerationResult]:
        """Generate from audio features (reference: whisper.cc:717-740;
        options: include/ctranslate2/models/whisper.h:11-59). With
        ``asynchronous=True`` returns one AsyncResult a prompt."""
        feats = torch.as_tensor(features)

        def run(rows):  # a contiguous share of the rows (_split_over_data)
            return self._generate_impl(feats[rows[0]:rows[-1] + 1],
                                       [prompts[i] for i in rows], **options)

        future = self._pool.submit(self._split_over_data, list(range(len(prompts))), run,
                                   options.get("sampling_topk", 1) == 1)
        if asynchronous:
            return [AsyncResult(future, i) for i in range(len(prompts))]
        return future.result()

    def _generate_impl(
        self,
        features,
        prompts: Sequence[Sequence],
        *,
        beam_size: int = 5,
        patience: float = 1.0,
        num_hypotheses: int = 1,
        length_penalty: float = 1.0,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        max_length: int = 448,
        return_scores: bool = False,
        return_logits_vocab: bool = False,
        return_no_speech_prob: bool = False,
        max_initial_timestamp_index: int = 50,
        suppress_blank: bool = True,
        suppress_tokens: Sequence[int] = (-1,),
        sampling_topk: int = 1,
        sampling_topp: float = 1.0,
        sampling_temperature: float = 1.0,
    ) -> List[WhisperGenerationResult]:
        v = self._vocab
        prompts_ids = [[v.to_id(t) if isinstance(t, str) else int(t) for t in p]
                       for p in prompts]

        # One SOT index and prompt length for the batch (reference:
        # whisper.cc:146-190).
        def sot_index(p):
            if self._sot_id not in p:
                raise ValueError("<|startoftranscript|> token was not found in the prompt")
            return p.index(self._sot_id)

        def prompt_length(p):
            i = sot_index(p)
            while i < len(p) and self._sot_id <= p[i] <= self._no_timestamps_id:
                i += 1
            return i

        sot_idx = sot_index(prompts_ids[0])
        plen = prompt_length(prompts_ids[0])
        for p in prompts_ids[1:]:
            if sot_index(p) != sot_idx or prompt_length(p) != plen:
                raise ValueError("The generate method requires the same prompt "
                                 "structure in all batches")

        model = self.model
        qa = model.policy.quantize_activations
        memory = self._maybe_encode(features)
        mem_kv, mem_bias = self._memory(memory)

        suppress_ids = []
        for t in suppress_tokens:
            if t >= 0:
                suppress_ids.append(int(t))
            elif t == -1:
                suppress_ids.extend(int(i) for i in model.config.get("suppress_ids", []))
        begin_ids = ([int(i) for i in model.config.get("suppress_ids_begin", [])]
                     if suppress_blank else [])

        B = len(prompts_ids)
        start_step = 0
        no_speech_probs = None
        cache = capacity = None
        start_tokens = prompts_ids
        if plen > 1:
            # The prompt up to its last special token, prefilled once into the
            # cache (attention over the fresh positions only).
            chunk = [p[:plen - 1] for p in prompts_ids]
            start_tokens = [p[plen - 1:] for p in prompts_ids]
            capacity = _round_up(len(prompts_ids[0]) + max_length, 64)
            consts = model.ensure_consts(capacity)
            cache = T.init_self_cache(model.arch, B, capacity, dtype=model.kv_dtype,
                                      device=model.device)
            logits, cache = T.decoder_forward(
                model.arch, model.params, consts,
                torch.tensor(chunk, dtype=torch.long, device=model.device), 0, cache,
                mem_kv, mem_bias, quantize_acts=qa, out_dtype=model.out_dtype,
                return_logits=return_no_speech_prob, fresh_prefill=True)
            if return_no_speech_prob:
                # The no-speech probability at the SOT step (reference:
                # whisper.cc:263-290).
                at = sot_idx if sot_idx < logits.shape[1] else -1
                no_speech_probs = self._no_speech_probs(logits[:, at])
            start_step = len(chunk[0])

        whisper_ts = None
        if prompts_ids[0][plen - 1] != self._no_timestamps_id:
            ts_begin = self._no_timestamps_id + 1
            whisper_ts = (self._eot_id, self._no_timestamps_id, ts_begin, len(v) - 1,
                          ts_begin + max_initial_timestamp_index)

        if return_no_speech_prob and no_speech_probs is None:
            # SOT is the decode start token: its logits, from a scratch cache.
            scratch = T.init_self_cache(model.arch, B, _round_up(max_length + 8, 64),
                                        dtype=model.out_dtype, device=model.device)
            logits, _ = T.decoder_forward(
                model.arch, model.params, model.consts,
                torch.tensor([[p[0]] for p in start_tokens], dtype=torch.long,
                             device=model.device), 0, scratch, mem_kv, mem_bias,
                quantize_acts=qa, out_dtype=model.out_dtype)
            no_speech_probs = self._no_speech_probs(logits[:, -1])

        options = DecodingOptions(
            beam_size=beam_size,
            patience=patience,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            max_length=min(max_length // 2, max(max_length - start_step, 1)),
            sampling_topk=sampling_topk,
            sampling_topp=sampling_topp,
            sampling_temperature=sampling_temperature,
            num_hypotheses=num_hypotheses,
            return_scores=return_scores,
            return_logits_vocab=return_logits_vocab,
            return_end_token=False,
            include_eos_in_hypotheses=False,
            suppress_tokens=tuple(suppress_ids),
            suppress_tokens_begin=tuple(begin_ids),
            return_prefix=True,
            whisper_ts=whisper_ts,
        )
        first_ids = [p[0] for p in start_tokens]
        prefix_ids = [p[1:] for p in start_tokens]
        if not any(prefix_ids):
            prefix_ids = None
        dec_results = self.engine.decode(
            first_ids, options, memory=(mem_kv, mem_bias), cache=cache,
            start_step=start_step, prefix_ids=prefix_ids, end_ids=(self._eot_id,),
            capacity=capacity)

        results = []
        for i, dr in enumerate(dec_results):
            r = WhisperGenerationResult(
                sequences=[[v.to_token(t) for t in h] for h in dr.hypotheses],
                sequences_ids=[list(h) for h in dr.hypotheses],
                scores=dr.scores,
                logits=dr.logits if return_logits_vocab else [])
            if no_speech_probs is not None:
                r.no_speech_prob = float(no_speech_probs[i])
            results.append(r)
        return results

    # ------------------------------------------------------------------

    def detect_language(self, features) -> List[List[Tuple[str, float]]]:
        """The language tokens' probabilities at the SOT step, best first
        (reference: whisper.cc:584-654)."""
        if not self._is_multilingual:
            raise RuntimeError("detect_language can only be called on multilingual models")
        model = self.model
        v = self._vocab
        lang_ids = [int(i) for i in model.config.get("lang_ids", [])]
        memory = self._maybe_encode(features)
        mem_kv, mem_bias = self._memory(memory)
        B = memory.shape[0]
        cache = T.init_self_cache(model.arch, B, 16, dtype=model.kv_dtype,
                                  device=model.device)
        logits, _ = T.decoder_forward(
            model.arch, model.params, model.consts,
            torch.full((B, 1), self._sot_id, dtype=torch.long, device=model.device), 0,
            cache, mem_kv, mem_bias, quantize_acts=model.policy.quantize_activations,
            out_dtype=model.out_dtype)
        lang_logits = logits[:, -1].float().cpu().numpy()[:, lang_ids]
        probs = np.exp(lang_logits - lang_logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        results = []
        for b in range(B):
            pairs = [(v.to_token(lang_ids[j]), float(probs[b, j]))
                     for j in range(len(lang_ids))]
            pairs.sort(key=lambda x: -x[1])
            results.append(pairs)
        return results

    # ------------------------------------------------------------------

    def align(self, features, start_sequence: Sequence[int],
              text_tokens: Sequence[Sequence[int]], num_frames,
              median_filter_width: int = 7) -> List[WhisperAlignmentResult]:
        """Word-level timestamp alignment: the alignment heads'
        cross-attention, normalized over each row's own length, median
        filtered and warped (reference: whisper.cc:387-582)."""
        model = self.model
        B = len(text_tokens)
        if isinstance(num_frames, int):
            num_frames = [num_frames] * B
        num_frames = [n // 2 for n in num_frames]
        heads = model.config.get("alignment_heads")
        if heads is None:
            raise RuntimeError("The model configuration does not contain "
                               "'alignment_heads'")
        alignment_pairs = tuple((int(l), int(h)) for l, h in heads)

        input_tokens = [list(start_sequence) + [self._no_timestamps_id] + list(text)
                        + [self._eot_id] for text in text_tokens]
        output_tokens = [seq[1:] + [0] for seq in input_tokens]
        memory = self._maybe_encode(features)
        mem_kv, mem_bias = self._memory(memory)

        max_len = max(len(s) for s in input_tokens)
        lengths = [len(s) for s in input_tokens]
        padded_in = [s + [0] * (max_len - len(s)) for s in input_tokens]
        padded_out = [s + [0] * (max_len - len(s)) for s in output_tokens]
        consts = model.ensure_consts(max_len)
        logits, _, attn = T.decoder_forward(
            model.arch, model.params, consts,
            torch.tensor(padded_in, dtype=torch.long, device=model.device), 0, None,
            mem_kv, mem_bias,
            lengths=torch.tensor(lengths, dtype=torch.long, device=model.device),
            alignment_pairs=alignment_pairs, raw_attention=True,
            quantize_acts=model.policy.quantize_activations, out_dtype=model.out_dtype)

        # The text tokens' probabilities over the text vocabulary only (a
        # softmax over ids [0, eot): reference whisper.cc:495-503).
        text_logits = logits.float().cpu().numpy()[:, :, :self._eot_id].copy()
        text_logits -= text_logits.max(-1, keepdims=True)
        probs = np.exp(text_logits)
        probs /= probs.sum(-1, keepdims=True)
        out_ids = np.asarray(padded_out)
        token_probs = np.take_along_axis(
            probs, np.minimum(out_ids, self._eot_id - 1)[..., None], axis=-1)[..., 0]
        attn_np = attn.float().cpu().numpy()  # [B, P, T, S], before the softmax

        results = []
        sot_len = len(start_sequence)
        # Each row is post-processed over its own token length (the
        # reference's variable-frames path, whisper.cc:519-548), never over
        # the padded batch.
        for b in range(B):
            text_len = len(text_tokens[b])
            probs_b = [float(token_probs[b, sot_len + t]) for t in range(text_len)]
            nf = num_frames[b]
            if nf <= 0:
                results.append(WhisperAlignmentResult([], probs_b))
                continue
            w = attn_np[b, :, :lengths[b], :nf]  # [P, T, S']
            w = w - w.max(-1, keepdims=True)
            w = np.exp(w)
            w /= w.sum(-1, keepdims=True)
            # Standardized over the text axis (LayerNorm(-2, 0)).
            mean = w.mean(axis=-2, keepdims=True)
            std = w.std(axis=-2, keepdims=True)
            w = (w - mean) / np.maximum(std, 1e-10)
            w = median_filter(w, median_filter_width)
            weights = w.mean(axis=0)  # [T, S']
            matrix = weights[sot_len:sot_len + text_len + 1]
            results.append(WhisperAlignmentResult(negative_dtw(matrix), probs_b))
        return results
