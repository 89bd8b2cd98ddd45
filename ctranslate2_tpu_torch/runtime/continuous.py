"""Iteration-level (continuous) batching for decoder-only models.

Port of the greedy and sampled ``ContinuousBatcher`` of
``ctranslate2_tpu/runtime/continuous.py`` (the serving capability the
reference approximates with a replica pool and a buffered batcher:
include/ctranslate2/replica_pool.h:19-300,
src/buffered_translation_wrapper.cc:68-111). A fixed set of slots decodes
one token a step; between blocks of ``steps_per_sync`` steps the host
frees finished slots and admits queued requests into them (the admit
prefills the prompt into a prompt-sized cache and copies it into the slot's
cache row). A request submitted while others decode joins them at the
next block.

- ``num_slots`` rows of ``capacity`` KV slots, allocated once;
- per-slot positions: every slot decodes at its own position, an int
  [num_slots] tensor through ``decoder_forward`` (position tables, rotary
  phases, cache scatters, biases, the decode attention's lengths);
- the slot state (tokens, positions, generated counts) stays on the
  device between blocks, so block N+1 is queued before the host has read
  block N's tokens (``pipeline_depth`` blocks in flight). A block's ids
  and scores come back through pinned host memory behind a CUDA event;
  no step reads the device.

Not ported yet (each raises ``NotImplementedError``): beam serving
(``beam_size > 1``), speculation (``speculation_k > 1``, ``draft_model``)
and multi-host serving.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..decoding import processors as proc
from ..decoding.sampling import (greedy_tokens, sample_tokens_per_row,
                                 slot_noise)
from ..models import transformer as T
from .results import GenerationResult, GenerationStepResult

# Blocks in flight; ``CT2TPU_PIPELINE_DEPTH`` or ``pipeline_depth=`` set
# another (1-4). 1 from the H100's runs (PERF.md section 5): a second block
# in flight gave the same tokens/s and latencies within their spread, and
# decoded 12% more steps (slots that ended while a block was in flight).
DEFAULT_PIPELINE_DEPTH = 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class _Request:
    prompt_ids: List[int]
    max_length: int
    min_length: int
    temperature: float = 0.0  # 0 = the batcher's default
    # Per-request sampling overrides (None = the batcher's default).
    topk: Optional[int] = None
    topp: Optional[float] = None
    seed: Optional[int] = None
    end_ids: Optional[tuple] = None
    # Per-request logits-processor overrides (None = the batcher's default).
    rep_penalty: Optional[float] = None
    ngram: Optional[int] = None
    suppress_ids: Optional[tuple] = None
    future: Future = field(default_factory=Future)
    # Token-streaming callback: return True to stop this request early.
    callback: Optional[object] = None
    # Multi-token stop sequences (token id tuples), matched on the
    # generated tail and trimmed from the result.
    stop_sequences: tuple = ()
    # Filled while decoding:
    generated: List[int] = field(default_factory=list)
    score: float = 0.0
    stopped: bool = False
    stop_len: Optional[int] = None
    stop_score: float = 0.0
    callback_error: Optional[BaseException] = None
    # Serving latency: submission time and the first token's.
    t_submit: float = field(default_factory=time.monotonic)
    t_first: Optional[float] = None
    # Rolling per-token scores (stop-sequence trimming refunds them).
    recent_scores: List[float] = field(default_factory=list)
    max_stop_len: int = 0

    def __post_init__(self):
        self.max_stop_len = max((len(s) for s in self.stop_sequences), default=0)


class ContinuousBatcher:
    """Continuous batching front-end over a ``Generator``'s model, on the
    model's device.

    Serves every decoder position family: rotary, learned, sinusoidal,
    ALiBi, the T5 bias, Shaw positions and sliding windows over ring caches
    (each slot's biases are built from its own position every step).

    Construction fixes the defaults; sampling (topk/topp/temperature/seed),
    end tokens, stop sequences, streaming callbacks, repetition_penalty,
    no_repeat_ngram_size and suppress_tokens are per request on
    ``submit`` (the reference's per-call options,
    include/ctranslate2/generation.h:14-78).

    Sampling draws each slot's Gumbel noise from a ``torch.Generator`` of
    its own, seeded at admit from the batcher's ``seed`` and the request's
    ``seed``: a request with a seed draws the same tokens whatever else the
    batcher serves. (The JAX package draws from ``fold_in(key, seed)``
    with the batcher's step count folded into ``key``; the same seed gives
    other tokens there, and the tokens of the two packages agree only when
    fed the same noise.) A request without a seed gets a new stream at
    every admit.
    """

    def __init__(self, generator, **kw):
        model = generator.model
        if not model.is_decoder_only:
            raise ValueError("ContinuousBatcher requires a decoder-only model")
        self._init_common(model, **kw)
        self._start_loop()

    def _init_common(
        self,
        model,
        *,
        num_slots: int = 8,
        capacity: int = 1024,
        end_token=None,
        suppress_tokens: Sequence[str] = (),
        sampling_topk: int = 1,
        sampling_topp: float = 1.0,
        sampling_temperature: float = 1.0,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        seed: int = 0,
        prefill_bucket: int = 16,
        steps_per_sync: int = 8,
        speculation_k: int = 0,
        draft_model=None,
        max_sampling_topk: int = 64,
        max_no_repeat_ngram_size: int = 8,
        beam_size: int = 1,
        num_hypotheses: int = 1,
        length_penalty: float = 1.0,
        patience: float = 1.0,
        pipeline_depth: int = None,
    ):
        if beam_size > 1:
            raise NotImplementedError("beam serving (beam_size > 1) is not ported yet")
        if speculation_k > 1:
            raise NotImplementedError("speculation (speculation_k > 1) is not ported yet")
        if draft_model is not None:
            raise NotImplementedError("draft-model speculation is not ported yet")
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError("multi-host continuous serving is not ported yet")
        self.model = model
        self._device = model.device
        self._vocab = model.target_vocabulary
        self._num_slots = num_slots
        self._capacity = capacity
        self._prefill_bucket = prefill_bucket
        # Steps a dispatch: the host frees and admits slots between blocks.
        self._block = max(1, steps_per_sync)
        self._topk = sampling_topk
        self._topp = sampling_topp
        self._temperature = sampling_temperature
        self._seed = int(seed)
        self._rep_penalty = float(repetition_penalty)
        self._ngram = int(no_repeat_ngram_size)
        self._max_ngram = max(int(max_no_repeat_ngram_size), self._ngram, 2)
        v = self._vocab
        if end_token is None or end_token == "":
            self._end_ids = (v.eos_id,)
        elif isinstance(end_token, str):
            self._end_ids = (v.to_id(end_token, allow_unk=False),)
        else:
            self._end_ids = tuple(t if isinstance(t, int) else v.to_id(t, allow_unk=False)
                                  for t in end_token)
        self._suppress_ids = tuple(v.to_id(t, allow_unk=False) for t in suppress_tokens)
        model.ensure_consts(capacity)

        S, V, dev = num_slots, len(v), self._device
        # Penalty tables: [S, V] generated-token presence (repetition
        # penalty) and [S, capacity + 1] generated-token history
        # (no-repeat-ngram; entry t the t-th generated token, the last
        # column where a slot past its capacity writes). Zero rows mean
        # "penalties off": allocated at construction, or on the first
        # request that asks for a penalty.
        pen_rows = S if (self._rep_penalty != 1.0 or self._ngram) else 0
        self._seen = torch.zeros((pen_rows, V), dtype=torch.bool, device=dev)
        self._hist = torch.zeros((pen_rows, capacity + 1), dtype=torch.long, device=dev)

        # The KV cache's type is fixed here (``CT2TPU_KV_CACHE`` is read once):
        # every admit's prefill cache takes it too.
        self._kv_dtype = model.kv_dtype
        self._cache = T.init_self_cache(model.arch, S, capacity, dtype=self._kv_dtype,
                                        device=dev, ring=True)
        self._rows = torch.arange(S, device=dev)
        # Device slot state, read and written by the queued work only.
        self._dstate = {"tokens": torch.zeros(S, dtype=torch.long, device=dev),
                        "pos": torch.zeros(S, dtype=torch.int32, device=dev),
                        "gen": torch.zeros(S, dtype=torch.int32, device=dev)}
        # The host's copy of each slot's device position after every block
        # queued so far: the length-adaptive attention's trip count.
        self._dpos = np.zeros(S, np.int64)

        if pipeline_depth is None:
            pipeline_depth = int(os.environ.get("CT2TPU_PIPELINE_DEPTH",
                                                str(DEFAULT_PIPELINE_DEPTH)))
        self._depth = max(1, min(int(pipeline_depth), 4))
        self._ttfts = deque(maxlen=10000)

        # Host slot state.
        self._slots: List[Optional[_Request]] = [None] * S
        self._pos = np.zeros(S, np.int32)
        self._temps = np.full(S, self._temperature or 1.0, np.float32)
        # topk: 1 = greedy, 0 = the whole vocabulary.
        self._max_topk = max(int(max_sampling_topk), self._topk if 1 < self._topk else 1)
        self._topks = np.full(S, max(self._topk, 0), np.int32)
        self._topps = np.full(S, min(self._topp, 1.0), np.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * S
        self._admits = 0
        # Per-slot end-token table [S, E] (-1 padding).
        self._end_cols = max(4, len(self._end_ids))
        self._end_table = np.full((S, self._end_cols), -1, np.int32)
        for e, eid in enumerate(self._end_ids):
            self._end_table[:, e] = eid
        self._min_lens = np.zeros(S, np.int32)
        self._rep_pens = np.full(S, self._rep_penalty, np.float32)
        self._ngrams = np.full(S, self._ngram, np.int32)
        # Per-request suppress_tokens [S, W]; zero width is a no-op.
        self._sup_table = np.full((S, 0), -1, np.int32)
        self._dopts = None  # the device copy of the per-slot options
        self._step_count = 0
        self._blocks = 0
        self._tokens_out = 0
        self._requests_done = 0
        self._slot_steps = 0
        self._started_at = time.monotonic()

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._admitting: Optional[_Request] = None
        self._closed = False
        self._wake = threading.Event()

    def _start_loop(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ct2tpu-torch-continuous")
        self._thread.start()

    # ------------------------------------------------------------------
    # Public API.
    # ------------------------------------------------------------------

    def submit(self, prompt: Sequence[str], *, max_length: int = 256,
               min_length: int = 0,
               sampling_temperature: float = None,
               sampling_topk: int = None,
               sampling_topp: float = None,
               seed: int = None,
               end_token=None,
               repetition_penalty: float = None,
               no_repeat_ngram_size: int = None,
               suppress_tokens: Sequence = None,
               num_hypotheses: int = None,
               callback=None,
               stop_sequences: Sequence[Sequence] = None) -> Future:
        """Queue one prompt; the Future resolves to a GenerationResult
        holding the GENERATED continuation (prompt not included).

        ``callback`` streams tokens: called with a GenerationStepResult per
        generated token from the scheduler thread (keep it cheap: it blocks
        the decode loop); return True to stop this request early. A
        callback exception cancels the request and surfaces through its
        future."""
        if self._closed:
            raise RuntimeError("The batcher is closed")
        if not prompt:
            raise ValueError("The prompt must contain at least one token")
        ids = [self._vocab.to_id(t) if isinstance(t, str) else int(t) for t in prompt]
        margin = self._block
        if len(ids) + max_length + margin > self._capacity:
            raise ValueError(
                f"prompt ({len(ids)}) + max_length ({max_length}) + "
                f"dispatch margin ({margin}) exceeds the slot "
                f"capacity ({self._capacity})")
        self._validate_request_sampling(sampling_topk)
        self._validate_beam_request(num_hypotheses)
        rep, ngram, sup_ids = self._validate_request_penalties(
            repetition_penalty, no_repeat_ngram_size, suppress_tokens)
        req = _Request(prompt_ids=ids, max_length=max_length,
                       min_length=min_length,
                       temperature=sampling_temperature or 0.0,
                       topk=sampling_topk, topp=sampling_topp, seed=seed,
                       end_ids=self._resolve_request_end_ids(end_token),
                       rep_penalty=rep, ngram=ngram, suppress_ids=sup_ids,
                       callback=callback,
                       stop_sequences=self._stop_ids(stop_sequences))
        self._queue.put(req)
        self._wake.set()
        return req.future

    def stream(self, *args, **kwargs):
        """Iterator of GenerationStepResults for one request (the serving
        form of ``generate_tokens``); the arguments are ``submit``'s.
        Closing the iterator early stops the request; request errors
        re-raise at the end of iteration."""
        q: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        def on_token(sr):
            q.put(sr)
            return stop.is_set()

        future = self.submit(*args, callback=on_token, **kwargs)
        future.add_done_callback(lambda f: q.put(None))
        finished = False
        try:
            while True:
                item = q.get()
                if item is None:
                    finished = True
                    break
                yield item
        finally:
            stop.set()
            if finished:
                future.result()  # surface request errors
            else:
                # The consumer walked away: wait for the stop, swallow errors.
                self._settle(future)

    async def async_stream(self, *args, **kwargs):
        """Asyncio form of :meth:`stream`."""
        import asyncio

        loop = asyncio.get_running_loop()
        q: "asyncio.Queue" = asyncio.Queue()
        stop = threading.Event()

        def on_token(sr):
            loop.call_soon_threadsafe(q.put_nowait, sr)
            return stop.is_set()

        future = self.submit(*args, callback=on_token, **kwargs)
        future.add_done_callback(lambda f: loop.call_soon_threadsafe(q.put_nowait, None))
        finished = False
        try:
            while True:
                item = await q.get()
                if item is None:
                    finished = True
                    break
                yield item
        finally:
            stop.set()
            if finished:
                future.result()
            else:
                await loop.run_in_executor(None, self._settle, future)

    @staticmethod
    def _settle(future):
        try:
            future.result(timeout=600)
        except Exception:
            pass

    @property
    def num_active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def num_queued_requests(self) -> int:
        return self._queue.qsize()

    @property
    def num_steps(self) -> int:
        """Decode steps dispatched (each advances every slot)."""
        return self._step_count

    def stats(self) -> dict:
        """Serving counters since construction: generated tokens, finished
        requests, decode steps and blocks, mean slot occupancy, tokens/s
        and time-to-first-token percentiles."""
        dt = max(time.monotonic() - self._started_at, 1e-9)
        tt = np.asarray(self._ttfts, np.float64)
        return {
            "ttft_mean_ms": float(tt.mean() * 1e3) if tt.size else None,
            "ttft_p50_ms": float(np.percentile(tt, 50) * 1e3) if tt.size else None,
            "ttft_p95_ms": float(np.percentile(tt, 95) * 1e3) if tt.size else None,
            "pipeline_depth": self._depth,
            "num_tokens": self._tokens_out,
            "num_requests": self._requests_done,
            "num_steps": self._step_count,
            "num_blocks": self._blocks,
            "tokens_per_sec": self._tokens_out / dt,
            "mean_slot_occupancy": (
                self._slot_steps / max(self._step_count * self._num_slots, 1)),
            "uptime_s": dt,
            "spec_tokens_per_dispatch": None,
            "spec_draft": None,
            "num_queued": self._queue.qsize(),
        }

    def close(self):
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=30)

    def join(self, timeout: Optional[float] = None) -> None:
        """Blocks until the scheduler thread exits."""
        self._thread.join(timeout)

    # ------------------------------------------------------------------
    # Per-request options.
    # ------------------------------------------------------------------

    def _req_end_ids(self, req) -> tuple:
        return req.end_ids if req.end_ids is not None else self._end_ids

    def _resolve_request_end_ids(self, end_token):
        """A per-request ``end_token`` (token, id or list) as ids, bounded by
        the slot end table's width."""
        if end_token is None:
            return None
        v = self._vocab
        if isinstance(end_token, str):
            ids = (v.to_id(end_token, allow_unk=False),)
        else:
            ids = tuple(t if isinstance(t, int) else v.to_id(t, allow_unk=False)
                        for t in end_token)
        if not ids:
            return None
        if len(ids) > self._end_cols:
            raise ValueError(f"end_token lists up to {self._end_cols} ids per request")
        return ids

    def _validate_request_sampling(self, topk) -> None:
        if topk is not None and topk != 0 and not 1 <= topk <= self._max_topk:
            raise ValueError(
                f"per-request sampling_topk must be 0 (full vocabulary) or "
                f"in [1, {self._max_topk}] (raise max_sampling_topk at "
                "construction for larger values)")

    def _validate_request_penalties(self, rep_penalty, ngram, suppress_tokens) -> tuple:
        """Checks per-request logits-processor overrides; returns
        (rep_penalty, ngram, suppress ids)."""
        if rep_penalty is not None and rep_penalty <= 0:
            raise ValueError("repetition_penalty must be positive")
        if ngram is not None and ngram != 0:
            if ngram < 2:
                raise ValueError("no_repeat_ngram_size must be 0 or >= 2")
            if ngram > self._max_ngram:
                raise ValueError(
                    f"per-request no_repeat_ngram_size must be <= "
                    f"{self._max_ngram} (raise max_no_repeat_ngram_size "
                    "at construction for larger values)")
        sup_ids = None
        if suppress_tokens:
            v = self._vocab
            sup_ids = tuple(t if isinstance(t, int) else v.to_id(t, allow_unk=False)
                            for t in suppress_tokens)
        return rep_penalty, ngram, sup_ids

    @staticmethod
    def _validate_beam_request(num_hypotheses) -> None:
        if num_hypotheses is not None and num_hypotheses != 1:
            raise NotImplementedError(
                "num_hypotheses > 1 needs beam serving, which is not ported yet")

    def _stop_ids(self, stop_sequences) -> tuple:
        v = self._vocab
        for seq in (stop_sequences or ()):
            if isinstance(seq, str):
                raise ValueError(
                    "each stop sequence must be a list of tokens or ids "
                    f"(got the string {seq!r}; wrap single tokens in a list)")
        return tuple(
            tuple(t if isinstance(t, int) else v.to_id(t, allow_unk=False) for t in seq)
            for seq in (stop_sequences or ()) if seq)

    def _set_slot_sampling(self, slot: int, req: _Request) -> None:
        """The request's options into the slot's row of the option tables
        (the batcher's options where the request gives none), and the
        slot's noise generator when it samples."""
        self._temps[slot] = req.temperature or self._temperature or 1.0
        self._topks[slot] = req.topk if req.topk is not None else max(self._topk, 0)
        self._topps[slot] = req.topp if req.topp is not None else min(self._topp, 1.0)
        self._end_table[slot, :] = -1
        for e, eid in enumerate(self._req_end_ids(req)):
            self._end_table[slot, e] = eid
        self._min_lens[slot] = req.min_length
        rp = req.rep_penalty if req.rep_penalty is not None else self._rep_penalty
        ng = req.ngram if req.ngram is not None else self._ngram
        if rp != 1.0 or ng:
            self._ensure_pen_tables()
        self._rep_pens[slot] = rp
        self._ngrams[slot] = ng
        sup = req.suppress_ids or ()
        if len(sup) > self._sup_table.shape[1]:
            grown = np.full((self._num_slots, _round_up(len(sup), 4)), -1, np.int32)
            grown[:, :self._sup_table.shape[1]] = self._sup_table
            self._sup_table = grown
        self._sup_table[slot, :] = -1
        self._sup_table[slot, :len(sup)] = sup
        self._admits += 1
        self._gens[slot] = None
        if self._topks[slot] != 1:
            g = torch.Generator(device=self._device)
            stream = req.seed if req.seed is not None else (1 << 32) + self._admits
            g.manual_seed((self._seed * 0x9E3779B1 + stream) % (1 << 63))
            self._gens[slot] = g
        self._dopts = None

    def _ensure_pen_tables(self) -> None:
        """Allocates the penalty tables on first use, backfilling every
        in-flight slot's generated tokens from its request record."""
        if self._seen.shape[0]:
            return
        S, V, C = self._num_slots, len(self._vocab), self._capacity
        seen = np.zeros((S, V), bool)
        hist = np.zeros((S, C + 1), np.int64)
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            gen = req.generated[:C]
            hist[s, :len(gen)] = gen
            seen[s, gen] = True
        self._seen = self._upload(seen)
        self._hist = self._upload(hist)

    def _upload(self, array):
        """A host array on the device: through pinned memory on a card, so
        the copy queues behind the work in flight instead of waiting."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _device_options(self) -> dict:
        """The per-slot option tables on the device, uploaded again after an
        admit changed them."""
        if self._dopts is None:
            self._dopts = {
                "temps": self._upload(self._temps),
                "topks": self._upload(self._topks.astype(np.int64)),
                "topps": self._upload(self._topps),
                "min_len": self._upload(self._min_lens),
                "rep_pens": self._upload(self._rep_pens),
                "ngrams": self._upload(self._ngrams.astype(np.int64)),
                "end_table": self._upload(self._end_table.astype(np.int64)),
                "sup_table": self._upload(self._sup_table.astype(np.int64)),
            }
        return self._dopts

    # ------------------------------------------------------------------
    # Token selection.
    # ------------------------------------------------------------------

    def _select(self, l, disable_end, opts, gens):
        """Tokens of float32 logits ``l`` [S, V] with the slots' suppressed
        tokens and, where ``disable_end``, their end tokens disabled."""
        l = proc.disable_tokens(l, self._suppress_ids)
        l = proc.disable_tokens_per_row(l, opts["sup_table"])
        ends = torch.where(disable_end[:, None], opts["end_table"], -1)
        l = proc.disable_tokens_per_row(l, ends)
        return self._pick(l, gens, opts)

    def _pick(self, l, gens, opts):
        """The argmax of the log-softmax of ``l`` (``gens`` None: no row
        samples), or the per-row sampler with each row's noise from
        ``gens``. Scores come from the distribution before the top-k,
        top-p and temperature (the reference's RandomSampler,
        src/sampling.cc:94-99)."""
        log_probs = torch.log_softmax(l, dim=-1)
        if gens is None:
            return greedy_tokens(log_probs)
        return sample_tokens_per_row(
            log_probs, slot_noise(gens, l.shape[-1], l.device), topks=opts["topks"],
            topps=opts["topps"], temps=opts["temps"], max_topk=self._max_topk)

    def _select_one(self, slot: int, logits, disable_end: bool):
        """The first token of an admitted request from its prompt's last
        logits [1, V], with the slot's options."""
        sup = self._suppress_ids + tuple(int(t) for t in self._sup_table[slot] if t >= 0)
        l = proc.disable_tokens(logits.float(), sup)
        if disable_end:
            l = proc.disable_tokens(l, tuple(int(t) for t in self._end_table[slot] if t >= 0))
        if self._topks[slot] == 1:
            return self._pick(l, None, None)
        dev = logits.device
        opts = {"topks": torch.full((1,), int(self._topks[slot]), dtype=torch.long, device=dev),
                "topps": torch.full((1,), float(self._topps[slot]), device=dev),
                "temps": torch.full((1,), float(self._temps[slot]), device=dev)}
        return self._pick(l, [self._gens[slot]], opts)

    # ------------------------------------------------------------------
    # Streaming and bookkeeping.
    # ------------------------------------------------------------------

    def _emit(self, req: _Request, tok: int, score: float) -> None:
        """Appends one generated token and streams it to the request's
        callback (``is_last`` on the end and max-length conditions)."""
        req.generated.append(tok)
        req.score += score
        if req.t_first is None:
            req.t_first = time.monotonic()
            self._ttfts.append(req.t_first - req.t_submit)
        if req.stop_sequences:
            req.recent_scores.append(score)
            del req.recent_scores[:-req.max_stop_len]
            for seq in req.stop_sequences:
                n = len(seq)
                if len(req.generated) >= n and tuple(req.generated[-n:]) == seq:
                    del req.generated[-n:]
                    req.score -= sum(req.recent_scores[-n:])
                    req.stopped = True
                    return
        if req.callback is None or req.stopped:
            return
        done = ((tok in self._req_end_ids(req) and len(req.generated) > req.min_length)
                or len(req.generated) >= req.max_length)
        try:
            if req.callback(GenerationStepResult(
                    step=len(req.generated) - 1, batch_id=0, token_id=tok,
                    hypothesis_id=0, token=self._vocab.to_token(tok),
                    score=score, is_last=done)):
                req.stopped = True
                req.stop_len = len(req.generated)
                req.stop_score = req.score
        except BaseException as e:  # noqa: BLE001
            req.callback_error = e
            req.stopped = True
            req.stop_len = len(req.generated)
            req.stop_score = req.score

    def _fail_pending(self, exc):
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)

    def _harvest(self):
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            done = False
            if (req.generated and req.generated[-1] in self._req_end_ids(req)
                    and len(req.generated) > req.min_length):
                req.generated.pop()  # the end token is not returned
                done = True
            elif len(req.generated) >= req.max_length:
                done = True
            elif req.stopped:
                done = True
            elif int(self._pos[i]) + self._block > self._capacity:
                done = True  # slot capacity exhausted
            if done:
                self._finish(i, req)

    def _finish(self, slot: int, req: _Request):
        v = self._vocab
        if req.stop_len is not None and len(req.generated) > req.stop_len:
            del req.generated[req.stop_len:]
            req.score = req.stop_score
        self._slots[slot] = None
        self._tokens_out += len(req.generated)
        self._requests_done += 1
        if req.callback_error is not None:
            if not req.future.done():
                req.future.set_exception(req.callback_error)
            return
        result = GenerationResult(
            sequences=[[v.to_token(t) for t in req.generated]],
            sequences_ids=[list(req.generated)],
            scores=[req.score])
        if not req.future.done():
            req.future.set_result(result)

    def _collect_admits(self):
        """Pops admissible requests and gives them free slots; a request
        cancelled through its future while queued is dropped here."""
        picked = []
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            # set_running_or_notify_cancel also wakes the waiters of a
            # cancelled future.
            if not req.future.set_running_or_notify_cancel():
                continue
            picked.append((free.pop(0), req))
        return picked

    # ------------------------------------------------------------------
    # Admit: the prompt's prefill into a free slot.
    # ------------------------------------------------------------------

    def _prefill_logits(self, ids: List[int]):
        """Prefill of one prompt into a prompt-sized cache (``fresh_prefill``,
        padded to ``prefill_bucket``, masked at its length): (the last
        prompt position's float32 logits [1, V], the 1-row cache)."""
        model = self.model
        dev = self._device
        L = len(ids)
        P = _round_up(L, self._prefill_bucket)
        padded = torch.zeros((1, P), dtype=torch.long)
        padded[0, :L] = torch.tensor(ids, dtype=torch.long)
        cache = T.init_self_cache(model.arch, 1, P, dtype=self._kv_dtype, device=dev,
                                  ring=True)
        qa = model.policy.quantize_activations
        h, cache = T.decoder_forward(
            model.arch, model.params, model.consts, padded.to(dev), 0, cache,
            lengths=torch.tensor([L], dtype=torch.long).to(dev), quantize_acts=qa,
            out_dtype=model.out_dtype, return_logits=False, fresh_prefill=True)
        return T.project_logits(model.arch, model.params, h[:, L - 1], qa).float(), cache

    def _prefill_chunked(self, ids: List[int], rb: int):
        """A window model's prompt longer than one ring block: the
        reference's chunked prefill (chunks split at multiples of the ring
        block) through a 1-row ring cache of the slot's shape."""
        model = self.model
        dev = self._device
        qa = model.policy.quantize_activations
        cache = T.init_self_cache(model.arch, 1, self._capacity, dtype=self._kv_dtype,
                                  device=dev, ring=True)
        h = last = None
        for off, size in T.split_prefill_chunks(0, len(ids), rb):
            chunk = torch.zeros((1, _round_up(size, self._prefill_bucket)),
                                dtype=torch.long)
            chunk[0, :size] = torch.tensor(ids[off:off + size], dtype=torch.long)
            # No lengths mask: it would mask the earlier chunks' keys. The
            # padded tail writes positions past the prompt, which decode
            # overwrites before they become visible.
            h, cache = T.decoder_forward(
                model.arch, model.params, model.consts, chunk.to(dev), off, cache,
                quantize_acts=qa, out_dtype=model.out_dtype, return_logits=False,
                fresh_prefill=(off == 0))
            last = size
        return T.project_logits(model.arch, model.params, h[:, last - 1], qa).float(), cache

    def _prefill_into_slot(self, slot: int, req: _Request):
        ids = req.prompt_ids
        rb = T.ring_block(self.model.arch)
        self._set_slot_sampling(slot, req)
        if rb and len(ids) > rb:
            logits, sub = self._prefill_chunked(ids, rb)
        else:
            logits, sub = self._prefill_logits(ids)
        tok, score = self._select_one(slot, logits, req.min_length > 0)
        T.cache_insert_row(self._cache, sub, slot)
        del sub
        first = int(tok[0])  # the admit's one wait for the card
        if self._seen.shape[0]:
            self._seen[slot] = False
            self._seen[slot, first] = True
            self._hist[slot] = 0
            self._hist[slot, 0] = first
        self._emit(req, first, float(score[0]))
        self._slots[slot] = req
        self._pos[slot] = len(ids)
        # The slot's device state: queued after the blocks in flight, so
        # the next block dispatched sees the admitted row.
        self._dstate["tokens"][slot] = first
        self._dstate["pos"][slot] = len(ids)
        self._dstate["gen"][slot] = 1
        self._dpos[slot] = len(ids)

    # ------------------------------------------------------------------
    # Decode blocks.
    # ------------------------------------------------------------------

    def _dispatch_block(self, active: List[int]):
        """Queues one block of ``steps_per_sync`` decode steps from the
        device slot state, without waiting for the card. Returns the
        handle ``_consume_block`` reads the block's tokens from (possibly
        after the NEXT block has been queued)."""
        model = self.model
        arch, qa = model.arch, model.policy.quantize_activations
        cap, block = self._capacity, self._block
        binding = {i: self._slots[i] for i in active}
        opts = self._device_options()
        sampled = any(self._topks[i] != 1 for i in active)
        gens = [g if self._topks[s] != 1 else None
                for s, g in enumerate(self._gens)] if sampled else None
        tokens, gen = self._dstate["tokens"], self._dstate["gen"]
        # Overshoot clamp: a slot that finished while a block was in
        # flight keeps advancing until re-admitted; its writes stay inside
        # its row (the admit resets it).
        pos = torch.clamp(self._dstate["pos"], max=cap - block)
        starts = np.minimum(self._dpos, cap - block)
        top = int(starts.max())
        self._dpos = starts + block
        seen, hist = self._seen, self._hist
        pen = seen.shape[0] > 0
        ids_k, scores_k = [], []
        for i in range(block):
            logits, self._cache = T.decoder_forward(
                arch, model.params, model.consts, tokens[:, None], pos, self._cache,
                quantize_acts=qa, out_dtype=model.out_dtype, pos_bound=top + i)
            l = logits[:, -1].float()
            if pen:
                l = proc.repetition_penalty_per_row(l, seen, opts["rep_pens"])
                l = proc.no_repeat_ngram_per_row(l, hist[:, :cap], gen, opts["ngrams"],
                                                 self._max_ngram)
            ids, scores = self._select(l, gen < opts["min_len"], opts, gens)
            if pen:
                seen[self._rows, ids] = True
                hist[self._rows, torch.clamp(gen, max=cap).long()] = ids
            ids_k.append(ids)
            scores_k.append(scores)
            tokens, pos, gen = ids, pos + 1, gen + 1
        self._dstate = {"tokens": tokens, "pos": pos, "gen": gen}
        self._step_count += block
        self._blocks += 1
        self._slot_steps += len(active) * block
        return self._to_host(torch.stack(ids_k), torch.stack(scores_k)) + (binding,)

    def _to_host(self, ids, scores):
        """Copies of a block's ids and scores [block, S] that the host can
        read once the returned event (None on the CPU) has completed."""
        if self._device.type != "cuda":
            return ids, scores, None
        host_ids = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        host_scores = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
        host_ids.copy_(ids, non_blocking=True)
        host_scores.copy_(scores, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host_ids, host_scores, done

    def _consume_block(self, handle):
        """Waits for one block's tokens and emits them. A slot whose request
        changed since the dispatch (finished and re-admitted while the
        block was in flight) is skipped: its tokens continue a request
        that has ended."""
        ids_h, scores_h, done, binding = handle
        if done is not None:
            done.synchronize()
        ids = ids_h.numpy()
        scores = scores_h.float().numpy()
        for i, req in binding.items():
            if self._slots[i] is not req:
                continue
            for j in range(self._block):
                tok = int(ids[j, i])
                self._emit(req, tok, float(scores[j, i]))
                self._pos[i] += 1
                # Once the request is done, the rest of the block is a
                # continuation nobody asked for; _harvest frees the slot.
                if req.stopped:
                    break
                if tok in self._req_end_ids(req) and len(req.generated) > req.min_length:
                    break
                if len(req.generated) >= req.max_length:
                    break

    # ------------------------------------------------------------------
    # Scheduler loop.
    # ------------------------------------------------------------------

    def _loop(self):
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            # Up to self._depth blocks in flight: the host reads block N's
            # tokens while block N+1 runs on the card.
            inflight = deque()
            while True:
                self._harvest()
                for slot, req in self._collect_admits():
                    self._admitting = req  # failed with the rest if the admit raises
                    self._prefill_into_slot(slot, req)
                    self._admitting = None
                active = [i for i, s in enumerate(self._slots) if s is not None]
                if not active and not inflight:
                    if self._closed:
                        self._fail_pending(RuntimeError("Batcher closed"))
                        return
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                if active:
                    inflight.append(self._dispatch_block(active))
                while len(inflight) >= (self._depth if active else 1):
                    self._consume_block(inflight.popleft())
        except BaseException as e:  # noqa: BLE001
            self._fail_pending(e)
            for s in self._slots + [self._admitting]:
                if s is not None and not s.future.done():
                    s.future.set_exception(e)
