"""Iteration-level (continuous) batching: decoder-only models
(``ContinuousBatcher``), encoder-decoder models (``ContinuousTranslator``)
and Whisper (``ContinuousWhisper``).

Port of ``ctranslate2_tpu/runtime/continuous.py`` (the serving capability
the reference approximates with a replica pool and a buffered batcher:
include/ctranslate2/replica_pool.h:19-300,
src/buffered_translation_wrapper.cc:68-111). A fixed set of slots decodes
one token a step; between blocks of ``steps_per_sync`` steps the host
frees finished slots and admits queued requests into them. A request
submitted while others decode joins them at the next block.

- ``num_slots`` rows of ``capacity`` KV slots (``num_slots * beam_size``
  under beam search), allocated once;
- per-slot positions: every slot decodes at its own position, an int
  tensor through ``decoder_forward`` (position tables, rotary phases,
  cache scatters, biases, the decode attention's lengths);
- the slot state stays on the device between blocks, so block N+1 is
  queued before the host has read block N (``pipeline_depth`` blocks in
  flight). A greedy block's ids and scores, or a beam block's [S] active
  flags, come back through pinned host memory behind a CUDA event; no
  step reads the device.

Greedy and sampled decoding emit one token a slot and step. Lossless
speculation (``speculation_k`` > 1, greedy only) verifies ``speculation_k``
tokens a slot in one decoder forward of T = ``speculation_k`` and emits the
matched prefix plus one token: the drafts come from the request's own
context (prompt lookup) or from a small ``draft_model`` that decodes
``speculation_k`` steps on the card first. It is host-driven: one dispatch
at a time, whose ids, scores and fed drafts come back in one pinned copy.
Beam search
(``beam_size`` > 1, the reference's serving default, src/decoding.cc:
411-720) keeps K rows a slot and the whole candidate bookkeeping on the
device: every step selects each slot's next K beams from its top 2K
candidates, harvests finished hypotheses into a per-slot store and
reorders the slot cache through the gather kernel (``cache_gather_rows``).

Multi-process serving (the model loaded with ``tensor_parallel=True`` in
every rank of a ``torch.distributed`` job): every rank constructs the
batcher with the same arguments. Rank 0 leads: it owns the queue and the
host bookkeeping (callbacks, cancellations, finishes) and broadcasts a
control record before each admit (the slots it freed since the last record
and the admitted requests, a Whisper admit's features included) and after
an admit's first token (the slots that token freed). The followers replay
the records, so every rank queues the same prefills and decode blocks, in
one order, and the model's collectives meet. The records travel over a
gloo group (``Grid.control``) in frames of ``parallel.comm.FRAME_BYTES``.
A follower takes no requests: it serves until the leader closes, which
``join()`` waits for. A leader whose scheduler fails sends a last record
with its error, which the followers raise from ``join()``, rather than
leave them waiting for a record until the group's timeout; a follower's
own failure (a replayed admit that fails on every rank) it raises there
too. A rank-local failure between two of the model's collectives (a card
fault on one rank) leaves the others in that collective until the process
group's timeout or until the launcher stops the job (``parallel/launch.py``
stops every rank at the first one's failure). A draft model under more
than one process raises ``NotImplementedError``, as in the JAX package.

The slots on the data axis: where the job's data axis D divides
``num_slots`` S, data group d owns the contiguous slots [d S/D, (d+1) S/D)
(as ``P("data")`` places rows, ``ctranslate2_tpu/parallel/sharding.py``
``shard_cache``) and holds on the card only their state: the slot cache,
the per-slot cross memory, the beam state and the penalty tables. Every
rank still takes every record and keeps the host bookkeeping of every
slot. Only the owner group prefills (or encodes) an admitted slot, with
no ring prefill over the data axis; the admit's first token, or its
failure, reaches every rank in one gather over the data axis. Each group
decodes its own active slots and skips a block in which it has none (so
it enters no model collective); the block's results (ids and scores, a
verify's drafts, a beam block's active flags with the finished or
streamed slots' hypotheses) are gathered over the data axis in one buffer
before any rank consumes them. Where D does not divide S every data rank
holds every slot, as ``fit_spec`` leaves an axis that does not divide
replicated.
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..decoding import processors as proc
from ..decoding.sampling import (greedy_tokens, gumbel_top_k_per_row,
                                 sample_tokens_per_row, slot_noise, small_top_k)
from ..models import transformer as T
from ..ops import attention as attn_ops
from .results import GenerationResult, GenerationStepResult

# Blocks in flight; ``CT2TPU_PIPELINE_DEPTH`` or ``pipeline_depth=`` set
# another (1-4). 1 from the H100's runs (PERF.md section 5): a second block
# in flight gave the same tokens/s and latencies within their spread, and
# decoded 12% more steps (slots that ended while a block was in flight).
DEFAULT_PIPELINE_DEPTH = 1
# A dead beam's running score (the batch engine's).
NEG = -1e10
# How long a failed leader waits for the followers to take its last record.
STOP_SECONDS = 10.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _seen_accept(seen, toks, counts):
    """Marks the first ``counts[s]`` of ``toks`` [S, K] in row s of the
    presence table ``seen`` [S, V], in place."""
    K = toks.shape[1]
    valid = torch.arange(K, device=toks.device)[None, :] < counts[:, None]
    seen |= proc._scatter_any(seen.shape[0], seen.shape[1], toks, valid)


def _hist_accept(hist, toks, counts, gen, cap: int):
    """Writes the first ``counts[s]`` of ``toks`` [S, K] into row s of the
    history table ``hist`` [S, cap + 1] at generated indices gen[s] ..., in
    place; the last column takes the rest."""
    K = toks.shape[1]
    j = torch.arange(K, device=toks.device)[None, :]
    posn = gen[:, None] + j
    hist.scatter_(1, torch.where((j < counts[:, None]) & (posn < cap), posn, cap), toks)


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
    # generated tail (greedy) or among the beam candidates (beam) and
    # trimmed from the result.
    stop_sequences: tuple = ()
    # Beam serving: the hypotheses returned (None = the batcher's default)
    # and the committed tokens already streamed.
    num_hypotheses: Optional[int] = None
    streamed: int = 0
    # Encoder-decoder requests: the decoder start token, the forced target
    # prefix (its length ``forced_len``), the source-factor id streams and
    # Whisper's mel features and timestamp-rules switch.
    start_id: Optional[int] = None
    prefix_ids: List[int] = field(default_factory=list)
    forced_len: int = 0
    feature_ids: Optional[list] = None
    features: Optional[np.ndarray] = None
    ts_on: bool = False
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
    # Whether the leader streams this request (followers hold no callback).
    streams: bool = False
    # Rolling per-token scores (stop-sequence trimming refunds them).
    recent_scores: List[float] = field(default_factory=list)
    max_stop_len: int = 0

    def __post_init__(self):
        self.max_stop_len = max((len(s) for s in self.stop_sequences), default=0)
        self.streams = self.streams or self.callback is not None


class ContinuousBatcher:
    """Continuous batching front-end over a ``Generator``'s model, on the
    model's device.

    Serves every decoder position family: rotary, learned, sinusoidal,
    ALiBi, the T5 bias, Shaw positions and sliding windows over ring caches
    (each slot's biases are built from its own position every step).

    Construction fixes the defaults and the beam width; sampling
    (topk/topp/temperature/seed), end tokens, stop sequences, streaming
    callbacks, repetition_penalty, no_repeat_ngram_size, suppress_tokens
    and, under beam search, num_hypotheses are per request on ``submit``
    (the reference's per-call options,
    include/ctranslate2/generation.h:14-78).

    Sampling draws each slot's Gumbel noise from a ``torch.Generator`` of
    its own, seeded at admit from the batcher's ``seed`` and the request's
    ``seed``: a request with a seed draws the same tokens whatever else the
    batcher serves. (The JAX package draws from ``fold_in(key, seed)``
    with the batcher's step count folded into ``key``; the same seed gives
    other tokens there, and the tokens of the two packages agree only when
    fed the same noise.) A request without a seed gets a new stream at
    every admit. Under beam search a sampled slot draws [K * V] noise a
    step, for ``gumbel_top_k_per_row``'s 2K candidates; a slot with topk 1
    keeps the deterministic candidates and draws nothing.
    """

    _seq2seq = False  # the encoder-decoder batchers carry per-slot memory
    _wts = None  # Whisper's timestamp-rule ids (ContinuousWhisper sets them)

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
        self._beam = max(1, int(beam_size))
        # The scheduler loop's three calls, greedy or beam for the batcher's life.
        self._harvest_any, self._dispatch_any, self._consume_any = (
            (self._harvest_beam, self._decode_step_beam, self._consume_beam)
            if self._beam > 1 else
            (self._harvest, self._decode_step_spec, self._accept_spec_round)
            if speculation_k > 1 else
            (self._harvest, self._dispatch_block, self._consume_block))
        if self._beam > 1 and (speculation_k or draft_model is not None):
            raise NotImplementedError(
                "speculation requires greedy decoding (beam_size=1): beam serving "
                "takes no speculation_k or draft_model")
        if speculation_k:
            if not (sampling_topk == 1 and sampling_topp >= 1.0):
                raise NotImplementedError(
                    "speculation requires greedy decoding (losslessness of "
                    "draft verification is only guaranteed under argmax)")
            T.check_speculation_window(model.arch, speculation_k)
        if draft_model is not None and speculation_k <= 1:
            raise ValueError("draft_model requires speculation_k > 1")
        self._dist = None  # the control group of a multi-process job
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            if getattr(model, "grid", None) is None:
                raise ValueError(
                    "multi-process continuous serving requires the model to be "
                    "loaded with tensor_parallel=True")
            if draft_model is not None:
                raise NotImplementedError(
                    "draft-model speculation is not supported in multi-process "
                    "continuous serving")
            self._dist = model.grid.control
        self._leader = self._dist is None or self._dist.rank == 0
        # The slots whose state this rank holds on the card: [lo, lo + ns),
        # a data group's share where the data axis divides num_slots.
        self._shard = None  # the data axis, in that layout
        self._lo, self._ns = 0, num_slots
        grid = getattr(model, "grid", None)
        if self._dist is not None and grid.num_data > 1 and num_slots % grid.num_data == 0:
            self._shard = grid.data
            self._ns = num_slots // grid.num_data
            self._lo = grid.data.rank * self._ns
        self._snap = None  # sharded beam: the last block's gathered hypotheses
        self._freed: List[int] = []  # the leader's frees not yet broadcast
        if self._beam > 1 and not 1 <= num_hypotheses <= self._beam:
            raise ValueError("num_hypotheses must be in [1, beam_size]")
        self._num_hyp = int(num_hypotheses)
        self._length_penalty = float(length_penalty)
        self._max_candidates = max(1, round(self._beam * patience))
        self._allow_early_exit = length_penalty == 0
        self.model = model
        self._device = model.device
        self._vocab = model.target_vocabulary
        self._num_slots = num_slots
        self._capacity = capacity
        self._prefill_bucket = prefill_bucket
        # Steps a dispatch: the host frees and admits slots between blocks.
        self._block = max(1, steps_per_sync)
        # Speculation: each dispatch verifies spec_k tokens a slot.
        self._spec_k = max(0, int(speculation_k))
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

        S, K, V, dev = self._ns, self._beam, len(v), self._device  # this rank's slots
        # Penalty tables: [S, V] generated-token presence (repetition
        # penalty) and [S, capacity + 1] generated-token history
        # (no-repeat-ngram; entry t the t-th generated token, the last
        # column where a slot past its capacity writes). Zero rows mean
        # "penalties off": allocated at construction, or on the first
        # request that asks for a penalty. Beam rows penalize over their
        # own alive history instead.
        pen_rows = S if (K == 1 and (self._rep_penalty != 1.0 or self._ngram)) else 0
        self._seen = torch.zeros((pen_rows, V), dtype=torch.bool, device=dev)
        self._hist = torch.zeros((pen_rows, capacity + 1), dtype=torch.long, device=dev)

        # The KV cache's type is fixed here (``CT2TPU_KV_CACHE`` is read once):
        # every admit's prefill cache takes it too.
        self._kv_dtype = model.kv_dtype
        self._cache = T.init_self_cache(model.arch, S * K, capacity, dtype=self._kv_dtype,
                                        device=dev, ring=True)
        self._rows = torch.arange(S, device=dev)
        # Device slot state, read and written by the queued work only.
        self._dstate = {"tokens": torch.zeros(S, dtype=torch.long, device=dev),
                        "pos": torch.zeros(S, dtype=torch.int32, device=dev),
                        "gen": torch.zeros(S, dtype=torch.int32, device=dev)}
        # The host's bound of each slot's device position after every block
        # queued so far: the length-adaptive attention's trip count.
        S = num_slots  # the host tables cover every slot
        self._dpos = np.zeros(S, np.int64)

        if pipeline_depth is None:
            pipeline_depth = int(os.environ.get("CT2TPU_PIPELINE_DEPTH",
                                                str(DEFAULT_PIPELINE_DEPTH)))
        self._depth = max(1, min(int(pipeline_depth), 4))
        if self._spec_k > 1 or self._dist is not None:
            # Host-driven speculation reads the last dispatch's tokens; the
            # ranks of a multi-process job replay one block at a time.
            self._depth = 1
        self._ttfts = deque(maxlen=10000)

        # Host slot state.
        self._slots: List[Optional[_Request]] = [None] * S
        self._pos = np.zeros(S, np.int32)
        self._tokens = np.zeros(S, np.int64)  # each slot's last token (speculation)
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
        # Forced target prefixes (the encoder-decoder batchers widen the
        # table), their lengths and the timestamp-rules switch, a slot each.
        self._prefix = np.zeros((S, 1), np.int64)
        self._plen = np.zeros(S, np.int32)
        self._ts_on = np.zeros(S, bool)
        self._dopts = None  # the device copy of the per-slot options
        self._step_count = 0
        self._blocks = 0
        self._tokens_out = 0
        self._requests_done = 0
        self._slot_steps = 0
        self._accepted_tokens = 0  # speculation: tokens emitted
        self._spec_dispatches = 0  # speculation: slot verify dispatches
        self._started_at = time.monotonic()
        if K > 1:
            self._init_beam()
        else:
            self._step_fn = (self._build_spec_step() if self._spec_k > 1
                             else self._build_step())

        # Draft-model speculation: a small model proposes spec_k - 1 tokens
        # a slot on the card, the target verifies them in one T = spec_k
        # forward. The draft's cache needs no rollback: its valid prefix
        # always equals the target's accepted one, since a draft token is
        # fed (and cached) at position p + 1 only after the target accepted
        # the token at p, and a round starts at the accepted position and
        # overwrites the rest.
        self._draft_model = None
        if draft_model is not None:
            dm = draft_model
            if isinstance(dm, str):
                from ..models.loader import load_model

                dm = load_model(dm, compute_type="default", device=self._device)
            # A task object (Generator, Translator, Whisper) or a loaded model.
            self._init_draft(getattr(dm, "model", dm))

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._admitting: List[_Request] = []  # an admit round's requests not yet in a slot
        self._failed_everywhere = False  # an admit failure every rank raised itself
        self._error: Optional[BaseException] = None  # what ended the scheduler
        self._closed = False
        self._wake = threading.Event()

    def _init_draft(self, dm):
        """A decoder-only draft model: its own slot cache, prefilled with the
        prompt at every admit."""
        if not dm.is_decoder_only:
            raise ValueError("draft_model must be a decoder-only model")
        if T.ring_capacity(dm.arch):
            raise NotImplementedError("sliding-window draft models are not supported")
        if len(dm.target_vocabulary) != len(self._vocab):
            raise ValueError(
                "draft model vocabulary size "
                f"({len(dm.target_vocabulary)}) must match the target "
                f"model ({len(self._vocab)})")
        self._alloc_draft_state(dm)

    def _alloc_draft_state(self, dm):
        """The draft's slot cache (its KV type fixed here, as the target's)
        and its per-slot cross-attention memory for an encoder-decoder
        draft; the draft function."""
        dm.ensure_consts(self._capacity)
        self._draft_model = dm
        self._draft_kv_dtype = dm.kv_dtype
        self._draft_cache = T.init_self_cache(dm.arch, self._ns, self._capacity,
                                              dtype=self._draft_kv_dtype,
                                              device=self._device, ring=True)
        self._draft_mem = None
        if self._seq2seq:
            self._draft_mem = []
            for layer in dm.arch.decoder.layers:
                a = layer.cross_attention
                shape = (None if a is None else
                         (self._ns, a.num_heads_kv, self._max_src, a.head_dim))
                self._draft_mem.append(None if a is None else {
                    n: torch.zeros(shape, dtype=dm.out_dtype, device=self._device)
                    for n in ("k", "v")})
        self._draft_fn = self._build_draft_fn()

    def _init_beam(self):
        """The beam state: this rank's slots x K rows, the hypothesis store
        (K hypotheses a slot, the per-request num_hypotheses ceiling) and the
        per-slot beam options."""
        S, K, L, dev = self._ns, self._beam, self._capacity, self._device

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        i64, f32 = torch.long, torch.float32
        self._bstate = {
            "tokens": full((S, K), 0, i64),
            "pos": full((S,), 0, i64),
            "gen": full((S,), 0, i64),
            "scores": full((S, K), NEG, f32),
            "alive": full((S, K, L), 0, i64),
            # Per-position cumulative scores along each alive beam and
            # stored hypothesis: stop-sequence trimming refunds the matched
            # suffix and streaming reports per-token scores.
            "alive_sc": full((S, K, L), 0.0, f32),
            "store_seqs": full((S, K, L), 0, i64),
            "store_sc": full((S, K, L), 0.0, f32),
            "store_lens": full((S, K), 0, i64),
            "store_scores": full((S, K), -float("inf"), f32),
            "store_count": full((S,), 0, i64),
            "top_fin": full((S,), False, torch.bool),
            "active": full((S,), False, torch.bool),
        }
        S = self._num_slots  # the host tables cover every slot
        self._b_active_host = np.zeros(S, bool)
        self._max_lens = np.ones(S, np.int32)
        self._nhyps = np.full(S, self._num_hyp, np.int32)
        # Stop-sequence tables [S, NS, LS] and lengths [S, NS]: zero size (no
        # matching) until a request brings stop sequences.
        self._bstop_tab = np.full((S, 0, 0), -1, np.int64)
        self._bstop_len = np.zeros((S, 0), np.int64)
        # Per-beam-row penalties (over the alive table) once any request or
        # the batcher's defaults ask for them.
        self._bpen = self._rep_penalty != 1.0 or self._ngram > 0
        self._beam_step_fn = self._build_beam_step()
        self._beam_reset_fn = self._build_beam_reset()

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
        future. Under beam search it streams the committed tokens, those
        every surviving hypothesis shares."""
        if self._closed:
            raise RuntimeError("The batcher is closed")
        if not prompt:
            raise ValueError("The prompt must contain at least one token")
        ids = [self._vocab.to_id(t) if isinstance(t, str) else int(t) for t in prompt]
        margin = max(self._block, self._spec_k)
        if len(ids) + max_length + margin > self._capacity:
            raise ValueError(
                f"prompt ({len(ids)}) + max_length ({max_length}) + "
                f"dispatch margin ({margin}) exceeds the slot "
                f"capacity ({self._capacity})")
        self._validate_request_sampling(sampling_topk, sampling_topp)
        self._validate_beam_request(num_hypotheses)
        rep, ngram, sup_ids = self._validate_request_penalties(
            repetition_penalty, no_repeat_ngram_size, suppress_tokens)
        req = _Request(prompt_ids=ids, max_length=max_length,
                       min_length=min_length,
                       temperature=sampling_temperature or 0.0,
                       topk=sampling_topk, topp=sampling_topp, seed=seed,
                       end_ids=self._resolve_request_end_ids(end_token),
                       rep_penalty=rep, ngram=ngram, suppress_ids=sup_ids,
                       num_hypotheses=num_hypotheses, callback=callback,
                       stop_sequences=self._stop_ids(stop_sequences))
        return self._enqueue(req)

    def _enqueue(self, req: _Request) -> Future:
        if not self._leader:
            raise RuntimeError("only rank 0 of a multi-process job takes requests")
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
        and time-to-first-token percentiles (under beam search the first
        delivery: a streamed commit, else the finish); the slots this rank
        holds on the card and their slot-cache bytes."""
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
            "spec_tokens_per_dispatch": (
                self._accepted_tokens / max(self._spec_dispatches, 1)
                if self._spec_k > 1 else None),
            "spec_draft": (None if self._spec_k <= 1 else
                           "model" if self._draft_model is not None
                           else "prompt-lookup"),
            "num_queued": self._queue.qsize(),
            "local_slots": self._ns,
            "slot_cache_bytes": self._slot_cache_bytes(),
        }

    def _slot_cache_bytes(self) -> int:
        """Bytes of this rank's slot cache on the card: the KV cache rows and
        the encoder-decoder batchers' per-slot cross memory."""
        bufs = [t for layer in self._cache for t in layer.values()]
        bufs += [t for m in getattr(self, "_mem", None) or () if m for t in m.values()]
        return sum(t.numel() * t.element_size() for t in bufs)

    def close(self):
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=30)

    def join(self, timeout: Optional[float] = None) -> None:
        """Blocks until the scheduler thread exits. A follower of a
        multi-process job, which holds no futures, raises here the error
        that ended its replay (the leader's, or its own)."""
        self._thread.join(timeout)
        if not self._leader and self._error is not None:
            raise self._error

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

    def _validate_request_sampling(self, topk, topp=None) -> None:
        if topk is not None and topk != 0 and not 1 <= topk <= self._max_topk:
            raise ValueError(
                f"per-request sampling_topk must be 0 (full vocabulary) or "
                f"in [1, {self._max_topk}] (raise max_sampling_topk at "
                "construction for larger values)")
        if self._spec_k > 1 and ((topk is not None and topk != 1)
                                 or (topp is not None and topp < 1.0)):
            raise NotImplementedError(
                "speculation requires greedy decoding; per-request "
                "sampling overrides must keep topk=1/topp=1")

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

    def _validate_beam_request(self, num_hypotheses) -> None:
        """Under beam search any num_hypotheses in [1, beam_size]; greedy
        and sampled decoding return one hypothesis."""
        if num_hypotheses is None:
            return
        if self._beam > 1:
            if not 1 <= num_hypotheses <= self._beam:
                raise ValueError(f"num_hypotheses must be in [1, beam_size] "
                                 f"(= [1, {self._beam}])")
        elif num_hypotheses != 1:
            raise NotImplementedError(
                "num_hypotheses > 1 requires beam serving (construct with "
                "beam_size > 1) or the batch APIs")

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
        self._set_slot_common(slot, req)
        rp, ng = self._rep_pens[slot], self._ngrams[slot]
        if rp != 1.0 or ng:
            self._ensure_pen_tables()

    def _set_slot_common(self, slot: int, req: _Request) -> None:
        """The options greedy and beam slots share: sampling (and the
        slot's noise generator), end tokens, min_length, penalties and
        suppressed tokens."""
        self._temps[slot] = req.temperature or self._temperature or 1.0
        self._topks[slot] = req.topk if req.topk is not None else max(self._topk, 0)
        self._topps[slot] = req.topp if req.topp is not None else min(self._topp, 1.0)
        self._end_table[slot, :] = -1
        for e, eid in enumerate(self._req_end_ids(req)):
            self._end_table[slot, e] = eid
        self._min_lens[slot] = req.min_length
        self._rep_pens[slot] = (req.rep_penalty if req.rep_penalty is not None
                                else self._rep_penalty)
        self._ngrams[slot] = req.ngram if req.ngram is not None else self._ngram
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

    def _set_beam_slot_options(self, slot: int, req: _Request) -> None:
        """A beam slot's options: those greedy slots take, the request's
        max_length, hypothesis count and stop sequences (the stop tables
        grow on demand)."""
        self._set_slot_common(slot, req)
        self._max_lens[slot] = req.max_length
        self._nhyps[slot] = req.num_hypotheses or self._num_hyp
        if self._rep_pens[slot] != 1.0 or self._ngrams[slot]:
            self._bpen = True
        stops = req.stop_sequences
        ns, ls = len(stops), max((len(s) for s in stops), default=0)
        NS, LS = self._bstop_tab.shape[1], self._bstop_tab.shape[2]
        if ns > NS or ls > LS:
            NSn, LSn = max(ns, NS, 1), max(_round_up(ls, 2), LS, 2)
            grown = np.full((self._num_slots, NSn, LSn), -1, np.int64)
            lens = np.zeros((self._num_slots, NSn), np.int64)
            grown[:, :NS, :LS] = self._bstop_tab
            lens[:, :NS] = self._bstop_len
            self._bstop_tab, self._bstop_len = grown, lens
        self._bstop_tab[slot] = -1
        self._bstop_len[slot] = 0
        for j, seq in enumerate(stops):
            self._bstop_tab[slot, j, :len(seq)] = seq
            self._bstop_len[slot, j] = len(seq)

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
        self._seen = self._upload(self._mine(seen))
        self._hist = self._upload(self._mine(hist))

    def _owns(self, slot: int) -> bool:
        """Whether this rank holds ``slot``'s state on the card."""
        return self._lo <= slot < self._lo + self._ns

    def _row(self, slot: int) -> int:
        """``slot``'s row in this rank's device state."""
        return slot - self._lo

    def _mine(self, array):
        """The rows of this rank's slots of a host table over every slot."""
        return array[self._lo:self._lo + self._ns]

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
            def up(a):
                return self._upload(self._mine(a))
            o = {"temps": up(self._temps),
                 "topks": up(self._topks.astype(np.int64)),
                 "topps": up(self._topps),
                 "min_len": up(self._min_lens.astype(np.int64)),
                 "rep_pens": up(self._rep_pens),
                 "ngrams": up(self._ngrams.astype(np.int64)),
                 "end_table": up(self._end_table.astype(np.int64)),
                 "sup_table": up(self._sup_table.astype(np.int64))}
            if self._beam > 1 or self._seq2seq:
                o["prefix"] = up(self._prefix)
                o["plen"] = up(self._plen.astype(np.int64))
            if self._wts is not None:
                o["ts_on"] = up(self._ts_on)
            if self._beam > 1:
                o["max_len"] = up(self._max_lens.astype(np.int64))
                o["nhyps"] = up(self._nhyps.astype(np.int64))
                o["stop_tab"] = up(self._bstop_tab)
                o["stop_len"] = up(self._bstop_len)
            self._dopts = o
        return self._dopts

    def _memory(self, opts):
        """(per-layer memory K/V, memory bias) of the slots; None for a
        decoder-only model."""
        return None, None

    # ------------------------------------------------------------------
    # Token selection.
    # ------------------------------------------------------------------

    def _disable(self, l, disable_end, opts):
        """``l`` [S, V] with the batcher's and the slots' suppressed tokens
        disabled and, where ``disable_end``, the slots' end tokens."""
        l = proc.disable_tokens(l, self._suppress_ids)
        l = proc.disable_tokens_per_row(l, opts["sup_table"])
        ends = torch.where(disable_end[:, None], opts["end_table"], -1)
        return proc.disable_tokens_per_row(l, ends)

    def _timestamp_rules(self, l, hist, gen, plen):
        """Whisper's timestamp rules on rows whose history ``hist`` [N, L]
        holds the forced prompt (``plen`` [N] tokens) and then the sampled
        tokens, at step ``gen`` [N]. The rules see only the steps past the
        prompt, as ``Whisper.generate`` (which prefills the prompt) and the
        reference (src/models/whisper.cc:742-865: the first sampled step
        takes only timestamps) do."""
        L = hist.shape[1]
        past = (torch.arange(L, device=hist.device)[None, :] + plen[:, None]).clamp(max=L - 1)
        return proc.whisper_timestamp_rules(l, hist.gather(1, past), gen - plen, 0, *self._wts)

    def _select(self, l, disable_end, opts, gens):
        """Tokens of float32 logits ``l`` [S, V] with the slots' suppressed
        tokens and, where ``disable_end``, their end tokens disabled."""
        return self._pick(self._disable(l, disable_end, opts), gens, opts)

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

    def _sampling_gens(self, active):
        """This rank's slots' noise generators (None where a slot keeps to
        the argmax), or None when no slot of ``active`` samples."""
        if not any(self._topks[i] != 1 for i in active):
            return None
        return self._mine([g if self._topks[s] != 1 else None
                           for s, g in enumerate(self._gens)])

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
                # A stop applies to generated tokens only: the matched
                # suffix lies wholly past the forced prefix.
                if (len(req.generated) >= req.forced_len + n
                        and tuple(req.generated[-n:]) == seq):
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
            elif int(self._pos[i]) + max(self._block, self._spec_k) > self._capacity:
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

    def _get_cache_prefill(self, padded_len: int, draft: bool = False):
        """The prefill of one prompt padded to ``padded_len`` into a cache of
        that size (``fresh_prefill``, masked at the prompt's length), by the
        target or with ``draft`` the draft model: a function (ids [1,
        padded_len], length) -> (hidden states, the 1-row cache). A beam
        admit and the draft keep only the cache."""
        model = self._draft_model if draft else self.model
        kv_dtype = self._draft_kv_dtype if draft else self._kv_dtype

        def prefill(ids, length: int):
            cache = T.init_self_cache(model.arch, 1, padded_len, dtype=kv_dtype,
                                      device=self._device, ring=True)
            return T.decoder_forward(
                model.arch, model.params, model.consts, ids.to(self._device), 0, cache,
                lengths=torch.tensor([length], dtype=torch.long).to(self._device),
                quantize_acts=model.policy.quantize_activations,
                out_dtype=model.out_dtype, return_logits=False, fresh_prefill=True)

        return prefill

    def _padded(self, ids: List[int], size: int):
        """``ids`` as a [1, size] id tensor, zero-padded, on the host."""
        out = torch.zeros((1, size), dtype=torch.long)
        out[0, :len(ids)] = torch.tensor(ids, dtype=torch.long)
        return out

    def _prefill_logits(self, ids: List[int]):
        """The prompt's prefill (padded to ``prefill_bucket``): (the last
        prompt position's float32 logits [1, V], the 1-row cache)."""
        model = self.model
        L = len(ids)
        P = _round_up(L, self._prefill_bucket)
        h, cache = self._get_cache_prefill(P)(self._padded(ids, P), L)
        qa = model.policy.quantize_activations
        return T.project_logits(model.arch, model.params, h[:, L - 1], qa).float(), cache

    def _prefill_chunked(self, ids: List[int], rb: int, logits: bool = True):
        """A window model's prompt longer than one ring block: the
        reference's chunked prefill (chunks split at multiples of the ring
        block) through a 1-row ring cache of the slot's shape: (the last
        prompt position's float32 logits [1, V], or None without
        ``logits``, and the cache)."""
        model = self.model
        qa = model.policy.quantize_activations
        cache = T.init_self_cache(model.arch, 1, self._capacity, dtype=self._kv_dtype,
                                  device=self._device, ring=True)
        h = last = None
        for off, size in T.split_prefill_chunks(0, len(ids), rb):
            chunk = self._padded(ids[off:off + size], _round_up(size, self._prefill_bucket))
            # No lengths mask: it would mask the earlier chunks' keys. The
            # padded tail writes positions past the prompt, which decode
            # overwrites before they become visible.
            h, cache = T.decoder_forward(
                model.arch, model.params, model.consts, chunk.to(self._device), off, cache,
                quantize_acts=qa, out_dtype=model.out_dtype, return_logits=False,
                fresh_prefill=(off == 0))
            last = size
        if not logits:
            return None, cache
        return T.project_logits(model.arch, model.params, h[:, last - 1], qa).float(), cache

    def _beam_cache_chunked(self, ids: List[int]):
        """``_prefill_chunked``'s cache alone (a beam admit)."""
        return self._prefill_chunked(ids, T.ring_block(self.model.arch), logits=False)[1]

    def _prefill_into_slot(self, slot: int, req: _Request):
        if self._beam > 1:
            return self._prefill_into_slot_beam(slot, req)
        ids = req.prompt_ids
        self._set_slot_sampling(slot, req)

        def prefill():
            rb = T.ring_block(self.model.arch)
            if rb and len(ids) > rb:
                logits, sub = self._prefill_chunked(ids, rb)
            else:
                logits, sub = self._prefill_logits(ids)
            tok, score = self._select_one(slot, logits, req.min_length > 0)
            T.cache_insert_row(self._cache, sub, self._row(slot))
            del sub
            if self._draft_model is not None:
                self._draft_prefill(slot, ids)
            return int(tok[0]), float(score[0])  # the admit's one wait for the card

        first, score = self._on_owner(slot, prefill)
        if self._owns(slot):
            r = self._row(slot)
            if self._seen.shape[0]:
                self._seen[r] = False
                self._seen[r, first] = True
                self._hist[r] = 0
                self._hist[r, 0] = first
            # The slot's device state: queued after the blocks in flight, so
            # the next block dispatched sees the admitted row.
            self._dstate["tokens"][r] = first
            self._dstate["pos"][r] = len(ids)
            self._dstate["gen"][r] = 1
        self._emit(req, first, score)
        self._slots[slot] = req
        self._pos[slot] = len(ids)
        self._tokens[slot] = first
        self._dpos[slot] = len(ids)

    def _prefill_into_slot_beam(self, slot: int, req: _Request):
        """Decoder-only beam admit: the prompt but its last token into all K
        rows of the slot, then every beam starts from the last prompt token
        at its position. The first step recomputes that token's keys and
        values, and the beam expansion falls out of the candidate step
        (only beam 0 carries score 0)."""
        ids = req.prompt_ids
        K = self._beam
        pos0 = len(ids) - 1

        def prefill():
            if pos0 <= 0:
                return
            rb = T.ring_block(self.model.arch)
            if rb and pos0 > rb:
                sub = self._beam_cache_chunked(ids[:-1])
            else:
                P = _round_up(pos0, self._prefill_bucket)
                _, sub = self._get_cache_prefill(P)(self._padded(ids[:-1], P), pos0)
            for k in range(K):
                T.cache_insert_row(self._cache, sub, self._row(slot) * K + k)

        self._on_owner(slot, prefill)
        self._set_beam_slot_options(slot, req)
        self._beam_reset_fn(slot, ids[-1], pos0)
        self._slots[slot] = req
        self._pos[slot] = pos0

    def _on_owner(self, slot: int, fn):
        """``fn()``, the device work of an admit into ``slot``. In the sharded
        layout only the slot's data group runs it, with no ring prefill (the
        other groups do not join one), and its result reaches every rank
        over the data axis; a failure there raises on every rank."""
        if self._shard is None:
            return fn()
        from ..parallel.context import batch_on_data_axis

        out = error = None
        if self._owns(slot):
            try:
                with batch_on_data_axis():
                    out = fn()
            except Exception as e:  # noqa: BLE001 - raised on every rank below
                error = e
        parts = self._shard.all_gather_objects(
            (out, None if error is None else f"{type(error).__name__}: {error}"))
        # Every rank raises here, so the leader sends no error record.
        self._failed_everywhere = any(text is not None for _, text in parts)
        if error is not None:
            raise error
        for d, (_, text) in enumerate(parts):
            if text is not None:
                raise RuntimeError(f"data rank {d} failed: {text}")
        return parts[slot // self._ns][0]

    def _share_rows(self, tensors, widths):
        """The [S, w] results of every slot: each data group's ``tensors``
        ([ns, w] each; None where the group decoded nothing) packed into one
        float64 buffer, exact for ids and float32 scores, and gathered over
        the data axis in slot order."""
        if tensors is None:
            buf = torch.zeros((self._ns, sum(widths)), dtype=torch.float64,
                              device=self._device)
        else:
            buf = torch.cat([t.reshape(self._ns, -1).double() for t in tensors], dim=1)
        return torch.split(self._shard.all_gather(buf, dim=0), list(widths), dim=1)

    def _build_beam_reset(self):
        """A function (slot, start token, start position) that writes one
        slot's rows of the beam state in place (queued after the blocks in
        flight): K beams on the start token, beam 0 at score 0 and the rest
        dead, an empty history and store."""
        def reset(slot: int, start_tok: int, pos0: int) -> None:
            self._b_active_host[slot] = True
            self._dpos[slot] = pos0
            if not self._owns(slot):
                return
            st, r = self._bstate, self._row(slot)
            st["tokens"][r] = start_tok
            st["pos"][r] = pos0
            st["gen"][r] = 0
            st["scores"][r] = NEG
            st["scores"][r, 0] = 0.0
            for name in ("alive", "alive_sc", "store_seqs", "store_sc", "store_lens",
                         "store_count"):
                st[name][r] = 0
            st["store_scores"][r] = -float("inf")
            st["top_fin"][r] = False
            st["active"][r] = True

        return reset

    # ------------------------------------------------------------------
    # Decode blocks.
    # ------------------------------------------------------------------

    def _block_bounds(self, clamp: int):
        """The host's position bound of this block's first step (the slots'
        bounds clamped at ``clamp``), advanced past the block."""
        starts = np.minimum(self._dpos, clamp)
        self._dpos = starts + self._block
        return int(self._mine(starts).max())

    def _build_step(self):
        """The greedy and sampled step: a function (tokens, positions,
        generated counts, options, memory, memory bias, noise generators,
        position bound) -> (ids, scores) [S] that decodes one token a slot,
        writing the slot cache and the penalty tables in place."""
        model = self.model
        arch, qa = model.arch, model.policy.quantize_activations
        cap = self._capacity

        def step(tokens, pos, gen, opts, mem, mem_bias, gens, pos_bound):
            logits, self._cache = T.decoder_forward(
                arch, model.params, model.consts, tokens[:, None], pos, self._cache,
                mem, mem_bias, quantize_acts=qa, out_dtype=model.out_dtype,
                pos_bound=pos_bound)
            l = logits[:, -1].float()
            seen, hist = self._seen, self._hist
            pen = seen.shape[0] > 0
            if pen:
                l = proc.repetition_penalty_per_row(l, seen, opts["rep_pens"])
                l = proc.no_repeat_ngram_per_row(l, hist[:, :cap], gen, opts["ngrams"],
                                                 self._max_ngram)
            disable_end = gen < opts["min_len"]
            if self._wts is not None and pen:
                # Whisper's timestamp rules per slot over its generated
                # history (the penalty table), applied to what the sampler
                # would see and switched per slot by its prompt.
                lp = self._disable(l, disable_end, opts)
                lp = self._timestamp_rules(lp, hist[:, :cap], gen, opts["plen"])
                l = torch.where(opts["ts_on"][:, None], lp, l)
            ids, scores = self._select(l, disable_end, opts, gens)
            if self._seq2seq:
                # The hard target prefix: its token is what gets fed, so the
                # cache holds the forced prefix.
                use = gen < opts["plen"]
                prefix = opts["prefix"]
                forced = prefix.gather(
                    1, torch.clamp(gen, max=prefix.shape[1] - 1).long()[:, None])[:, 0]
                ids = torch.where(use, forced, ids)
                scores = torch.where(use, torch.zeros_like(scores), scores)
            if pen:
                seen[self._rows, ids] = True
                hist[self._rows, torch.clamp(gen, max=cap).long()] = ids
            return ids, scores

        return step

    def _dispatch_block(self, active: List[int]):
        """Queues one block of ``steps_per_sync`` decode steps from the
        device slot state, without waiting for the card. Returns the
        handle ``_consume_block`` reads the block's tokens from (possibly
        after the NEXT block has been queued)."""
        cap, block = self._capacity, self._block
        binding = {i: self._slots[i] for i in active}
        mine = [i for i in active if self._owns(i)]
        top = self._block_bounds(cap - block)
        out = None
        if mine:
            opts = self._device_options()
            mem, mem_bias = self._memory(opts)
            gens = self._sampling_gens(mine)
            tokens, gen = self._dstate["tokens"], self._dstate["gen"]
            # Overshoot clamp: a slot that finished while a block was in
            # flight keeps advancing until re-admitted; its writes stay
            # inside its row (the admit resets it).
            pos = torch.clamp(self._dstate["pos"], max=cap - block)
            ids_k, scores_k = [], []
            for i in range(block):
                ids, scores = self._step_fn(tokens, pos, gen, opts, mem, mem_bias, gens,
                                            top + i)
                ids_k.append(ids)
                scores_k.append(scores)
                tokens, pos, gen = ids, pos + 1, gen + 1
            self._dstate = {"tokens": tokens, "pos": pos, "gen": gen}
            out = torch.stack(ids_k), torch.stack(scores_k)  # [block, ns] each
        self._step_count += block
        self._blocks += 1
        self._slot_steps += len(active) * block
        if self._shard is not None:
            ids, scores = self._share_rows(None if out is None else [t.T for t in out],
                                           (block, block))
            out = ids.T.long(), scores.T.float()
        return self._to_host(*out) + (binding,)

    def _to_host(self, *tensors):
        """Copies of ``tensors`` that the host can read once the returned
        event (None on the CPU) has completed, followed by that event."""
        if self._device.type != "cuda":
            return tensors + (None,)
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        done = torch.cuda.Event()
        done.record()
        return tuple(out) + (done,)

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
    # Speculation: one verify of spec_k tokens a slot a dispatch, drafted
    # by prompt lookup on the host or by the draft model on the card.
    # ------------------------------------------------------------------

    def _build_spec_step(self):
        """The verify step: a function (fed [S, K], positions, generated
        counts, options, memory, memory bias) -> (ids, scores) [S, K] that
        runs one decoder forward of T = K from each slot's position; the
        ids at j are the greedy targets of generated index gen + j, given
        the fed tokens before it. The penalties see, at each j, the fed
        drafts before j as generated (what the sequential step would have
        seen); the penalty tables take the accepted tokens in place."""
        model = self.model
        arch, qa = model.arch, model.policy.quantize_activations
        K, cap = self._spec_k, self._capacity

        def step(fed, pos, gen, opts, mem, mem_bias):
            logits, self._cache = T.decoder_forward(
                arch, model.params, model.consts, fed, pos, self._cache, mem, mem_bias,
                quantize_acts=qa, out_dtype=model.out_dtype)
            l = logits.float()  # [S, K, V]
            S, V = l.shape[0], l.shape[-1]
            dev = l.device
            seen, hist = self._seen, self._hist
            pen = seen.shape[0] > 0
            gl = gen[:, None] + torch.arange(K, device=dev)[None, :]  # [S, K]
            if pen:
                # The intra-chunk presence: position j has seen the drafts
                # fed at 1..j (column V takes the drafts not yet fed).
                jj = torch.arange(K, device=dev)
                later = jj[None, :, None] <= torch.arange(K - 1, device=dev)[None, None, :]
                cols = torch.where(later, V, fed[:, None, 1:])  # [S, K, K-1]
                intra = torch.zeros((S, K, V + 1), dtype=torch.bool, device=dev)
                intra.scatter_(2, cols, True)
                p = opts["rep_pens"][:, None, None]
                penalized = torch.where(l > 0, l / p, l * p)
                l = torch.where(seen[:, None, :] | intra[:, :, :V], penalized, l)
                # The n-gram ban at j over the history with the fed drafts
                # written at generated indices gen .. gen + j - 1.
                hist_fed = hist.clone()
                hist_fed.scatter_(1, torch.clamp(gl[:, :K - 1], max=cap), fed[:, 1:])
                l = torch.stack([proc.no_repeat_ngram_per_row(
                    l[:, j], hist_fed[:, :cap], gen + j, opts["ngrams"], self._max_ngram)
                    for j in range(K)], dim=1)
            l = proc.disable_tokens(l, self._suppress_ids)
            if opts["sup_table"].shape[1]:
                l = torch.where(proc.token_table_mask(opts["sup_table"], V)[:, None, :],
                                proc.DISABLE, l)
            ends = proc.token_table_mask(opts["end_table"], V)
            l = torch.where((gl < opts["min_len"][:, None])[..., None] & ends[:, None, :],
                            proc.DISABLE, l)
            ids, scores = greedy_tokens(torch.log_softmax(l, dim=-1))  # [S, K]
            if self._seq2seq:
                # Hard target prefixes: forced a position each, scored 0.
                prefix = opts["prefix"]
                use = gl < opts["plen"][:, None]
                ids = torch.where(use, prefix.gather(
                    1, torch.clamp(gl, max=prefix.shape[1] - 1)), ids)
                scores = torch.where(use, 0.0, scores)
            if pen:
                # The tokens a continuing slot accepts: up to the first draft
                # that missed its target (a slot that ends inside the chunk
                # is reset at its next admit).
                counts = 1 + torch.cumprod((fed[:, 1:] == ids[:, :-1]).long(), dim=1).sum(1)
                _seen_accept(seen, ids, counts)
                _hist_accept(hist, ids, counts, gen, cap)
            return ids, scores

        return step

    def _draft_memory(self, opts):
        """The draft's (memory K/V, memory bias); None for a decoder-only
        draft."""
        if self._draft_mem is None:
            return None, None
        return self._draft_mem, attn_ops.length_mask_bias(opts["src_len"], self._max_src)

    def _build_draft_fn(self):
        """The draft: a function (last tokens [S], positions, generated
        counts, options, position bound) -> [S, K-1] proposals on the card.
        It runs K feeds of T = 1 (not K - 1), so the last proposal's K/V is
        cached too: when the target accepts every draft and its bonus token,
        the next round starts at pos + K and attends pos + K - 1, which
        only that feed writes. A forced target prefix is applied inside the
        loop, so the draft's cache holds the accepted stream."""
        dm = self._draft_model
        arch, qa = dm.arch, dm.policy.quantize_activations
        K = self._spec_k

        def draft(last, pos, gen, opts, pos_bound):
            mem, mem_bias = self._draft_memory(opts)
            tok, outs = last, []
            for j in range(K):
                logits, self._draft_cache = T.decoder_forward(
                    arch, dm.params, dm.consts, tok[:, None], pos + j, self._draft_cache,
                    mem, mem_bias, quantize_acts=qa, out_dtype=dm.out_dtype,
                    pos_bound=pos_bound + j)
                # The verifier's global suppressions, so that a suppressed
                # token never takes a draft position.
                l = proc.disable_tokens(logits[:, -1].float(), self._suppress_ids)
                tok = torch.argmax(l, dim=-1)
                if self._seq2seq:
                    idx = gen + j
                    prefix = opts["prefix"]
                    forced = prefix.gather(
                        1, torch.clamp(idx, max=prefix.shape[1] - 1)[:, None])[:, 0]
                    tok = torch.where(idx < opts["plen"], forced, tok)
                outs.append(tok)
            return torch.stack(outs[:K - 1], dim=1)

        return draft

    def _draft_prefill(self, slot: int, ids: List[int]):
        """The draft's prefill of an admitted prompt into its slot row (one
        small-model forward an admit)."""
        P = _round_up(len(ids), self._prefill_bucket)
        _, cache = self._get_cache_prefill(P, draft=True)(self._padded(ids, P), len(ids))
        T.cache_insert_row(self._draft_cache, cache, self._row(slot))

    def _draft_context(self, req) -> List[int]:
        """The context prompt lookup searches: the prompt and the tokens
        generated so far."""
        return req.prompt_ids + req.generated

    def _draft(self, req, k: int) -> List[int]:
        """Prompt-lookup draft: the continuation of the latest earlier match
        of the context's last bigram, padded with the last token. The host
        form of ``device_loop.draft_tokens``: the context is the request's
        host lists, and the drafts ride the dispatch's one upload."""
        ctx = self._draft_context(req)
        draft = []
        if len(ctx) >= 3:
            a, b = ctx[-2], ctx[-1]
            for j in range(len(ctx) - 2, 0, -1):
                if ctx[j] == b and ctx[j - 1] == a:
                    draft = ctx[j + 1:j + 1 + k]
                    break
        while len(draft) < k:
            draft.append(ctx[-1])
        return draft[:k]

    def _decode_step_spec(self, active: List[int]):
        """Queues one verify dispatch: the fed tokens (the last accepted
        one and the prompt-lookup drafts), positions and generated counts
        go up in one copy; a draft model's proposals are made and fed on
        the card. Returns the handle ``_accept_spec_round`` reads the ids,
        scores and fed tokens from, in one pinned copy."""
        K, cap = self._spec_k, self._capacity
        binding = {i: self._slots[i] for i in active}
        mine = [i for i in active if self._owns(i)]
        out = None
        if mine:
            host = np.zeros((self._ns, K + 2), np.int64)
            # A finished slot's writes stay inside its row (the admit resets it).
            pos = np.minimum(self._mine(self._pos), cap - K)
            host[:, K] = pos
            for i in mine:
                req, r = self._slots[i], self._row(i)
                host[r, 0] = self._tokens[i]
                host[r, K + 1] = len(req.generated)
                if self._draft_model is None:
                    host[r, 1:K] = self._draft(req, K - 1)
            up = self._upload(host)
            fed, pos_d, gen_d = up[:, :K], up[:, K], up[:, K + 1]
            opts = self._device_options()
            mem, mem_bias = self._memory(opts)
            if self._draft_model is not None:
                drafts = self._draft_fn(fed[:, 0], pos_d, gen_d, opts, int(pos.max()))
                fed = torch.cat([fed[:, :1], drafts], dim=1)
            ids, scores = self._step_fn(fed, pos_d, gen_d, opts, mem, mem_bias)
            out = ids, scores, fed
        self._step_count += 1
        self._blocks += 1
        self._slot_steps += len(active)
        if self._shard is not None:
            ids, scores, fed = self._share_rows(out, (K, K, K))
            out = ids.long(), scores.float(), fed.long()
        return self._to_host(*out) + (binding,)

    def _accept_spec_round(self, handle):
        """Waits for one verify dispatch and emits each slot's accepted
        tokens: its greedy targets up to an end or stop condition or the
        first draft that missed."""
        ids_h, scores_h, fed_h, done, binding = handle
        if done is not None:
            done.synchronize()
        ids, scores, fed = ids_h.numpy(), scores_h.numpy(), fed_h.numpy()
        K = self._spec_k
        for i, req in binding.items():
            if self._slots[i] is not req:
                continue
            emitted = 0
            for j in range(K):
                tok = int(ids[i, j])
                self._emit(req, tok, float(scores[i, j]))
                self._tokens[i] = tok
                emitted = j + 1
                self._accepted_tokens += 1
                if tok in self._req_end_ids(req) and len(req.generated) > req.min_length:
                    break
                if len(req.generated) >= req.max_length or req.stopped:
                    break
                # The next fed draft must equal this target, or the verify
                # of the positions after it read a token never emitted.
                if j + 1 < K and int(fed[i, j + 1]) != tok:
                    break
            self._pos[i] += emitted
            self._spec_dispatches += 1

    # ------------------------------------------------------------------
    # Beam search: K rows a slot, the candidate bookkeeping of the batch
    # engine's beam loop with a step counter a slot, all on the device. The
    # host reads only the [S] active flags a block, and a slot's store when
    # it finishes (or, for streaming, a snapshot).
    # ------------------------------------------------------------------

    def _build_beam_step(self):
        """The beam step: a function (cache, state, options, memory, memory
        bias, noise generators, position bound) -> (cache, state) that runs
        one decode step of every slot's K beams."""
        model = self.model
        S, K, dev = self._ns, self._beam, self._device  # this rank's slots
        K2 = 2 * K

        def rep(x):  # a slot's value on each of its K rows
            return x.repeat_interleave(K, dim=0)

        def step(cache, st, o, mem, mem_bias, gens, pos_bound):
            tokens, pos, gen = st["tokens"], st["pos"], st["gen"]
            scores, alive, alive_sc, active = (st["scores"], st["alive"], st["alive_sc"],
                                               st["active"])
            Lb = alive.shape[2]
            plen, prefix = o["plen"], o["prefix"]
            pos_rows = rep(torch.clamp(pos, max=self._capacity - 1))
            logits, cache = T.decoder_forward(
                model.arch, model.params, model.consts, tokens.reshape(S * K)[:, None],
                pos_rows, cache, mem, mem_bias, beam_size=K,
                quantize_acts=model.policy.quantize_activations, out_dtype=model.out_dtype,
                pos_bound=pos_bound)
            l = logits[:, -1].float()  # [S*K, V]
            V = l.shape[-1]
            l = proc.disable_tokens(l, self._suppress_ids)
            if o["sup_table"].shape[1]:
                l = proc.disable_tokens_per_row(l, rep(o["sup_table"]))
            alive_flat = alive.reshape(S * K, Lb)
            gen_rows = rep(gen)
            if self._bpen:
                # Per-beam-row penalties over each row's own alive history (the
                # batch engine's alive_seq: generated tokens only).
                seen = proc.presence_per_row(alive_flat, gen_rows, V)
                l = proc.repetition_penalty_per_row(l, seen, rep(o["rep_pens"]))
                l = proc.no_repeat_ngram_per_row(l, alive_flat, gen_rows, rep(o["ngrams"]),
                                                 self._max_ngram)
            min_end = rep((gen < o["min_len"])[:, None] & proc.token_table_mask(o["end_table"], V))
            if self._wts is not None:
                # Whisper's timestamp rules on each beam row over its own alive
                # history, over the state the batch loop sees, switched per slot.
                lp = torch.where(min_end, proc.DISABLE, l)
                lp = self._timestamp_rules(lp, alive_flat, gen_rows, rep(plen))
                l = torch.where(rep(o["ts_on"])[:, None], lp, l)
            l = torch.where(min_end, proc.DISABLE, l)

            log_probs = torch.log_softmax(l, dim=-1)
            flat = (log_probs + scores.reshape(S * K)[:, None]).reshape(S, K * V)
            if gens is not None:
                # Gumbel-top-2K draws for the sampled slots; the others keep
                # the deterministic candidates.
                ts, ti = gumbel_top_k_per_row(
                    flat, slot_noise(gens, K * V, dev), K2, topks=o["topks"], topps=o["topps"],
                    temps=o["temps"], max_topk=self._max_topk)
            else:
                ts, ti = small_top_k(flat, K2)  # [S, 2K]
            words, origins = ti % V, ti // V
            cand = torch.arange(K2, device=dev)[None, :]
            end_table = o["end_table"]

            def is_end(tok):  # [S, C] -> [S, C]: any of the slot's end ids
                return (tok[:, :, None] == end_table[:, None, :]).any(dim=-1)

            # The hard prefix (reference update_sample_with_prefix,
            # src/decoding.cc:21-67): the prefix token as candidate 0 at score
            # 0 while gen < plen; an end token among the other candidates is
            # dropped at the first free step.
            forced = (gen < plen)[:, None]
            ptok = prefix.gather(1, torch.clamp(gen, max=prefix.shape[1] - 1)[:, None])
            words = torch.where(forced, ptok, words)
            ts = torch.where(forced, torch.where(cand == 0, 0.0, NEG), ts)
            origins = torch.where(forced, 0, origins)
            eos_k = is_end(words) & (cand > 0) & (gen == plen)[:, None]
            words = torch.where(eos_k, 0, words)
            ts = torch.where(eos_k, NEG, ts)

            is_eos_cand = is_end(words)
            past_prefix = (gen >= plen)[:, None]
            last_step = (gen + 1) >= o["max_len"]
            wcol = torch.clamp(gen, max=Lb - 1)

            stop_tab, n_st = o["stop_tab"], o["stop_len"]
            NS, LS = stop_tab.shape[1], stop_tab.shape[2]
            if NS and LS:
                # Stop sequences: a candidate whose tail [gen-n+1 .. gen] equals
                # one finishes like an end token, the matched suffix trimmed and
                # its scores refunded from the cumulative-score table.
                i_idx = torch.arange(LS, device=dev)
                p_idx = (gen[:, None, None, None] - n_st[:, None, :, None] + 1
                         + i_idx[None, None, None, :])  # [S, 1, NS, LS]
                seqs = alive.gather(1, origins[:, :, None].expand(S, K2, Lb))  # [S, 2K, L]
                pc = torch.clamp(p_idx, 0, Lb - 1).expand(S, K2, NS, LS)
                toks = seqs.gather(2, pc.reshape(S, K2, NS * LS)).reshape(S, K2, NS, LS)
                tok_p = torch.where(p_idx == gen[:, None, None, None],
                                    words[:, :, None, None], toks)
                valid_i = i_idx[None, None, None, :] < n_st[:, None, :, None]
                eq_all = ((tok_p == stop_tab[:, None, :, :]) | ~valid_i).all(dim=-1)
                # A match fits the generated range and lies past the prefix.
                okn = ((n_st > 0) & ((gen[:, None] + 1) >= n_st)
                       & ((gen[:, None] + 1 - n_st) >= plen[:, None]))  # [S, NS]
                stop_n = torch.where(eq_all & okn[:, None, :], n_st[:, None, :], 0).amax(dim=-1)
            else:
                stop_n = torch.zeros((S, K2), dtype=torch.long, device=dev)
            stopped_cand = stop_n > 0
            dead_cand = is_eos_cand | stopped_cand

            # Harvest finished hypotheses among the first K candidates.
            finish_k = active[:, None] & ((is_eos_cand[:, :K] & past_prefix)
                                          | stopped_cand[:, :K] | last_step[:, None])
            top_fin = st["top_fin"] | finish_k[:, 0]
            sseq, s_sc, slen = st["store_seqs"], st["store_sc"], st["store_lens"]
            ssc, scount = st["store_scores"], st["store_count"]
            rows_s = torch.arange(S, device=dev)
            hyp_slots = torch.arange(K, device=dev)[None, :]
            for k in range(K):
                o_k = origins[:, k]
                seq = alive[rows_s, o_k]  # [S, L] (a copy)
                seq_sc = alive_sc[rows_s, o_k]
                seq[rows_s, wcol] = words[:, k]
                seq_sc[rows_s, wcol] = ts[:, k]
                # The end token never lands in the hypothesis, but the length
                # normalization counts it (the reference's defaults). A stop
                # match trims the suffix and refunds its scores.
                sn = stop_n[:, k]
                stp = sn > 0
                hyp_len = torch.where(stp, gen + 1 - sn,
                                      torch.where(is_eos_cand[:, k], gen, gen + 1))
                kept = torch.clamp(gen - sn, 0, Lb - 1)
                cum_kept = seq_sc.gather(1, kept[:, None])[:, 0]
                raw = torch.where(stp, torch.where(gen - sn >= 0, cum_kept, 0.0), ts[:, k])
                norm_len = torch.clamp(torch.where(stp, hyp_len, gen + 1), min=1).float()
                norm_score = raw / torch.pow(norm_len, self._length_penalty)
                worst = torch.argmin(ssc, dim=1)  # [S]
                cur_min = ssc.gather(1, worst[:, None])[:, 0]
                do = finish_k[:, k] & (norm_score > cur_min)
                hit = (hyp_slots == worst[:, None]) & do[:, None]
                ssc = torch.where(hit, norm_score[:, None], ssc)
                slen = torch.where(hit, hyp_len[:, None], slen)
                sseq = torch.where(hit[:, :, None], seq[:, None, :], sseq)
                s_sc = torch.where(hit[:, :, None], seq_sc[:, None, :], s_sc)
                scount = scount + finish_k[:, k].long()

            if self._allow_early_exit:
                finished = top_fin & (scount >= o["nhyps"])
            else:
                finished = scount >= self._max_candidates
            # A stop match on the top candidate ends the request at this step
            # (the emitted stream matched), instead of letting longer
            # continuations outscore the trimmed hypothesis.
            finished = finished | stopped_cand[:, 0]
            new_active = active & ~(finished | last_step)

            # The next K beams: live candidates first, in order.
            order = torch.argsort(dead_cand.int(), dim=1, stable=True)[:, :K]
            new_words = words.gather(1, order)
            new_scores = ts.gather(1, order)
            new_origins = origins.gather(1, order)
            rows = (rows_s[:, None] * K + new_origins).reshape(S * K).to(torch.int32)
            cache = T.cache_gather_rows(cache, rows)
            where = new_origins[:, :, None].expand(S, K, Lb)
            col = wcol[:, None, None].expand(S, K, 1)
            new_alive = alive.gather(1, where).scatter_(2, col, new_words[:, :, None])
            new_alive_sc = alive_sc.gather(1, where).scatter_(2, col, new_scores[:, :, None])
            a1, a3 = active[:, None], active[:, None, None]
            step = active.long()
            return cache, {
                "tokens": torch.where(a1, new_words, tokens), "pos": pos + step,
                "gen": gen + step, "scores": torch.where(a1, new_scores, scores),
                "alive": torch.where(a3, new_alive, alive),
                "alive_sc": torch.where(a3, new_alive_sc, alive_sc),
                "store_seqs": sseq, "store_sc": s_sc, "store_lens": slen,
                "store_scores": ssc, "store_count": scount, "top_fin": top_fin,
                "active": new_active}

        return step

    def _decode_step_beam(self, active: List[int]):
        """Queues one block of beam steps; returns the handle of the block's
        [S] active flags (read back through pinned memory) and the slots'
        requests at dispatch."""
        binding = {i: self._slots[i] for i in active}
        mine = [i for i in active if self._owns(i)]
        cap = self._capacity
        top = self._block_bounds(cap - 1)
        if mine:
            opts = self._device_options()
            mem, mem_bias = self._memory(opts)
            gens = self._sampling_gens(mine)
            cache, st = self._cache, self._bstate
            for i in range(self._block):
                cache, st = self._beam_step_fn(cache, st, opts, mem, mem_bias, gens,
                                               min(top + i, cap - 1))
            self._cache, self._bstate = cache, st
        self._step_count += self._block
        self._blocks += 1
        self._slot_steps += len(active) * self._block
        return self._to_host(self._bstate["active"]) + (binding,)

    def _consume_beam(self, handle):
        """Reads a block's active flags. A slot admitted after the dispatch
        keeps its own flag: the block saw the slot's previous request."""
        flags, done, binding = handle
        if done is not None:
            done.synchronize()
        flags = flags.numpy()
        if self._shard is not None:
            flags, self._snap = self._share_beam(flags, binding)
        for i, req in binding.items():
            if self._slots[i] is req:
                self._b_active_host[i] = bool(flags[i])

    _BEAM_SNAP_KEYS = ("alive", "alive_sc", "gen", "scores", "store_seqs", "store_sc",
                       "store_lens", "store_scores")

    def _beam_snapshot(self):
        return {k: self._bstate[k].cpu().numpy() for k in self._BEAM_SNAP_KEYS}

    def _share_beam(self, flags, binding):
        """The sharded layout's beam block, gathered over the data axis in
        one buffer: every slot's active flag ([S]) and the hypotheses
        (``_BEAM_SNAP_KEYS``, by key and slot) of each slot that the block
        finished or whose request streams, which the harvest reads."""
        need = [i for i, req in binding.items() if self._owns(i) and self._slots[i] is req
                and (not flags[self._row(i)] or req.streams)]
        snaps = {}
        if need:
            rows = torch.tensor([self._row(i) for i in need], device=self._device)
            got = {k: self._bstate[k].index_select(0, rows).cpu().numpy()
                   for k in self._BEAM_SNAP_KEYS}
            snaps = {i: {k: got[k][j] for k in got} for j, i in enumerate(need)}
        parts = self._shard.all_gather_objects((flags, snaps))
        snap = {k: {} for k in self._BEAM_SNAP_KEYS}
        for _, got in parts:
            for i, rec in got.items():
                for k, a in rec.items():
                    snap[k][i] = a
        return np.concatenate([f for f, _ in parts]), snap

    def _harvest_beam(self):
        if self._shard is not None:
            snap = self._snap  # gathered with the last block's flags
        elif any(r is not None and (r.callback is not None or r.stopped)
                 for r in self._slots):
            snap = self._beam_snapshot()
        else:
            snap = None
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if not self._b_active_host[i]:
                self._finish_beam(i, req, snap)
                continue
            if req.callback is not None and not req.stopped:
                self._stream_beam_slot(i, req, snap)
            if req.stopped:
                # A callback's stop (or error): the slot goes inactive and
                # finishes with its best hypothesis so far.
                if self._owns(i):
                    self._bstate["active"][self._row(i)] = False
                self._b_active_host[i] = False
                self._finish_beam(i, req, snap)

    def _stream_beam_slot(self, slot: int, req: _Request, snap) -> None:
        """Streams the COMMITTED tokens: the longest prefix that every alive
        beam shares and every stored hypothesis agrees with. Every later
        finished hypothesis descends from an alive row, so a committed
        token is a prefix of the request's final best hypothesis. The
        stop-sequence window (at least 1 token, so that ``is_last`` comes
        at the finish) is held back against a later stop-suffix trim."""
        gen = int(snap["gen"][slot])
        hold = max(1, req.max_stop_len)
        cap = gen - hold
        if cap <= req.streamed:
            return
        alive = snap["alive"][slot]  # [K, L]
        ne = np.flatnonzero(~(alive[:1, :cap] == alive[:, :cap]).all(axis=0))
        lcp = int(ne[0]) if ne.size else cap
        ssc, slen = snap["store_scores"][slot], snap["store_lens"][slot]
        sseq = snap["store_seqs"][slot]
        for j in np.flatnonzero(np.isfinite(ssc)):
            # A finished hypothesis may win the final ranking: commit only
            # what matches it, short of its end.
            m = max(min(int(slen[j]) - 1, lcp), 0)
            dif = np.flatnonzero(sseq[j, :m] != alive[0, :m])
            lcp = int(dif[0]) if dif.size else m
        if lcp <= req.streamed:
            return
        cum = snap["alive_sc"][slot][0]
        v = self._vocab
        if req.t_first is None:
            req.t_first = time.monotonic()
            self._ttfts.append(req.t_first - req.t_submit)
        for t in range(req.streamed, lcp):
            prev = float(cum[t - 1]) if t > 0 else 0.0
            tok = int(alive[0, t])
            try:
                stop = req.callback(GenerationStepResult(
                    step=t, batch_id=0, token_id=tok, hypothesis_id=0,
                    token=v.to_token(tok), score=float(cum[t]) - prev, is_last=False))
            except BaseException as e:  # noqa: BLE001
                req.callback_error = e
                req.stopped = True
                return
            req.streamed = t + 1
            if stop:
                req.stopped = True
                return

    def _finish_beam(self, slot: int, req: _Request, snap=None):
        v = self._vocab
        if req.t_first is None:
            # Beam TTFT is delivery-based: the first streamed commit, else
            # the finish that materializes the hypotheses.
            req.t_first = time.monotonic()
            self._ttfts.append(req.t_first - req.t_submit)
        if snap is not None:
            def get(k):
                return snap[k][slot]
        else:
            def get(k):
                return self._bstate[k][self._row(slot)].cpu().numpy()
        sseq, slen = get("store_seqs"), get("store_lens")
        ssc, s_sc = get("store_scores"), get("store_sc")
        self._slots[slot] = None
        hyps, scores, hyp_sc = [], [], []
        for j in np.argsort(-ssc, kind="stable"):
            if not np.isfinite(ssc[j]):
                continue
            hyps.append([int(t) for t in sseq[j, :slen[j]]])
            scores.append(float(ssc[j]))
            hyp_sc.append(s_sc[j])
        if not hyps:
            # Stopped early with nothing stored yet: the best alive beam so
            # far, normalized like a finished one.
            alive, bsc = get("alive"), get("scores")
            gen = int(get("gen"))
            b = int(np.argmax(bsc))
            hyps = [[int(t) for t in alive[b, :gen]]]
            scores = [float(bsc[b]) / max(gen, 1) ** self._length_penalty]
            hyp_sc = [get("alive_sc")[b]]
        nh = req.num_hypotheses or self._num_hyp
        hyps, scores = hyps[:nh], scores[:nh]
        self._tokens_out += len(hyps[0])
        self._requests_done += 1
        if req.callback is not None and not req.stopped and req.callback_error is None:
            # The final best hypothesis's tail through the callback (the
            # streaming holds back at least one token, so ``is_last`` is
            # always delivered here).
            cum = hyp_sc[0]
            for t in range(req.streamed, len(hyps[0])):
                prev = float(cum[t - 1]) if t > 0 else 0.0
                try:
                    req.callback(GenerationStepResult(
                        step=t, batch_id=0, token_id=hyps[0][t], hypothesis_id=0,
                        token=v.to_token(hyps[0][t]), score=float(cum[t]) - prev,
                        is_last=(t == len(hyps[0]) - 1)))
                except BaseException as e:  # noqa: BLE001
                    req.callback_error = e
                    break
            req.streamed = len(hyps[0])
        if req.callback_error is not None:
            if not req.future.done():
                req.future.set_exception(req.callback_error)
            return
        result = GenerationResult(
            sequences=[[v.to_token(t) for t in h] for h in hyps],
            sequences_ids=[list(h) for h in hyps], scores=scores)
        if not req.future.done():
            req.future.set_result(result)

    # ------------------------------------------------------------------
    # Multi-process control records.
    # ------------------------------------------------------------------

    # The request fields a follower replays (the rest is the leader's).
    _REPLAY_FIELDS = ("prompt_ids", "max_length", "min_length", "temperature", "topk",
                      "topp", "seed", "end_ids", "rep_penalty", "ngram", "suppress_ids",
                      "stop_sequences", "num_hypotheses", "start_id", "prefix_ids",
                      "forced_len", "feature_ids", "features", "ts_on", "streams")

    def _tracked(self, harvest) -> None:
        """Runs ``harvest``; on the leader of a job, records the slots it
        freed for the next control record."""
        before = [s is not None for s in self._slots]
        harvest()
        if self._dist is not None:
            self._freed += [i for i, (b, s) in enumerate(zip(before, self._slots))
                            if b and s is None]

    def _send(self, admits=(), close: bool = False, error: Optional[str] = None,
              timeout: Optional[float] = None) -> None:
        record = {"free": self._freed, "close": close, "error": error,
                  "admits": [(slot, {f: getattr(req, f) for f in self._REPLAY_FIELDS})
                             for slot, req in admits]}
        self._freed = []
        self._dist.broadcast_bytes(pickle.dumps(record), timeout=timeout)

    def _receive(self) -> dict:
        record = pickle.loads(self._dist.broadcast_bytes(None))
        if record["error"] is not None:
            raise RuntimeError(f"the leader's scheduler failed: {record['error']}")
        for i in record["free"]:
            if self._beam > 1:
                if self._owns(i):
                    self._bstate["active"][self._row(i)] = False
                self._b_active_host[i] = False
            self._slots[i] = None
        return record

    def _follower_loop(self) -> None:
        """Replays the leader's records: its frees, its admits and, with
        the slots both leave active, the same decode blocks."""
        while True:
            record = self._receive()
            if record["close"]:
                return
            for slot, fields in record["admits"]:
                self._prefill_into_slot(slot, _Request(**fields))
            if record["admits"] and self._beam == 1:
                self._receive()
            active = [i for i, s in enumerate(self._slots) if s is not None]
            if active:
                self._consume_any(self._dispatch_any(active))

    # ------------------------------------------------------------------
    # Scheduler loop.
    # ------------------------------------------------------------------

    def _loop(self):
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            if not self._leader:
                self._follower_loop()
                return
            # Up to self._depth blocks in flight: the host reads block N
            # while block N+1 runs on the card.
            inflight = deque()
            while True:
                self._tracked(self._harvest_any)
                admits = self._collect_admits()
                if self._dist is not None and (admits or any(self._slots)):
                    self._send(admits)
                admitted = False
                self._admitting = [req for _, req in admits]  # failed if an admit raises
                for slot, req in admits:
                    self._prefill_into_slot(slot, req)
                    self._admitting.pop(0)
                    admitted = True
                if admitted and self._beam == 1:
                    # An admit's first token may end its request (an end
                    # token, max_length 1): it finishes before the next
                    # dispatch decodes past it.
                    self._tracked(self._harvest)
                    if self._dist is not None:
                        self._send()
                active = [i for i, s in enumerate(self._slots) if s is not None]
                if not active and not inflight:
                    if self._closed:
                        self._fail_pending(RuntimeError("Batcher closed"))
                        if self._dist is not None:
                            self._send(close=True)
                        return
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                if active:
                    inflight.append(self._dispatch_any(active))
                depth = self._depth
                if self._beam > 1 and any(r is not None and r.callback is not None
                                          for r in self._slots):
                    # Beam streaming runs in lockstep: a callback's stop
                    # finishes from the block the callback saw.
                    depth = 1
                while len(inflight) >= (depth if active else 1):
                    self._consume_any(inflight.popleft())
        except BaseException as e:  # noqa: BLE001
            self._error = e
            self._fail_pending(e)
            for s in self._slots + self._admitting:
                if s is not None and not s.future.done():
                    s.future.set_exception(e)
            if self._dist is not None and self._leader and not self._failed_everywhere:
                self._send_error(e)

    def _send_error(self, exc: BaseException) -> None:
        """The failed leader's last record, which the followers raise from
        ``join()``. A follower that waits elsewhere (in a model collective
        the leader left) does not take it within ``STOP_SECONDS``: it waits
        on until the process group's timeout or until the launcher stops
        the job."""
        try:
            self._send(close=True, error=f"{type(exc).__name__}: {exc}",
                       timeout=STOP_SECONDS)
        except Exception:  # noqa: BLE001 - the failure is the leader's own
            pass


class ContinuousTranslator(ContinuousBatcher):
    """Continuous batching of an encoder-decoder model (a ``Translator``'s).

    Each slot owns cross-attention memory of a fixed shape: the admit
    encodes the source, projects it through every layer's cross K/V (or
    a merged layer's ``memory_kv``) and writes the result into the slot's
    rows of [num_slots, Hkv, max_source_len, D] buffers, allocated once;
    a per-slot length mask covers the padding. Decoding starts from the
    decoder start token at position 0, so there is no decoder-side
    prefill.

    Serves every encoder-decoder family the batch path does: separate
    cross-attention, merged self+cross attention (T5Gemma2), the T5 bias,
    Shaw positions and source factors (``￨``-factored tokens, split at
    submit). Target prefixes are forced while decoding, including on
    models whose ``decoder_start_token`` is null, where the prefix's first
    token takes the start token's role (reference:
    src/models/sequence_to_sequence.cc:169-186).
    """

    _seq2seq = True

    def __init__(self, translator, *, max_source_len: int = 128,
                 max_target_prefix: int = 32, **kw):
        model = translator.model
        if not model.is_sequence_to_sequence:
            raise ValueError("ContinuousTranslator requires an encoder-decoder model")
        self._translator = translator
        self._max_src = max_source_len
        self._src_vocab = model.source_vocabularies[0]
        self._num_features = model.arch.encoder.embeddings.num_features
        start = model.config.get("decoder_start_token", "<s>")
        self._start_id = None if start is None else model.target_vocabulary.to_id(start)
        self._init_common(model, **kw)
        self._init_seq2seq_state(max_target_prefix)
        self._start_loop()

    def _init_seq2seq_state(self, max_target_prefix: int):
        """Per-slot cross-attention memory (zeros attend as masked) and the
        forced target-prefix table."""
        model = self.model
        self.model.ensure_consts(max(self._capacity, self._max_src))
        self._mem = []
        for layer in model.arch.decoder.layers:
            # A merged (T5Gemma2) layer carries its memory through the
            # self-attention's memory_kv projection.
            a = layer.cross_attention
            if a is None and layer.self_attention.has_memory_kv:
                a = layer.self_attention
            if a is None:
                self._mem.append(None)
                continue
            shape = (self._ns, a.num_heads_kv, self._max_src, a.head_dim)
            self._mem.append({n: torch.zeros(shape, dtype=model.out_dtype,
                                             device=self._device) for n in ("k", "v")})
        self._src_len = np.zeros(self._num_slots, np.int64)
        self._max_prefix = max_target_prefix
        self._prefix = np.zeros((self._num_slots, max(1, max_target_prefix)), np.int64)

    def submit(self, source: Sequence[str], *, max_length: int = 256,
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
               target_prefix: Sequence[str] = None,
               callback=None,
               stop_sequences: Sequence[Sequence] = None) -> Future:
        """Queue one tokenized source sentence; the Future resolves to a
        GenerationResult of the target tokens (the forced ``target_prefix``
        included, as the reference's return_prefix). ``callback`` streams
        target tokens, as ``ContinuousBatcher.submit``'s does."""
        if self._closed:
            raise RuntimeError("The batcher is closed")
        if not source:
            raise ValueError("The source must contain at least one token")
        cfg = self.model.config
        bos, eos = bool(cfg.get("add_source_bos", False)), bool(cfg.get("add_source_eos", False))
        feature_ids = None
        if self._num_features > 1:
            from .translator import extract_features

            streams = extract_features([list(source)], self._num_features)
            feature_ids = [vocab.tokens_to_ids(stream, add_bos=bos, add_eos=eos)[0]
                           for vocab, stream in zip(self.model.source_vocabularies, streams)]
            ids = feature_ids[0]
        else:
            ids = self._src_vocab.tokens_to_ids([list(source)], add_bos=bos, add_eos=eos)[0]
        if len(ids) > self._max_src:
            raise ValueError(f"source length {len(ids)} (BOS and EOS included) exceeds "
                             f"max_source_len ({self._max_src})")
        if max_length + self._block > self._capacity:
            raise ValueError("max_length exceeds the slot capacity")
        prefix_ids = []
        if target_prefix:
            tv = self.model.target_vocabulary
            prefix_ids = [tv.to_id(t) for t in target_prefix]
        start_id = self._start_id
        if start_id is None:
            # No decoder start token: the prefix's first token is fed as one
            # and the rest is forced (as translate_batch does).
            if not prefix_ids:
                raise ValueError(
                    "The model requires a target prefix as the decoder start token")
            start_id, prefix_ids = prefix_ids[0], prefix_ids[1:]
        if len(prefix_ids) > self._max_prefix:
            raise ValueError(f"target_prefix length {len(prefix_ids)} exceeds "
                             f"max_target_prefix ({self._max_prefix})")
        self._validate_request_sampling(sampling_topk, sampling_topp)
        self._validate_beam_request(num_hypotheses)
        rep, ngram, sup_ids = self._validate_request_penalties(
            repetition_penalty, no_repeat_ngram_size, suppress_tokens)
        req = _Request(prompt_ids=ids, max_length=max_length,
                       min_length=min_length + len(prefix_ids),
                       temperature=sampling_temperature or 0.0,
                       topk=sampling_topk, topp=sampling_topp, seed=seed,
                       end_ids=self._resolve_request_end_ids(end_token),
                       rep_penalty=rep, ngram=ngram, suppress_ids=sup_ids,
                       num_hypotheses=num_hypotheses, callback=callback,
                       stop_sequences=self._stop_ids(stop_sequences),
                       start_id=start_id, prefix_ids=prefix_ids,
                       forced_len=len(prefix_ids), feature_ids=feature_ids)
        return self._enqueue(req)

    def _memory(self, opts):
        return self._mem, attn_ops.length_mask_bias(opts["src_len"], self._max_src)

    def _device_options(self) -> dict:
        if self._dopts is None:
            o = super()._device_options()
            o["src_len"] = self._upload(self._mine(self._src_len))
        return self._dopts

    @staticmethod
    def _mem_insert_impl(mem, sub, slot: int):
        """Writes one request's per-layer memory K/V (``sub``, padded to the
        buffers' length) into row ``slot`` of the memory buffers ``mem``, in
        place."""
        for buf, s in zip(mem, sub):
            if buf is not None:
                for name in buf:
                    buf[name][slot].copy_(s[name][0])

    def _get_encode(self, padded_len: int):
        return self._make_encode_fn(self.model, padded_len)

    def _get_draft_encode(self, padded_len: int):
        return self._make_encode_fn(self._draft_model, padded_len)

    def _init_draft(self, dm):
        """An encoder-decoder draft model: per-slot cross-attention memory
        of its own and a slot cache beside the target's; the admit encodes
        the same source with it, and it proposes K - 1 target tokens a
        round."""
        if not dm.is_sequence_to_sequence:
            raise ValueError(
                "the continuous translator's draft_model must be an "
                "encoder-decoder model")
        if T.ring_capacity(dm.arch):
            raise NotImplementedError("sliding-window draft models are not supported")
        if any(l.self_attention.has_memory_kv for l in dm.arch.decoder.layers):
            raise NotImplementedError("merged-attention draft models are not supported")
        if dm.arch.encoder.embeddings.num_features > 1:
            raise NotImplementedError("source-factor draft models are not supported")
        if len(dm.target_vocabulary) != len(self._vocab):
            raise ValueError(
                "draft model vocabulary size "
                f"({len(dm.target_vocabulary)}) must match the target "
                f"model ({len(self._vocab)})")
        if len(dm.source_vocabularies[0]) != len(self._src_vocab):
            raise ValueError(
                "draft model source vocabulary size must match the target model")
        self._alloc_draft_state(dm)

    def _draft_context(self, req) -> List[int]:
        # The target side only: the source ids live in another vocabulary.
        return [req.start_id] + req.generated

    def _make_encode_fn(self, model, padded_len: int, speech: bool = False):
        """A function (encoder input, length) -> the per-layer memory K/V of
        one request, [1, Hkv, max_source_len, D] each (zero-padded): source
        ids ``padded_len`` long (a tuple of them with source factors), or
        with ``speech`` mel features [1, n_mels, padded_len frames]."""
        qa = model.policy.quantize_activations

        def encode(ids, length=None):
            if speech:
                memory = T.speech_encoder_forward(model.arch, model.params, model.consts, ids,
                                                  quantize_acts=qa, out_dtype=model.out_dtype)
            else:
                memory = T.encoder_forward(
                    model.arch, model.params, model.consts, ids,
                    torch.tensor([length], dtype=torch.long, device=self._device),
                    quantize_acts=qa, out_dtype=model.out_dtype)
            pad = self._max_src - memory.shape[1]
            return [None if m is None else {k: F.pad(v, (0, 0, 0, pad)) for k, v in m.items()}
                    for m in T.precompute_memory(model.arch, model.params, memory,
                                                 quantize_acts=qa)]

        return encode

    def _prefill_into_slot(self, slot: int, req: _Request):
        ids = req.prompt_ids
        P = min(_round_up(max(len(ids), 1), self._prefill_bucket), self._max_src)

        def pad_ids(row):
            return self._padded(row[:P], P).to(self._device)

        def encode():
            r = self._row(slot)
            enc_ids = (tuple(pad_ids(f) for f in req.feature_ids)
                       if req.feature_ids is not None else pad_ids(ids))
            self._mem_insert_impl(self._mem, self._get_encode(P)(enc_ids, min(len(ids), P)), r)
            if self._draft_model is not None:
                # A draft takes one feature stream (_init_draft): the main one.
                self._mem_insert_impl(self._draft_mem, self._get_draft_encode(P)(
                    pad_ids(ids), min(len(ids), P)), r)

        self._on_owner(slot, encode)
        self._src_len[slot] = min(len(ids), P)
        self._admit_decoder(slot, req, req.start_id)

    def _admit_decoder(self, slot: int, req: _Request, start_id: int) -> None:
        """The slot's decoder state: the start token at position 0 and the
        forced prefix (beam rows all start from it; only beam 0 carries
        score 0, so the first step's candidates expand the beams)."""
        self._slots[slot] = req
        self._pos[slot] = 0
        self._tokens[slot] = start_id
        self._prefix[slot, :] = 0
        self._prefix[slot, :len(req.prefix_ids)] = req.prefix_ids
        self._plen[slot] = len(req.prefix_ids)
        self._ts_on[slot] = req.ts_on
        if self._beam > 1:
            self._set_beam_slot_options(slot, req)
            self._beam_reset_fn(slot, start_id, 0)
            return
        if req.ts_on:
            # The greedy rules read the generated history from the penalty
            # table (1.0 / 0 penalty rows stay no-ops for the others).
            self._ensure_pen_tables()
        self._set_slot_sampling(slot, req)
        self._dpos[slot] = 0
        if not self._owns(slot):
            return
        r = self._row(slot)
        self._dstate["tokens"][r] = start_id
        self._dstate["pos"][r] = 0
        self._dstate["gen"][r] = 0
        if self._seen.shape[0]:
            self._seen[r] = False
            self._hist[r] = 0


class ContinuousWhisper(ContinuousTranslator):
    """Continuous batching of Whisper (a ``Whisper``'s model).

    ``submit(features, prompt)`` encodes the request's mel features
    [n_mels, frames] into the slot's cross-attention memory and forces the
    prompt (the start-of-transcript sequence) as a target prefix.
    Whisper's timestamp rules (reference: src/models/whisper.cc:742-865)
    apply to a request whose prompt does not end with
    ``<|notimestamps|>``, under greedy and beam search, over the steps past
    the prompt, so the first sampled token is a timestamp, as in
    ``Whisper.generate``; the model's config
    ``suppress_ids`` are suppressed every step. The encoder attends every
    frame, so serving feeds one fixed mel length (the 30 s window, padded
    upstream as the reference does).
    """

    def __init__(self, whisper, *, max_target_prefix: int = 16,
                 max_initial_timestamp_index: int = 50, **kw):
        model = whisper.model
        enc = model.arch.encoder
        if enc is None or not enc.num_conv_layers:
            raise ValueError("ContinuousWhisper requires a Whisper-style speech model")
        v = model.target_vocabulary
        if "<|notimestamps|>" in v and "<|endoftext|>" in v:
            no_ts = v.to_id("<|notimestamps|>")
            ts_begin = no_ts + 1
            self._wts = (v.to_id("<|endoftext|>"), no_ts, ts_begin, len(v) - 1,
                         ts_begin + max_initial_timestamp_index)
        self._translator = whisper
        # The encoder's output capacity: the position table's length
        # (reference: src/layers/whisper.cc:44-49).
        self._max_src = int(model.params["encoder"]["position_encodings"].shape[0])
        self._src_vocab = None
        self._start_id = None  # a request's prompt[0]
        if "end_token" not in kw and "<|endoftext|>" in v:
            kw["end_token"] = "<|endoftext|>"
        self._init_common(model, **kw)
        sup = tuple(int(i) for i in (model.config.get("suppress_ids") or ()))
        self._suppress_ids = tuple(sorted(set(self._suppress_ids) | set(sup)))
        self._init_seq2seq_state(max_target_prefix)
        self._start_loop()

    def _init_draft(self, dm):
        """A speech draft model (a smaller Whisper): the admit encodes the
        same mel segment into its own per-slot memory; the translator's
        draft function proposes the tokens."""
        enc = dm.arch.encoder
        if enc is None or not enc.num_conv_layers:
            raise ValueError(
                "ContinuousWhisper's draft_model must be a Whisper-style speech model")
        if T.ring_capacity(dm.arch):
            raise NotImplementedError("sliding-window draft models are not supported")
        if any(l.self_attention.has_memory_kv for l in dm.arch.decoder.layers):
            raise NotImplementedError("merged-attention draft models are not supported")
        if len(dm.target_vocabulary) != len(self._vocab):
            raise ValueError(
                "draft model vocabulary size "
                f"({len(dm.target_vocabulary)}) must match the target "
                f"model ({len(self._vocab)})")
        n_mels = self.model.params["encoder"]["convs"][0]["w"].shape[1]
        d_mels = dm.params["encoder"]["convs"][0]["w"].shape[1]
        if d_mels != n_mels:
            raise ValueError(
                f"draft model expects {d_mels} mel bins, the target model {n_mels}")
        if dm.params["encoder"]["position_encodings"].shape[0] < self._max_src:
            raise ValueError("draft model encoder capacity is smaller than the target's")
        self._alloc_draft_state(dm)

    def _get_draft_speech_encode(self, frames: int):
        return self._make_encode_fn(self._draft_model, frames, speech=True)

    def submit(self, features, prompt: Sequence, *, max_length: int = 256,
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
        """Queue one audio segment: ``features`` [n_mels, frames], ``prompt``
        the start-of-transcript tokens (or ids). The Future resolves to a
        GenerationResult whose tokens start with the forced prompt tail
        (``prompt[1:]``) and continue with the transcription."""
        if self._closed:
            raise RuntimeError("The batcher is closed")
        if not prompt:
            raise ValueError("The prompt must contain at least one token")
        v = self._vocab
        ids = [t if isinstance(t, int) else v.to_id(t, allow_unk=False) for t in prompt]
        if len(ids) - 1 > self._max_prefix:
            raise ValueError(f"prompt length {len(ids)} exceeds max_target_prefix + 1 "
                             f"({self._max_prefix + 1})")
        if max_length + max(self._block, self._spec_k) > self._capacity:
            raise ValueError("max_length exceeds the slot capacity")
        feats = np.asarray(features, np.float32)
        if feats.ndim != 2:
            raise ValueError("features must be one segment of shape [n_mels, frames]")
        # The stride-2 convolution's output length is ceil(frames / 2).
        if (feats.shape[-1] + 1) // 2 > self._max_src:
            raise ValueError(f"features length {feats.shape[-1]} exceeds the encoder "
                             f"capacity ({2 * self._max_src} frames)")
        self._validate_request_sampling(sampling_topk, sampling_topp)
        self._validate_beam_request(num_hypotheses)
        rep, ngram, sup_ids = self._validate_request_penalties(
            repetition_penalty, no_repeat_ngram_size, suppress_tokens)
        # The rules apply unless the prompt opts out.
        ts_on = self._wts is not None and ids[-1] != self._wts[1]
        if ts_on and self._spec_k > 1:
            raise NotImplementedError(
                "Whisper timestamp rules are not compatible with "
                "speculation; use <|notimestamps|> prompts or "
                "speculation_k=0")
        req = _Request(prompt_ids=[], max_length=max_length,
                       min_length=min_length + (len(ids) - 1),
                       temperature=sampling_temperature or 0.0,
                       topk=sampling_topk, topp=sampling_topp, seed=seed,
                       end_ids=self._resolve_request_end_ids(end_token),
                       rep_penalty=rep, ngram=ngram, suppress_ids=sup_ids,
                       num_hypotheses=num_hypotheses, callback=callback,
                       stop_sequences=self._stop_ids(stop_sequences),
                       start_id=ids[0], prefix_ids=ids[1:], forced_len=len(ids) - 1,
                       features=feats, ts_on=ts_on)
        return self._enqueue(req)

    def _get_speech_encode(self, frames: int):
        # Serving feeds one fixed mel length (the 30 s window, padded
        # upstream): the encoder attends every frame unmasked, so zero
        # padding here would change the memory (reference:
        # src/layers/whisper.cc:25-62).
        return self._make_encode_fn(self.model, frames, speech=True)

    def _prefill_into_slot(self, slot: int, req: _Request):
        frames = req.features.shape[-1]

        def encode():
            r = self._row(slot)
            feats = torch.as_tensor(req.features[None]).to(self._device)
            self._mem_insert_impl(self._mem, self._get_speech_encode(frames)(feats), r)
            if self._draft_model is not None:
                self._mem_insert_impl(self._draft_mem,
                                      self._get_draft_speech_encode(frames)(feats), r)

        self._on_owner(slot, encode)
        self._src_len[slot] = min((frames + 1) // 2, self._max_src)
        self._admit_decoder(slot, req, req.start_id)
