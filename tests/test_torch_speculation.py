"""Lossless speculation in the port against the JAX package, on the CPU.

- ``Generator.generate_batch(speculation_k)`` (prompt-lookup drafts
  verified in chunks of T = speculation_k by ``spec_greedy_loop``) on a
  builder Llama (2 layers, d_model 64, 8 query / 4 KV heads, vocabulary
  64): speculation_k 2, 4 and 6 with and without the prompt in the result,
  min_length, a static prompt, int8 weights with the int8 KV cache and a
  windowed ring model whose positions wrap the ring. The tokens equal the
  JAX package's and the port's own plain greedy, the scores within
  ``TOL``; every validation error is the JAX package's.
- ``spec_greedy_loop`` on a row whose last verify writes the cache's last
  slot, against ``greedy_loop`` at the same capacity.
- ``ContinuousBatcher`` with prompt-lookup drafts (speculation_k 2 and 4)
  and with draft models (an unrelated 1-layer draft, the target itself, an
  ALiBi draft for an ALiBi target) on rotary, ALiBi, ring-window,
  hybrid-window and int8-KV ring models: per-request min / max length,
  repetition penalty, no-repeat n-grams and suppressed tokens. The tokens
  equal the JAX batcher's (run once per model in a module fixture) and
  ``generate_batch``'s, the scores within ``TOL`` (``INT8_KV_TOL`` with the
  int8 KV cache). Where requests carry options, both batchers suppress the
  vocabulary's last id for every request (the JAX batcher's -1 table
  padding, ROADMAP queue 3).
"""

import os

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.decoding import device_loop
from ctranslate2_tpu_torch.decoding.engine import DecodingEngine
from ctranslate2_tpu_torch.decoding.options import DecodingOptions

TOL = 1e-4
INT8_KV_TOL = 1e-3
PROMPTS = [["tok1", "tok2"], ["tok3"], ["tok4", "tok5", "tok6", "tok7"]]
LLAMA = dict(vocab_size=64, num_layers=2, num_heads=8, num_heads_kv=4, d_model=64,
             d_ff=128, rotary_dim=8, glu=True, rms_norm=True, activation="swish")


class kv_cache:
    """Sets ``CT2TPU_KV_CACHE`` for a block (read when a model loads)."""

    def __init__(self, kv):
        self.kv = kv

    def __enter__(self):
        self.old = os.environ.get("CT2TPU_KV_CACHE")
        os.environ["CT2TPU_KV_CACHE"] = self.kv

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("CT2TPU_KV_CACHE")
        else:
            os.environ["CT2TPU_KV_CACHE"] = self.old


def same(got, ref, tol=TOL):
    for g, r in zip(got, ref):
        assert g.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(g.scores, r.scores, atol=tol, rtol=0)


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    path = jbuilder.build_decoder_only_model(str(tmp_path_factory.mktemp("spec")), **LLAMA)
    return ct.Generator(path), tt.Generator(path, device="cpu")


# ---------------------------------------------------------------------------
# generate_batch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [2, 4, 6])
@pytest.mark.parametrize("include_prompt", [True, False])
def test_generate_batch_speculation(llama, spec_k, include_prompt):
    jg, pg = llama
    kw = dict(max_length=16, include_prompt_in_result=include_prompt, return_scores=True)
    got = pg.generate_batch(PROMPTS, speculation_k=spec_k, **kw)
    same(got, jg.generate_batch(PROMPTS, speculation_k=spec_k, **kw))
    same(got, pg.generate_batch(PROMPTS, **kw))


@pytest.mark.parametrize("case", ["min_length", "static_prompt"])
def test_generate_batch_speculation_options(llama, case):
    jg, pg = llama
    kw = (dict(max_length=12, min_length=6) if case == "min_length"
          else dict(max_length=16, static_prompt=["tok9", "tok8"]))
    kw["return_scores"] = True
    got = pg.generate_batch(PROMPTS, speculation_k=4, **kw)
    same(got, jg.generate_batch(PROMPTS, speculation_k=4, **kw))
    same(got, pg.generate_batch(PROMPTS, **kw))


def test_generate_batch_speculation_int8_kv(tmp_path):
    path = jbuilder.build_decoder_only_model(
        str(tmp_path / "i8"), quantization="int8", **dict(LLAMA, vocab_size=64))
    with kv_cache("int8"):
        jg, pg = ct.Generator(path), tt.Generator(path, device="cpu")
        kw = dict(max_length=16, return_scores=True)
        got = pg.generate_batch(PROMPTS, speculation_k=4, **kw)
        same(got, jg.generate_batch(PROMPTS, speculation_k=4, **kw), INT8_KV_TOL)
        same(got, pg.generate_batch(PROMPTS, **kw), INT8_KV_TOL)


def test_generate_batch_speculation_ring(tmp_path):
    """A window of 16 over ring caches of 256 slots: the 250-token prompt's
    verify chunks cross the ring's end, each element wrapping on its own."""
    path = jbuilder.build_decoder_only_model(str(tmp_path / "win"), sliding_window=16,
                                             **LLAMA)
    jg, pg = ct.Generator(path), tt.Generator(path, device="cpu")
    rng = np.random.default_rng(3)
    prompts = PROMPTS + [[f"tok{int(t)}" for t in rng.integers(3, 60, 250)]]
    kw = dict(max_length=270, return_scores=True)
    got = pg.generate_batch(prompts, speculation_k=4, **kw)
    assert len(got[-1].sequences_ids[0]) > 256
    same(got, jg.generate_batch(prompts, speculation_k=4, **kw))
    same(got, pg.generate_batch(prompts, **kw))
    with pytest.raises(ValueError, match="sliding window"):
        pg.generate_batch(PROMPTS, max_length=8, speculation_k=32)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(beam_size=2), ValueError, "beam_size"),
    (dict(sampling_topk=5), NotImplementedError, "greedy"),
    (dict(no_repeat_ngram_size=2), NotImplementedError, "ContinuousBatcher"),
    (dict(repetition_penalty=1.2), NotImplementedError, "ContinuousBatcher"),
    (dict(suppress_sequences=[["tok3"]]), NotImplementedError, "ContinuousBatcher"),
    (dict(callback=lambda r: None), ValueError, "callback"),
    (dict(return_alternatives=True), ValueError, "return_alternatives"),
])
def test_generate_batch_speculation_validation(llama, kwargs, error, match):
    """The port raises the JAX package's exception and message."""
    for gen in llama:
        with pytest.raises(error, match=match):
            gen.generate_batch(PROMPTS, speculation_k=4, **kwargs)


def test_spec_loop_row_ends_at_the_last_slot(llama):
    """A row decodes ``capacity - K + 1`` steps: its last verify writes
    slots C - K .. C - 1, and the rows that finished before keep verifying
    at ``capacity - K`` (a write past the buffer raises). The loop's tokens,
    lengths and scores equal ``greedy_loop``'s at the same capacity."""
    _, pg = llama
    model, K, C = pg.model, 4, 64
    L = C - K + 1
    v = model.target_vocabulary
    starts = [v.to_id(p[0]) for p in PROMPTS]
    end = v.eos_id
    control = torch.zeros((3, 3 + 8), dtype=torch.long)
    control[:, 2] = torch.tensor(starts)
    control[0, 0] = 6  # a forced prefix of 6 tokens on row 0
    control[0, 3:9] = torch.tensor([5, 6, 5, 6, 5, 6])
    sig = DecodingEngine._make_sig(DecodingOptions(), (end,))
    consts = model.ensure_consts(C)
    args = dict(max_steps=L, capacity=C, has_prefix=True, control=control, start_pos=0)
    spec = device_loop.spec_greedy_loop(model, model.params, consts, sig, spec_k=K, **args)
    plain = device_loop.greedy_loop(model, model.params, consts, sig, **args)
    assert int(spec[1].max()) == L  # one row ran to the last slot
    for s, p in zip(spec, plain):
        np.testing.assert_allclose(s.numpy(), p.numpy(), atol=TOL, rtol=0)


def test_draft_tokens_continue_the_latest_bigram_match():
    """The device's prompt lookup drafts what the batcher's host rule does."""
    cb = tt.ContinuousBatcher.__new__(tt.ContinuousBatcher)
    rng = np.random.default_rng(0)
    rows = [[int(t) for t in rng.integers(0, 5, n)] for n in (1, 2, 3, 9, 17, 30)]
    L = 32
    buf = torch.zeros((len(rows), L), dtype=torch.long)
    for i, r in enumerate(rows):
        buf[i, :len(r) - 1] = torch.tensor(r[1:])
    start = torch.tensor([r[0] for r in rows])
    last = torch.tensor([r[-1] for r in rows])
    gen = torch.tensor([len(r) - 1 for r in rows])
    for k in (2, 4, 6):
        got = device_loop.draft_tokens(k, start, last, buf, gen)
        for i, r in enumerate(rows):
            req = type("R", (), {"prompt_ids": r, "generated": []})()
            assert got[i].tolist() == tt.ContinuousBatcher._draft(cb, req, k - 1)


# ---------------------------------------------------------------------------
# ContinuousBatcher.
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96)
ROTARY = dict(BASE, num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
              activation="swish")
WINDOW = dict(BASE, sliding_window=8, rotary_dim=0)
MAX_LENGTH = 12
# name -> (builder arguments, KV cache, batcher arguments)
MODELS = {
    "rotary": (ROTARY, "", dict(num_slots=3, capacity=128)),
    "alibi": (dict(BASE, alibi=True), "", dict(num_slots=2, capacity=64)),
    "ring": (WINDOW, "", dict(num_slots=2, capacity=320)),
    "hybrid": (dict(WINDOW, sliding_window_pattern=2), "",
               dict(num_slots=2, capacity=256)),
    "ring_int8_kv": (WINDOW, "int8", dict(num_slots=2, capacity=320)),
}
# (model, speculation_k, draft) the port's batcher runs; the JAX batcher
# runs all but the last two, which are held to generate_batch (and the
# self-draft to prompt lookup).
RUNS = [("rotary", 2, None), ("rotary", 4, None), ("rotary", 4, "unrelated"),
        ("alibi", 4, None), ("ring", 4, None), ("hybrid", 4, None),
        ("ring_int8_kv", 4, None), ("rotary", 4, "self"), ("alibi", 3, "alibi")]
JAX_RUNS = RUNS[:-2]
DRAFTS = {"unrelated": dict(ROTARY, num_layers=1, seed=7),
          "alibi": dict(BASE, alibi=True, num_layers=1, seed=7)}


def prompts(n, seed, lengths=(3, 9, 14, 5, 11, 7, 2, 6)):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(3, 90, lengths[i % len(lengths)])]
            for i in range(n)]


def requests_for(name, options=True):
    """(prompt, submit options): plain greedy requests (one past a ring
    block on the window models, another that repeats itself, so prompt
    lookup finds matches), and on the rotary model with ``options`` every
    per-request option the speculative step takes."""
    ps = prompts(5, seed=len(name))
    ps.append(ps[0] * 3)
    reqs = [(p, dict(max_length=MAX_LENGTH)) for p in ps]
    if name in ("ring", "ring_int8_kv"):
        # Past one ring block, and on past the ring's end: chunked
        # prefill, then verify chunks that wrap the ring. (The JAX batcher
        # cannot prefill such a prompt on the hybrid stack, ROADMAP queue 3.)
        reqs.append((prompts(1, 5, lengths=(200,))[0], dict(max_length=64)))
    if name == "rotary" and options:
        reqs += [
            (ps[0], dict(max_length=MAX_LENGTH, min_length=6)),
            (ps[1], dict(max_length=5)),
            (ps[2], dict(max_length=MAX_LENGTH, repetition_penalty=1.5)),
            (ps[5], dict(max_length=MAX_LENGTH, no_repeat_ngram_size=2)),
            (ps[3], dict(max_length=MAX_LENGTH, repetition_penalty=0.7,
                         no_repeat_ngram_size=3)),
            (ps[0], dict(max_length=MAX_LENGTH, suppress_tokens=["tok40", "tok41"])),
        ]
    return reqs


def run_batcher(module, gen, reqs, **kw):
    cb = module.ContinuousBatcher(gen, **kw)
    try:
        futures = [cb.submit(p, **o) for p, o in reqs]
        return [f.result(timeout=600) for f in futures], cb.stats()
    finally:
        cb.close()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}
    for name, build in [(n, b) for n, (b, _, _) in MODELS.items()] + list(DRAFTS.items()):
        out[name] = jbuilder.build_decoder_only_model(
            str(tmp_path_factory.mktemp(name)), **build)
    return out


@pytest.fixture(scope="module")
def served(dirs):
    """(model, speculation_k, draft) -> (requests, JAX results, port
    results, port stats, port Generator)."""
    out = {}
    for name, spec_k, draft in RUNS:
        build, kv, kw = MODELS[name]
        with kv_cache(kv):
            pg = tt.Generator(dirs[name], device="cpu")
            jg = ct.Generator(dirs[name])
            # The draft runs take plain requests: the options are the
            # verify's, which the prompt-lookup runs hold.
            reqs = requests_for(name, options=draft is None)
            kw = dict(kw, speculation_k=spec_k)
            if name == "rotary":
                v = pg.model.target_vocabulary
                kw["suppress_tokens"] = [v.to_token(len(v) - 1)]
            jkw, pkw = dict(kw), dict(kw)
            if draft == "self":
                jkw["draft_model"], pkw["draft_model"] = jg, pg
            elif draft:
                jkw["draft_model"] = pkw["draft_model"] = dirs[draft]
            ref = (run_batcher(ct, jg, reqs, **jkw)[0]
                   if (name, spec_k, draft) in JAX_RUNS else None)
            got, stats = run_batcher(tt, pg, reqs, **pkw)
        out[name, spec_k, draft] = (reqs, ref, got, stats, pg)
    return out


@pytest.mark.parametrize("run", JAX_RUNS,
                         ids=[f"{n}-k{k}-{d or 'lookup'}" for n, k, d in JAX_RUNS])
def test_batcher_speculation_matches_jax(served, run):
    reqs, ref, got, stats, pg = served[run]
    eos = pg.model.target_vocabulary.eos_id
    tol = INT8_KV_TOL if MODELS[run[0]][1] == "int8" else TOL
    assert len(got) == len(ref) == len(reqs) > MODELS[run[0]][2]["num_slots"]
    for (_, opts), o, r in zip(reqs, got, ref):
        if r.sequences_ids[0][:1] == [eos] and "min_length" not in opts:
            # The JAX batcher decodes past an admit's end token
            # (test_jax_spec_batcher_decodes_past_an_admitted_end_token).
            assert o.sequences_ids == [[]]
            continue
        assert o.sequences_ids == r.sequences_ids, opts
        np.testing.assert_allclose(o.scores, r.scores, atol=tol, rtol=0)
        assert 0 < len(o.sequences_ids[0]) <= opts["max_length"]
    assert stats["num_requests"] == len(reqs)
    assert stats["num_tokens"] == sum(len(o.sequences_ids[0]) for o in got)
    assert stats["spec_draft"] == ("model" if run[2] else "prompt-lookup")
    assert stats["spec_tokens_per_dispatch"] >= 1.0


@pytest.mark.parametrize("run", [r for r in RUNS if r[0] != "rotary" or r[1:] == (4, None)],
                         ids=lambda r: f"{r[0]}-k{r[1]}-{r[2] or 'lookup'}")
def test_batcher_speculation_matches_generate_batch(served, run):
    """Plain requests decode what ``generate_batch`` decodes."""
    reqs, _, got, _, pg = served[run]
    with kv_cache(MODELS[run[0]][1]):
        for (p, opts), o in zip(reqs, got):
            if len(opts) == 1:
                ref = pg.generate_batch([p], include_prompt_in_result=False, **opts)[0]
                assert o.sequences_ids == ref.sequences_ids


def test_batcher_speculation_options_took_effect(served):
    reqs, _, got, _, pg = served["rotary", 4, None]
    v = pg.model.target_vocabulary
    for (p, opts), o in zip(reqs, got):
        ids = o.sequences_ids[0]
        if "min_length" in opts:
            assert len(ids) >= opts["min_length"]
        if opts["max_length"] == 5:
            assert len(ids) <= 5
        if "suppress_tokens" in opts:
            assert not {v.to_id(t) for t in opts["suppress_tokens"]} & set(ids)
        if opts.get("no_repeat_ngram_size") == 2:
            pairs = list(zip(ids, ids[1:]))
            assert len(pairs) == len(set(pairs))


def test_self_draft_accepts_most_drafts(served):
    """With the target as its own draft every draft matches: each dispatch
    emits more than 1.5 tokens a slot, and the draft's cache, never rolled
    back, keeps the tokens equal to plain greedy."""
    _, _, got, stats, _ = served["rotary", 4, "self"]
    _, _, lookup, lstats, _ = served["rotary", 4, None]
    assert stats["spec_tokens_per_dispatch"] > 1.5
    assert stats["spec_tokens_per_dispatch"] > lstats["spec_tokens_per_dispatch"]
    assert [o.sequences_ids for o in got] == [o.sequences_ids for o in lookup[:len(got)]]


def test_stats_report_speculation(served):
    pg = served["rotary", 2, None][4]
    cb = tt.ContinuousBatcher(pg, num_slots=2, capacity=64)
    try:
        st = cb.stats()
    finally:
        cb.close()
    assert st["spec_tokens_per_dispatch"] is None and st["spec_draft"] is None
    _, _, got, stats, _ = served["rotary", 2, None]
    # At most K = 2 tokens a slot dispatch; the admits emit the first.
    assert 1.0 <= stats["spec_tokens_per_dispatch"] <= 2.0
    assert stats["num_steps"] > 0


def test_batcher_speculation_validation(served, dirs, tmp_path):
    """The JAX batcher's errors: greedy only, the ring's smallest window,
    a draft needs speculation_k > 1, a decoder-only draft without a
    window, with the target's vocabulary size, and a path that loads."""
    pg = served["rotary", 2, None][4]
    with pytest.raises(NotImplementedError, match="greedy"):
        tt.ContinuousBatcher(pg, speculation_k=4, sampling_topk=5)
    with pytest.raises(ValueError, match="speculation_k > 1"):
        tt.ContinuousBatcher(pg, draft_model=dirs["unrelated"])
    small_vocab = jbuilder.build_decoder_only_model(str(tmp_path / "v"), vocab_size=48)
    with pytest.raises(ValueError, match="vocabulary size"):
        tt.ContinuousBatcher(pg, speculation_k=4, draft_model=small_vocab)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tt.ContinuousBatcher(pg, speculation_k=4, draft_model=dirs["ring"])
    translator = jbuilder.build_seq2seq_model(str(tmp_path / "s2s"), vocab_size=96)
    with pytest.raises(ValueError, match="decoder-only"):
        tt.ContinuousBatcher(pg, speculation_k=4, draft_model=translator)
    with pytest.raises(FileNotFoundError):
        tt.ContinuousBatcher(pg, speculation_k=4, draft_model=str(tmp_path / "none"))
    ring = tt.Generator(dirs["ring"], device="cpu")
    with pytest.raises(ValueError, match="sliding window"):
        tt.ContinuousBatcher(ring, speculation_k=9, capacity=320)
    cb = tt.ContinuousBatcher(pg, speculation_k=4, num_slots=1, capacity=32,
                              steps_per_sync=2)
    try:
        with pytest.raises(NotImplementedError, match="greedy"):
            cb.submit(["tok3"], max_length=4, sampling_topk=4)
        with pytest.raises(NotImplementedError, match="greedy"):
            cb.submit(["tok3"], max_length=4, sampling_topp=0.5)
        # The capacity margin is max(steps_per_sync, speculation_k).
        with pytest.raises(ValueError, match="dispatch margin \\(4\\)"):
            cb.submit(["tok3"] * 8, max_length=21)
        assert cb.submit(["tok3"] * 8, max_length=20).result(timeout=120).sequences_ids
    finally:
        cb.close()
    with pytest.raises(NotImplementedError, match="beam"):
        tt.ContinuousBatcher(pg, beam_size=2, speculation_k=4)


def test_an_admitted_end_token_ends_the_request(served):
    """A prompt whose first generated token is the end token: the port's
    batchers, speculating or not, return no token, as ``generate_batch``
    does (the request finishes before the next dispatch)."""
    reqs, _, _, _, pg = served["ring", 4, None]
    prompt, opts = reqs[3]
    assert pg.generate_batch([prompt], include_prompt_in_result=False,
                             **opts)[0].sequences_ids == [[]]
    for kw in (dict(pipeline_depth=1), dict(speculation_k=4)):
        got, stats = run_batcher(tt, pg, [(prompt, opts)], num_slots=2, capacity=320, **kw)
        assert got[0].sequences_ids == [[]] and stats["num_steps"] == 0


def test_jax_spec_batcher_decodes_past_an_admitted_end_token(served):
    """The JAX batcher (speculating, or greedy at pipeline depth 1)
    dispatches a request whose admit emitted the end token: the verify
    emits on past it, so its result keeps that end token where
    ``generate_batch`` returns none (ROADMAP queue 3). The port finishes
    the request at the admit."""
    reqs, ref, got, _, pg = served["ring", 4, None]
    eos = pg.model.target_vocabulary.eos_id
    assert ref[3].sequences_ids[0][:1] == [eos]
    assert got[3].sequences_ids == [[]]
    assert pg.generate_batch([reqs[3][0]], include_prompt_in_result=False,
                             **reqs[3][1])[0].sequences_ids == [[]]
