"""The port's ``ContinuousBatcher`` against the JAX package's, on the CPU.

On builder models (2 layers, d_model 64, 4 heads, vocabulary 96): a
rotary GQA model, its int8 twin with the int8 KV cache, negative-ALiBi,
T5-bias, Shaw and ring-window models. Each model's requests (more than the
slots, with per-request min_length and end tokens, stop sequences,
repetition penalty, no-repeat n-grams and suppressed tokens) run once
through each package's batcher, all submitted together: the port's tokens
equal the JAX package's, with scores within ``TOL`` (``INT8_KV_TOL`` with
the int8 KV cache, where a cached vector at a half-step tie lands one int8
step apart). The JAX batcher runs once per model (module fixture). Where
requests carry options, both batchers suppress the vocabulary's last id
for every request: the JAX package's per-row suppress and end tables turn
their -1 padding into that id (a fault of the JAX package, ROADMAP queue
3, ``test_jax_batcher_pads_to_the_last_id``), which the global suppression
makes moot.

The rest holds the port's batcher to itself and to ``generate_batch``: a
request submitted mid-decode finishes before a long one; ``stream``,
``async_stream`` and cancelling a queued request; callback early stop and
callback exceptions; ``stats``; validation errors; a sampled request
repeats its tokens under its seed, and greedy requests beside it keep
``generate_batch``'s tokens.
"""

import asyncio
import concurrent.futures
import os
import time

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.runtime import continuous

TOL = 1e-4
INT8_KV_TOL = 1e-3
BASE = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96)
ROTARY = dict(BASE, num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
              activation="swish")
# name -> (builder arguments, KV cache, batcher arguments)
MODELS = {
    "rotary": (ROTARY, "", dict(num_slots=3, capacity=128, steps_per_sync=4)),
    "int8": (dict(ROTARY, quantization="int8"), "int8",
             dict(num_slots=3, capacity=128, steps_per_sync=4)),
    "alibi_negative": (dict(BASE, alibi=True, alibi_positive=False), "",
                       dict(num_slots=2, capacity=64, steps_per_sync=3)),
    "t5": (dict(BASE, rel_bias_buckets=8, rel_bias_max_distance=20), "",
           dict(num_slots=2, capacity=64, steps_per_sync=3)),
    "shaw": (dict(BASE, rel_position_max=4), "",
             dict(num_slots=2, capacity=64, steps_per_sync=3)),
    "ring_window": (dict(BASE, sliding_window=16, rotary_dim=0), "",
                    dict(num_slots=2, capacity=320, steps_per_sync=4)),
}
MAX_LENGTH = 12


def prompts(n, seed, lengths=(3, 9, 14, 5, 11, 7, 2, 6)):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(3, 90, lengths[i % len(lengths)])]
            for i in range(n)]


class kv_cache:
    """Sets ``CT2TPU_KV_CACHE`` for a block (read when a batcher is made)."""

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


def requests_for(tg, name):
    """(prompt, submit options) of a model: plain greedy requests, and on
    the rotary and int8 models every per-request option, its end token and
    stop sequence taken from the greedy continuation so that they fire."""
    ps = prompts(6 if name != "ring_window" else 3, seed=len(name))
    if name == "ring_window":
        ps.append(prompts(1, 5, lengths=(200,))[0])  # past one ring block
    reqs = [(p, dict(max_length=MAX_LENGTH)) for p in ps]
    if name not in ("rotary", "int8"):
        return reqs
    greedy = [r.sequences_ids[0] for r in tg.generate_batch(
        ps[:4], max_length=MAX_LENGTH, include_prompt_in_result=False)]
    v = tg.model.target_vocabulary
    reqs += [
        (ps[0], dict(max_length=MAX_LENGTH, min_length=4,
                     end_token=[v.to_token(greedy[0][2]), v.to_token(greedy[0][5])])),
        (ps[1], dict(max_length=MAX_LENGTH, stop_sequences=[greedy[1][3:5]])),
        (ps[2], dict(max_length=MAX_LENGTH, repetition_penalty=1.5)),
        (ps[3], dict(max_length=MAX_LENGTH, no_repeat_ngram_size=2)),
        (ps[0], dict(max_length=MAX_LENGTH,
                     suppress_tokens=[v.to_token(t) for t in greedy[0][:2]])),
    ]
    return reqs


def run_batcher(module, gen, reqs, **kw):
    cb = module.ContinuousBatcher(gen, **kw)
    try:
        futures = [cb.submit(p, **o) for p, o in reqs]
        return [f.result(timeout=600) for f in futures], cb.stats()
    finally:
        cb.close()


def last_id_suppressed(tg, name, kw):
    """The batcher's arguments, suppressing the last vocabulary id where the
    requests carry options (see the module docstring)."""
    if name not in ("rotary", "int8"):
        return kw
    v = tg.model.target_vocabulary
    return dict(kw, suppress_tokens=[v.to_token(len(v) - 1)])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """name -> (port Generator, requests, JAX results, port results,
    port stats, model directory)."""
    out = {}
    for name, (build, kv, kw) in MODELS.items():
        path = jbuilder.build_decoder_only_model(
            str(tmp_path_factory.mktemp(name)), **build)
        with kv_cache(kv):
            tg = tt.Generator(path, device="cpu")
            reqs = requests_for(tg, name)
            kw = last_id_suppressed(tg, name, kw)
            ref, _ = run_batcher(ct, ct.Generator(path), reqs, **kw)
            got, stats = run_batcher(tt, tg, reqs, **kw)
        out[name] = (tg, reqs, ref, got, stats, path)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_batcher_matches_jax_batcher(served, name):
    tg, reqs, ref, got, stats, _ = served[name]
    tol = INT8_KV_TOL if MODELS[name][1] == "int8" else TOL
    assert len(got) == len(ref) == len(reqs) > MODELS[name][2]["num_slots"]
    for (prompt, opts), o, r in zip(reqs, got, ref):
        assert o.sequences_ids == r.sequences_ids, opts
        assert o.sequences == r.sequences
        np.testing.assert_allclose(o.scores, r.scores, atol=tol, rtol=0)
        assert 0 < len(o.sequences_ids[0]) <= opts["max_length"]
    assert stats["num_requests"] == len(reqs)
    assert stats["num_tokens"] == sum(len(o.sequences_ids[0]) for o in got)


def test_jax_batcher_pads_to_the_last_id(served):
    """Without the global suppression, the JAX batcher disables the last
    vocabulary id for a request during its min_length (the end table's -1
    padding) and for every request once one carries suppress_tokens (the
    suppress table's); the port disables neither, and its first-token score
    of a min_length request renormalizes over that id too."""
    tg, reqs, _, _, _, path = served["rotary"]
    p, opts = next((p, o) for p, o in reqs if "min_length" in o)
    kw = dict(MODELS["rotary"][2], num_slots=1)
    steps = {}
    for module, gen in ((ct, ct.Generator(path)), (tt, tg)):
        seen = []
        cb = module.ContinuousBatcher(gen, **kw)
        try:
            cb.submit(p, callback=lambda sr: seen.append(sr.score), **opts).result(
                timeout=120)
        finally:
            cb.close()
        steps[module.__name__] = seen
    ids = [[tg.model.target_vocabulary.to_id(t) for t in p]]
    lp = torch.log_softmax(tg.forward_batch(ids)[0, len(p) - 1].float(), -1)
    v = tg.model.target_vocabulary
    ends = [v.to_id(t) for t in opts["end_token"]]
    keep = torch.ones_like(lp, dtype=torch.bool)
    keep[ends] = False
    first = steps["ctranslate2_tpu_torch"][0]
    jax_first = steps["ctranslate2_tpu"][0]
    # The port renormalizes over every id but the end tokens; the JAX
    # package also drops the last id.
    port_mass = torch.logsumexp(lp[keep], -1).item()
    keep[-1] = False
    jax_mass = torch.logsumexp(lp[keep], -1).item()
    assert abs((jax_first - first) - (port_mass - jax_mass)) < 1e-4
    assert port_mass - jax_mass > 1e-6


def test_per_request_options_took_effect(served):
    tg, reqs, _, got, _, _ = served["rotary"]
    plain = {tuple(p): o.sequences_ids[0] for (p, opts), o in zip(reqs, got)
             if len(opts) == 1}
    for (p, opts), o in zip(reqs, got):
        ids = o.sequences_ids[0]
        if "min_length" in opts:
            assert len(ids) >= 4 and len(ids) < MAX_LENGTH
        if "stop_sequences" in opts:
            # Cut before the stop sequence's first occurrence.
            full, stop = plain[tuple(p)], list(opts["stop_sequences"][0])
            first = next(i for i in range(len(full)) if full[i:i + len(stop)] == stop)
            assert ids == full[:first]
        if "suppress_tokens" in opts:
            banned = {tg.model.target_vocabulary.to_id(t) for t in opts["suppress_tokens"]}
            assert not banned & set(ids)
        if "no_repeat_ngram_size" in opts:
            pairs = list(zip(ids, ids[1:]))
            assert len(pairs) == len(set(pairs))


def test_greedy_matches_generate_batch(served):
    tg, reqs, _, got, _, _ = served["rotary"]
    for (p, opts), o in zip(reqs, got):
        if len(opts) == 1:
            ref = tg.generate_batch([p], max_length=MAX_LENGTH,
                                    include_prompt_in_result=False)[0]
            assert o.sequences_ids == ref.sequences_ids


def _small(served, **kw):
    tg = served["rotary"][0]
    kw.setdefault("num_slots", 2)
    kw.setdefault("capacity", 160)
    return tg, tt.ContinuousBatcher(tg, **kw)


def test_join_mid_decode(served):
    """A short request submitted while a long one decodes finishes first."""
    tg, cb = _small(served, steps_per_sync=2)
    try:
        long_f = cb.submit(["tok1"], max_length=120)
        deadline = time.time() + 60
        while cb.num_steps < 6 and time.time() < deadline:
            time.sleep(0.005)
        assert cb.num_steps >= 6 and not long_f.done()
        short = cb.submit(["tok2", "tok5"], max_length=3).result(timeout=120)
        assert 0 < len(short.sequences_ids[0]) <= 3
        assert not long_f.done()
        assert len(long_f.result(timeout=300).sequences_ids[0]) <= 120
    finally:
        cb.close()


def test_stream_and_callbacks(served):
    tg, cb = _small(served)
    p = ["tok1", "tok2"]
    expected = tg.generate_batch([p], max_length=12,
                                 include_prompt_in_result=False)[0].sequences_ids[0]
    try:
        steps = list(cb.stream(p, max_length=12))
        assert [s.token_id for s in steps][:len(expected)] == expected
        assert [s.step for s in steps] == list(range(len(steps)))
        assert steps[-1].is_last

        async def collect():
            return [s.token_id async for s in cb.async_stream(p, max_length=12)]

        assert asyncio.run(collect())[:len(expected)] == expected
        # Early stop from the callback: three tokens.
        r = cb.submit(["tok1"], max_length=32,
                      callback=lambda sr: sr.step >= 2).result(timeout=120)
        assert len(r.sequences_ids[0]) == 3
        # Closing a stream early stops its request.
        it = cb.stream(["tok3"], max_length=40)
        next(it)
        it.close()

        def boom(sr):
            raise KeyError("callback failed")

        with pytest.raises(KeyError, match="callback failed"):
            cb.submit(["tok1"], max_length=8, callback=boom).result(timeout=120)
        # The batcher keeps serving after a callback error.
        again = cb.submit(p, max_length=12).result(timeout=120)
        assert again.sequences_ids[0] == expected
    finally:
        cb.close()


def test_cancel_a_queued_request(served):
    tg, cb = _small(served, num_slots=1)
    try:
        f1 = cb.submit(["tok1"], max_length=48)
        f2 = cb.submit(["tok2"], max_length=8)
        f3 = cb.submit(["tok3"], max_length=8)
        assert f3.cancel() or f3.done()
        f1.result(timeout=120)
        f2.result(timeout=120)
        if f3.cancelled():
            with pytest.raises(concurrent.futures.CancelledError):
                f3.result(timeout=30)
            done, _ = concurrent.futures.wait([f3], timeout=30)
            assert f3 in done
        deadline = time.time() + 30
        while cb.stats()["num_queued"] and time.time() < deadline:
            time.sleep(0.05)
        assert cb.stats()["num_queued"] == 0
    finally:
        cb.close()


def test_stats(served):
    tg, cb = _small(served, steps_per_sync=4)
    try:
        results = [f.result(timeout=120) for f in
                   [cb.submit(p, max_length=8) for p in prompts(4, 3)]]
        s = cb.stats()
        assert s["num_requests"] == 4
        assert s["num_tokens"] == sum(len(r.sequences_ids[0]) for r in results)
        assert s["num_steps"] == cb.num_steps == 4 * s["num_blocks"] > 0
        assert 0 < s["mean_slot_occupancy"] <= 1
        assert s["ttft_p50_ms"] > 0 and s["ttft_p95_ms"] >= s["ttft_p50_ms"]
        assert s["tokens_per_sec"] > 0
        assert s["pipeline_depth"] == continuous.DEFAULT_PIPELINE_DEPTH
        assert s["num_queued"] == 0 and cb.num_active_slots == 0
    finally:
        cb.close()


def test_validation_errors(served):
    tg, cb = _small(served, capacity=32)
    try:
        with pytest.raises(ValueError, match="capacity"):
            cb.submit(["tok1"] * 20, max_length=100)
        with pytest.raises(ValueError, match="at least one token"):
            cb.submit([])
        with pytest.raises(ValueError, match="sampling_topk"):
            cb.submit(["tok1"], max_length=4, sampling_topk=65)
        with pytest.raises(ValueError, match="positive"):
            cb.submit(["tok1"], max_length=4, repetition_penalty=0)
        with pytest.raises(ValueError, match="0 or >= 2"):
            cb.submit(["tok1"], max_length=4, no_repeat_ngram_size=1)
        with pytest.raises(ValueError, match="max_no_repeat_ngram_size"):
            cb.submit(["tok1"], max_length=4, no_repeat_ngram_size=9)
        with pytest.raises(ValueError, match="wrap single tokens"):
            cb.submit(["tok1"], max_length=4, stop_sequences=["</s>"])
        with pytest.raises(ValueError, match="end_token"):
            cb.submit(["tok1"], max_length=4, end_token=["tok1"] * 5)
        with pytest.raises(NotImplementedError, match="beam serving"):
            cb.submit(["tok1"], max_length=4, num_hypotheses=2)
    finally:
        cb.close()
    with pytest.raises(RuntimeError, match="closed"):
        cb.submit(["tok1"])
    with pytest.raises(ValueError, match="decoder-only"):
        tt.ContinuousBatcher(type("G", (), {"model": type(
            "M", (), {"is_decoder_only": False})()})())


def test_sampled_requests_repeat_under_a_seed(served):
    tg, cb = _small(served, num_slots=3)
    p = ["tok4", "tok9", "tok2"]
    greedy = tg.generate_batch([p], max_length=10,
                               include_prompt_in_result=False)[0].sequences_ids[0]
    sampled = dict(max_length=10, sampling_topk=0, sampling_temperature=1.5)
    try:
        fs = [cb.submit(p, seed=5, **sampled), cb.submit(p, max_length=10),
              cb.submit(p, seed=5, **sampled), cb.submit(p, seed=6, **sampled)]
        a, g, b, c = (f.result(timeout=120).sequences_ids[0] for f in fs)
        assert a == b and a != c
        assert g == greedy
        # Alone in a batcher of its own, the seeded request draws the same.
        tg2, cb2 = _small(served, num_slots=1, steps_per_sync=3)
        try:
            assert cb2.submit(p, seed=5, **sampled).result(
                timeout=120).sequences_ids[0] == a
        finally:
            cb2.close()
    finally:
        cb.close()


def test_kv_cache_type_is_fixed_at_construction(served):
    """``CT2TPU_KV_CACHE`` is read when the batcher is made: a request
    admitted after the setting changed still prefills into the slots'
    cache type."""
    tg = served["rotary"][0]
    with kv_cache("int8"):
        cb = tt.ContinuousBatcher(tg, num_slots=2, capacity=64)
    try:
        assert cb._cache[0]["k"].dtype == torch.int8
        with kv_cache(""):
            r = cb.submit(["tok1", "tok2"], max_length=6).result(timeout=120)
        assert 0 < len(r.sequences_ids[0]) <= 6
    finally:
        cb.close()
