"""Beam serving: the port's ``ContinuousBatcher(beam_size > 1)`` against the
JAX package's, on the CPU.

On builder models (2 layers, d_model 64, 4 heads, vocabulary 96): a rotary
GQA model (beam 2 with every per-request option; beam 3 with two
hypotheses, a length penalty and patience; beam 2 with early exit,
``length_penalty=0``), its int8 twin with the int8 KV cache, negative
ALiBi (beam 3) and a ring-window model with a prompt past one ring block.
Each case's requests outnumber the slots, and the last one is submitted
once the first has finished, while the others decode. Both packages run
at pipeline depth 1 (the JAX batcher once per case, module fixture): the
tokens are equal, the scores within ``TOL`` (``INT8_KV_TOL`` with the int8
KV cache). Where requests carry options, both batchers suppress the
vocabulary's last id for every request: the JAX beam step turns the -1
padding of its per-row suppress and end tables into that id
(``test_jax_beam_batcher_pads_to_the_last_id``).

The rest: beam serving equals the port's own ``generate_batch(beam_size=K)``
at pipeline depth 1 and 2 (the JAX batcher cuts a request admitted while a
block is in flight at depth 2,
``test_jax_beam_batcher_cuts_requests_admitted_in_flight``);
``gumbel_top_k_per_row`` and ``gumbel_top_k`` fed the JAX package's noise;
the committed-token streaming contract against the JAX batcher's
callbacks, callback early stop and exceptions; greedy and sampled rows in
one batcher; validation errors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
from ctranslate2_tpu.decoding import sampling as js
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.decoding import sampling as ts
from test_torch_continuous import BASE, ROTARY, kv_cache, prompts

TOL = 1e-4
INT8_KV_TOL = 1e-3
MAX_LENGTH = 12
MODELS = {
    "rotary": (ROTARY, ""),
    "int8": (dict(ROTARY, quantization="int8"), "int8"),
    "alibi_negative": (dict(BASE, alibi=True, alibi_positive=False), ""),
    "ring_window": (dict(BASE, sliding_window=16, rotary_dim=0), ""),
}
COMMON = dict(capacity=128, steps_per_sync=4, pipeline_depth=1)
# case -> (model, batcher arguments, requests)
CASES = {
    "rotary_beam2": ("rotary", dict(COMMON, beam_size=2, num_slots=3), "options"),
    "rotary_beam3": ("rotary", dict(COMMON, beam_size=3, num_slots=2, num_hypotheses=2,
                                    length_penalty=0.6, patience=2.0), "plain"),
    "rotary_early_exit": ("rotary", dict(COMMON, beam_size=2, num_slots=2,
                                         num_hypotheses=2, length_penalty=0), "plain"),
    "int8_beam2": ("int8", dict(COMMON, beam_size=2, num_slots=3), "options"),
    "alibi_negative": ("alibi_negative", dict(COMMON, beam_size=3, num_slots=2), "plain"),
    "ring_window": ("ring_window", dict(COMMON, beam_size=2, num_slots=2, capacity=320),
                    "long"),
}


def requests_for(tg, model, kind, beam):
    """(prompt, submit options): plain requests; with ``kind`` "options"
    every per-request option, its end token and stop sequence taken from
    the port's beam output so that they fire; with "long" a prompt past
    one ring block."""
    ps = prompts(5, seed=len(model) + beam)
    reqs = [(p, dict(max_length=MAX_LENGTH)) for p in ps]
    if kind == "long":
        reqs.append((prompts(1, 5, lengths=(200,))[0], dict(max_length=MAX_LENGTH)))
    if kind != "options":
        return reqs
    best = [r.sequences_ids[0] for r in tg.generate_batch(
        ps[:4], max_length=MAX_LENGTH, beam_size=beam, include_prompt_in_result=False)]
    v = tg.model.target_vocabulary
    # The requests with options first, those whose option tables grow in
    # the first wave of admits: the JAX batcher recompiles its step for
    # each table that grows, and admits in submission order.
    return [
        (ps[1], dict(max_length=MAX_LENGTH, stop_sequences=[best[1][3:5]])),
        (ps[0], dict(max_length=MAX_LENGTH,
                     suppress_tokens=[v.to_token(t) for t in best[0][:2]])),
        (ps[2], dict(max_length=MAX_LENGTH, repetition_penalty=1.5)),
        (ps[0], dict(max_length=MAX_LENGTH, min_length=4,
                     end_token=[v.to_token(best[0][1]), v.to_token(best[0][4])])),
        (ps[3], dict(max_length=MAX_LENGTH, no_repeat_ngram_size=2, num_hypotheses=2)),
    ] + reqs


def run_batcher(module, gen, reqs, **kw):
    """Every request but the last submitted at once; the last once the
    first has finished (joining the slots that decode)."""
    cb = module.ContinuousBatcher(gen, **kw)
    try:
        futures = [cb.submit(p, **o) for p, o in reqs[:-1]]
        futures[0].result(timeout=600)
        futures.append(cb.submit(reqs[-1][0], **reqs[-1][1]))
        return [f.result(timeout=600) for f in futures], cb.stats()
    finally:
        cb.close()


def last_id_suppressed(tg, kind, kw):
    if kind != "options":
        return kw
    v = tg.model.target_vocabulary
    return dict(kw, suppress_tokens=[v.to_token(len(v) - 1)])


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return {name: jbuilder.build_decoder_only_model(
        str(tmp_path_factory.mktemp(name)), **build)
        for name, (build, _) in MODELS.items()}


@pytest.fixture(scope="module")
def served(paths):
    """case -> (port Generator, requests, JAX results, port results, port
    stats)."""
    out = {}
    for case, (model, kw, kind) in CASES.items():
        with kv_cache(MODELS[model][1]):
            tg = tt.Generator(paths[model], device="cpu")
            reqs = requests_for(tg, model, kind, kw["beam_size"])
            kw = last_id_suppressed(tg, kind, kw)
            ref, _ = run_batcher(ct, ct.Generator(paths[model]), reqs, **kw)
            got, stats = run_batcher(tt, tg, reqs, **kw)
        out[case] = (tg, reqs, ref, got, stats)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_batcher_matches_jax_batcher(served, case):
    tg, reqs, ref, got, stats = served[case]
    model, kw, _ = CASES[case]
    tol = INT8_KV_TOL if MODELS[model][1] == "int8" else TOL
    assert len(got) == len(ref) == len(reqs) > kw["num_slots"]
    for (prompt, opts), o, r in zip(reqs, got, ref):
        assert o.sequences_ids == r.sequences_ids, opts
        assert o.sequences == r.sequences
        np.testing.assert_allclose(o.scores, r.scores, atol=tol, rtol=0)
        n = opts.get("num_hypotheses") or kw.get("num_hypotheses", 1)
        assert len(o.sequences_ids) == n
        assert all(len(h) <= opts["max_length"] for h in o.sequences_ids)
    assert stats["num_requests"] == len(reqs)
    assert stats["num_tokens"] == sum(len(o.sequences_ids[0]) for o in got)


def test_beam_options_took_effect(served):
    tg, reqs, _, got, _ = served["rotary_beam2"]
    plain = {tuple(p): o.sequences_ids[0] for (p, opts), o in zip(reqs, got)
             if len(opts) == 1}
    v = tg.model.target_vocabulary
    for (p, opts), o in zip(reqs, got):
        ids = o.sequences_ids[0]
        if "min_length" in opts:
            assert len(ids) >= 4
            ends = {v.to_id(t) for t in opts["end_token"]}
            assert not ends & set(ids)
        if "stop_sequences" in opts:
            stop = list(opts["stop_sequences"][0])
            assert all(ids[i:i + len(stop)] != stop for i in range(len(ids)))
            assert ids != plain[tuple(p)]
        if "suppress_tokens" in opts:
            banned = {v.to_id(t) for t in opts["suppress_tokens"]}
            assert not banned & set(ids)
        if "no_repeat_ngram_size" in opts:
            for h in o.sequences_ids:
                pairs = list(zip(h, h[1:]))
                assert len(pairs) == len(set(pairs))
            assert o.scores[0] >= o.scores[1]


@pytest.fixture(scope="module")
def streamed(served, paths):
    """Two requests with callbacks through one batcher of each package (beam
    2, no global suppression): the min_length request of ``rotary_beam2``
    and a plain one. module -> [(result, GenerationStepResults)]."""
    tg, reqs, _, _, _ = served["rotary_beam2"]
    p, opts = next((p, o) for p, o in reqs if "min_length" in o)
    subs = [(p, opts), (prompts(1, seed=2)[0], dict(max_length=MAX_LENGTH))]
    out = {}
    for module, gen in ((ct, ct.Generator(paths["rotary"])), (tt, tg)):
        cb = module.ContinuousBatcher(gen, num_slots=2, capacity=64, beam_size=2,
                                      steps_per_sync=2, pipeline_depth=1)
        try:
            seen = [[] for _ in subs]
            fs = [cb.submit(q, callback=lambda sr, i=i: seen[i].append(sr) or False, **o)
                  for i, (q, o) in enumerate(subs)]
            out[module.__name__] = [(f.result(timeout=600), calls)
                                    for f, calls in zip(fs, seen)]
        finally:
            cb.close()
    return subs, out


def test_jax_beam_batcher_pads_to_the_last_id(served, streamed):
    """Without the global suppression, the JAX beam step disables the last
    vocabulary id for a request during its min_length (the end table's -1
    padding); the port does not. The first committed token's score shows
    it: the two log-softmaxes part by the last id's share of the mass."""
    tg = served["rotary_beam2"][0]
    (p, opts), _ = streamed[0]
    port = streamed[1]["ctranslate2_tpu_torch"][0][1][0]
    jax_first = streamed[1]["ctranslate2_tpu"][0][1][0]
    assert port.token_id == jax_first.token_id
    v = tg.model.target_vocabulary
    ids = [[v.to_id(t) for t in p]]
    lp = torch.log_softmax(tg.forward_batch(ids)[0, len(p) - 1].float(), -1)
    keep = torch.ones_like(lp, dtype=torch.bool)
    keep[[v.to_id(t) for t in opts["end_token"]]] = False
    port_mass = torch.logsumexp(lp[keep], -1).item()
    keep[-1] = False
    jax_mass = torch.logsumexp(lp[keep], -1).item()
    assert abs((jax_first.score - port.score) - (port_mass - jax_mass)) < 1e-4
    assert port_mass - jax_mass > 1e-6


@pytest.mark.parametrize("depth", [1, 2])
def test_beam_matches_generate_batch(served, depth):
    """Beam serving equals the port's own generate_batch, for requests
    that outnumber the slots and one that joins while the others decode,
    at pipeline depth 1 and 2."""
    tg = served["rotary_beam2"][0]
    ps = prompts(4, seed=11)
    for beam, extra in ((2, {}), (3, dict(num_hypotheses=2, length_penalty=1.0))):
        exp = [tg.generate_batch([p], max_length=MAX_LENGTH, beam_size=beam,
                                 include_prompt_in_result=False, return_scores=True,
                                 **extra)[0] for p in ps]
        got, _ = run_batcher(tt, tg, [(p, dict(max_length=MAX_LENGTH)) for p in ps],
                             num_slots=2, capacity=64, beam_size=beam, steps_per_sync=3,
                             pipeline_depth=depth, **extra)
        for e, g in zip(exp, got):
            assert g.sequences_ids == e.sequences_ids
            np.testing.assert_allclose(g.scores, e.scores, atol=TOL, rtol=0)


def test_jax_beam_batcher_cuts_requests_admitted_in_flight(served, paths):
    """At pipeline depth 2 the JAX beam batcher reads a block that was
    dispatched before an admit as the admitted slot's flags: the request
    finishes after one block, its hypothesis cut short. The port keeps a
    slot's flag from blocks that saw its previous request."""
    ps = prompts(3, seed=4)
    tg = served["rotary_beam2"][0]
    exp = [tg.generate_batch([p], max_length=MAX_LENGTH, beam_size=2,
                             include_prompt_in_result=False)[0].sequences_ids[0]
           for p in ps]
    gen = ct.Generator(paths["rotary"])
    kw = dict(num_slots=1, capacity=64, beam_size=2, steps_per_sync=4)
    cut, _ = run_batcher(ct, gen, [(p, dict(max_length=MAX_LENGTH)) for p in ps],
                         pipeline_depth=2, **kw)
    assert cut[0].sequences_ids[0] == exp[0]
    assert len(cut[1].sequences_ids[0]) == kw["steps_per_sync"] < len(exp[1])
    port, _ = run_batcher(tt, tg, [(p, dict(max_length=MAX_LENGTH)) for p in ps],
                          pipeline_depth=2, **kw)
    assert [r.sequences_ids[0] for r in port] == exp


# ---------------------------------------------------------------------------
# The beam draws fed the JAX package's noise.
# ---------------------------------------------------------------------------

# Per row: (topk, topp, temperature, seed).
ROWS = [(1, 1.0, 1.0, 0), (0, 0.9, 0.7, 3), (5, 1.0, 1.3, 4), (40, 0.5, 1.0, 5),
        (1, 0.3, 1.0, 6), (3, 0.8, 2.0, 7)]


def _flat_scores(rows, width, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, width)) * 3).astype(np.float32)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("k", [4, 6])
def test_gumbel_top_k_per_row_matches_fed_jax_noise(step, k):
    W = 3 * 100
    flat = _flat_scores(len(ROWS), W, seed=20 + step)
    topks, topps, temps, seeds = (np.array(c) for c in zip(*ROWS))
    key = jax.random.fold_in(jax.random.PRNGKey(9), step)
    ref_s, ref_i = jax.jit(js.gumbel_top_k_per_row, static_argnums=2,
                           static_argnames="max_topk")(
        jnp.asarray(flat), key, k, topks=jnp.asarray(topks, jnp.int32),
        topps=jnp.asarray(topps, jnp.float32), temps=jnp.asarray(temps, jnp.float32),
        seeds=jnp.asarray(seeds, jnp.int32), max_topk=64)
    # The JAX draw's own noise: row s's field from fold_in(key, seed_s).
    noise = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(key, int(s)), (W,), jnp.float32)) for s in seeds])
    got_s, got_i = ts.gumbel_top_k_per_row(
        torch.from_numpy(flat), torch.from_numpy(noise), k,
        topks=torch.from_numpy(topks.astype(np.int64)),
        topps=torch.from_numpy(topps.astype(np.float32)),
        temps=torch.from_numpy(temps.astype(np.float32)), max_topk=64)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-6, rtol=0)
    # The greedy rows draw nothing: any noise gives their top-k.
    greedy = topks == 1
    det = ts.small_top_k(torch.from_numpy(flat[greedy]), k)[1]
    np.testing.assert_array_equal(got_i.numpy()[greedy], det.numpy())


@pytest.mark.parametrize("options", [dict(), dict(topk=7), dict(topp=0.8, temperature=0.6),
                                     dict(topk=20, topp=0.9, temperature=1.5)])
def test_gumbel_top_k_matches_fed_jax_noise(options):
    flat = _flat_scores(3, 250, seed=31)
    key = jax.random.PRNGKey(4)
    ref_s, ref_i = jax.jit(js.gumbel_top_k, static_argnums=2,
                           static_argnames=tuple(options))(jnp.asarray(flat), key, 5,
                                                           **options)
    u = np.array(jax.random.uniform(key, flat.shape, minval=1e-20, maxval=1.0))
    got_s, got_i = ts.gumbel_top_k(torch.from_numpy(flat), torch.from_numpy(u), 5,
                                   **options)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Streaming, sampling and validation.
# ---------------------------------------------------------------------------

def _beam(served, **kw):
    tg = served["rotary_beam2"][0]
    kw.setdefault("num_slots", 2)
    kw.setdefault("capacity", 96)
    kw.setdefault("beam_size", 2)
    return tg, tt.ContinuousBatcher(tg, **kw)


def test_beam_streaming_contract(streamed):
    """The callback gets the committed tokens: those of the final best
    hypothesis, in order, one ``is_last``, per-token scores summing to the
    raw score; the JAX batcher's callback gets the same tokens and scores."""
    r, seen = streamed[1]["ctranslate2_tpu_torch"][1]
    jr, jseen = streamed[1]["ctranslate2_tpu"][1]
    assert [s.token_id for s in seen] == r.sequences_ids[0] == jr.sequences_ids[0]
    assert [s.step for s in seen] == list(range(len(seen)))
    assert [s.is_last for s in seen].count(True) == 1 and seen[-1].is_last
    assert sum(s.score for s in seen) == pytest.approx(r.scores[0] * len(seen), abs=1e-4)
    assert [s.token_id for s in jseen] == [s.token_id for s in seen]
    np.testing.assert_allclose([s.score for s in seen], [s.score for s in jseen],
                               atol=TOL, rtol=0)


def test_beam_callback_early_stop_and_exception(served):
    tg, cb = _beam(served, num_slots=1, steps_per_sync=2)
    try:
        got = []
        r = cb.submit(["tok1", "tok2"], max_length=48,
                      callback=lambda sr: got.append(sr.token_id) or len(got) >= 3).result(
            timeout=600)
        assert len(got) >= 3
        assert r.sequences_ids[0][:len(got)] == got
        assert len(r.sequences_ids[0]) < 48

        def boom(sr):
            raise KeyError("beam callback failed")

        with pytest.raises(KeyError, match="beam callback failed"):
            cb.submit(["tok1", "tok2"], max_length=32, callback=boom).result(timeout=600)
        # The slot is free again and the batcher keeps serving.
        exp = tg.generate_batch([["tok3"]], max_length=8, beam_size=2,
                                include_prompt_in_result=False)[0].sequences_ids[0]
        assert cb.submit(["tok3"], max_length=8).result(timeout=600).sequences_ids[0] == exp
    finally:
        cb.close()


def test_beam_mixed_greedy_and_sampled(served):
    """A request with topk 1 keeps the argmax beams beside sampled ones; a
    sampled request repeats under its seed, here and alone in another
    batcher, and another seed draws otherwise."""
    tg, cb = _beam(served, num_slots=4, steps_per_sync=3)
    p = ["tok1", "tok2"]
    exp = tg.generate_batch([p], max_length=MAX_LENGTH, beam_size=2,
                            include_prompt_in_result=False)[0].sequences_ids[0]
    sampled = dict(max_length=MAX_LENGTH, sampling_topk=0, sampling_temperature=5.0)
    try:
        fs = [cb.submit(p, max_length=MAX_LENGTH, sampling_topk=1),
              cb.submit(p, seed=3, **sampled), cb.submit(p, seed=3, **sampled),
              cb.submit(p, seed=4, **sampled)]
        g, a, b, c = (f.result(timeout=600) for f in fs)
        assert g.sequences_ids[0] == exp
        assert a.sequences_ids == b.sequences_ids and a.scores == b.scores
        assert a.sequences_ids != c.sequences_ids
        assert all(s <= 0 for s in a.scores)
    finally:
        cb.close()
    tg, alone = _beam(served, num_slots=1, steps_per_sync=4)
    try:
        assert alone.submit(p, seed=3, **sampled).result(timeout=600).sequences_ids == \
            a.sequences_ids
    finally:
        alone.close()


def test_beam_validation_errors(served):
    tg = served["rotary_beam2"][0]
    with pytest.raises(NotImplementedError, match="greedy"):
        tt.ContinuousBatcher(tg, beam_size=2, speculation_k=3)
    with pytest.raises(NotImplementedError, match="greedy"):
        tt.ContinuousBatcher(tg, beam_size=2, draft_model="draft")
    with pytest.raises(ValueError, match="num_hypotheses"):
        tt.ContinuousBatcher(tg, beam_size=2, num_hypotheses=3)
    tg, cb = _beam(served, capacity=32)
    try:
        with pytest.raises(ValueError, match="num_hypotheses"):
            cb.submit(["tok1"], max_length=8, num_hypotheses=3)
        with pytest.raises(ValueError, match="capacity"):
            cb.submit(["tok1"] * 20, max_length=16)
        with pytest.raises(ValueError, match="wrap single tokens"):
            cb.submit(["tok1"], max_length=4, stop_sequences=["</s>"])
    finally:
        cb.close()
    greedy = tt.ContinuousBatcher(tg, num_slots=1, capacity=32)
    try:
        with pytest.raises(NotImplementedError, match="beam"):
            greedy.submit(["tok1"], max_length=8, num_hypotheses=2)
    finally:
        greedy.close()
