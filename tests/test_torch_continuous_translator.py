"""``ContinuousTranslator`` and ``ContinuousWhisper`` against the JAX
package's, on the CPU.

- ``ContinuousTranslator``, greedy and beam 2, on builder seq2seq models
  (2 layers, d_model 64, vocabulary 96): float32, int8, merged self+cross
  attention, two source factors, the Shaw seq2seq of
  ``test_torch_positions_bias.py``, and a model whose
  ``decoder_start_token`` is null (the target prefix's first token takes
  its role; beam 2 only). Requests outnumber the slots; target prefixes of
  different lengths stagger the slots' positions. Both packages run at
  pipeline depth 1, the JAX batcher once per model and mode (module
  fixture): the tokens are equal, the scores within ``TOL``.
- ``ContinuousWhisper``, greedy and beam 3, with and without timestamp
  rules (prompts with and without ``<|notimestamps|>``) on
  ``build_whisper_model``'s directory: without them the tokens equal the
  JAX batcher's, the scores within ``TOL``; with them and without, the
  tokens equal the port's ``Whisper.generate``, and every timestamped
  result keeps the rules (a timestamp first, pairs that never decrease).
  The JAX batcher skips the initial-timestamp rule (ROADMAP queue 3); one
  test shows it.
- The per-row ``whisper_timestamp_rules`` (``gen_len`` and
  ``sample_begin`` int [N] tensors) equals the JAX package's on random
  logits and histories.
- Streaming, ``translate_batch`` agreement and validation errors.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
from ctranslate2_tpu.decoding import processors as jp
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.decoding import processors as tp
from test_torch_positions_bias import add_shaw_tables

TOL = 1e-4
SEQ2SEQ = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96)
MODELS = {
    "float32": dict(SEQ2SEQ),
    "int8": dict(SEQ2SEQ, quantization="int8"),
    "merged": dict(SEQ2SEQ, merged_attention=True),
    "factors": dict(SEQ2SEQ, num_source_features=2),
    "shaw": dict(SEQ2SEQ),
    "null_start": dict(SEQ2SEQ),
}
# The beam widths each model serves (the start token's handling is the
# same in both modes).
BEAMS = dict({name: (1, 2) for name in MODELS}, null_start=(2,))
MAX_LENGTH = 10
KW = dict(num_slots=2, capacity=64, max_source_len=16, steps_per_sync=3, pipeline_depth=1)


def sources(name, n=5, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for length in (6, 11, 4, 9, 7)[:n]:
        toks = [f"tok{int(t)}" for t in rng.integers(3, 90, length)]
        if name == "factors":
            toks = [f"{t}￨tok{int(f)}" for t, f in zip(toks, rng.integers(0, 12, length))]
        out.append(toks)
    return out


def requests_for(name):
    """(source, submit options): staggered target prefixes and, on the
    float32 model, per-request options."""
    src = sources(name)
    prefix = [None, ["tok4", "tok8"], None, ["tok7"], ["tok9", "tok3", "tok5"]]
    if name == "null_start":
        prefix = [["<s>"] + (p or []) for p in prefix]
    reqs = [(s, dict(max_length=MAX_LENGTH, min_length=2,
                     **({"target_prefix": p} if p else {})))
            for s, p in zip(src, prefix)]
    if name == "float32":
        # First: the JAX batcher recompiles its step when the penalty
        # tables appear, and admits in submission order.
        reqs = [(src[0], dict(max_length=MAX_LENGTH, repetition_penalty=1.5,
                              no_repeat_ngram_size=2)),
                (src[1], dict(max_length=MAX_LENGTH, end_token=["tok11", "</s>"]))] + reqs
    return reqs


def run(module, cls, task, reqs, **kw):
    cb = getattr(module, cls)(task, **kw)
    try:
        futures = [cb.submit(s, **o) for s, o in reqs]
        return [f.result(timeout=600) for f in futures]
    finally:
        cb.close()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}
    for name, build in MODELS.items():
        path = jbuilder.build_seq2seq_model(str(tmp_path_factory.mktemp(name)), **build)
        if name == "shaw":
            add_shaw_tables(path)
        if name == "null_start":
            cfg_path = os.path.join(path, "config.json")
            with open(cfg_path) as f:
                cfg = json.load(f)
            cfg["decoder_start_token"] = None
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
        out[name] = path
    return out


@pytest.fixture(scope="module")
def translated(dirs):
    """(name, beam) -> (requests, JAX results, port results)."""
    out = {}
    for name, path in dirs.items():
        reqs = requests_for(name)
        jt, pt = ct.Translator(path), tt.Translator(path, device="cpu")
        # The JAX package's per-row tables turn their -1 padding into the
        # last id (ROADMAP queue 3): suppressed for every request.
        kw = dict(KW, suppress_tokens=["tok92"])
        for beam in BEAMS[name]:
            ref = run(ct, "ContinuousTranslator", jt, reqs, beam_size=beam, **kw)
            got = run(tt, "ContinuousTranslator", pt, reqs, beam_size=beam, **kw)
            out[name, beam] = (reqs, ref, got)
    return out


@pytest.mark.parametrize("name,beam", [(n, b) for n in sorted(MODELS) for b in BEAMS[n]])
def test_translator_matches_jax(translated, name, beam):
    reqs, ref, got = translated[name, beam]
    assert len(got) == len(ref) == len(reqs) > KW["num_slots"]
    for (src, opts), o, r in zip(reqs, got, ref):
        assert o.sequences_ids == r.sequences_ids, opts
        np.testing.assert_allclose(o.scores, r.scores, atol=TOL, rtol=0)
        prefix = opts.get("target_prefix") or []
        if name == "null_start":
            prefix = prefix[1:]
        assert o.sequences[0][:len(prefix)] == prefix
        assert len(o.sequences_ids[0]) >= min(opts.get("min_length", 0) + len(prefix),
                                              MAX_LENGTH)


def test_translator_matches_translate_batch(dirs):
    """Greedy and beam 2 serving give translate_batch's hypotheses,
    prefixes included. A beam request's score is its hypothesis's
    teacher-forced log-prob (``score_batch``, the end token counted)
    normalized by its length, with the forced prefix at score 0, as
    translate_batch's is where a prefix is forced. (Unforced, that batch
    search's score of a hypothesis one token long parts from the
    teacher-forced one by about 1e-2, in the JAX package too.) A greedy
    request's score is its tokens' log-prob sum, as in the JAX package."""
    tr = tt.Translator(dirs["float32"], device="cpu")
    # Without min_length: serving counts it past the prefix.
    reqs = [(s, {k: v for k, v in o.items() if k != "min_length"})
            for s, o in requests_for("float32")[2:]]
    for beam in (1, 2):
        got = run(tt, "ContinuousTranslator", tr, reqs, beam_size=beam, **KW)
        for (src, opts), g in zip(reqs, got):
            prefix = opts.get("target_prefix")
            exp = tr.translate_batch(
                [src], beam_size=beam, max_decoding_length=MAX_LENGTH,
                return_scores=True, target_prefix=[prefix])[0]
            assert g.sequences == [exp.hypotheses[0]]
            if beam == 1 or len(g.sequences[0]) == MAX_LENGTH:
                continue
            if prefix:
                assert abs(g.scores[0] - exp.scores[0]) < TOL
            else:
                forced = tr.score_batch([src], [g.sequences[0]])[0].tokens_score
                n = len(forced)  # the end token included
                assert abs(g.scores[0] - sum(forced) / n) < TOL


def test_translator_counts_the_source_eos_in_max_source_len(dirs, tmp_path):
    """On a model that appends EOS to the source, ``max_source_len`` holds
    the source with its EOS: a source one token short serves as
    ``translate_batch`` translates it, one at the limit is refused rather
    than cut."""
    path = str(tmp_path / "eos")
    shutil.copytree(dirs["float32"], path)
    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["add_source_eos"] = True
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    tr = tt.Translator(path, device="cpu")
    rng = np.random.default_rng(4)
    src = [f"tok{int(t)}" for t in rng.integers(3, 90, KW["max_source_len"] - 1)]
    exp = tr.translate_batch([src], beam_size=1,
                             max_decoding_length=MAX_LENGTH)[0].hypotheses[0]
    cb = tt.ContinuousTranslator(tr, **KW)
    try:
        assert cb.submit(src, max_length=MAX_LENGTH).result(timeout=600).sequences[0] == exp
        with pytest.raises(ValueError, match="max_source_len"):
            cb.submit(src + ["tok5"], max_length=MAX_LENGTH)
    finally:
        cb.close()


def test_translator_streams_and_validates(dirs):
    tr = tt.Translator(dirs["float32"], device="cpu")
    src = sources("float32", 1)[0]
    for beam in (1, 2):
        cb = tt.ContinuousTranslator(tr, beam_size=beam, **KW)
        try:
            seen = []
            r = cb.submit(src, max_length=MAX_LENGTH, target_prefix=["tok4", "tok8"],
                          callback=lambda sr: seen.append(sr) or False).result(timeout=600)
            assert [s.token_id for s in seen][:len(r.sequences_ids[0])] == r.sequences_ids[0]
            assert r.sequences[0][:2] == ["tok4", "tok8"]
            assert [s.is_last for s in seen].count(True) == 1
            with pytest.raises(ValueError, match="max_source_len"):
                cb.submit(["tok1"] * 17, max_length=8)
            with pytest.raises(ValueError, match="at least one token"):
                cb.submit([], max_length=8)
            with pytest.raises(ValueError, match="max_target_prefix"):
                cb.submit(src, max_length=8, target_prefix=["tok1"] * 33)
            with pytest.raises(ValueError, match="capacity"):
                cb.submit(src, max_length=64)
        finally:
            cb.close()
    null = tt.Translator(dirs["null_start"], device="cpu")
    cb = tt.ContinuousTranslator(null, **KW)
    try:
        with pytest.raises(ValueError, match="target prefix as the decoder start token"):
            cb.submit(src, max_length=8)
    finally:
        cb.close()
    with pytest.raises(ValueError, match="encoder-decoder"):
        tt.ContinuousTranslator(tt.Generator(
            jbuilder.build_decoder_only_model(os.path.join(dirs["float32"] + "_gen")),
            device="cpu"))
    shutil.rmtree(dirs["float32"] + "_gen", ignore_errors=True)


# ---------------------------------------------------------------------------
# Whisper.
# ---------------------------------------------------------------------------

PROMPT_TS = ["<|startoftranscript|>", "<|en|>", "<|transcribe|>"]
PROMPT_NO_TS = PROMPT_TS + ["<|notimestamps|>"]


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    return jbuilder.build_whisper_model(str(tmp_path_factory.mktemp("whisper")))[0]


def _features(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((24, 64)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def transcribed(whisper_dir):
    """beam -> (prompts, JAX results, port results)."""
    jw, pw = ct.Whisper(whisper_dir), tt.Whisper(whisper_dir, device="cpu")
    feats = _features(5)
    reqs = [(f, PROMPT_TS if i % 2 == 0 else PROMPT_NO_TS) for i, f in enumerate(feats)]
    out = {}
    for beam in (1, 3):
        kw = dict(num_slots=2, capacity=64, beam_size=beam, steps_per_sync=4,
                  pipeline_depth=1)
        res = {}
        for module, w in ((ct, jw), (tt, pw)):
            cb = module.ContinuousWhisper(w, **kw)
            try:
                fs = [cb.submit(f, p, max_length=16) for f, p in reqs]
                res[module.__name__] = [x.result(timeout=600) for x in fs]
            finally:
                cb.close()
        out[beam] = (reqs, res["ctranslate2_tpu"], res["ctranslate2_tpu_torch"])
    return out, pw.model.target_vocabulary


def _timestamps_well_formed(tokens, ts_begin, eot_id, max_initial=50):
    """Whether the tokens sampled after a timestamped prompt keep the
    timestamp rules that show in the output: a timestamp first (at most
    ``max_initial`` past the first), which stands as a pair; no timestamp
    after a pair, no text token after a lone timestamp; a pair's second
    timestamp not below its first, any other above every earlier one; no
    ``<|notimestamps|>``."""
    if not tokens or not ts_begin <= tokens[0] <= ts_begin + max_initial:
        return False
    latest = tokens[0]
    for i in range(1, len(tokens)):
        x, last = tokens[i], tokens[i - 1]
        penult = tokens[i - 2] if i >= 2 else last  # the first timestamp stands as a pair
        if x == ts_begin - 1:  # <|notimestamps|>
            return False
        if last >= ts_begin and penult >= ts_begin:
            bad = x >= ts_begin  # text after a pair
        elif last >= ts_begin:
            bad = x < eot_id or ts_begin <= x < last  # no text after a lone timestamp
        else:
            bad = ts_begin <= x <= latest  # a new timestamp goes past every earlier one
        if bad:
            return False
        if x >= ts_begin:
            latest = x
    return True


def _well_formed(gen, v):
    """``_timestamps_well_formed``, with at least one pair (this data makes
    one in every timestamped result; the rules ask for none)."""
    ts_begin = v.to_id("<|notimestamps|>") + 1
    runs = "".join("t" if t >= ts_begin else "w" for t in gen)
    return _timestamps_well_formed(gen, ts_begin, v.to_id("<|endoftext|>")) and "tt" in runs


@pytest.mark.parametrize("beam", [1, 3])
def test_whisper_matches_jax(transcribed, beam):
    """With ``<|notimestamps|>`` the port transcribes as the JAX batcher
    does. With timestamp rules the JAX batcher skips the initial-timestamp
    rule (ROADMAP queue 3), so the port's results are held to the rules
    here and to ``Whisper.generate`` below."""
    (out, v) = transcribed
    reqs, ref, got = out[beam]
    for (_, prompt), o, r in zip(reqs, got, ref):
        assert o.sequences[0][:len(prompt) - 1] == prompt[1:]
        if prompt is PROMPT_NO_TS:
            assert o.sequences_ids == r.sequences_ids
            np.testing.assert_allclose(o.scores, r.scores, atol=TOL, rtol=0)
        else:
            assert _well_formed(o.sequences_ids[0][len(prompt) - 1:], v)


def _generate(module, whisper_dir, reqs, beam):
    """``Whisper.generate`` on each request, its max_length covering the
    serving steps (serving forces the prompt, ``generate`` prefills it)."""
    w = module.Whisper(whisper_dir, **({"device": "cpu"} if module is tt else {}))
    return [w.generate(feats[None], [prompt], beam_size=beam,
                       max_length=2 * (16 - len(prompt) + 1), suppress_blank=False)[0]
            for feats, prompt in reqs]


@pytest.mark.parametrize("beam", [1, 3])
def test_whisper_serving_against_generate(transcribed, whisper_dir, beam):
    """Serving transcribes as ``Whisper.generate`` does
    (``suppress_blank=False``), with and without timestamp rules: the
    rules see the steps past the forced prompt, so the first sampled token
    takes the initial-timestamp rule in both."""
    (out, v) = transcribed
    reqs, ref, got = out[beam]
    for (_, prompt), o, e in zip(reqs, got, _generate(tt, whisper_dir, reqs, beam)):
        assert o.sequences_ids[0][len(prompt) - 1:] == e.sequences_ids[0]


def test_jax_whisper_batcher_skips_the_initial_timestamp_rule(transcribed, whisper_dir):
    """The JAX ``ContinuousWhisper`` passes the forced prompt's length as
    ``sample_begin``, and its ``whisper_timestamp_rules`` takes the
    initial-timestamp rule only at step 0 of a row with none: a timestamped
    request's first sampled token need not be a timestamp there, where the
    JAX package's own ``Whisper.generate`` starts with one (ROADMAP queue
    3)."""
    (out, v) = transcribed
    reqs, ref, _ = out[1]
    ts_begin = v.to_id("<|notimestamps|>") + 1
    ts = [(r, p) for r, p in zip(reqs, ref) if r[1] is PROMPT_TS]
    gen = _generate(ct, whisper_dir, [r for r, _ in ts], 1)
    assert all(e.sequences_ids[0][0] >= ts_begin for e in gen)
    assert not all(p.sequences_ids[0][len(PROMPT_TS) - 1] >= ts_begin for _, p in ts)


def test_whisper_validates(whisper_dir):
    w = tt.Whisper(whisper_dir, device="cpu")
    cb = tt.ContinuousWhisper(w, num_slots=1, capacity=64)
    try:
        with pytest.raises(ValueError, match="one segment"):
            cb.submit(_features(1)[0][None], PROMPT_TS, max_length=8)
        with pytest.raises(ValueError, match="encoder capacity"):
            cb.submit(np.zeros((24, 2 * cb._max_src + 2), np.float32), PROMPT_TS,
                      max_length=8)
        with pytest.raises(ValueError, match="max_target_prefix"):
            cb.submit(_features(1)[0], PROMPT_TS * 6, max_length=8)
        with pytest.raises(ValueError, match="at least one token"):
            cb.submit(_features(1)[0], [], max_length=8)
        with pytest.raises(ValueError, match="capacity"):
            cb.submit(_features(1)[0], PROMPT_TS, max_length=64)
    finally:
        cb.close()
    with pytest.raises(ValueError, match="speech model"):
        tt.ContinuousWhisper(type("W", (), {"model": tt.Translator(
            jbuilder.build_seq2seq_model(whisper_dir + "_s2s", **SEQ2SEQ),
            device="cpu").model})())
    shutil.rmtree(whisper_dir + "_s2s", ignore_errors=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_row_timestamp_rules_match_jax(seed):
    """``gen_len`` and ``sample_begin`` as [N] tensors, histories mixing
    text tokens and timestamps."""
    rng = np.random.default_rng(seed)
    N, V, L = 12, 60, 20
    eot, no_ts, ts_begin = 20, 29, 30
    wts = (eot, no_ts, ts_begin, V - 1, ts_begin + 10)
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    hist = rng.integers(0, V, (N, L)).astype(np.int64)
    gen_len = rng.integers(0, L, N).astype(np.int64)
    gen_len[:2] = 0
    sample_begin = np.minimum(rng.integers(0, 4, N), gen_len).astype(np.int64)
    sample_begin[0] = 0
    rules = jax.jit(jp.whisper_timestamp_rules, static_argnums=(4, 5, 6, 7, 8))
    ref = rules(jnp.asarray(logits), jnp.asarray(hist, jnp.int32),
                jnp.asarray(gen_len, jnp.int32), jnp.asarray(sample_begin, jnp.int32), *wts)
    got = tp.whisper_timestamp_rules(torch.from_numpy(logits), torch.from_numpy(hist),
                                     torch.from_numpy(gen_len),
                                     torch.from_numpy(sample_begin), *wts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # A scalar gen_len and sample_begin is every row's.
    ref = rules(jnp.asarray(logits), jnp.asarray(hist, jnp.int32), 5, 2, *wts)
    got = tp.whisper_timestamp_rules(torch.from_numpy(logits), torch.from_numpy(hist),
                                     5, 2, *wts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
