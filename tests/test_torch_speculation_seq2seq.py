"""Lossless speculation in ``ContinuousTranslator`` and
``ContinuousWhisper`` against the JAX package's, on the CPU.

- ``ContinuousTranslator`` (speculation_k 4) with prompt-lookup drafts
  (drafted from the target side) and with a draft cut from the target's own
  file (its encoder, embeddings and decoder layer 0), on a builder seq2seq
  model (2 layers, d_model 64, vocabulary 96), the T5 model the JAX
  package's converter writes and the Shaw seq2seq of
  ``test_torch_positions_bias.py``. Requests outnumber the slots and carry
  target prefixes of different lengths (forced a position each inside the
  verify, and inside the draft's loop). The tokens equal the JAX
  batcher's (run once per model in a module fixture) and
  ``translate_batch(beam_size=1)``'s, the scores within ``TOL``.
- ``ContinuousWhisper`` (speculation_k 3) with and without a draft cut
  from ``build_whisper_model``'s directory (its encoder and first decoder
  layer), on ``<|notimestamps|>`` requests: the tokens equal the JAX
  batcher's and ``Whisper.generate``'s; a timestamped request is refused.
- The draft validation errors are the JAX package's.
"""

import shutil

import numpy as np
import pytest

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.formats.model_file import load_model_file
from test_torch_positions_bias import add_shaw_tables, convert

TOL = 1e-4
SEQ2SEQ = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96)
KW = dict(num_slots=2, capacity=64, max_source_len=24, steps_per_sync=3)
MAX_LENGTH = 10
# (model, speculation_k, draft)
RUNS = [("float32", 4, None), ("float32", 4, "layer0"), ("t5", 4, None),
        ("shaw", 4, None)]


def cut_decoder(src, dst, keep):
    """A copy of the model directory ``src`` in ``dst`` whose decoder keeps
    only the layers ``keep`` (renumbered from 0); the encoder, embeddings,
    projection and vocabularies are the source's."""
    import re

    shutil.copytree(src, dst)
    mf = load_model_file(src)
    names = list(mf.variables)
    for name in names:
        m = re.match(r"decoder/layer_(\d+)/(.*)", name)
        if m is None:
            continue
        var = mf.variables.pop(name)
        if int(m.group(1)) in keep:
            new = f"decoder/layer_{keep.index(int(m.group(1)))}/{m.group(2)}"
            var.name = new
            mf.variables[new] = var
    mf.save(dst)
    return dst


def sources(prefix, seed=2, n=5, high=90):
    rng = np.random.default_rng(seed)
    lengths = (6, 11, 4, 9, 7)[:n]
    srcs = [[f"{prefix}{int(t)}" for t in rng.integers(4, high, length)] for length in lengths]
    srcs[3] = srcs[3][:5] * 3  # a repetitive source: prompt lookup finds matches
    return srcs


def requests_for(name):
    """(source, submit options): staggered target prefixes."""
    if name == "t5":
        src = sources("tk", high=60)
        prefix = [None, ["tk4", "tk8"], None, ["tk7"], ["tk9", "tk11", "tk5"]]
    else:
        src = sources("tok")
        prefix = [None, ["tok4", "tok8"], None, ["tok7"], ["tok9", "tok3", "tok5"]]
    return [(s, dict(max_length=MAX_LENGTH, **({"target_prefix": p} if p else {})))
            for s, p in zip(src, prefix)]


def run(module, cls, task, reqs, **kw):
    cb = getattr(module, cls)(task, **kw)
    try:
        futures = [cb.submit(*s, **o) if cls == "ContinuousWhisper" else cb.submit(s, **o)
                   for s, o in reqs]
        return [f.result(timeout=600) for f in futures], cb.stats()
    finally:
        cb.close()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    import torch
    import transformers

    out = {}
    out["float32"] = jbuilder.build_seq2seq_model(
        str(tmp_path_factory.mktemp("float32")), **SEQ2SEQ)
    out["layer0"] = cut_decoder(out["float32"], str(tmp_path_factory.mktemp("l0") / "m"),
                                [0])
    out["shaw"] = add_shaw_tables(jbuilder.build_seq2seq_model(
        str(tmp_path_factory.mktemp("shaw")), **SEQ2SEQ))
    torch.manual_seed(0)
    cfg = transformers.T5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        feed_forward_proj="gated-gelu", decoder_start_token_id=0,
        tie_word_embeddings=False)
    out["t5"] = convert(transformers.T5ForConditionalGeneration(cfg),
                        tmp_path_factory.mktemp("t5"))
    return out


def suppress_last(path):
    """The JAX batcher's per-row tables turn their -1 padding into the last
    id (ROADMAP queue 3): both batchers suppress it for every request."""
    v = tt.Translator(path, device="cpu").model.target_vocabulary
    return [v.to_token(len(v) - 1)]


@pytest.fixture(scope="module")
def translated(dirs):
    """(model, speculation_k, draft) -> (requests, JAX results, port
    results, port stats)."""
    out = {}
    for name, spec_k, draft in RUNS:
        reqs = requests_for(name)
        kw = dict(KW, speculation_k=spec_k, suppress_tokens=suppress_last(dirs[name]))
        if draft:
            kw["draft_model"] = dirs[draft]
        ref, _ = run(ct, "ContinuousTranslator", ct.Translator(dirs[name]), reqs, **kw)
        got, stats = run(tt, "ContinuousTranslator", tt.Translator(dirs[name], device="cpu"),
                         reqs, **kw)
        out[name, spec_k, draft] = (reqs, ref, got, stats)
    return out


@pytest.mark.parametrize("run_key", RUNS, ids=[f"{n}-{d or 'lookup'}" for n, _, d in RUNS])
def test_translator_speculation_matches_jax(translated, run_key):
    reqs, ref, got, stats = translated[run_key]
    assert len(got) == len(ref) == len(reqs) > KW["num_slots"]
    for (src, opts), o, r in zip(reqs, got, ref):
        assert o.sequences_ids == r.sequences_ids, opts
        np.testing.assert_allclose(o.scores, r.scores, atol=TOL, rtol=0)
        prefix = opts.get("target_prefix") or []
        assert o.sequences[0][:len(prefix)] == prefix
    assert stats["spec_draft"] == ("model" if run_key[2] else "prompt-lookup")
    assert stats["num_requests"] == len(reqs)


@pytest.mark.parametrize("run_key", RUNS, ids=[f"{n}-{d or 'lookup'}" for n, _, d in RUNS])
def test_translator_speculation_matches_translate_batch(translated, dirs, run_key):
    """Each request decodes translate_batch's greedy hypothesis, its
    target prefix included."""
    reqs, _, got, _ = translated[run_key]
    tr = tt.Translator(dirs[run_key[0]], device="cpu")
    for (src, opts), g in zip(reqs, got):
        exp = tr.translate_batch([src], beam_size=1, max_decoding_length=MAX_LENGTH,
                                 target_prefix=[opts.get("target_prefix")])[0]
        assert g.sequences == [exp.hypotheses[0]]


def test_translator_draft_and_lookup_agree(translated):
    """The early-exit draft proposes other tokens than prompt lookup does,
    and both keep the plain greedy tokens; a forced prefix is accepted
    whole in either."""
    lookup = translated["float32", 4, None]
    drafted = translated["float32", 4, "layer0"]
    assert [o.sequences_ids for o in lookup[2]] == [o.sequences_ids for o in drafted[2]]
    assert (lookup[3]["spec_tokens_per_dispatch"]
            != drafted[3]["spec_tokens_per_dispatch"])
    assert drafted[3]["spec_tokens_per_dispatch"] > 1.0


def test_translator_draft_validation(dirs, tmp_path):
    """The JAX package's draft errors: an encoder-decoder draft without
    merged attention or source factors, with the target's vocabularies."""
    tr = tt.Translator(dirs["float32"], device="cpu")
    cases = [
        (jbuilder.build_seq2seq_model(str(tmp_path / "merged"), merged_attention=True,
                                      **SEQ2SEQ), NotImplementedError, "merged-attention"),
        (jbuilder.build_seq2seq_model(str(tmp_path / "factors"), num_source_features=2,
                                      **SEQ2SEQ), NotImplementedError, "source-factor"),
        (jbuilder.build_seq2seq_model(str(tmp_path / "vocab"),
                                      **dict(SEQ2SEQ, vocab_size=48)),
         ValueError, "vocabulary size"),
        (jbuilder.build_decoder_only_model(str(tmp_path / "dec"), vocab_size=96),
         ValueError, "encoder-decoder"),
    ]
    for draft, error, match in cases:
        for module, task in ((ct, ct.Translator(dirs["float32"])), (tt, tr)):
            with pytest.raises(error, match=match):
                module.ContinuousTranslator(task, speculation_k=4, draft_model=draft, **KW)
    with pytest.raises(ValueError, match="speculation_k > 1"):
        tt.ContinuousTranslator(tr, draft_model=dirs["layer0"], **KW)
    with pytest.raises(NotImplementedError, match="beam"):
        tt.ContinuousTranslator(tr, beam_size=2, speculation_k=4, **KW)


# ---------------------------------------------------------------------------
# Whisper.
# ---------------------------------------------------------------------------

PROMPT_TS = ["<|startoftranscript|>", "<|en|>", "<|transcribe|>"]
PROMPT_NO_TS = PROMPT_TS + ["<|notimestamps|>"]
WKW = dict(num_slots=2, capacity=64, steps_per_sync=4)


def _features(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((24, 64)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def whisper_dirs(tmp_path_factory):
    path = jbuilder.build_whisper_model(str(tmp_path_factory.mktemp("whisper")))[0]
    return {"target": path,
            "draft": cut_decoder(path, str(tmp_path_factory.mktemp("wd") / "m"), [0])}


@pytest.fixture(scope="module")
def transcribed(whisper_dirs):
    """draft -> (requests, JAX results, port results, port stats)."""
    path = whisper_dirs["target"]
    reqs = [((f, PROMPT_NO_TS), dict(max_length=16)) for f in _features(4)]
    out = {}
    for draft in (None, "draft"):
        kw = dict(WKW, speculation_k=3)
        if draft:
            kw["draft_model"] = whisper_dirs[draft]
        ref, _ = run(ct, "ContinuousWhisper", ct.Whisper(path), reqs, **kw)
        got, stats = run(tt, "ContinuousWhisper", tt.Whisper(path, device="cpu"), reqs, **kw)
        out[draft] = (reqs, ref, got, stats)
    return out


@pytest.mark.parametrize("draft", [None, "draft"])
def test_whisper_speculation_matches_jax_and_generate(transcribed, whisper_dirs, draft):
    reqs, ref, got, stats = transcribed[draft]
    w = tt.Whisper(whisper_dirs["target"], device="cpu")
    for ((feats, prompt), opts), o, r in zip(reqs, got, ref):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=TOL, rtol=0)
        assert o.sequences[0][:len(prompt) - 1] == prompt[1:]
        e = w.generate(feats[None], [prompt], beam_size=1,
                       max_length=2 * (16 - len(prompt) + 1), suppress_blank=False)[0]
        assert o.sequences_ids[0][len(prompt) - 1:] == e.sequences_ids[0]
    assert stats["spec_draft"] == ("model" if draft else "prompt-lookup")


def test_whisper_speculation_validation(whisper_dirs, tmp_path):
    """A timestamped prompt is refused under speculation, and a draft must
    be a Whisper with the target's vocabulary, mel bins and encoder
    capacity (the JAX package's errors)."""
    path = whisper_dirs["target"]
    for module, w in ((ct, ct.Whisper(path)), (tt, tt.Whisper(path, device="cpu"))):
        cb = module.ContinuousWhisper(w, speculation_k=3, **WKW)
        try:
            with pytest.raises(NotImplementedError, match="timestamp"):
                cb.submit(_features(1)[0], PROMPT_TS, max_length=8)
        finally:
            cb.close()
        bins = jbuilder.build_whisper_model(str(tmp_path / f"bins{module.__name__}"),
                                            n_mels=16)[0]
        with pytest.raises(ValueError, match="mel bins"):
            module.ContinuousWhisper(w, speculation_k=3, draft_model=bins, **WKW)
        short = jbuilder.build_whisper_model(str(tmp_path / f"short{module.__name__}"),
                                             max_positions=16)[0]
        with pytest.raises(ValueError, match="encoder capacity"):
            module.ContinuousWhisper(w, speculation_k=3, draft_model=short, **WKW)
        s2s = jbuilder.build_seq2seq_model(str(tmp_path / f"s2s{module.__name__}"), **SEQ2SEQ)
        with pytest.raises(ValueError, match="speech model"):
            module.ContinuousWhisper(w, speculation_k=3, draft_model=s2s, **WKW)
    with pytest.raises(ValueError, match="capacity"):
        cb = tt.ContinuousWhisper(tt.Whisper(path, device="cpu"), speculation_k=6,
                                  num_slots=1, capacity=64, steps_per_sync=2)
        try:
            cb.submit(_features(1)[0], PROMPT_NO_TS, max_length=60)
        finally:
            cb.close()
