"""The teacher-forced entry points of the port against the JAX package's, on
the CPU, on builder models (2 layers, d_model 64; a seq2seq model of 128
words and a decoder-only one of 96, float32 and int8):
``Translator.score_batch`` / ``score_iterable`` and
``Generator.score_batch`` / ``forward_batch`` / ``score_iterable``.

Tokens must be identical; scores and log-probs agree within 1e-5 in
float32. Under int8 (W8A8) an activation within an ulp of a half step can
round one int8 step apart in the two frameworks (see
tests/test_torch_translator.py); the inputs here are fixed ones on which no
such tie occurs, and int8 scores are held within 1e-4.

On the port alone: the log-probs ``score_batch`` gives a greedy
continuation sum to the score ``generate_batch`` / ``translate_batch``
gave it (length penalty 0), within 1e-4: the same model once through the
cached decode loop, once through one uncached pass.
"""

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.converters import builder as tbuilder

TOL = {"float32": 1e-5, "int8": 1e-4}
MODEL = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
             num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
             activation="swish")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"score_seq2seq_{dtype}"))
        out["seq2seq", dtype] = tbuilder.build_seq2seq_model(
            path, vocab_size=128, num_layers=2, num_heads=4, d_model=64,
            d_ff=128, quantization=quant)
        path = str(tmp_path_factory.mktemp(f"score_decoder_{dtype}"))
        out["decoder", dtype] = tbuilder.build_decoder_only_model(
            path, quantization=quant, **MODEL)
    return out


@pytest.fixture(scope="module")
def pairs(dirs):
    cache = {}

    def get(kind, dtype):
        if (kind, dtype) not in cache:
            cls = "Translator" if kind == "seq2seq" else "Generator"
            cache[kind, dtype] = (getattr(ct, cls)(dirs[kind, dtype], device="cpu"),
                                  getattr(tt, cls)(dirs[kind, dtype], device="cpu"))
        return cache[kind, dtype]
    return get


def _tokens(n, low, high, seed):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(i)}" for i in rng.integers(0, 90, rng.integers(low, high))]
            for _ in range(n)]


def _assert_same(out, ref, tol):
    assert len(out) == len(ref)
    assert [o.tokens for o in out] == [r.tokens for r in ref]
    np.testing.assert_allclose([s for o in out for s in o.tokens_score],
                               [s for r in ref for s in r.tokens_score],
                               atol=tol, rtol=0)


def _results(out):
    return [r.result() for r in out]


# ---------------------------------------------------------------------------
# Translator.
# ---------------------------------------------------------------------------

TRANSLATOR_CASES = {
    "plain": dict(),
    "rebatched": dict(max_batch_size=2),
    "rebatched_tokens": dict(max_batch_size=24, batch_type="tokens"),
    "asynchronous": dict(asynchronous=True),
    "offset_ignored": dict(offset=3),
    "truncated": dict(max_input_length=6),
}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(TRANSLATOR_CASES))
def test_translator_score_batch_matches(pairs, dtype, case):
    jt, pt = pairs("seq2seq", dtype)
    source = _tokens(5, 3, 15, seed=4)
    target = _tokens(5, 1, 12, seed=5)
    source[2] = []  # scores 0.0 on every target token, without the model
    kw = TRANSLATOR_CASES[case]
    ref = jt.score_batch(source, target, **kw)
    out = pt.score_batch(source, target, **kw)
    if kw.get("asynchronous"):
        ref, out = _results(ref), _results(out)
    _assert_same(out, ref, TOL[dtype])
    assert out[2].tokens_score == [0.0] * len(out[2].tokens) and out[2].tokens
    assert all(isinstance(r, tt.ScoringResult) for r in out)
    full = [r for i, r in enumerate(out) if i != 2 and not kw.get("max_input_length")]
    assert all(r.tokens[-1] == "</s>" for r in full)


def test_translator_score_iterable_matches(pairs):
    jt, pt = pairs("seq2seq", "float32")
    source = _tokens(7, 3, 15, seed=6)
    target = _tokens(7, 1, 12, seed=7)
    ref = list(jt.score_iterable(iter(source), iter(target), max_batch_size=3))
    out = list(pt.score_iterable(iter(source), iter(target), max_batch_size=3))
    _assert_same(out, ref, TOL["float32"])
    assert pt.score_batch([], []) == []


# ---------------------------------------------------------------------------
# Generator.
# ---------------------------------------------------------------------------

GENERATOR_CASES = {
    "plain": dict(),
    "offset": dict(offset=3),
    "offset_past_the_end": dict(offset=40),
    "rebatched": dict(max_batch_size=2),
    "asynchronous": dict(asynchronous=True),
    "truncated": dict(max_input_length=5),
}


def _generator_rows():
    rows = _tokens(5, 2, 20, seed=8)
    rows.insert(1, ["tok3"])  # under 2 tokens: an empty result
    rows.append([])
    return rows


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_generator_score_batch_matches(pairs, dtype, case):
    jg, pg = pairs("decoder", dtype)
    kw = GENERATOR_CASES[case]
    rows = _generator_rows()
    ref = jg.score_batch(rows, **kw)
    out = pg.score_batch(rows, **kw)
    if kw.get("asynchronous"):
        ref, out = _results(ref), _results(out)
    _assert_same(out, ref, TOL[dtype])
    assert out[1].tokens == [] and out[-1].tokens == []
    assert out[1].normalized_score() == 0.0


def test_generator_score_iterable_matches(pairs):
    jg, pg = pairs("decoder", "float32")
    rows = _generator_rows()
    ref = list(jg.score_iterable(iter(rows), max_batch_size=3))
    out = list(pg.score_iterable(iter(rows), max_batch_size=3))
    _assert_same(out, ref, TOL["float32"])


def _forward_inputs(vocab, kind):
    rows = _tokens(4, 1, 14, seed=9)
    ids = [[vocab.to_id(t) for t in row] for row in rows]
    if kind == "tokens":
        return rows, None
    if kind == "ids":
        return ids, None
    width = max(len(r) for r in ids) + 3
    dense = np.zeros((len(ids), width), np.int64)
    for i, r in enumerate(ids):
        dense[i, :len(r)] = r
    lengths = [len(r) for r in ids]
    if kind == "array":
        return dense, lengths
    return torch.from_numpy(dense), torch.tensor(lengths)  # "tensor"


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("log_probs", [False, True])
@pytest.mark.parametrize("kind", ["tokens", "ids", "array", "tensor"])
def test_forward_batch_matches(pairs, dtype, log_probs, kind):
    jg, pg = pairs("decoder", dtype)
    inputs, lengths = _forward_inputs(pg._vocab, kind)
    jax_inputs = inputs.numpy() if kind == "tensor" else inputs
    jax_lengths = lengths.tolist() if kind == "tensor" else lengths
    ref = np.asarray(jg.forward_batch(jax_inputs, jax_lengths,
                                      return_log_probs=log_probs))
    out = pg.forward_batch(inputs, lengths, return_log_probs=log_probs)
    assert out.shape == ref.shape
    assert out.dtype == torch.float32
    # Log-probs and logits of the padded positions included.
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL[dtype], rtol=0)


def test_forward_batch_log_probs_gather_to_score_batch(pairs):
    _, pg = pairs("decoder", "float32")
    rows = _tokens(3, 2, 14, seed=10)
    lp = pg.forward_batch(rows, return_log_probs=True)
    scores = pg.score_batch(rows)
    for i, row in enumerate(rows):
        ids = [pg._vocab.to_id(t) for t in row]
        gathered = [float(lp[i, t, ids[t + 1]]) for t in range(len(ids) - 1)]
        np.testing.assert_allclose(gathered, scores[i].tokens_score, atol=1e-6)


def test_forward_batch_lengths_need_a_dense_input(pairs):
    _, pg = pairs("decoder", "float32")
    with pytest.raises(ValueError, match="dense"):
        pg.forward_batch([["tok1", "tok2"]], lengths=[2])


# ---------------------------------------------------------------------------
# Scoring a greedy continuation gives the decode loop's score.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_generator_scores_its_own_continuation(pairs, dtype):
    """No minimum length: that would mask EOS before the softmax the loop
    reads, and scoring reads the unmasked distribution."""
    _, pg = pairs("decoder", dtype)
    prompts = _tokens(3, 3, 10, seed=11)
    gen = pg.generate_batch(prompts, max_length=12, return_scores=True,
                            return_end_token=True, length_penalty=0.0)
    for p, g in zip(prompts, gen):
        row = pg.score_batch([g.sequences[0]], offset=len(p) - 1)[0]
        assert row.tokens == g.sequences[0][len(p):]
        np.testing.assert_allclose(row.cumulated_score(), g.scores[0], atol=1e-4)


def test_translator_scores_its_own_translation(pairs):
    _, pt = pairs("seq2seq", "float32")
    source = _tokens(6, 3, 12, seed=12)
    max_length = 8
    out = pt.translate_batch(source, beam_size=1, max_decoding_length=max_length,
                             min_decoding_length=0, return_scores=True,
                             length_penalty=0.0)
    scored = pt.score_batch(source, [o.hypotheses[0] for o in out])
    for o, s in zip(out, scored):
        hyp = o.hypotheses[0]
        assert s.tokens == hyp + ["</s>"]
        # A translation cut at the maximum length has no EOS in its score.
        ended = len(hyp) < max_length
        total = sum(s.tokens_score if ended else s.tokens_score[:-1])
        np.testing.assert_allclose(total, o.scores[0], atol=1e-4)
