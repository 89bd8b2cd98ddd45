"""The file and streaming helpers of the port against the JAX package's, on
the CPU, on builder models (a 2+2-layer seq2seq model of 128 words and a
2-layer decoder-only model of 96, d_model 64, float32 and int8):
``Translator.translate_file`` / ``score_file`` / ``translate_iterable`` /
``translate_tokens`` and ``Generator.generate_iterable`` /
``generate_tokens`` / ``async_generate_tokens``, and the read-window loop
``runtime/batching.py::consume_stream`` they share.

Tokens must be identical; scores within ``TOL[dtype]`` (1e-5 in float32,
1e-4 in int8, where an activation at a half-step tie could round one int8
step apart in the two packages: the inputs here are fixed ones free of such
ties).
"""

import asyncio
import threading
import time

import numpy as np
import pytest

import ctranslate2_tpu as ct
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.converters import builder as tbuilder
from ctranslate2_tpu_torch.runtime.batching import (consume_stream,
                                                    default_read_batch_size)
from ctranslate2_tpu_torch.runtime.results import AsyncResult

TOL = {"float32": 1e-5, "int8": 1e-4}
DECODER = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
               num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
               activation="swish")
OPTS = dict(beam_size=2, max_decoding_length=8)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"file_seq2seq_{dtype}"))
        out["seq2seq", dtype] = tbuilder.build_seq2seq_model(
            path, vocab_size=128, num_layers=2, num_heads=4, d_model=64,
            d_ff=128, quantization=quant)
        path = str(tmp_path_factory.mktemp(f"file_decoder_{dtype}"))
        out["decoder", dtype] = tbuilder.build_decoder_only_model(
            path, quantization=quant, **DECODER)
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


def _lines(n, low, high, seed, top=120):
    rng = np.random.default_rng(seed)
    return [" ".join(f"tok{int(i)}" for i in rng.integers(0, top, rng.integers(low, high)))
            for _ in range(n)]


def _write(path, lines):
    with open(path, "w", encoding="utf-8") as f:
        f.write("".join(line + "\n" for line in lines))
    return str(path)


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


def _split_scored(lines):
    scores, texts = [], []
    for line in lines:
        score, text = line.split(" ||| ")
        scores.append(float(score))
        texts.append(text)
    return scores, texts


# ---------------------------------------------------------------------------
# translate_file.
# ---------------------------------------------------------------------------

FILE_CASES = {
    "plain": dict(),
    "with_scores": dict(with_scores=True),
    "read_batch_1": dict(read_batch_size=1, with_scores=True),
    "read_batch_3": dict(read_batch_size=3),
    "max_batch_1": dict(max_batch_size=1),
    "max_batch_0": dict(max_batch_size=0, with_scores=True),
    "hypotheses": dict(num_hypotheses=2, with_scores=True),
    "greedy": dict(beam_size=1, with_scores=True),
}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(FILE_CASES))
def test_translate_file_matches(pairs, tmp_path, dtype, case):
    jt, pt = pairs("seq2seq", dtype)
    src = _write(tmp_path / "src.txt", _lines(11, 2, 14, seed=4))
    kw = dict(OPTS, **FILE_CASES[case])
    ref_stats = jt.translate_file(src, str(tmp_path / "ref.txt"), **kw)
    stats = pt.translate_file(src, str(tmp_path / "out.txt"), **kw)
    ref, out = _read(tmp_path / "ref.txt"), _read(tmp_path / "out.txt")
    assert len(out) == 11 * kw.get("num_hypotheses", 1)
    if kw.get("with_scores"):
        (ref_s, ref), (out_s, out) = _split_scored(ref), _split_scored(out)
        np.testing.assert_allclose(out_s, ref_s, atol=TOL[dtype], rtol=0)
    assert out == ref
    assert isinstance(stats, tt.ExecutionStats)
    assert (stats.num_examples, stats.num_tokens) == (
        ref_stats.num_examples, ref_stats.num_tokens) and stats.num_examples == 11
    assert stats.total_time_in_ms > 0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_translate_file_target_prefix(pairs, tmp_path, dtype):
    jt, pt = pairs("seq2seq", dtype)
    src = _write(tmp_path / "src.txt", _lines(7, 2, 12, seed=5))
    tgt = _write(tmp_path / "tgt.txt", _lines(7, 0, 4, seed=6))
    jt.translate_file(src, str(tmp_path / "ref.txt"), tgt, read_batch_size=2, **OPTS)
    pt.translate_file(src, str(tmp_path / "out.txt"), tgt, read_batch_size=2, **OPTS)
    out = _read(tmp_path / "out.txt")
    assert out == _read(tmp_path / "ref.txt")
    for line, prefix in zip(out, _read(tgt)):
        assert line.startswith(prefix)


def test_translate_file_callbacks(pairs, tmp_path):
    """Raw lines through the tokenize / detokenize callbacks."""
    jt, pt = pairs("seq2seq", "float32")
    raw = [line.replace(" ", ",") for line in _lines(6, 2, 10, seed=7)]
    src = _write(tmp_path / "src.txt", raw)
    tgt = _write(tmp_path / "tgt.txt", ["tok3", "", "tok4,tok5", "", "", "tok1"])
    kw = dict(source_tokenize_fn=lambda s: s.split(","),
              target_tokenize_fn=lambda s: s.split(",") if s else [],
              target_detokenize_fn=lambda toks: "+".join(toks), **OPTS)
    jt.translate_file(src, str(tmp_path / "ref.txt"), tgt, **kw)
    pt.translate_file(src, str(tmp_path / "out.txt"), tgt, **kw)
    out = _read(tmp_path / "out.txt")
    assert out == _read(tmp_path / "ref.txt")
    assert all(" " not in line for line in out) and out[0].startswith("tok3")


@pytest.mark.parametrize("target_lines", [3, 5])
def test_translate_file_line_count_mismatch(pairs, tmp_path, target_lines):
    _, pt = pairs("seq2seq", "float32")
    src = _write(tmp_path / "src.txt", _lines(4, 2, 6, seed=1))
    tgt = _write(tmp_path / "tgt.txt", _lines(target_lines, 1, 3, seed=2))
    with pytest.raises(ValueError, match="same number of lines"):
        pt.translate_file(src, str(tmp_path / "out.txt"), tgt, read_batch_size=2,
                          **OPTS)


@pytest.mark.parametrize("kw, message", [
    (dict(source_tokenize_fn=str.split), "both be set"),
    (dict(target_detokenize_fn=" ".join), "both be set"),
    (dict(source_tokenize_fn=str.split, target_detokenize_fn=" ".join,
          target_path="TGT"), "target_tokenize_fn"),
])
def test_translate_file_callback_errors(pairs, tmp_path, kw, message):
    _, pt = pairs("seq2seq", "float32")
    src = _write(tmp_path / "src.txt", _lines(2, 2, 4, seed=1))
    if kw.get("target_path"):
        kw = dict(kw, target_path=_write(tmp_path / "tgt.txt", ["a", "b"]))
    with pytest.raises(ValueError, match=message):
        pt.translate_file(src, str(tmp_path / "out.txt"), **kw)


# ---------------------------------------------------------------------------
# score_file.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("with_tokens_score", [False, True])
def test_score_file_matches(pairs, tmp_path, dtype, with_tokens_score):
    jt, pt = pairs("seq2seq", dtype)
    src = _write(tmp_path / "src.txt", _lines(9, 2, 12, seed=8))
    tgt = _write(tmp_path / "tgt.txt", _lines(9, 1, 9, seed=9))
    kw = dict(read_batch_size=4, with_tokens_score=with_tokens_score)
    ref_stats = jt.score_file(src, tgt, str(tmp_path / "ref.txt"), **kw)
    stats = pt.score_file(src, tgt, str(tmp_path / "out.txt"), **kw)
    ref, out = _read(tmp_path / "ref.txt"), _read(tmp_path / "out.txt")
    assert len(out) == 9
    assert (stats.num_examples, stats.num_tokens) == (
        ref_stats.num_examples, ref_stats.num_tokens)
    for o, r in zip(out, ref):
        o, r = o.split(" ||| "), r.split(" ||| ")
        assert len(o) == len(r) == (3 if with_tokens_score else 2)
        assert o[1] == r[1] and o[1].endswith("</s>")
        assert abs(float(o[0]) - float(r[0])) <= TOL[dtype] + 1e-6
        if with_tokens_score:
            np.testing.assert_allclose([float(s) for s in o[2].split()],
                                       [float(s) for s in r[2].split()],
                                       atol=TOL[dtype] + 1e-6, rtol=0)


def test_score_file_line_count_mismatch(pairs, tmp_path):
    _, pt = pairs("seq2seq", "float32")
    src = _write(tmp_path / "src.txt", _lines(3, 2, 6, seed=1))
    tgt = _write(tmp_path / "tgt.txt", _lines(4, 1, 3, seed=2))
    with pytest.raises(ValueError, match="same number of lines"):
        pt.score_file(src, tgt, str(tmp_path / "out.txt"))


# ---------------------------------------------------------------------------
# The iterables.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_translate_iterable_in_order(pairs, dtype):
    jt, pt = pairs("seq2seq", dtype)
    source = [line.split() for line in _lines(10, 2, 12, seed=13)]
    prefix = [line.split() for line in _lines(10, 0, 3, seed=14)]
    kw = dict(OPTS, return_scores=True)
    for with_prefix in (False, True):
        p = prefix if with_prefix else None
        ref = list(jt.translate_iterable(iter(source), p and iter(p),
                                         max_batch_size=3, **kw))
        out = list(pt.translate_iterable(iter(source), p and iter(p),
                                         max_batch_size=3, **kw))
        batch = pt.translate_batch(source, p, **kw)
        assert [r.hypotheses for r in out] == [r.hypotheses for r in ref]
        assert [r.hypotheses for r in out] == [r.hypotheses for r in batch]
        np.testing.assert_allclose([r.scores[0] for r in out],
                                   [r.scores[0] for r in ref], atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_generate_iterable_in_order(pairs, dtype):
    jg, pg = pairs("decoder", dtype)
    prompts = [["<s>"] + line.split() for line in _lines(7, 1, 9, seed=13, top=90)]
    kw = dict(max_length=6, return_scores=True)
    ref = list(jg.generate_iterable(iter(prompts), max_batch_size=2, **kw))
    out = list(pg.generate_iterable(iter(prompts), max_batch_size=2, **kw))
    assert len(out) == 7
    assert [r.sequences for r in out] == [r.sequences for r in ref]
    assert [r.sequences_ids for r in out] == [r.sequences_ids for r in ref]
    np.testing.assert_allclose([r.scores[0] for r in out], [r.scores[0] for r in ref],
                               atol=TOL[dtype], rtol=0)


# ---------------------------------------------------------------------------
# Token streaming.
# ---------------------------------------------------------------------------


def _steps(it):
    return [(s.step, s.batch_id, s.token_id, s.token, s.is_last, s.log_prob)
            for s in it]


def _assert_same_steps(out, ref, tol):
    assert [s[:5] for s in out] == [s[:5] for s in ref]
    if ref and ref[0][5] is not None:
        np.testing.assert_allclose([s[5] for s in out], [s[5] for s in ref],
                                   atol=tol, rtol=0)
    else:
        assert all(s[5] is None for s in out)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("log_prob", [False, True])
def test_generate_tokens_matches(pairs, dtype, log_prob):
    jg, pg = pairs("decoder", dtype)
    prompt = ["<s>", "tok4", "tok17", "tok30"]
    kw = dict(max_length=7, return_log_prob=log_prob)
    ref = _steps(jg.generate_tokens(prompt, **kw))
    out = _steps(pg.generate_tokens(prompt, **kw))
    _assert_same_steps(out, ref, TOL[dtype])
    assert out[-1][4] and len(out) <= 7
    # The steps are the batch call's tokens, the prompt's after "<s>" first
    # (``include_prompt_in_result``, as in generate_batch).
    batch = pg.generate_batch([prompt], max_length=7)
    assert [s[2] for s in out if s[3] != "</s>"] == batch[0].sequences_ids[0]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_translate_tokens_matches(pairs, dtype):
    jt, pt = pairs("seq2seq", dtype)
    source = "tok3 tok8 tok11 tok40 tok2".split()
    for prefix in (None, ["tok9"]):
        kw = dict(max_decoding_length=8, return_log_prob=True)
        ref = _steps(jt.translate_tokens(source, prefix, **kw))
        out = _steps(pt.generate_tokens(source, prefix, **kw))
        _assert_same_steps(out, ref, TOL[dtype])
        assert out[-1][4]


def test_generate_tokens_close_before_end(pairs):
    _, pg = pairs("decoder", "float32")
    it = pg.generate_tokens(["<s>", "tok4"], max_length=40, min_length=40)
    first = [next(it) for _ in range(3)]
    assert [s.step for s in first] == [0, 1, 2]
    it.close()
    assert not it._thread.is_alive()
    # The stream ended at the row's next step: the call is over, and the
    # same Generator serves the next call.
    again = _steps(pg.generate_tokens(["<s>", "tok4"], max_length=3))
    assert len(again) <= 3 and again[-1][4]


def test_generate_tokens_error_propagates(pairs):
    _, pg = pairs("decoder", "float32")
    with pytest.raises(ValueError):
        list(pg.generate_tokens(["<s>"], max_length=0))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_async_generate_tokens_matches(pairs, dtype):
    jg, pg = pairs("decoder", dtype)
    prompt = ["<s>", "tok9", "tok2"]

    async def collect(gen):
        return [s async for s in gen.async_generate_tokens(
            prompt, max_length=6, return_scores=True)]

    ref = _steps(asyncio.run(collect(jg)))
    out = _steps(asyncio.run(collect(pg)))
    _assert_same_steps(out, ref, TOL[dtype])
    assert out == _steps(pg.generate_tokens(prompt, max_length=6, return_log_prob=True))


def test_async_generate_tokens_stops_early(pairs):
    """Leaving the ``async for`` early ends the call on its worker thread."""
    _, pg = pairs("decoder", "float32")

    async def first_three():
        out = []
        agen = pg.async_generate_tokens(["<s>", "tok4"], max_length=40, min_length=40)
        async for step in agen:
            out.append(step.step)
            if len(out) == 3:
                break
        await agen.aclose()
        return out

    before = threading.active_count()
    assert asyncio.run(first_three()) == [0, 1, 2]
    assert threading.active_count() <= before


def test_step_stream_close_is_idempotent(pairs):
    _, pg = pairs("decoder", "float32")
    it = pg.generate_tokens(["<s>", "tok4"], max_length=3)
    steps = list(it)
    it.close()
    it.close()
    assert len(steps) <= 3 and next(it, None) is None


# ---------------------------------------------------------------------------
# consume_stream and the read window.
# ---------------------------------------------------------------------------


def test_default_read_batch_size():
    assert default_read_batch_size(5, 32) == 5
    assert default_read_batch_size(0, 32) == 512
    assert default_read_batch_size(0, 1) == 1
    assert default_read_batch_size(0, 0) is None


class _Slow:
    """An AsyncResult-like handle that resolves once released."""

    def __init__(self, value, gate):
        self.value, self.gate = value, gate

    def done(self):
        return self.gate.is_set()

    def result(self):
        self.gate.wait(5)
        return self.value


def test_consume_stream_order_and_backpressure():
    windows = [[1, 2], [3, 4], [5, 6], [7]]
    gates = {}
    in_flight = []
    written = []

    def read():
        return windows.pop(0) if windows else None

    def submit(window):
        out = []
        for v in window:
            gates[v] = threading.Event()
            out.append(_Slow(v, gates[v]))
        in_flight.append(len(gates) - len(written))
        return out

    def release():
        for v in range(1, 8):
            time.sleep(0.01)
            gates.get(v) and gates[v].set()

    threading.Thread(target=release, daemon=True).start()
    consume_stream(read, submit, written.append, max_pending=3)
    assert written == [1, 2, 3, 4, 5, 6, 7]
    # Never more than max_pending + one window in flight.
    assert max(in_flight) <= 3 + 2


def test_consume_stream_error_settles_pending():
    settled = []

    class Done:
        def __init__(self, v):
            self.v = v

        def done(self):
            return False

        def result(self):
            settled.append(self.v)
            return self.v

    windows = [[1, 2], [3]]

    def read():
        if not windows:
            raise ValueError("bad window")
        return windows.pop(0)

    with pytest.raises(ValueError, match="bad window"):
        consume_stream(read, lambda w: [Done(v) for v in w], lambda r: None)
    assert settled == [1, 2, 3]


def test_async_result_of_a_value():
    r = AsyncResult([4, 5], 1)
    assert r.done() and r.result() == 5
