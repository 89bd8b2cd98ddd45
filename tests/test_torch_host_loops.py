"""The host decode loops of the port against the JAX package's, on the CPU.

Builder models (2+2 layers or 2 decoder layers, d_model 64), float32 and
int8. The options that need a read of every step on the host (attention
and ``replace_unknowns``, the coverage penalty, prefix-biased decoding,
vocabulary logits, step callbacks) and the ones served around the loops
(a vocabulary map, a static prompt) must give the JAX package's tokens,
with scores, attention and logits within ``TOL[dtype]`` (1e-5 in float32,
1e-4 in int8).

Under int8 (W8A8) an activation at a half-step tie can round one int8 step
apart in the two packages (see tests/test_torch_translator.py): the inputs
are fixed ones on which no such tie occurs.

The JAX package's greedy host loop draws its noise from a key split once a
step; the sampled callback test feeds the port that noise (the noise hook
``sampling.noise_source`` replaced), as tests/test_torch_sampling.py does
for the device loops.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters.builder import (build_decoder_only_model,
                                                build_seq2seq_model)
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.decoding import sampling as ts

TOL = {"float32": 1e-5, "int8": 1e-4}
DECODER = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
               num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
               activation="swish")
PREFIX = [["tok5", "tok9", "tok3", "tok1"], None, ["tok7"], None,
          ["tok1", "tok2", "tok3"]]


def write_vmap(path, vocab=125):
    """A vocabulary map: each source token proposes six target tokens."""
    with open(f"{path}/vmap.txt", "w") as f:
        for i in range(vocab):
            f.write(f"tok{i}\t" + " ".join(f"tok{(i * 7 + j) % vocab}"
                                           for j in range(6)) + "\n")


@pytest.fixture(scope="module")
def seq2seq_dirs(tmp_path_factory):
    dirs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"host_seq2seq_{dtype}"))
        build_seq2seq_model(path, vocab_size=128, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, quantization=quant)
        write_vmap(path)
        dirs[dtype] = path
    return dirs


@pytest.fixture(scope="module")
def translators(seq2seq_dirs):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = (ct.Translator(seq2seq_dirs[dtype], device="cpu"),
                            tt.Translator(seq2seq_dirs[dtype], device="cpu"))
        return cache[dtype]

    return get


@pytest.fixture(scope="module")
def decoder_dirs(tmp_path_factory):
    dirs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"host_decoder_{dtype}"))
        build_decoder_only_model(path, quantization=quant, **DECODER)
        dirs[dtype] = path
    return dirs


@pytest.fixture(scope="module")
def generators(decoder_dirs):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cache[dtype] = (ct.Generator(decoder_dirs[dtype], device="cpu"),
                            tt.Generator(decoder_dirs[dtype], device="cpu"))
        return cache[dtype]

    return get


def source(n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [[f"tok{i}" for i in rng.integers(0, 125, rng.integers(3, 15))]
            for _ in range(n)]


def prompts(seed=5):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(0, 90, n)] for n in (5, 1, 12, 9)]


def assert_nested_close(a, b, tol):
    """Equal nesting and lengths, numbers within ``tol``."""
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_nested_close(x, y, tol)
        return
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=tol, rtol=0)


def compare_translations(translators, dtype, src, prefix=None, **opts):
    jt, pt = translators(dtype)
    opts.setdefault("max_decoding_length", 16)
    opts.setdefault("return_scores", True)
    rj = jt.translate_batch(src, prefix, **opts)
    rp = pt.translate_batch(src, prefix, **opts)
    assert [r.hypotheses for r in rp] == [r.hypotheses for r in rj]
    tol = TOL[dtype]
    assert_nested_close([r.scores for r in rp], [r.scores for r in rj], tol)
    assert_nested_close([r.attention for r in rp], [r.attention for r in rj], tol)
    assert_nested_close([[np.asarray(x) for x in r.logits] for r in rp],
                        [[np.asarray(x) for x in r.logits] for r in rj], tol)
    return rp


def compare_generations(generators, dtype, inputs=None, **opts):
    jg, pg = generators(dtype)
    inputs = inputs or prompts()
    opts.setdefault("max_length", 10)
    opts.setdefault("return_scores", True)
    rj = jg.generate_batch(inputs, **opts)
    rp = pg.generate_batch(inputs, **opts)
    assert [r.sequences_ids for r in rp] == [r.sequences_ids for r in rj]
    tol = TOL[dtype]
    assert_nested_close([r.scores for r in rp], [r.scores for r in rj], tol)
    assert_nested_close([[np.asarray(x) for x in r.logits] for r in rp],
                        [[np.asarray(x) for x in r.logits] for r in rj], tol)
    return rp


# ---------------------------------------------------------------------------
# Attention, unknown-token replacement, coverage.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2, 4])
def test_return_attention(translators, dtype, beam):
    src = source()
    out = compare_translations(translators, dtype, src, PREFIX, beam_size=beam,
                               num_hypotheses=min(beam, 2), return_attention=True)
    for r, s in zip(out, src):
        assert len(r.attention) == len(r.hypotheses)
        for hyp, attn in zip(r.hypotheses, r.attention):
            assert len(attn) == len(hyp)
            rows = np.asarray(attn)
            assert rows.shape[1] == len(s) and (rows >= 0).all()
            np.testing.assert_allclose(rows.sum(axis=1), 1.0, atol=1e-5)


def _favor_unk(translator, jax_side: bool):
    """Raises the <unk> bias of the output projection by 8, which puts it at
    the top of most steps."""
    proj = translator.model.params["decoder"]["projection"]
    unk = translator.model.target_vocabulary.unk_id
    if jax_side:
        proj["b"] = proj["b"].at[unk].add(8.0)
    else:
        proj["b"][unk] += 8.0


@pytest.mark.parametrize("beam", [1, 2])
def test_replace_unknowns(seq2seq_dirs, beam):
    jt = ct.Translator(seq2seq_dirs["float32"], device="cpu")
    pt = tt.Translator(seq2seq_dirs["float32"], device="cpu")
    _favor_unk(jt, True)
    _favor_unk(pt, False)
    src = source(seed=3)
    opts = dict(beam_size=beam, max_decoding_length=8, return_scores=True)
    plain = pt.translate_batch(src, **opts)
    assert any("<unk>" in h for r in plain for h in r.hypotheses)
    rj = jt.translate_batch(src, replace_unknowns=True, **opts)
    rp = pt.translate_batch(src, replace_unknowns=True, **opts)
    assert [r.hypotheses for r in rp] == [r.hypotheses for r in rj]
    assert not any("<unk>" in h for r in rp for h in r.hypotheses)
    for r, p, s in zip(rp, plain, src):
        for hyp, orig in zip(r.hypotheses, p.hypotheses):
            assert all(t in s for t, o in zip(hyp, orig) if o == "<unk>")
    np.testing.assert_allclose([s for r in rp for s in r.scores],
                               [s for r in rj for s in r.scores], atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2, 4])
@pytest.mark.parametrize("penalty", [0.2, -0.2])
def test_coverage_penalty(translators, dtype, beam, penalty):
    compare_translations(translators, dtype, source(), beam_size=beam,
                         coverage_penalty=penalty, length_penalty=0.5)


# ---------------------------------------------------------------------------
# Prefix-biased decoding.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("beta", [0.3, 0.7])
def test_prefix_bias(translators, dtype, beam, beta):
    out = compare_translations(translators, dtype, source(), PREFIX, beam_size=beam,
                               prefix_bias_beta=beta)
    # A biased prefix is a preference, not a constraint: the decode runs the
    # whole length budget past it.
    assert all(len(r.hypotheses[0]) > 0 for r in out)


@pytest.mark.parametrize("option,match", [
    (dict(prefix_bias_beta=1.0), "must be < 1"),
    (dict(prefix_bias_beta=0.5, return_alternatives=True), "return_alternatives"),
    (dict(prefix_bias_beta=0.5, callback=lambda r: False), "callback"),
], ids=["beta_1", "alternatives", "callback"])
def test_prefix_bias_errors(translators, option, match):
    for translator in translators("float32"):
        with pytest.raises(ValueError, match=match):
            translator.translate_batch(source(), PREFIX, **option)
    _, pt = translators("float32")
    failed = pt.translate_batch(source(), PREFIX, asynchronous=True, **option)
    with pytest.raises(ValueError, match=match):
        failed[0].result()


# ---------------------------------------------------------------------------
# Vocabulary logits.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2, 4])
def test_return_logits_vocab(translators, dtype, beam):
    out = compare_translations(translators, dtype, source(), beam_size=beam,
                               num_hypotheses=min(beam, 2), return_logits_vocab=True)
    for r in out:
        assert len(r.logits) == len(r.hypotheses)
        for hyp, logits in zip(r.hypotheses, r.logits):
            assert all(np.asarray(l).shape == (128,) for l in logits)
            if beam == 1:  # every decoded step, the EOS's included
                assert len(logits) in (len(hyp), len(hyp) + 1)
            else:  # the step that finished the hypothesis
                assert len(logits) == 1


@pytest.mark.parametrize("beam", [1, 2])
def test_generator_return_logits_vocab(generators, beam):
    out = compare_generations(generators, "float32", beam_size=beam,
                              return_logits_vocab=True)
    assert all(len(r.logits) == len(r.sequences_ids) for r in out)
    assert all(np.asarray(l).shape == (96,) for r in out for ls in r.logits for l in ls)


# ---------------------------------------------------------------------------
# Step callbacks.
# ---------------------------------------------------------------------------


def _record(into, stop=None):
    def callback(r):
        into.append((r.step, r.batch_id, r.token_id, r.hypothesis_id, r.token,
                     r.score, r.is_last,
                     None if getattr(r, "logits", None) is None
                     else np.asarray(r.logits)))
        return stop is not None and stop(r)
    return callback


def _same_steps(a, b, tol):
    assert [x[:5] + (x[6],) for x in a] == [y[:5] + (y[6],) for y in b]
    for x, y in zip(a, b):
        assert (x[5] is None) == (y[5] is None)
        if x[5] is not None:
            assert abs(x[5] - y[5]) <= tol
        assert (x[7] is None) == (y[7] is None)
        if x[7] is not None:
            np.testing.assert_allclose(x[7], y[7], atol=tol, rtol=0)


def _split_chain_noise(seed, device):
    """The JAX package's greedy host loop's noise: step s draws from the
    (s + 1)-th subkey of ``PRNGKey(seed)`` split once a step."""
    key = jax.random.PRNGKey(seed)
    subkeys = []

    def noise(step, shape, device):
        nonlocal key
        while len(subkeys) <= step:
            key, sub = jax.random.split(key)
            subkeys.append(sub)
        return torch.from_numpy(np.array(
            jax.random.gumbel(subkeys[step], tuple(shape), jnp.float32))).to(device)

    return noise


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_translator_callback_sequence(translators, dtype):
    """Every emitted token, in order, with the example's index in the call
    across sub-batches of 2; the last of each row marked."""
    jt, pt = translators(dtype)
    calls = ([], [])
    src = source()
    for translator, into in zip((jt, pt), calls):
        translator.translate_batch(src, beam_size=1, max_decoding_length=8,
                                   return_scores=True, max_batch_size=2,
                                   callback=_record(into))
    _same_steps(calls[0], calls[1], TOL[dtype])
    assert sorted({c[1] for c in calls[1]}) == list(range(len(src)))
    assert sum(c[6] for c in calls[1]) == len(src)


def test_callback_true_ends_its_row(generators):
    """A callback that returns True ends its row: row 2 stops at step 3 and
    its hypothesis ends there."""
    jg, pg = generators("float32")
    stop = lambda r: r.batch_id == 2 and r.step == 3  # noqa: E731
    calls = ([], [])
    outs = [g.generate_batch(prompts(), max_length=10, return_scores=True,
                             include_prompt_in_result=False,
                             callback=_record(into, stop))
            for g, into in zip((jg, pg), calls)]
    _same_steps(calls[0], calls[1], TOL["float32"])
    assert [r.sequences_ids for r in outs[1]] == [r.sequences_ids for r in outs[0]]
    row2 = [c for c in calls[1] if c[1] == 2]
    assert max(c[0] for c in row2) == 3 and not row2[-1][6]
    assert len(outs[1][2].sequences_ids[0]) == len(row2)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_generator_callback_with_logits(generators, dtype):
    jg, pg = generators(dtype)
    calls = ([], [])
    for g, into in zip((jg, pg), calls):
        g.generate_batch(prompts(), max_length=6, return_scores=True,
                         return_logits_vocab=True, max_batch_size=3,
                         callback=_record(into))
    _same_steps(calls[0], calls[1], TOL[dtype])
    assert all(c[7].shape == (96,) for c in calls[1])


def test_sampled_callback_fed_jax_noise(generators, monkeypatch):
    monkeypatch.setattr(ts, "noise_source", _split_chain_noise)
    jg, pg = generators("float32")
    calls = ([], [])
    outs = [g.generate_batch(prompts(), max_length=8, sampling_topk=10,
                             num_hypotheses=2, seed=3, return_scores=True,
                             callback=_record(into))
            for g, into in zip((jg, pg), calls)]
    _same_steps(calls[0], calls[1], TOL["float32"])
    assert {c[3] for c in calls[1]} == {0, 1}
    assert [r.sequences_ids for r in outs[1]] == [r.sequences_ids for r in outs[0]]


# ---------------------------------------------------------------------------
# Vocabulary maps.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2])
def test_use_vmap(translators, dtype, beam):
    src = source()
    out = compare_translations(translators, dtype, src, beam_size=beam, use_vmap=True,
                               return_attention=beam == 2)
    # The candidates are the batch's: the map's targets of every source.
    _, pt = translators(dtype)
    allowed = set(pt._vmap.get_candidates(src))
    assert len(allowed) < 128
    ids = {pt._target_vocab.to_id(t) for r in out for h in r.hypotheses for t in h}
    assert ids <= allowed


def test_restricted_projection_pads_to_256(translators):
    for dtype in ("float32", "int8"):
        _, pt = translators(dtype)
        params, to_output, to_original = pt._restricted_output_params([3, 9, 40])
        proj = params["decoder"]["projection"]
        width = proj["w"].shape[1] if "w" in proj else proj["wq"].shape[0]
        assert width == 256 and len(to_original) == 256
        assert to_original[:3] == [3, 9, 40] and to_output[40] == 2
        assert float(proj["b"][3:].max()) == -1e10
        if "wq" in proj:
            full = pt.model.params["decoder"]["projection"]
            assert torch.equal(proj["wq"][1], full["wq"][9])
            assert float(proj["scale"][2]) == float(full["scale"][40])


# ---------------------------------------------------------------------------
# Static prompts.
# ---------------------------------------------------------------------------


def static_prompt(n=20, seed=9):
    rng = np.random.default_rng(seed)
    return [f"tok{int(t)}" for t in rng.integers(0, 90, n)]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("with_prompt", [True, False])
def test_static_prompt(generators, dtype, beam, with_prompt):
    compare_generations(generators, dtype, static_prompt=static_prompt(),
                        beam_size=beam, include_prompt_in_result=with_prompt)


@pytest.mark.parametrize("beam", [1, 2])
def test_static_prompt_equals_prepended(generators, beam):
    """A static prompt decodes as the prompt prepended to every input."""
    _, pg = generators("float32")
    sp = static_prompt()
    inputs = [p[:6] for p in prompts(seed=6) * 2 if len(p) >= 6]  # one prefill
    opts = dict(max_length=8, beam_size=beam, return_scores=True,
                include_prompt_in_result=False)
    cached = pg.generate_batch(inputs, static_prompt=sp, **opts)
    prepended = pg.generate_batch([sp + p for p in inputs], **opts)
    assert [r.sequences_ids for r in cached] == [r.sequences_ids for r in prepended]
    np.testing.assert_allclose([s for r in cached for s in r.scores],
                               [s for r in prepended for s in r.scores], atol=1e-5)


def test_static_prompt_cache_reused(decoder_dirs, monkeypatch):
    pg = tt.Generator(decoder_dirs["float32"], device="cpu")
    prefills = []
    orig = pg._prefill
    monkeypatch.setattr(pg, "_prefill", lambda ids, cache, start: (
        prefills.append((len(ids), len(ids[0]), start)), orig(ids, cache, start))[1])
    sp = static_prompt()
    first = pg.generate_batch(prompts(), static_prompt=sp, max_length=6)
    assert prefills == [(1, len(sp), 0)]
    second = pg.generate_batch(prompts(), static_prompt=sp, max_length=6)
    assert len(prefills) == 1  # the cached prompt: no prefill
    third = pg.generate_batch(prompts(), static_prompt=sp, max_length=6,
                              cache_static_prompt=False)
    assert len(prefills) == 2 and len(pg._static_prompt_cache) == 1
    pg.generate_batch(prompts(), static_prompt=sp[:5], max_length=6,
                      cache_static_prompt=False)
    assert len(pg._static_prompt_cache) == 1  # not stored either
    assert ([r.sequences_ids for r in first] == [r.sequences_ids for r in second]
            == [r.sequences_ids for r in third])


@pytest.mark.parametrize("beam", [1, 2])
def test_static_prompt_int8_kv(decoder_dirs, monkeypatch, beam):
    """Both packages read CT2TPU_KV_CACHE when they load."""
    monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    jg = ct.Generator(decoder_dirs["float32"], device="cpu")
    pg = tt.Generator(decoder_dirs["float32"], device="cpu")
    opts = dict(static_prompt=static_prompt(), beam_size=beam, max_length=8,
                return_scores=True)
    rj, rp = jg.generate_batch(prompts(), **opts), pg.generate_batch(prompts(), **opts)
    assert pg.model.kv_dtype == torch.int8
    assert [r.sequences_ids for r in rp] == [r.sequences_ids for r in rj]
    np.testing.assert_allclose([s for r in rp for s in r.scores],
                               [s for r in rj for s in r.scores], atol=TOL["int8"])


def test_speculation_k_still_raises(generators):
    """Raised until speculation came; now it decodes the JAX package's
    speculative tokens, which are the plain greedy ones."""
    jg, pg = generators("float32")
    kw = dict(max_length=12, return_scores=True)
    got = pg.generate_batch(prompts(), speculation_k=4, **kw)
    for ref in (jg.generate_batch(prompts(), speculation_k=4, **kw),
                pg.generate_batch(prompts(), **kw)):
        for g, r in zip(got, ref):
            assert g.sequences_ids == r.sequences_ids
            assert abs(g.scores[0] - r.scores[0]) < 1e-4
