"""Random sampling in the port against the JAX package, on the CPU.

The samplers take their Gumbel noise as an argument; the JAX package draws
it from ``fold_in(PRNGKey(seed), step)``. Fed the JAX package's draws (the
noise hook ``sampling.noise_source`` replaced by one that returns them),
the port samples the same tokens:

- ``top_p_mask`` and ``sample_tokens`` against the JAX functions: ids
  equal, scores within 1e-6;
- ``Generator.generate_batch`` (the greedy sampler, ``num_hypotheses`` 3 as
  replicas) and ``Translator.translate_batch`` (greedy and beam 2 with
  sampling) token-identical, scores within 1e-4, on builder models (2
  layers, d_model 64).

Beam search takes the best candidates in both packages whatever the
sampler (the JAX package's ``_beam_search`` builds its signature with the
argmax sampler): beam + sampling gives the argmax beam.

On the CPU, the port's own noise is deterministic for a seed, and its
draws follow the truncated, renormalized distribution (within 5 standard
errors a word, none outside the nucleus).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.decoding import sampling as js
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.converters import builder as tbuilder
from ctranslate2_tpu_torch.decoding import sampling as ts
from test_torch_cuda import assert_frequencies, draw_samples

SCORE_TOL = 1e-6
E2E_TOL = 1e-4
MODEL = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
             num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
             activation="swish")


def _log_probs(rows, vocab, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    return np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _jax_gumbel(key, shape):
    """The noise of ``jax.random.categorical`` (sample_tokens)."""
    return np.array(jax.random.gumbel(key, shape, jnp.float32))


SAMPLE_CASES = {
    "topk_5": dict(topk=5),
    "topk_40": dict(topk=40),  # above 16: lax.top_k / a stable sort
    "topp": dict(topk=0, topp=0.8),
    "temperature": dict(topk=0, temperature=0.7),
    "topk_temperature": dict(topk=10, temperature=1.5),
    "topk_topp": dict(topk=50, topp=0.9),
    "all": dict(topk=50, topp=0.9, temperature=0.7),
}


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.99])
@pytest.mark.parametrize("vocab", [40, 1100])
def test_top_p_mask_matches(p, vocab):
    x = _log_probs(8, vocab, seed=1) / 0.7
    ref = np.asarray(js.top_p_mask(jnp.asarray(x), p))
    out = ts.top_p_mask(torch.from_numpy(x), p).numpy()
    np.testing.assert_array_equal(out == ts.DISABLE, ref == js.DISABLE)
    np.testing.assert_allclose(out, ref, atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
@pytest.mark.parametrize("vocab", [300, 1100])
def test_sample_tokens_matches_fed_jax_noise(case, vocab):
    opts = SAMPLE_CASES[case]
    topk = opts.get("topk", 0)
    lp = _log_probs(16, vocab, seed=2)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    ref_ids, ref_scores = js.sample_tokens(
        jnp.asarray(lp), key, topk=topk, topp=opts.get("topp", 1.0),
        temperature=opts.get("temperature", 1.0))
    shape = ts.sample_noise_shape(16, vocab, topk)
    noise = _jax_gumbel(key, shape)

    # Precondition: the JAX package's draw is the argmax of its scores plus
    # this noise (jax.random.categorical's implementation).
    s = jnp.asarray(lp)
    top_ids = None
    if 0 < topk < vocab:
        s, top_ids = js.small_top_k(s, topk)
    if opts.get("temperature", 1.0) != 1.0:
        s = s / opts["temperature"]
    if opts.get("topp", 1.0) < 1.0:
        s = js.top_p_mask(s, opts["topp"])
    assert np.array_equal(np.asarray(jax.random.categorical(key, s, axis=-1)),
                          np.argmax(np.asarray(s) + noise, axis=-1))

    ids, scores = ts.sample_tokens(
        torch.from_numpy(lp), torch.from_numpy(noise), topk=topk,
        topp=opts.get("topp", 1.0), temperature=opts.get("temperature", 1.0))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores),
                               atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("k", [3, 16, 17, 60])
def test_small_top_k_tie_order_matches(k):
    """Ties break toward the lower index on both sides of the k > 16
    switch, as the JAX package's tournament and ``lax.top_k`` do."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 6, (5, 700)).astype(np.float32)
    ref_v, ref_i = js.small_top_k(jnp.asarray(x), k)
    v, i = ts.small_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


# ---------------------------------------------------------------------------
# End to end, fed the JAX package's noise.
# ---------------------------------------------------------------------------


def _jax_noise_source(draw):
    """A replacement for ``sampling.noise_source`` that returns the JAX
    package's draw for each step: ``draw(fold_in(PRNGKey(seed), step),
    shape)``."""
    def source(seed, device):
        key = jax.random.PRNGKey(seed)

        def noise(step, shape, device):
            arr = draw(jax.random.fold_in(key, step), tuple(shape))
            return torch.from_numpy(np.array(arr)).to(device)
        return noise
    return source


@pytest.fixture(scope="module")
def decoder_dirs(tmp_path_factory):
    dirs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"sampling_decoder_{dtype}"))
        tbuilder.build_decoder_only_model(path, quantization=quant, **MODEL)
        dirs[dtype] = path
    return dirs


@pytest.fixture(scope="module")
def seq2seq_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sampling_seq2seq"))
    return tbuilder.build_seq2seq_model(path, vocab_size=128, num_layers=2,
                                        num_heads=4, d_model=64, d_ff=128)


def _prompts(seed=5):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(0, 90, n)] for n in (5, 1, 12, 9)]


GENERATE_CASES = {
    "topk": dict(sampling_topk=10),
    "topk_40": dict(sampling_topk=40),
    "full_vocab_topp": dict(sampling_topk=0, sampling_topp=0.8),
    "topk_topp_temperature": dict(sampling_topk=20, sampling_topp=0.9,
                                  sampling_temperature=0.7),
    "replicas": dict(sampling_topk=5, num_hypotheses=3),
    "replicas_without_prompt": dict(sampling_topk=5, num_hypotheses=3,
                                    include_prompt_in_result=False),
    "temperature_alone_is_argmax": dict(sampling_temperature=0.5),
    "min_length_repetition": dict(sampling_topk=8, min_length=6,
                                  repetition_penalty=1.3),
}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_batch_sampled_token_identical(decoder_dirs, monkeypatch, case, dtype):
    monkeypatch.setattr(ts, "noise_source", _jax_noise_source(_jax_gumbel))
    jg = ct.Generator(decoder_dirs[dtype], device="cpu")
    tg = tt.Generator(decoder_dirs[dtype], device="cpu")
    opts = dict(max_length=10, return_scores=True, seed=3, **GENERATE_CASES[case])
    ref = jg.generate_batch(_prompts(), **opts)
    out = tg.generate_batch(_prompts(), **opts)
    assert [o.sequences_ids for o in out] == [r.sequences_ids for r in ref]
    assert len(out[0].sequences_ids) == opts.get("num_hypotheses", 1)
    np.testing.assert_allclose([s for o in out for s in o.scores],
                               [s for r in ref for s in r.scores],
                               atol=E2E_TOL, rtol=E2E_TOL)


@pytest.mark.parametrize("opts", [
    dict(beam_size=1, sampling_topk=10),
    dict(beam_size=1, sampling_topk=20, num_hypotheses=3, sampling_topp=0.9),
    dict(beam_size=2, sampling_topk=10),
    dict(beam_size=2, sampling_topk=10, sampling_temperature=0.8, num_hypotheses=2),
], ids=["greedy", "greedy_replicas", "beam", "beam_hypotheses"])
def test_translate_batch_sampled_token_identical(seq2seq_dir, monkeypatch, opts):
    monkeypatch.setattr(ts, "noise_source", _jax_noise_source(_jax_gumbel))
    rng = np.random.default_rng(4)
    source = [[f"tok{i}" for i in rng.integers(0, 125, rng.integers(3, 15))]
              for _ in range(5)]
    ref = ct.Translator(seq2seq_dir, device="cpu").translate_batch(
        source, max_decoding_length=16, return_scores=True, **opts)
    out = tt.Translator(seq2seq_dir, device="cpu").translate_batch(
        source, max_decoding_length=16, return_scores=True, **opts)
    assert [o.hypotheses for o in out] == [r.hypotheses for r in ref]
    if opts["beam_size"] > 1:  # the argmax beam
        argmax = tt.Translator(seq2seq_dir, device="cpu").translate_batch(
            source, max_decoding_length=16, beam_size=opts["beam_size"],
            num_hypotheses=opts.get("num_hypotheses", 1))
        assert [o.hypotheses for o in out] == [a.hypotheses for a in argmax]
    np.testing.assert_allclose([s for o in out for s in o.scores],
                               [s for r in ref for s in r.scores],
                               atol=E2E_TOL, rtol=E2E_TOL)


# ---------------------------------------------------------------------------
# The port's own noise.
# ---------------------------------------------------------------------------


def test_noise_source_is_deterministic_for_a_seed():
    a = ts.noise_source(5, "cpu")
    b = ts.noise_source(5, "cpu")
    c = ts.noise_source(6, "cpu")
    x = [a(step, (3, 40), "cpu") for step in range(3)]
    y = [b(step, (3, 40), "cpu") for step in range(3)]
    z = [c(step, (3, 40), "cpu") for step in range(3)]
    assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not any(torch.equal(u, w) for u, w in zip(x, z))
    assert all(bool(torch.isfinite(u).all()) and u.dtype == torch.float32 for u in x)


def test_generate_batch_is_reproducible_for_a_seed(decoder_dirs):
    tg = tt.Generator(decoder_dirs["float32"], device="cpu")
    runs = [tg.generate_batch(_prompts(), max_length=10, sampling_topk=20,
                              sampling_temperature=1.5, seed=s)
            for s in (1, 1, 2)]
    ids = [[r.sequences_ids for r in run] for run in runs]
    assert ids[0] == ids[1] and ids[0] != ids[2]


@pytest.mark.parametrize("sampler", ["sample_tokens"])
def test_sampler_frequencies_on_cpu(sampler):
    """20,000 draws from one 60-word distribution under top-k 12, top-p 0.9
    and temperature 0.7, with the port's own noise on the CPU."""
    rows, topk, topp, temperature = 20000, 12, 0.9, 0.7
    lp = torch.log_softmax(torch.from_numpy(
        np.random.default_rng(6).standard_normal(60).astype(np.float32)) * 1.5, -1)
    ids = draw_samples(lp, rows, topk, topp, temperature)
    assert_frequencies(ids.numpy(), ts.truncated_probabilities(
        lp.numpy(), topk, topp, temperature), rows)
