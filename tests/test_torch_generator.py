"""The decoder-only slice of the port against the JAX package, on the CPU,
on builder models (2 layers, d_model 64, 4 query / 2 KV heads, rotary,
RMSNorm, gated FFN, vocabulary 96).

- the port's ``build_decoder_only_model`` writes the JAX package's files
  byte for byte;
- rotary tables and ``apply_rotary`` agree within 1e-6;
- the int8 KV cache (append, dequantize, tile) is bit-equal;
- ``decoder_forward`` with ``fresh_prefill`` gives the same hidden states
  and cache within 1e-4 (float32);
- ``Generator.generate_batch`` is token-identical, with scores within 1e-4.

Under int8 weights (W8A8) an activation within an ulp of a half step can
round one int8 step apart in the two frameworks, so the prompts are fixed
ones on which no such tie occurs (see tests/test_torch_translator.py).
``CT2TPU_KV_CACHE=int8`` is read by both packages; a fresh pair of
generators is made per environment because the JAX package reads it when it
builds a decode loop.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
from ctranslate2_tpu.models import transformer as JT
from ctranslate2_tpu.ops import positions as jpos
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.converters import builder as tbuilder
from ctranslate2_tpu_torch.models import transformer as TT
from ctranslate2_tpu_torch.models.params import (cache_from_numpy,
                                                 params_from_numpy)
from ctranslate2_tpu_torch.ops import positions as tpos

MODEL = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
             num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
             activation="swish")


# ---------------------------------------------------------------------------
# Builder.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build,kwargs", [
    ("build_decoder_only_model", MODEL),
    ("build_decoder_only_model", dict(MODEL, quantization="int8")),
    ("build_decoder_only_model", dict(MODEL, rotary_dim=8, tied_projection=True, seed=7)),
    ("build_decoder_only_model", dict(vocab_size=40, num_layers=1, tied_projection=True)),
    ("build_decoder_only_model", dict(MODEL, num_heads_kv=1, quantization="float16")),
    ("build_decoder_only_model", dict(alibi=True)),
    ("build_decoder_only_model", dict(alibi=True, alibi_positive=False)),
    ("build_decoder_only_model", dict(sliding_window=4)),
    ("build_decoder_only_model", dict(MODEL, sliding_window=4, sliding_window_pattern=2,
                                      num_layers=4)),
    ("build_decoder_only_model", dict(parallel_residual=True)),
    ("build_decoder_only_model", dict(parallel_residual=True, shared_layer_norm=True)),
    ("build_decoder_only_model", dict(rel_position_max=4)),
    ("build_decoder_only_model", dict(rel_bias_buckets=8, rel_bias_max_distance=20)),
    ("build_seq2seq_model", dict(merged_attention=True)),
    ("build_seq2seq_model", dict(num_source_features=2, features_merge="add")),
    ("build_decoder_only_model", dict(MODEL, quantization="int16")),
], ids=["gqa_rotary", "int8", "partial_rotary_tied", "learned_positions", "mqa_f16",
        "alibi", "alibi_negative", "sliding_window", "sliding_window_pattern",
        "parallel_residual", "parallel_residual_shared", "rel_position_max",
        "rel_bias_buckets", "seq2seq_merged_attention", "seq2seq_source_features",
        "int16"])
def test_builder_writes_the_same_files(tmp_path, build, kwargs):
    a = getattr(jbuilder, build)(str(tmp_path / "jax"), **kwargs)
    b = getattr(tbuilder, build)(str(tmp_path / "port"), **kwargs)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "model.bin" in names
    assert "vocabulary.json" in names or "shared_vocabulary.json" in names \
        or "target_vocabulary.json" in names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert (sorted(match), mismatch, errors) == (names, [], [])


# ---------------------------------------------------------------------------
# Rotary positions.
# ---------------------------------------------------------------------------

ROTARY_CASES = {
    "default": dict(dim=16),
    "not_interleaved_llama_base": dict(dim=16, base=500000.0, interleave=False),
    "linear": dict(dim=8, scaling_type="linear", scaling_factor=4.0),
    "llama3": dict(dim=16, scaling_type="llama3", scaling_factor=8.0,
                   low_freq_factor=1.0, high_freq_factor=4.0,
                   original_max_position_embeddings=32),
    "su_long": dict(dim=8, scaling_type="su",
                    long_factor=np.linspace(1, 2, 4, dtype=np.float32),
                    short_factor=np.ones(4, np.float32),
                    original_max_position_embeddings=32,
                    max_position_embeddings=128),
}


@pytest.mark.parametrize("case", sorted(ROTARY_CASES))
def test_rotary_tables_match(case):
    kw = dict(ROTARY_CASES[case])
    dim = kw.pop("dim")
    for a, b in zip(tpos.rotary_tables(64, dim, **kw), jpos.rotary_tables(64, dim, **kw)):
        assert a.shape == (64, dim) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("rotary_dim", [0, 8])
def test_apply_rotary_matches(interleave, rotary_dim):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 10, 16)).astype(np.float32)
    dim = rotary_dim or 16
    sin, cos = jpos.rotary_tables(32, dim, interleave=interleave)
    sin, cos = sin[5:15], cos[5:15]
    ref = jpos.apply_rotary(jnp.asarray(x), jnp.asarray(sin), jnp.asarray(cos),
                            interleave, rotary_dim)
    out = tpos.apply_rotary(torch.from_numpy(x), torch.from_numpy(sin),
                            torch.from_numpy(cos), interleave, rotary_dim)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    if rotary_dim:
        np.testing.assert_array_equal(out.numpy()[..., dim:], x[..., dim:])


# ---------------------------------------------------------------------------
# Models, caches, decoder_forward.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    dirs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"decoder_{dtype}"))
        tbuilder.build_decoder_only_model(path, quantization=quant, **MODEL)
        dirs[dtype] = path
    return dirs


def _np_cache(cache):
    return jax.tree.map(np.asarray, cache)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("kwargs", [
    MODEL, dict(MODEL, quantization="int8"),
    dict(MODEL, quantization="int8", tied_projection=True),
    dict(vocab_size=40, num_layers=1)], ids=["float32", "int8", "int8_tied",
                                             "learned_positions"])
def test_params_from_numpy_equals_loader_decoder_only(tmp_path, kwargs):
    """The decoder-only tree (gated FFN, gamma-only norms, int8 embeddings, a
    separate or tied projection) carried across from the JAX package equals
    the port's own load; rotary needs no parameters."""
    from ctranslate2_tpu.models import loader as jloader

    path = tbuilder.build_decoder_only_model(str(tmp_path / "m"), **kwargs)
    jm = jloader.load_model(path)
    tm = tt.load_model(path, device="cpu")
    assert tm.is_decoder_only and not tm.is_sequence_to_sequence
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.arch)
    a, b = dict(_leaves(carried)), dict(_leaves(tm.params))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name
    if kwargs.get("glu"):
        assert "/decoder/layers/0/ffn/linear_0_noact/" + (
            "wq" if kwargs.get("quantization") else "w") in a
        assert "/decoder/layers/0/ffn/layer_norm/beta" not in a


def _tie_free(rng, shape):
    """Vectors whose int8 scale is exactly 64 and whose values sit on no
    half step, so both frameworks quantize them alike."""
    x = rng.integers(-126, 127, shape).astype(np.float32) / 64.0
    x[..., 0] = 127.0 / 64.0
    return x


def test_int8_cache_append_dequantize_and_tile_bit_equal(model_dirs):
    arch = tt.load_model(model_dirs["float32"], device="cpu").arch
    jcache = JT.init_self_cache(arch_j(model_dirs), 3, 16, dtype=jnp.int8)
    tcache = TT.init_self_cache(arch, 3, 16, dtype=torch.int8)
    assert sorted(tcache[0]) == ["k", "k_scale", "v", "v_scale"]
    assert tcache[0]["k"].dtype == torch.int8
    assert tuple(tcache[0]["k_scale"].shape) == (3, 2, 1, 16)
    rng = np.random.default_rng(1)
    for offset, T in ((0, 5), (5, 1), (6, 3)):
        k, v = _tie_free(rng, (3, 2, T, 16)), _tie_free(rng, (3, 2, T, 16))
        jcache[0] = JT._update_int8_cache(jcache[0], jnp.asarray(k),
                                          jnp.asarray(v), offset)
        TT._update_int8_cache(tcache[0], torch.from_numpy(k),
                              torch.from_numpy(v), offset)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tcache[0][name].numpy(),
                                      np.asarray(jcache[0][name]))
    for a, b in zip(TT._dequantize_cache(tcache[0], torch.float32),
                    JT._dequantize_cache(jcache[0], jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tiled = TT.cache_repeat_rows(tcache, 2)
    ref = JT.cache_repeat_rows(jcache, 2)
    carried = cache_from_numpy(_np_cache(ref))
    for layer_t, layer_c in zip(tiled, carried):
        for name in layer_t:
            assert torch.equal(layer_t[name], layer_c[name])
    rows = torch.tensor([5, 0, 3, 3], dtype=torch.int32)
    gathered = TT.cache_gather_rows(tiled, rows)
    for name in ("k", "k_scale"):
        assert torch.equal(gathered[0][name], tiled[0][name][rows.long()])


def arch_j(model_dirs):
    from ctranslate2_tpu.models import loader as jloader

    return jloader.load_model(model_dirs["float32"]).arch


def test_cache_from_numpy_splits_a_stacked_cache():
    rng = np.random.default_rng(2)
    stacked = {"k": rng.standard_normal((3, 2, 2, 8, 4)).astype(np.float32),
               "v": rng.standard_normal((3, 2, 2, 8, 4)).astype(np.float32)}
    cache = cache_from_numpy(stacked)
    assert len(cache) == 3
    np.testing.assert_array_equal(cache[1]["v"].numpy(), stacked["v"][1])


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_decoder_forward_fresh_prefill_matches(model_dirs, kv, with_lengths):
    from ctranslate2_tpu.models import loader as jloader

    jm = jloader.load_model(model_dirs["float32"])
    tm = tt.load_model(model_dirs["float32"], device="cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 96, (3, 9))
    lengths = np.array([9, 4, 7]) if with_lengths else None
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32, torch.float32)
    jcache = JT.init_self_cache(jm.arch, 3, 64, dtype=jdt)
    tcache = TT.init_self_cache(tm.arch, 3, 64, dtype=tdt)
    jh, jcache, _ = JT.decoder_forward(
        jm.arch, jm.params, jm.consts, jnp.asarray(ids, jnp.int32), 0, jcache,
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32),
        quantize_acts=False, return_logits=False, fresh_prefill=True)
    th, tcache = TT.decoder_forward(
        tm.arch, tm.params, tm.consts, torch.from_numpy(ids), 0, tcache,
        lengths=None if lengths is None else torch.from_numpy(lengths),
        quantize_acts=False, return_logits=False, fresh_prefill=True)
    assert tuple(th.shape) == (3, 9, 64)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    for tl, jl in zip(tcache, _np_cache(jcache)):
        if kv == "int8":
            # Payloads may part by one int8 step where a float32 sum lands
            # within an ulp of a half step; compare what they stand for.
            tk, tv = TT._dequantize_cache(tl, torch.float32)
            jk, jv = JT._dequantize_cache(jax.tree.map(jnp.asarray, jl), jnp.float32)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=2e-2)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-2)
            assert np.mean(tl["k"].numpy() == jl["k"]) > 0.999
        else:
            np.testing.assert_allclose(tl["k"].numpy(), jl["k"], atol=1e-4)
            np.testing.assert_allclose(tl["v"].numpy(), jl["v"], atol=1e-4)
    # One more token against the filled cache, with logits.
    nxt = rng.integers(3, 96, (3, 1))
    jl2, _, _ = JT.decoder_forward(
        jm.arch, jm.params, jm.consts, jnp.asarray(nxt, jnp.int32), 9, jcache,
        quantize_acts=False)
    tl2, _ = TT.decoder_forward(
        tm.arch, tm.params, tm.consts, torch.from_numpy(nxt), 9, tcache,
        quantize_acts=False)
    tol = 2e-3 if kv == "int8" else 1e-4
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=tol, rtol=tol)


def test_decoder_forward_per_row_positions_raise(model_dirs):
    """Per-row positions run since continuous batching came
    (tests/test_torch_per_row_positions.py holds them against the JAX
    package); a position vector must have one entry a row."""
    tm = tt.load_model(model_dirs["float32"], device="cpu")
    with pytest.raises(ValueError, match="per-row"):
        TT.decoder_forward(tm.arch, tm.params, tm.consts,
                           torch.zeros((2, 1), dtype=torch.long),
                           torch.tensor([1, 2, 3]), None)


# ---------------------------------------------------------------------------
# Generator.generate_batch.
# ---------------------------------------------------------------------------

def _prompts(seed=0, lengths=(9, 5, 7, 12)):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(0, 90, n)] for n in lengths]


def _pair(model_dirs, dtype, **kwargs):
    return (ct.Generator(model_dirs[dtype], device="cpu", **kwargs),
            tt.Generator(model_dirs[dtype], device="cpu", **kwargs))


def _compare(jg, tg, prompts, **opts):
    opts.setdefault("max_length", 12)
    opts.setdefault("return_scores", True)
    ref = jg.generate_batch(prompts, **opts)
    out = tg.generate_batch(prompts, **opts)
    assert len(out) == len(ref) == len(prompts)
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids
        assert o.sequences == r.sequences
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-4, rtol=1e-4)
    return out


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("include_prompt", [True, False])
def test_generate_batch_token_identical(model_dirs, monkeypatch, include_prompt,
                                        dtype, kv):
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    jg, tg = _pair(model_dirs, dtype)
    assert tg.model.kv_dtype == (torch.int8 if kv == "int8" else torch.float32)
    out = _compare(jg, tg, _prompts(), include_prompt_in_result=include_prompt)
    for o, p in zip(out, _prompts()):
        # Ragged prompts: the shortest sets the prefill, the rest is forced.
        if include_prompt:
            assert o.sequences[0][:len(p)] == p
        assert len(o.sequences[0]) <= 12 + (len(p) if include_prompt else 7)


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("include_prompt", [True, False])
def test_generate_batch_beam_token_identical(model_dirs, monkeypatch,
                                             include_prompt, kv):
    """Beam search: the chain mask applies only to a float cache that the
    loop creates itself; a prefilled or int8 cache is reordered row by row."""
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    jg, tg = _pair(model_dirs, "float32")
    _compare(jg, tg, _prompts(1), include_prompt_in_result=include_prompt,
             beam_size=2, num_hypotheses=2)


# Gemma-style 256-wide heads (4 query / 2 KV heads of 256, d_model 1024).
WIDE_HEADS = dict(MODEL, d_model=1024, d_ff=128)


@pytest.fixture(scope="module")
def wide_head_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decoder_head_dim_256"))
    tbuilder.build_decoder_only_model(path, **WIDE_HEADS)
    return path


@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("include_prompt", [True, False])
def test_generate_batch_head_dim_256_int8_kv_token_identical(
        wide_head_dir, monkeypatch, include_prompt, beam_size):
    """The slice at a head dim of 256 with the int8 KV cache: greedy and
    beam tokens identical to the JAX package's. Scores within 1e-3: at
    d_model 1024 the two frameworks' float32 sums put some K/V entries within
    6e-6 of a half step of the int8 grid, where the cache may round one step
    apart; one such step moves a row's score by 3.4e-4 here (the float
    cache agrees to 2e-6)."""
    monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    jg = ct.Generator(wide_head_dir, device="cpu")
    tg = tt.Generator(wide_head_dir, device="cpu")
    assert tg.model.kv_dtype == torch.int8
    assert tg.model.arch.decoder.layers[0].self_attention.head_dim == 256
    opts = dict(max_length=12, return_scores=True, beam_size=beam_size,
                include_prompt_in_result=include_prompt)
    ref = jg.generate_batch(_prompts(3), **opts)
    out = tg.generate_batch(_prompts(3), **opts)
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids and o.sequences == r.sequences
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-3, rtol=0)


# Heads wider than the card's attention kernels take (4 query / 2 KV heads of
# 320, d_model 1280): on the card they take the plain attention.
WIDER_HEADS = dict(MODEL, d_model=1280, d_ff=128)


@pytest.fixture(scope="module")
def wider_head_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decoder_head_dim_320"))
    tbuilder.build_decoder_only_model(path, **WIDER_HEADS)
    return path


@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_generate_batch_head_dim_320_token_identical(wider_head_dir, monkeypatch, kv,
                                                     beam_size):
    """The slice at a head dim of 320, above every attention kernel's
    widest instance: greedy and beam tokens identical to the JAX package's.
    Scores within 1e-4 with the float cache; within 1e-3 with the int8
    cache, where a K/V entry at a half step of the int8 grid may round one
    step apart (see the head-dim-256 test)."""
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    jg = ct.Generator(wider_head_dir, device="cpu")
    tg = tt.Generator(wider_head_dir, device="cpu")
    assert tg.model.arch.decoder.layers[0].self_attention.head_dim == 320
    assert tg.model.kv_dtype == (torch.int8 if kv == "int8" else torch.float32)
    opts = dict(max_length=12, return_scores=True, beam_size=beam_size,
                include_prompt_in_result=False)
    ref = jg.generate_batch(_prompts(4), **opts)
    out = tg.generate_batch(_prompts(4), **opts)
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids and o.sequences == r.sequences
        np.testing.assert_allclose(o.scores, r.scores, rtol=0,
                                   atol=1e-3 if kv == "int8" else 1e-4)


@pytest.mark.parametrize("opts", [
    dict(end_token="tok11", include_prompt_in_result=False),
    dict(end_token=["tok11", "tok40"], return_end_token=True),
    dict(min_length=6, max_length=8, include_prompt_in_result=False),
    dict(return_scores=False, include_prompt_in_result=False),
    dict(repetition_penalty=1.3, no_repeat_ngram_size=2),
    dict(max_batch_size=2, include_prompt_in_result=False),
    dict(length_penalty=0.6, disable_unk=True),
], ids=["end_token", "end_tokens_returned", "min_length", "no_scores",
        "penalties", "rebatched", "length_penalty"])
def test_generate_batch_options_token_identical(model_dirs, opts):
    jg, tg = _pair(model_dirs, "float32")
    _compare(jg, tg, _prompts(2), **opts)


def test_generate_batch_min_length_and_single_token_prompts(model_dirs):
    jg, tg = _pair(model_dirs, "float32")
    out = _compare(jg, tg, [["tok3"], ["<s>"], ["tok9", "tok4"]],
                   min_length=5, max_length=5, include_prompt_in_result=False)
    assert [len(o.sequences[0]) for o in out] == [5, 5, 5]


def test_flash_attention_flag_changes_nothing_on_cpu(model_dirs):
    jg, tg = _pair(model_dirs, "float32", flash_attention=True)
    assert tg.model.arch.flash_min_len == 0
    flagged = _compare(jg, tg, _prompts(3), include_prompt_in_result=False)
    plain = tt.Generator(model_dirs["float32"], device="cpu").generate_batch(
        _prompts(3), include_prompt_in_result=False, max_length=12)
    assert [o.sequences_ids for o in flagged] == [o.sequences_ids for o in plain]


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_prefill_in_jax_decode_in_port(model_dirs, monkeypatch, kv):
    """The JAX package prefills the prompt, its cache is carried across, and
    the port decodes from it: the same tokens as the port alone."""
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    jg, tg = _pair(model_dirs, "float32")
    prompts = _prompts(4, lengths=(8, 8, 8))
    ids = [[tg._vocab.to_id(t) for t in p] for p in prompts]
    capacity = 64
    jg.model.ensure_consts(capacity)
    jcache = JT.init_self_cache(jg.model.arch, 3, capacity, dtype=jg.model.kv_dtype,
                                stacked=jg.model.scan_layers)
    jcache = jg._prefill([row[:-1] for row in ids], jcache, 0, capacity)
    carried = cache_from_numpy(_np_cache(jcache))
    assert ("k_scale" in carried[0]) == (kv == "int8")

    from ctranslate2_tpu_torch.decoding.options import DecodingOptions

    options = DecodingOptions(max_length=10, return_scores=True, return_prefix=False)
    mixed = tg.engine.decode([row[-1] for row in ids], options, cache=carried,
                             start_step=7, end_ids=(tg._vocab.eos_id,),
                             capacity=capacity)
    alone = tg.generate_batch(prompts, max_length=10, return_scores=True,
                              include_prompt_in_result=False)
    for m, a in zip(mixed, alone):
        assert m.hypotheses == a.sequences_ids
        np.testing.assert_allclose(m.scores, a.scores, atol=1e-4)


@pytest.mark.parametrize("option", [
    dict(static_prompt=["tok1"]), dict(callback=lambda step: False),
    dict(return_alternatives=True), dict(speculation_k=4),
    dict(return_logits_vocab=True)],
    ids=["static_prompt", "callback", "alternatives", "speculation",
         "logits_vocab"])
def test_unported_generator_options_raise(model_dirs, option):
    """Each option runs: the host-loop ones since the host decode loops
    came (tests/test_torch_host_loops.py holds them against the JAX
    package), ``speculation_k`` since lossless speculation came
    (tests/test_torch_speculation.py)."""
    tg = tt.Generator(model_dirs["float32"], device="cpu")
    out = tg.generate_batch(_prompts(), max_length=4, **option)
    assert len(out) == len(_prompts()) and all(r.sequences_ids for r in out)


@pytest.mark.parametrize("method", ["generate_tokens", "generate_iterable"])
def test_unported_generator_methods_raise(model_dirs, method):
    """Both raised until the streaming helpers came; now each runs
    (tests/test_torch_file_helpers.py holds them against the JAX package)."""
    tg = tt.Generator(model_dirs["float32"], device="cpu")
    if method == "generate_tokens":
        steps = list(tg.generate_tokens(["tok1"], max_length=4))
        assert steps and steps[-1].is_last and len(steps) <= 4
    else:
        out = list(tg.generate_iterable([["tok1"], ["tok2", "tok3"]], max_length=4))
        assert len(out) == 2 and all(r.sequences_ids for r in out)


def test_generator_entry_checks(model_dirs, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tt.Generator(model_dirs["float32"])
    tg = tt.Generator(model_dirs["int8"], device="cpu")
    assert tg.compute_type == "int8_float32" and tg.device == "cpu"
    assert tg.generate_batch([]) == []
    with pytest.raises(ValueError, match="start token"):
        tg.generate_batch([[]])
    seq2seq = tbuilder.build_seq2seq_model(str(tmp_path / "s2s"))
    with pytest.raises(ValueError, match="decoder-only"):
        tt.Generator(seq2seq, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        tt.Translator(model_dirs["float32"], device="cpu")
    futures = tg.generate_batch(_prompts(), max_length=4, asynchronous=True)
    assert all(len(f.result().sequences[0]) >= 4 for f in futures)


def test_generator_is_freed_after_use(model_dirs):
    """A Generator that has run a call is freed once dropped: its worker
    thread keeps no reference to the last job, whose function is a bound
    method of the Generator (its model's weights would stay on the card)."""
    import gc
    import weakref

    tg = tt.Generator(model_dirs["float32"], device="cpu")
    tg.generate_batch(_prompts(), max_length=4)
    model = weakref.ref(tg.model)
    del tg
    gc.collect()
    assert model() is None
