"""Sandwich-norm, parallel-residual and merged-attention layers, and the JAX
package's stacked (scan) layers, in the port against the JAX package, on
the CPU.

- parallel residual in both forms (builder models, 3 layers, d_model 64:
  one shared norm as GPT-J and Falcon write it, two norms of the same input
  as GPT-NeoX does) and a Gemma-2 model from the JAX package's
  Transformers converter (3 layers, sandwich norms with the plus-one gamma,
  a window of 4 on every other layer, final softcap 30): ``generate_batch``
  (greedy and beam) and ``score_batch`` give the JAX package's tokens;
- T5Gemma from that converter (sandwich encoder and decoder layers with
  cross-attention, hybrid windows) and the builder's seq2seq model with
  ``merged_attention`` (one softmax over [self keys | memory keys]):
  ``translate_batch``, ``score_batch`` and, for T5Gemma,
  ``Encoder.forward_batch``;
- under W8A8 every such layer quantizes each activation once: the residual
  stream travels as (x, delta), so a layer that added its residual twice or
  skipped it would part from the JAX package at the second layer, and a
  shared norm quantizes once for the QKV and the FFN's first linear;
- ``stack_layers=True`` (``CT2TPU_SCAN_LAYERS=1``) in the JAX package gives
  the port's tokens and logits: ``params_from_numpy`` splits its stacked
  tree by layer, and the port's per-layer loop is the scan's counterpart.

Tolerances and tie-free inputs as in ``test_torch_positions_bias.py``.
"""

import numpy as np
import pytest
import torch

import jax

import ctranslate2_tpu as ct
from ctranslate2_tpu.models import loader as jloader
import ctranslate2_tpu_torch as tt
import ctranslate2_tpu_torch.ops.linear as L
from ctranslate2_tpu_torch.converters import builder as tbuilder
from ctranslate2_tpu_torch.models import transformer as TT
from ctranslate2_tpu_torch.models.params import params_from_numpy

from test_torch_positions_bias import (TOL, compare_encoders, compare_generator_scores,
                                       compare_generators, compare_translator_scores,
                                       compare_translators, convert,
                                       converter_prompts, prompts, set_kv)

BASE = dict(vocab_size=96, num_layers=3, num_heads=4, d_model=64, d_ff=96,
            rotary_dim=0)
PARALLEL = {
    "parallel_shared_norm": dict(parallel_residual=True, shared_layer_norm=True),
    "parallel_two_norms": dict(parallel_residual=True),
}
# Inputs free of W8A8 half-step ties, by case: the seed of ``prompts``.
TIE_FREE_SEEDS = {}


@pytest.fixture(scope="module")
def decoder_dirs(tmp_path_factory):
    import transformers

    dirs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        for name, kw in PARALLEL.items():
            path = str(tmp_path_factory.mktemp(f"{name}_{dtype}"))
            tbuilder.build_decoder_only_model(path, quantization=quant, **BASE, **kw)
            dirs[name, dtype] = path
        torch.manual_seed(0)
        cfg = transformers.Gemma2Config(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
            head_dim=8, sliding_window=4, query_pre_attn_scalar=8,
            attn_logit_softcapping=None, final_logit_softcapping=30.0)
        dirs["gemma2", dtype] = convert(transformers.Gemma2ForCausalLM(cfg),
                                        tmp_path_factory.mktemp(f"gemma2_{dtype}"),
                                        quant)
    return dirs


def _batch(name, dtype):
    seed = TIE_FREE_SEEDS.get((name, dtype), 0)
    return converter_prompts(seed) if name == "gemma2" else prompts(seed)


@pytest.mark.parametrize("search", ["greedy", "beam", "greedy_prompt_in_result"])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["gemma2", *sorted(PARALLEL)])
def test_decoder_layers_generate_like_jax(decoder_dirs, monkeypatch, name, dtype, kv,
                                          search):
    set_kv(monkeypatch, kv)
    compare_generators(decoder_dirs[name, dtype], _batch(name, dtype), kv,
                       beam_size=2 if search == "beam" else 1,
                       include_prompt_in_result=search == "greedy_prompt_in_result")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["gemma2", *sorted(PARALLEL)])
def test_decoder_layers_score_like_jax(decoder_dirs, name, dtype):
    compare_generator_scores(decoder_dirs[name, dtype], _batch(name, dtype))


def test_layer_specs(decoder_dirs):
    g = tt.load_model(decoder_dirs["gemma2", "float32"], device="cpu").arch.decoder
    assert all(layer.sandwich_norm for layer in g.layers)
    assert [layer.self_attention.sliding_window for layer in g.layers] == [4, 0, 4]
    assert g.final_logit_softcapping == 30.0
    shared = tt.load_model(decoder_dirs["parallel_shared_norm", "float32"],
                           device="cpu").arch.decoder.layers[0]
    two = tt.load_model(decoder_dirs["parallel_two_norms", "float32"],
                        device="cpu").arch.decoder.layers[0]
    assert shared.shared_layer_norm and not shared.post_attention_layer_norm
    assert two.input_layer_norm and two.post_attention_layer_norm


def _quantizations(monkeypatch, path, widths):
    """The int8 activations of one 8-token forward pass, by width."""
    seen = []
    real = L.int8_activations

    def spy(q, scale, dtype):
        seen.append(q.shape[-1])
        return real(q, scale, dtype)

    monkeypatch.setattr(L, "int8_activations", spy)
    tm = tt.load_model(path, device="cpu")
    ids = torch.arange(3, 11)[None]
    TT.decoder_forward(tm.arch, tm.params, tm.consts, ids, 0, None, return_logits=False)
    return {w: seen.count(w) for w in widths}


@pytest.mark.parametrize("name,expected", [
    # Per layer (3 layers): one norm output for QKV and the FFN's linear_0
    # (the shared norm), the attention output (width 64), the FFN's inner
    # activation (width 96); no projection (hidden states out).
    ("parallel_shared_norm", {64: 3 * 2, 96: 3, 192: 0}),
    # The second norm quantizes once more, for linear_0.
    ("parallel_two_norms", {64: 3 * 3, 96: 3, 192: 0}),
])
def test_parallel_layers_quantize_each_activation_once(decoder_dirs, monkeypatch,
                                                       name, expected):
    counts = _quantizations(monkeypatch, decoder_dirs[name, "int8"], expected)
    assert counts == expected


def test_sandwich_layers_quantize_each_activation_once(decoder_dirs, monkeypatch):
    """Gemma-2 (width 32, heads 4 x 8, FFN 64, 3 layers), per layer: the
    input norm for QKV, the attention output, the pre-FFN norm once for the
    GLU pair (width 32), the FFN's inner activation (width 64). The post
    norms normalise the deltas and quantize nothing."""
    counts = _quantizations(monkeypatch, decoder_dirs["gemma2", "int8"], (32, 64))
    assert counts == {32: 3 * 3, 64: 3}


@pytest.fixture(scope="module")
def seq2seq_dirs(tmp_path_factory):
    import transformers

    dirs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"merged_{dtype}"))
        dirs["merged", dtype] = tbuilder.build_seq2seq_model(
            path, quantization=quant, vocab_size=96, merged_attention=True)
        module = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=8, intermediate_size=64,
                      vocab_size=64, sliding_window=4, query_pre_attn_scalar=8,
                      layer_types=["sliding_attention", "full_attention"],
                      max_position_embeddings=64)
        torch.manual_seed(0)
        cfg = transformers.T5GemmaConfig(
            encoder=transformers.T5GemmaModuleConfig(**module),
            decoder=transformers.T5GemmaModuleConfig(**module), vocab_size=64)
        dirs["t5gemma", dtype] = convert(
            transformers.T5GemmaForConditionalGeneration(cfg),
            tmp_path_factory.mktemp(f"t5gemma_{dtype}"), quant)
    return dirs


def _sources(name, seed=0):
    return converter_prompts(seed) if name == "t5gemma" else prompts(seed)


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["merged", "t5gemma"])
def test_seq2seq_layers_translate_like_jax(seq2seq_dirs, monkeypatch, name, dtype, kv,
                                           beam):
    set_kv(monkeypatch, kv)
    compare_translators(seq2seq_dirs[name, dtype],
                        _sources(name, TIE_FREE_SEEDS.get((name, dtype), 0)), kv,
                        beam_size=beam)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["merged", "t5gemma"])
def test_seq2seq_layers_score_like_jax(seq2seq_dirs, name, dtype):
    seed = TIE_FREE_SEEDS.get((name, dtype), 0)
    compare_translator_scores(seq2seq_dirs[name, dtype], _sources(name, seed),
                              [p[:4] for p in _sources(name, seed + 10)])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sandwich_encoder_encodes_like_jax(seq2seq_dirs, dtype):
    arch = tt.load_model(seq2seq_dirs["t5gemma", dtype], device="cpu").arch
    assert all(layer.sandwich_norm for layer in arch.encoder.layers)
    compare_encoders(seq2seq_dirs["t5gemma", dtype], _sources("t5gemma"))


def test_merged_attention_layout(seq2seq_dirs):
    tm = tt.load_model(seq2seq_dirs["merged", "float32"], device="cpu")
    layer = tm.arch.decoder.layers[0]
    assert layer.self_attention.has_memory_kv and layer.cross_attention is None
    w = tm.params["decoder"]["layers"][0]["self_attention"]["memory_kv"]["w"]
    assert tuple(w.shape) == (32, 64)


# ---------------------------------------------------------------------------
# The JAX package's stacked (scan) layers.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uniform_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("uniform"))
    return tbuilder.build_decoder_only_model(
        path, vocab_size=96, num_layers=3, num_heads=4, d_model=64, d_ff=96,
        rotary_dim=0, glu=True, rms_norm=True, activation="swish", num_heads_kv=2)


def test_stacked_params_carry_to_the_port(uniform_dir):
    jm = jloader.load_model(uniform_dir, compute_type="float32", stack_layers=True)
    assert jm.scan_layers and isinstance(jm.params["decoder"]["layers"], dict)
    tm = tt.load_model(uniform_dir, device="cpu")
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.arch)
    assert len(carried["decoder"]["layers"]) == 3
    for a, b in zip(carried["decoder"]["layers"], tm.params["decoder"]["layers"]):
        assert torch.equal(a["self_attention"]["qkv"]["w"], b["self_attention"]["qkv"]["w"])
        assert torch.equal(a["ffn"]["linear_1"]["w"], b["ffn"]["linear_1"]["w"])
    ids = torch.arange(3, 14)[None]
    ours = TT.decoder_forward(tm.arch, carried, tm.consts, ids, 0, None)[0]
    ref = TT.decoder_forward(tm.arch, tm.params, tm.consts, ids, 0, None)[0]
    assert torch.equal(ours, ref)


@pytest.mark.parametrize("beam", [1, 2])
def test_scan_layers_generate_like_the_port(uniform_dir, monkeypatch, beam):
    """``CT2TPU_SCAN_LAYERS=1``: the JAX package scans one layer body over
    stacked weights; its tokens and scores are the port's."""
    monkeypatch.setenv("CT2TPU_SCAN_LAYERS", "1")
    jg = ct.Generator(uniform_dir, device="cpu")
    assert jg.model.scan_layers
    opts = dict(max_length=10, return_scores=True, beam_size=beam,
                include_prompt_in_result=False)
    ref = jg.generate_batch(prompts(), **opts)
    out = tt.Generator(uniform_dir, device="cpu").generate_batch(prompts(), **opts)
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=TOL, rtol=0)
