"""Hugging Face Transformers -> CTranslate2-format model directory.

Functional parity with the reference converter registry
(reference: python/ctranslate2/converters/transformers.py:289-4069),
re-implemented against this package's SpecBuilder. Loaders are registered
by HF config class name; each maps module weights onto the CT2 variable
scopes consumed by :mod:`..models.spec`.

Weights come from a local checkpoint directory (or an in-memory
``PreTrainedModel`` for tests) — no network access is required.

The port's copy of ``ctranslate2_tpu/converters/transformers_conv.py``: it writes the
same model directory, byte for byte, and imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np

from .builder import ACTIVATION_IDS, SpecBuilder

LOADERS: Dict[str, Callable] = {}

_HF_ACTIVATIONS = {
    "gelu": "gelu_tanh",  # HF "gelu" for GPT-2 family is the tanh approx
    "gelu_new": "gelu_tanh",
    "gelu_fast": "gelu_tanh",
    "gelu_pytorch_tanh": "gelu_tanh",
    "gelu_python": "gelu",
    "gelu_accurate": "gelu_tanh",
    "relu": "relu",
    "silu": "swish",
    "swish": "swish",
    "quick_gelu": "gelu_sigmoid",
    "tanh": "tanh",
}


def register(*names):
    def deco(fn):
        for n in names:
            LOADERS[n] = fn
        return fn

    return deco


def _np(tensor) -> np.ndarray:
    return tensor.detach().to("cpu").float().numpy()


def _is_awq(module) -> bool:
    return hasattr(module, "qweight")


def _np_int(tensor) -> np.ndarray:
    return tensor.detach().to("cpu").numpy().astype(np.int32)


class ConvBuilder(SpecBuilder):
    """SpecBuilder with torch-module-aware setters."""

    def _record_awq(self, module):
        # AutoAWQ module classes: WQLinear_GEMM / WQLinear_GEMV
        # (reference converter: transformers.py:49-51, 237-248).
        version = 2 if "GEMV" in type(module).__name__.upper() else 1
        self._awq_config = {
            "quantization_type": version,
            "quantization_bits": int(getattr(module, "w_bit", 4)),
            "quantization_group_size": int(getattr(module, "group_size", 128)),
        }
        return version

    def set_awq_linear(self, scope: str, module):
        """Pass through AWQ-packed weights unchanged
        (reference: transformers.py:241-244)."""
        self._record_awq(module)
        self.add(f"{scope}/weight", _np_int(module.qweight))
        self.add(f"{scope}/weight_scale", _np(module.scales))
        self.add(f"{scope}/weight_zero", _np_int(module.qzeros))
        if getattr(module, "bias", None) is not None:
            self.add(f"{scope}/bias", _np(module.bias))

    def set_linear(self, scope: str, module, transpose: bool = False):
        if _is_awq(module):
            self.set_awq_linear(scope, module)
            return
        w = _np(module.weight)
        if transpose or type(module).__name__ == "Conv1D":
            w = w.T  # HF GPT-2 Conv1D stores [in, out]
        self.add(f"{scope}/weight", np.ascontiguousarray(w))
        if getattr(module, "bias", None) is not None:
            self.add(f"{scope}/bias", _np(module.bias))

    def set_qkv(self, scope: str, q, k, v, transpose: bool = False):
        """Store a fused QKV projection in artifact layout [q|k|v]."""
        if _is_awq(q):
            # AWQ GEMM packs [in, out/8]: fuse along axis 1; GEMV packs
            # [out, in/8]: fuse along axis 0.
            axis = 0 if self._record_awq(q) == 2 else 1
            self.add(f"{scope}/linear_0/weight",
                     np.concatenate([_np_int(m.qweight) for m in (q, k, v)], axis))
            self.add(f"{scope}/linear_0/weight_scale",
                     np.concatenate([_np(m.scales) for m in (q, k, v)], axis))
            self.add(f"{scope}/linear_0/weight_zero",
                     np.concatenate([_np_int(m.qzeros) for m in (q, k, v)], axis))
            if getattr(q, "bias", None) is not None:
                self.add(f"{scope}/linear_0/bias",
                         np.concatenate([_np(m.bias) for m in (q, k, v)]))
            return
        ws = []
        bs = []
        for m in (q, k, v):
            w = _np(m.weight)
            if transpose or type(m).__name__ == "Conv1D":
                w = w.T
            ws.append(w)
            if getattr(m, "bias", None) is not None:
                bs.append(_np(m.bias))
        self.add(f"{scope}/linear_0/weight", np.concatenate(ws, axis=0))
        if len(bs) == len(ws):
            self.add(f"{scope}/linear_0/bias", np.concatenate(bs, axis=0))

    def set_layer_norm(self, scope: str, module, rms: bool = False,
                       plus_one: bool = False):
        gamma = _np(module.weight)
        if plus_one:
            # Gemma RMSNorm computes x * rms * (1 + gamma); bake in the +1.
            gamma = gamma + 1.0
        self.add(f"{scope}/gamma", gamma)
        if not rms and getattr(module, "bias", None) is not None:
            self.add(f"{scope}/beta", _np(module.bias))

    def set_embeddings(self, scope: str, module):
        self.add(f"{scope}/weight", _np(module.weight))

    def set_position_embeddings(self, scope: str, module, offset: int = 0):
        # Sinusoidal modules (M2M100/NLLB) store the table as `weights`.
        w = _np(module.weight if hasattr(module, "weight") else module.weights)
        if offset:
            w = w[offset:]
        self.add(f"{scope}/encodings", w)


def get_vocabulary(model, tokenizer):
    """Token list ordered by id, padded to the model vocab size
    (reference: transformers.py ModelLoader.get_vocabulary)."""
    vocab = tokenizer.get_vocab()
    tokens = [None] * len(vocab)
    for tok, idx in vocab.items():
        if idx < len(tokens):
            tokens[idx] = tok
    tokens = [t if t is not None else f"<pad_{i}>" for i, t in enumerate(tokens)]
    vocab_size = getattr(model.config, "vocab_size", len(tokens))
    for i in range(vocab_size - len(tokens)):
        tokens.append(f"<extra_id_{i}>")
    if vocab_size and vocab_size < len(tokens):
        tokens = tokens[:vocab_size]
    return tokens


# ---------------------------------------------------------------------------
# Decoder-only loaders.
# ---------------------------------------------------------------------------


@register("GPT2Config")
def load_gpt2(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    b.add_attr(f"{sc}/num_heads", config.n_head, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(
        f"{sc}/activation",
        ACTIVATION_IDS[_HF_ACTIVATIONS[config.activation_function]], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    module = model.transformer
    b.set_embeddings(f"{sc}/embeddings", module.wte)
    b.set_position_embeddings(f"{sc}/position_encodings", module.wpe)
    b.set_layer_norm(f"{sc}/layer_norm", module.ln_f)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.h):
        ls = f"{sc}/layer_{i}"
        b.set_layer_norm(f"{ls}/self_attention/layer_norm", layer.ln_1)
        b.set_linear(f"{ls}/self_attention/linear_0", layer.attn.c_attn)
        b.set_linear(f"{ls}/self_attention/linear_1", layer.attn.c_proj)
        b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.ln_2)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.c_fc)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.c_proj)
    return {}


def _rotary_scaling(b, sc_layers, config):
    """Attach rotary scaling attributes per layer scope."""
    rope_scaling = getattr(config, "rope_scaling", None)
    out = {}
    if not rope_scaling:
        return out
    rtype = rope_scaling.get("rope_type", rope_scaling.get("type"))
    if rtype in ("linear",):
        out["rotary_scaling_type"] = 0
        out["rotary_scaling_factor"] = float(rope_scaling["factor"])
    elif rtype in ("su", "longrope"):
        out["rotary_scaling_type"] = 1
    elif rtype == "llama3":
        out["rotary_scaling_type"] = 2
        out["rotary_scaling_factor"] = float(rope_scaling["factor"])
        out["rotary_low_freq_factor"] = float(rope_scaling["low_freq_factor"])
        out["rotary_high_freq_factor"] = float(rope_scaling["high_freq_factor"])
        out["original_max_position_embeddings"] = int(
            rope_scaling["original_max_position_embeddings"])
    return out


@register("LlamaConfig", "MistralConfig", "Qwen2Config", "Qwen3Config")
def load_llama(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    num_heads = config.num_attention_heads
    num_heads_kv = getattr(config, "num_key_value_heads", num_heads)
    head_dim = getattr(config, "head_dim", None) or (
        config.hidden_size // num_heads)

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS["swish"], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    sliding_window = getattr(config, "sliding_window", None) or 0
    if sliding_window:
        b.add_attr(f"{sc}/sliding_window", int(sliding_window), "int32")

    module = model.model
    b.set_embeddings(f"{sc}/embeddings", module.embed_tokens)
    b.set_layer_norm(f"{sc}/layer_norm", module.norm, rms=True)
    b.set_linear(f"{sc}/projection", model.lm_head)

    rope_attrs = _rotary_scaling(b, None, config)

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{asc}/layer_norm", layer.input_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/ffn/layer_norm",
                         layer.post_attention_layernorm, rms=True)
        b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                  layer.self_attn.v_proj)
        b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.gate_proj)
        b.set_linear(f"{ls}/ffn/linear_0_noact", layer.mlp.up_proj)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)

        if num_heads_kv != num_heads:
            b.add_attr(f"{asc}/num_heads_kv", num_heads_kv, "int32")
        if head_dim != config.hidden_size // num_heads:
            b.add_attr(f"{asc}/head_dim", head_dim, "int32")
        if sliding_window:
            b.add_attr(f"{asc}/sliding_window", int(sliding_window), "int32")
        b.add_attr(f"{asc}/rotary_dim", 0, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        b.add_attr(f"{asc}/rotary_base",
                   float(getattr(config, "rope_theta", 10000.0)), "float32")
        for name, value in rope_attrs.items():
            dtype = "int8" if name == "rotary_scaling_type" else (
                "int32" if "position" in name else "float32")
            b.add_attr(f"{asc}/{name}", value, dtype)

        # Qwen3 QK norms.
        if hasattr(layer.self_attn, "q_norm"):
            b.set_layer_norm(f"{asc}/q_norm", layer.self_attn.q_norm, rms=True)
        if hasattr(layer.self_attn, "k_norm"):
            b.set_layer_norm(f"{asc}/k_norm", layer.self_attn.k_norm, rms=True)

    return {"layer_norm_epsilon": float(config.rms_norm_eps)}


@register("OPTConfig")
def load_opt(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    b.add_attr(f"{sc}/num_heads", config.num_attention_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1 if config.do_layer_norm_before else 0, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.activation_function]],
               "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    module = model.model.decoder
    b.set_embeddings(f"{sc}/embeddings", module.embed_tokens)
    # OPT position embeddings have a +2 offset.
    b.set_position_embeddings(f"{sc}/position_encodings",
                              module.embed_positions, offset=2)
    if module.final_layer_norm is not None:
        b.set_layer_norm(f"{sc}/layer_norm", module.final_layer_norm)
    if getattr(module, "project_in", None) is not None:
        b.set_linear(f"{sc}/project_in", module.project_in)
    if getattr(module, "project_out", None) is not None:
        b.set_linear(f"{sc}/project_out", module.project_out)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{asc}/layer_norm", layer.self_attn_layer_norm)
        b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                  layer.self_attn.v_proj)
        b.set_linear(f"{asc}/linear_1", layer.self_attn.out_proj)
        b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.final_layer_norm)
        b.set_linear(f"{ls}/ffn/linear_0", layer.fc1)
        b.set_linear(f"{ls}/ffn/linear_1", layer.fc2)
    return {}


@register("GPTNeoXConfig")
def load_gpt_neox(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    num_heads = config.num_attention_heads
    head_dim = config.hidden_size // num_heads
    rotary_dim = int(head_dim * config.rotary_pct)

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.hidden_act]], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    module = model.gpt_neox
    b.set_embeddings(f"{sc}/embeddings", module.embed_in)
    b.set_layer_norm(f"{sc}/layer_norm", module.final_layer_norm)
    b.set_linear(f"{sc}/projection", model.embed_out)

    parallel = getattr(config, "use_parallel_residual", True)

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        if parallel:
            b.set_layer_norm(f"{ls}/input_layer_norm", layer.input_layernorm)
            b.set_layer_norm(f"{ls}/post_attention_layer_norm",
                             layer.post_attention_layernorm)
        else:
            b.set_layer_norm(f"{asc}/layer_norm", layer.input_layernorm)
            b.set_layer_norm(f"{ls}/ffn/layer_norm",
                             layer.post_attention_layernorm)

        # HF NeoX QKV is interleaved per head: [h0q h0k h0v h1q ...].
        import torch

        qkv_w = layer.attention.query_key_value.weight
        qkv_b = layer.attention.query_key_value.bias
        w = _np(qkv_w).reshape(num_heads, 3, head_dim, -1)
        q, k, v = w[:, 0], w[:, 1], w[:, 2]
        fused = np.concatenate(
            [q.reshape(num_heads * head_dim, -1),
             k.reshape(num_heads * head_dim, -1),
             v.reshape(num_heads * head_dim, -1)], axis=0)
        b.add(f"{asc}/linear_0/weight", fused)
        if qkv_b is not None:
            bb = _np(qkv_b).reshape(num_heads, 3, head_dim)
            b.add(f"{asc}/linear_0/bias", np.concatenate(
                [bb[:, 0].reshape(-1), bb[:, 1].reshape(-1),
                 bb[:, 2].reshape(-1)]))
        b.set_linear(f"{asc}/linear_1", layer.attention.dense)
        b.add_attr(f"{asc}/rotary_dim", rotary_dim, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        b.add_attr(f"{asc}/rotary_base",
                   float(getattr(config, "rotary_emb_base",
                                 getattr(config, "rope_theta", 10000.0))),
                   "float32")

        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.dense_h_to_4h)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.dense_4h_to_h)
    return {"layer_norm_epsilon": float(config.layer_norm_eps)}


@register("BloomConfig")
def load_bloom(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    num_heads = config.n_head
    head_dim = config.hidden_size // num_heads

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS["gelu_tanh"], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")
    b.add_attr(f"{sc}/alibi", 1, "int8")
    b.add_attr(f"{sc}/alibi_use_positive_positions", 0, "int8")

    module = model.transformer
    b.set_embeddings(f"{sc}/embeddings", module.word_embeddings)
    b.add(f"{sc}/layernorm_embedding/gamma", _np(module.word_embeddings_layernorm.weight))
    b.add(f"{sc}/layernorm_embedding/beta", _np(module.word_embeddings_layernorm.bias))
    b.set_layer_norm(f"{sc}/layer_norm", module.ln_f)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.h):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{asc}/layer_norm", layer.input_layernorm)
        # Bloom QKV interleaved per head [h, 3, d].
        w = _np(layer.self_attention.query_key_value.weight)
        w = w.reshape(num_heads, 3, head_dim, -1)
        fused = np.concatenate([w[:, j].reshape(num_heads * head_dim, -1)
                                for j in range(3)], axis=0)
        b.add(f"{asc}/linear_0/weight", fused)
        bias = layer.self_attention.query_key_value.bias
        if bias is not None:
            bb = _np(bias).reshape(num_heads, 3, head_dim)
            b.add(f"{asc}/linear_0/bias", np.concatenate(
                [bb[:, j].reshape(-1) for j in range(3)]))
        b.set_linear(f"{asc}/linear_1", layer.self_attention.dense)
        b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.post_attention_layernorm)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.dense_h_to_4h)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.dense_4h_to_h)
    return {"layer_norm_epsilon": float(config.layer_norm_epsilon)}


@register("GemmaConfig", "Gemma2Config")
def load_gemma(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    num_heads = config.num_attention_heads
    num_heads_kv = getattr(config, "num_key_value_heads", num_heads)
    head_dim = config.head_dim
    is_gemma2 = config.__class__.__name__ == "Gemma2Config"

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS["gelu_tanh"], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 1, "int8")
    b.add("decoder/scale_embeddings",
          np.float32(config.hidden_size ** 0.5))
    if is_gemma2 and getattr(config, "final_logit_softcapping", None):
        b.add_attr(f"{sc}/final_logit_softcapping",
                   float(config.final_logit_softcapping), "float32")

    module = model.model
    b.set_embeddings(f"{sc}/embeddings", module.embed_tokens)
    b.set_layer_norm(f"{sc}/layer_norm", module.norm, rms=True, plus_one=True)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        if is_gemma2:
            b.set_layer_norm(f"{ls}/input_layer_norm",
                             layer.input_layernorm, rms=True, plus_one=True)
            b.set_layer_norm(f"{ls}/post_attention_layer_norm",
                             layer.post_attention_layernorm, rms=True,
                             plus_one=True)
            b.set_layer_norm(f"{ls}/pre_feedforward_layer_norm",
                             layer.pre_feedforward_layernorm, rms=True,
                             plus_one=True)
            b.set_layer_norm(f"{ls}/post_feedforward_layer_norm",
                             layer.post_feedforward_layernorm, rms=True,
                             plus_one=True)
            if i % 2 == 0 and getattr(config, "sliding_window", None):
                b.add_attr(f"{asc}/sliding_window",
                           int(config.sliding_window), "int32")
        else:
            b.set_layer_norm(f"{asc}/layer_norm",
                             layer.input_layernorm, rms=True, plus_one=True)
            b.set_layer_norm(f"{ls}/ffn/layer_norm",
                             layer.post_attention_layernorm, rms=True,
                             plus_one=True)
        b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                  layer.self_attn.v_proj)
        b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.gate_proj)
        b.set_linear(f"{ls}/ffn/linear_0_noact", layer.mlp.up_proj)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)
        if num_heads_kv != num_heads:
            b.add_attr(f"{asc}/num_heads_kv", num_heads_kv, "int32")
        if head_dim != config.hidden_size // num_heads:
            b.add_attr(f"{asc}/head_dim", head_dim, "int32")
        b.add_attr(f"{asc}/rotary_dim", 0, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        b.add_attr(f"{asc}/rotary_base",
                   float(getattr(config, "rope_theta", 10000.0)), "float32")
        if is_gemma2 and getattr(config, "attn_logit_softcapping", None):
            pass  # attention softcapping: not in the reference either
        if is_gemma2:
            b.add_attr(f"{asc}/queries_scale",
                       float(config.query_pre_attn_scalar ** -0.5), "float32")

    return {"layer_norm_epsilon": float(config.rms_norm_eps)}


# ---------------------------------------------------------------------------
# Encoder-decoder loaders.
# ---------------------------------------------------------------------------


def _load_bart_like(b: ConvBuilder, model, config, tokenizer, *,
                    spec_name="TransformerSpec", activation=None,
                    scale_embeddings=None, pos_offset=2,
                    layernorm_embedding=True, final_norm=False,
                    pre_norm=None):
    b.spec_name, b.revision = spec_name, 7
    act = activation or _HF_ACTIVATIONS[config.activation_function]
    scale = (config.scale_embedding if scale_embeddings is None
             else scale_embeddings)
    if pre_norm is None:
        pre_norm = getattr(config, "normalize_before", False)

    for side in ("encoder", "decoder"):
        b.add_attr(f"{side}/num_heads", config.encoder_attention_heads
                   if side == "encoder" else config.decoder_attention_heads,
                   "int16")
        b.add_attr(f"{side}/pre_norm", 1 if pre_norm else 0, "int8")
        b.add_attr(f"{side}/activation", ACTIVATION_IDS[act], "int8")
        b.add_attr(f"{side}/scale_embeddings", 1 if scale else 0, "int8")
    b.add_attr("encoder/embeddings_merge", 0, "int8")

    enc = model.model.encoder
    dec = model.model.decoder

    b.set_embeddings("encoder/embeddings_0", enc.embed_tokens)
    b.set_embeddings("decoder/embeddings", dec.embed_tokens)
    b.set_position_embeddings("encoder/position_encodings",
                              enc.embed_positions, offset=pos_offset)
    b.set_position_embeddings("decoder/position_encodings",
                              dec.embed_positions, offset=pos_offset)
    if layernorm_embedding:
        b.set_layer_norm("encoder/layernorm_embedding", enc.layernorm_embedding)
        b.set_layer_norm("decoder/layernorm_embedding", dec.layernorm_embedding)
    if final_norm:
        b.set_layer_norm("encoder/layer_norm", enc.layer_norm)
        b.set_layer_norm("decoder/layer_norm", dec.layer_norm)
    b.set_linear("decoder/projection", model.lm_head)

    for side, module in (("encoder", enc), ("decoder", dec)):
        for i, layer in enumerate(module.layers):
            ls = f"{side}/layer_{i}"
            asc = f"{ls}/self_attention"
            b.set_layer_norm(f"{asc}/layer_norm", layer.self_attn_layer_norm)
            b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                      layer.self_attn.v_proj)
            b.set_linear(f"{asc}/linear_1", layer.self_attn.out_proj)
            if side == "decoder":
                csc = f"{ls}/attention"
                b.set_layer_norm(f"{csc}/layer_norm",
                                 layer.encoder_attn_layer_norm)
                b.set_linear(f"{csc}/linear_0", layer.encoder_attn.q_proj)
                kw = _np(layer.encoder_attn.k_proj.weight)
                vw = _np(layer.encoder_attn.v_proj.weight)
                b.add(f"{csc}/linear_1/weight", np.concatenate([kw, vw], axis=0))
                kb = layer.encoder_attn.k_proj.bias
                vb = layer.encoder_attn.v_proj.bias
                if kb is not None:
                    b.add(f"{csc}/linear_1/bias",
                          np.concatenate([_np(kb), _np(vb)]))
                b.set_linear(f"{csc}/linear_2", layer.encoder_attn.out_proj)
            b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.final_layer_norm)
            b.set_linear(f"{ls}/ffn/linear_0", layer.fc1)
            b.set_linear(f"{ls}/ffn/linear_1", layer.fc2)

    return {
        "bos_token": tokenizer.bos_token or "<s>",
        "eos_token": tokenizer.eos_token or "</s>",
        "unk_token": tokenizer.unk_token or "<unk>",
        "decoder_start_token": tokenizer.convert_ids_to_tokens(
            config.decoder_start_token_id)
        if getattr(config, "decoder_start_token_id", None) is not None
        else "<s>",
    }


@register("BartConfig")
def load_bart(b, model, config, tokenizer):
    return _load_bart_like(b, model, config, tokenizer)


@register("MBartConfig")
def load_mbart(b, model, config, tokenizer):
    # MBart hardcodes pre-norm in its modeling code.
    return _load_bart_like(b, model, config, tokenizer, final_norm=True,
                           pre_norm=True)


@register("M2M100Config")
def load_m2m100(b, model, config, tokenizer):
    # M2M100 / NLLB: sinusoidal positions with offset 2, final layer norm,
    # and ALWAYS pre-norm — the HF modeling code hardcodes it and the
    # config has no normalize_before field (reference forces
    # model.config.normalize_before = True, transformers.py:483-486).
    cfg = _load_bart_like(b, model, config, tokenizer,
                          layernorm_embedding=False, final_norm=True,
                          pos_offset=2, pre_norm=True)
    return cfg


@register("MarianConfig")
def load_marian(b, model, config, tokenizer):
    # OPUS-MT: sinusoidal positions (no stored table), no embedding norm.
    cfg = _load_bart_like(b, model, config, tokenizer,
                          layernorm_embedding=False, pos_offset=0)
    return cfg


@register("T5Config", "MT5Config")
def load_t5(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerSpec", 7
    act = ("gelu_tanh" if "gelu" in (config.feed_forward_proj or "relu")
           else "relu")
    glu = "gated" in (config.feed_forward_proj or "")

    for side in ("encoder", "decoder"):
        b.add_attr(f"{side}/num_heads", config.num_heads, "int16")
        b.add_attr(f"{side}/pre_norm", 1, "int8")
        b.add_attr(f"{side}/activation", ACTIVATION_IDS[act], "int8")
        b.add_attr(f"{side}/scale_embeddings", 0, "int8")
    b.add_attr("encoder/embeddings_merge", 0, "int8")

    b.set_embeddings("encoder/embeddings_0", model.shared)
    b.set_embeddings("decoder/embeddings", model.shared)
    b.set_linear("decoder/projection", model.lm_head)
    if config.tie_word_embeddings:
        b.add("decoder/scale_outputs",
              np.float32(config.d_model ** -0.5))

    for side, module in (("encoder", model.encoder), ("decoder", model.decoder)):
        b.set_layer_norm(f"{side}/layer_norm", module.final_layer_norm, rms=True)
        for i, block in enumerate(module.block):
            ls = f"{side}/layer_{i}"
            asc = f"{ls}/self_attention"
            attn = block.layer[0].SelfAttention
            b.set_layer_norm(f"{asc}/layer_norm",
                             block.layer[0].layer_norm, rms=True)
            b.set_qkv(asc, attn.q, attn.k, attn.v)
            b.set_linear(f"{asc}/linear_1", attn.o)
            b.add_attr(f"{asc}/queries_scale", 1.0, "float32")
            if i == 0:
                first_attn = attn
            b.add(f"{asc}/relative_attention_bias",
                  _np(first_attn.relative_attention_bias.weight))
            b.add_attr(f"{asc}/relative_attention_max_distance",
                       config.relative_attention_max_distance, "int32")
            ffn_idx = 1
            if side == "decoder":
                csc = f"{ls}/attention"
                cross = block.layer[1].EncDecAttention
                b.set_layer_norm(f"{csc}/layer_norm",
                                 block.layer[1].layer_norm, rms=True)
                b.set_linear(f"{csc}/linear_0", cross.q)
                kw = _np(cross.k.weight)
                vw = _np(cross.v.weight)
                b.add(f"{csc}/linear_1/weight", np.concatenate([kw, vw], axis=0))
                b.set_linear(f"{csc}/linear_2", cross.o)
                b.add_attr(f"{csc}/queries_scale", 1.0, "float32")
                ffn_idx = 2
            ff = block.layer[ffn_idx]
            b.set_layer_norm(f"{ls}/ffn/layer_norm", ff.layer_norm, rms=True)
            mlp = ff.DenseReluDense
            if glu:
                b.set_linear(f"{ls}/ffn/linear_0", mlp.wi_0)
                b.set_linear(f"{ls}/ffn/linear_0_noact", mlp.wi_1)
            else:
                b.set_linear(f"{ls}/ffn/linear_0", mlp.wi)
            b.set_linear(f"{ls}/ffn/linear_1", mlp.wo)

    # T5 relative bias exists on layer 0 only; alias it to other layers like
    # the reference does via position_bias reuse (our runtime reuses the
    # first computed bias per stack).
    return {
        "bos_token": tokenizer.pad_token or "<pad>",
        "eos_token": tokenizer.eos_token or "</s>",
        "unk_token": tokenizer.unk_token or "<unk>",
        "decoder_start_token": tokenizer.pad_token or "<pad>",
        "layer_norm_epsilon": float(config.layer_norm_epsilon),
    }


@register("WhisperConfig")
def load_whisper(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "WhisperSpec", 3
    enc = model.model.encoder
    dec = model.model.decoder

    for side, heads in (("encoder", config.encoder_attention_heads),
                        ("decoder", config.decoder_attention_heads)):
        b.add_attr(f"{side}/num_heads", heads, "int16")
    b.add_attr("decoder/pre_norm", 1, "int8")
    b.add_attr("decoder/activation", ACTIVATION_IDS["gelu"], "int8")

    b.add("encoder/conv1/weight", _np(enc.conv1.weight))
    b.add("encoder/conv1/bias", _np(enc.conv1.bias))
    b.add("encoder/conv2/weight", _np(enc.conv2.weight))
    b.add("encoder/conv2/bias", _np(enc.conv2.bias))
    b.set_position_embeddings("encoder/position_encodings", enc.embed_positions)
    b.set_layer_norm("encoder/layer_norm", enc.layer_norm)

    b.set_embeddings("decoder/embeddings", dec.embed_tokens)
    b.set_position_embeddings("decoder/position_encodings", dec.embed_positions)
    b.set_layer_norm("decoder/layer_norm", dec.layer_norm)
    b.add("decoder/projection/weight", _np(dec.embed_tokens.weight))

    for side, module in (("encoder", enc), ("decoder", dec)):
        for i, layer in enumerate(module.layers):
            ls = f"{side}/layer_{i}"
            asc = f"{ls}/self_attention"
            b.set_layer_norm(f"{asc}/layer_norm", layer.self_attn_layer_norm)
            b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                      layer.self_attn.v_proj)
            b.set_linear(f"{asc}/linear_1", layer.self_attn.out_proj)
            if side == "decoder":
                csc = f"{ls}/attention"
                b.set_layer_norm(f"{csc}/layer_norm",
                                 layer.encoder_attn_layer_norm)
                b.set_linear(f"{csc}/linear_0", layer.encoder_attn.q_proj)
                kw = _np(layer.encoder_attn.k_proj.weight)
                vw = _np(layer.encoder_attn.v_proj.weight)
                b.add(f"{csc}/linear_1/weight", np.concatenate([kw, vw], axis=0))
                kb = layer.encoder_attn.k_proj.bias
                vb = layer.encoder_attn.v_proj.bias
                if kb is not None and vb is not None:
                    b.add(f"{csc}/linear_1/bias",
                          np.concatenate([_np(kb), _np(vb)]))
                else:
                    # Whisper K has no bias but V does: zero-fill K's half.
                    kb_np = np.zeros(kw.shape[0], np.float32) if kb is None else _np(kb)
                    vb_np = np.zeros(vw.shape[0], np.float32) if vb is None else _np(vb)
                    b.add(f"{csc}/linear_1/bias", np.concatenate([kb_np, vb_np]))
                b.set_linear(f"{csc}/linear_2", layer.encoder_attn.out_proj)
            b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.final_layer_norm)
            b.set_linear(f"{ls}/ffn/linear_0", layer.fc1)
            b.set_linear(f"{ls}/ffn/linear_1", layer.fc2)

    # Whisper self-attn K has no bias either: fix the fused bias zero-fill.
    cfg = {
        "suppress_ids": list(getattr(config, "suppress_tokens", None) or []),
        "suppress_ids_begin": list(getattr(config, "begin_suppress_tokens", None) or []),
        "lang_ids": sorted(
            v for k, v in tokenizer.get_vocab().items()
            if k.startswith("<|") and k.endswith("|>") and len(k) in (6, 7)
            and k[2:-2].isalpha()
        ),
    }
    if getattr(config, "alignment_heads", None):
        cfg["alignment_heads"] = [list(p) for p in config.alignment_heads]
    return cfg


@register("Wav2Vec2Config")
def load_wav2vec2(b: ConvBuilder, model, config, tokenizer):
    """Wav2Vec2ForCTC (stable-layer-norm variant, like the reference:
    transformers.py:1036-1111)."""
    import torch

    b.spec_name, b.revision = "Wav2Vec2Spec", 3
    sc = "encoder"
    b.add_attr(f"{sc}/num_heads", config.num_attention_heads, "int16")

    w2v = model.wav2vec2
    fe = w2v.feature_extractor

    b.add(f"{sc}/feat_layer0/conv/weight", _np(fe.conv_layers[0].conv.weight))
    if fe.conv_layers[0].conv.bias is not None:
        b.add(f"{sc}/feat_layer0/conv/bias", _np(fe.conv_layers[0].conv.bias))
    b.set_layer_norm(f"{sc}/feat_layer0/layer_norm", fe.conv_layers[0].layer_norm)
    for i, layer in enumerate(fe.conv_layers[1:]):
        b.add(f"{sc}/feat_layer_{i}/conv/weight", _np(layer.conv.weight))
        if layer.conv.bias is not None:
            b.add(f"{sc}/feat_layer_{i}/conv/bias", _np(layer.conv.bias))
        b.set_layer_norm(f"{sc}/feat_layer_{i}/layer_norm", layer.layer_norm)

    fp = w2v.feature_projection
    b.set_layer_norm(f"{sc}/fp_layer_norm", fp.layer_norm)
    b.set_linear(f"{sc}/fp_projection", fp.projection)

    # Materialize the weight-norm parametrized positional conv
    # (reference: transformers.py:1088-1099).
    pos_conv = w2v.encoder.pos_conv_embed.conv
    with torch.no_grad():
        w2v.encoder.pos_conv_embed(torch.randn(1, 1, config.hidden_size))
    b.add(f"{sc}/pos_conv_embed/conv/weight", _np(pos_conv.weight))
    if pos_conv.bias is not None:
        b.add(f"{sc}/pos_conv_embed/conv/bias", _np(pos_conv.bias))

    b.set_layer_norm(f"{sc}/layer_norm", w2v.encoder.layer_norm)
    b.set_linear(f"{sc}/lm_head", model.lm_head)

    for i, layer in enumerate(w2v.encoder.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        att = layer.attention
        b.set_layer_norm(f"{asc}/layer_norm", layer.layer_norm)
        b.set_qkv(asc, att.q_proj, att.k_proj, att.v_proj)
        b.set_linear(f"{asc}/linear_1", att.out_proj)
        b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.final_layer_norm)
        b.set_linear(f"{ls}/ffn/linear_0", layer.feed_forward.intermediate_dense)
        b.set_linear(f"{ls}/ffn/linear_1", layer.feed_forward.output_dense)

    return {"layer_norm_epsilon": float(config.layer_norm_eps)}


# ---------------------------------------------------------------------------
# Encoder-only loaders.
# ---------------------------------------------------------------------------


@register("BertConfig", "RobertaConfig", "XLMRobertaConfig", "CamembertConfig")
def load_bert(b: ConvBuilder, model, config, tokenizer):
    b.spec_name, b.revision = "TransformerEncoderSpec", 1
    sc = "encoder"
    b.add_attr(f"{sc}/num_heads", config.num_attention_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 0, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.hidden_act]], "int8")
    b.add_attr(f"{sc}/embeddings_merge", 1, "int8")  # add
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    base = getattr(model, "bert", None) or getattr(model, "roberta", None) \
        or model.base_model
    emb = base.embeddings
    b.set_embeddings(f"{sc}/embeddings_0", emb.word_embeddings)
    b.set_embeddings(f"{sc}/embeddings_1", emb.token_type_embeddings)
    # RoBERTa-family positions start at padding_idx + 1 (reference:
    # transformers.py:3442-3447); plain BERT starts at 0.
    pad_idx = getattr(emb.position_embeddings, "padding_idx", None)
    if pad_idx is None:
        pad_idx = getattr(emb, "padding_idx", None)
    b.set_position_embeddings(f"{sc}/position_encodings",
                              emb.position_embeddings,
                              offset=(pad_idx + 1) if pad_idx else 0)
    b.set_layer_norm(f"{sc}/layernorm_embedding", emb.LayerNorm)

    for i, layer in enumerate(base.encoder.layer):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        att = layer.attention
        b.set_qkv(asc, att.self.query, att.self.key, att.self.value)
        b.set_linear(f"{asc}/linear_1", att.output.dense)
        b.set_layer_norm(f"{asc}/layer_norm", att.output.LayerNorm)
        b.set_linear(f"{ls}/ffn/linear_0", layer.intermediate.dense)
        b.set_linear(f"{ls}/ffn/linear_1", layer.output.dense)
        b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.output.LayerNorm)

    if getattr(base, "pooler", None) is not None:
        b.set_linear("pooler_dense", base.pooler.dense)
        b.add_attr("pooler_activation", ACTIVATION_IDS["tanh"], "int8")
    return {"layer_norm_epsilon": float(config.layer_norm_eps)}


# ---------------------------------------------------------------------------
# Converter entry.
# ---------------------------------------------------------------------------


def _smooth_one(layer_norm, linears, act_scales):
    """Fold SmoothQuant scales into a layer_norm -> linear(s) pair in
    place: ln output is divided by s, every consumer weight column is
    multiplied by s — numerically an identity for the float model, but it
    moves activation outliers into the weights so int8 activation
    quantization loses less (reference: converters/utils.py:78-105)."""
    import torch

    weight = torch.cat([lin.weight for lin in linears], dim=0)
    weight_scales = weight.abs().amax(dim=0).clamp(min=1e-5)
    scales = (act_scales.to(weight_scales.dtype)
              / weight_scales).sqrt().clamp(min=1e-5)
    layer_norm.weight.data /= scales
    if getattr(layer_norm, "bias", None) is not None:
        layer_norm.bias.data /= scales
    for lin in linears:
        lin.weight.data *= scales.reshape(1, -1)


def _smooth_activation(model, config, activation_scales):
    """Apply pre-computed SmoothQuant activation scales to the torch
    modules before conversion (reference: TransformersConverter
    activation_scales, transformers.py:161-165; OPT support,
    transformers.py:561-575). The fold spans the fused q/k/v group since
    they share the smoothed layer-norm output."""
    name = type(config).__name__
    if name != "OPTConfig":
        raise NotImplementedError(
            "No activation smoothing logic is defined for this model")
    for i, layer in enumerate(model.model.decoder.layers):
        scope = f"model.decoder.layers.{i}"
        _smooth_one(
            layer.self_attn_layer_norm,
            [layer.self_attn.q_proj, layer.self_attn.k_proj,
             layer.self_attn.v_proj],
            activation_scales[f"{scope}.self_attn.q_proj"])
        _smooth_one(
            layer.final_layer_norm, [layer.fc1],
            activation_scales[f"{scope}.fc1"])


class TransformersConverter:
    """Convert a local HF Transformers checkpoint (or in-memory model)."""

    def __init__(self, model_name_or_path=None, model=None, tokenizer=None,
                 activation_scales=None, copy_files=None,
                 load_as_float16: bool = False, low_cpu_mem_usage: bool = False,
                 trust_remote_code: bool = False):
        self._path = model_name_or_path
        self._model = model
        self._tokenizer = tokenizer
        self._activation_scales = activation_scales
        self._copy_files = copy_files

    def convert(self, output_dir: str, quantization: Optional[str] = None,
                force: bool = False) -> str:
        if os.path.exists(os.path.join(output_dir, "model.bin")) and not force:
            raise RuntimeError(
                f"The output directory {output_dir} already exists "
                "(use force=True to override)")

        model = self._model
        tokenizer = self._tokenizer
        if model is None:
            import transformers

            config = transformers.AutoConfig.from_pretrained(self._path)
            model = transformers.AutoModelForCausalLM.from_pretrained(self._path) \
                if config.is_decoder or config.__class__.__name__ in (
                    "GPT2Config",) else \
                transformers.AutoModel.from_pretrained(self._path)
            if tokenizer is None:
                tokenizer = transformers.AutoTokenizer.from_pretrained(self._path)

        config = model.config
        loader = LOADERS.get(config.__class__.__name__)
        if loader is None:
            raise ValueError(
                f"No converter is registered for the model {config.__class__.__name__} "
                f"(supported: {', '.join(sorted(LOADERS))})")

        if self._activation_scales is not None:
            import torch

            scales = self._activation_scales
            if isinstance(scales, str):
                scales = torch.load(scales, map_location="cpu")
            with torch.no_grad():
                _smooth_activation(model, config, scales)

        b = ConvBuilder("", 1)
        extra_config = loader(b, model, config, tokenizer) or {}
        gemma_residual = extra_config.pop("gemma_residual_norm", False)

        tokens = get_vocabulary(model, tokenizer)

        model_config = {
            "bos_token": extra_config.pop(
                "bos_token", getattr(tokenizer, "bos_token", None) or "<s>"),
            "eos_token": extra_config.pop(
                "eos_token", getattr(tokenizer, "eos_token", None) or "</s>"),
            "unk_token": extra_config.pop(
                "unk_token", getattr(tokenizer, "unk_token", None) or "<unk>"),
        }
        model_config.update(extra_config)

        b.quantize(quantization)
        os.makedirs(output_dir, exist_ok=True)
        b.save(output_dir, config=model_config)
        # Sequence-to-sequence specs need the shared vocabulary under the
        # name the runtime maps to BOTH source and target
        # (reference: model dir layout, src/models/sequence_to_sequence.cc:13-77).
        vocab_name = ("shared_vocabulary.json"
                      if b.spec_name == "TransformerSpec"
                      else "vocabulary.json")
        with open(os.path.join(output_dir, vocab_name), "w",
                  encoding="utf-8") as f:
            json.dump(tokens, f, ensure_ascii=False)
        if self._copy_files:
            import shutil

            if not self._path:
                raise ValueError(
                    "copy_files requires a model_name_or_path directory")
            for filename in self._copy_files:
                shutil.copy(os.path.join(self._path, filename),
                            os.path.join(output_dir, filename))
        return output_dir


@register("Wav2Vec2BertConfig")
def load_wav2vec2bert(b: ConvBuilder, model, config, tokenizer):
    """Wav2Vec2Bert conformer CTC encoder
    (reference: python/ctranslate2/converters/transformers.py:1114-1227)."""
    b.spec_name, b.revision = "Wav2Vec2BertSpec", 1
    sc = "encoder"
    enc = model.wav2vec2_bert

    b.set_layer_norm(f"{sc}/fp_layer_norm", enc.feature_projection.layer_norm)
    b.set_linear(f"{sc}/fp_projection", enc.feature_projection.projection)

    left_max = getattr(config, "left_max_position_embeddings", 0)
    right_max = getattr(config, "right_max_position_embeddings", 0)

    def set_attention(scope, attn, rel=False):
        b.set_qkv(scope, attn.linear_q, attn.linear_k, attn.linear_v)
        b.set_linear(f"{scope}/linear_1", attn.linear_out)
        if rel and getattr(attn, "distance_embedding", None) is not None:
            b.add(f"{scope}/relative_asymmetric_position_keys",
                  _np(attn.distance_embedding.weight))
            b.add_attr(f"{scope}/relative_left_max_position",
                       int(left_max), "int32")
            b.add_attr(f"{scope}/relative_right_max_position",
                       int(right_max), "int32")
        b.add_attr(f"{scope}/num_heads", config.num_attention_heads, "int16")

    def set_conv(scope, conv):
        b.add(f"{scope}/weight", _np(conv.weight))
        if getattr(conv, "bias", None) is not None:
            b.add(f"{scope}/bias", _np(conv.bias))

    for i, layer in enumerate(enc.encoder.layers):
        ls = f"{sc}/encoder_layers_{i}"
        b.set_layer_norm(f"{ls}/enc_ffn1_layer_norm", layer.ffn1_layer_norm)
        b.set_linear(f"{ls}/enc_ffn1/linear_0", layer.ffn1.intermediate_dense)
        b.set_linear(f"{ls}/enc_ffn1/linear_1", layer.ffn1.output_dense)
        b.set_layer_norm(f"{ls}/enc_attn_layer_norm", layer.self_attn_layer_norm)
        set_attention(f"{ls}/enc_attn", layer.self_attn, rel=True)
        cm = layer.conv_module
        b.set_layer_norm(f"{ls}/enc_conv_layer_norm", cm.layer_norm)
        set_conv(f"{ls}/enc_conv_pointwise_conv1", cm.pointwise_conv1)
        set_conv(f"{ls}/enc_conv_depthwise_conv", cm.depthwise_conv)
        b.set_layer_norm(f"{ls}/enc_conv_depthwise_layer_norm",
                         cm.depthwise_layer_norm)
        set_conv(f"{ls}/enc_conv_pointwise_conv2", cm.pointwise_conv2)
        b.set_layer_norm(f"{ls}/enc_ffn2_layer_norm", layer.ffn2_layer_norm)
        b.set_linear(f"{ls}/enc_ffn2/linear_0", layer.ffn2.intermediate_dense)
        b.set_linear(f"{ls}/enc_ffn2/linear_1", layer.ffn2.output_dense)
        b.set_layer_norm(f"{ls}/enc_final_layer_norm", layer.final_layer_norm)

    if getattr(enc, "adapter", None) is not None:
        for i, layer in enumerate(enc.adapter.layers):
            ls = f"{sc}/adapter_layers_{i}"
            b.set_layer_norm(f"{ls}/adpt_residual_layer_norm",
                             layer.residual_layer_norm)
            set_conv(f"{ls}/adpt_residual_conv", layer.residual_conv)
            b.set_layer_norm(f"{ls}/adpt_attn_layer_norm",
                             layer.self_attn_layer_norm)
            set_conv(f"{ls}/adpt_attn_conv", layer.self_attn_conv)
            set_attention(f"{ls}/adpt_attn_layer", layer.self_attn)
            b.set_layer_norm(f"{ls}/adpt_ffn_layer_norm", layer.ffn_layer_norm)
            b.set_linear(f"{ls}/adpt_ffn/linear_0", layer.ffn.intermediate_dense)
            b.set_linear(f"{ls}/adpt_ffn/linear_1", layer.ffn.output_dense)

    if getattr(model, "lm_head", None) is not None:
        b.set_linear(f"{sc}/lm_head", model.lm_head)
    return {}


# ---------------------------------------------------------------------------
# Additional decoder-only loaders (GPT-J family, code models, Falcon, MPT,
# Phi) — reference registry: transformers.py:613-3230.
# ---------------------------------------------------------------------------


def _permute_sliced_rotary(w: np.ndarray, num_heads: int,
                           rotary_dim: Optional[int] = None) -> np.ndarray:
    """Convert interleaved-rotary weights to the half-split layout so the
    runtime can run rotary_interleave=False
    (reference: python/ctranslate2/converters/utils.py:57-73)."""
    if rotary_dim is not None:
        w = w.reshape(num_heads, w.shape[0] // num_heads, -1).copy()
        r = _permute_sliced_rotary(
            w[:, :rotary_dim].reshape(num_heads * rotary_dim, -1), num_heads
        ).reshape(num_heads, rotary_dim, -1)
        w[:, :rotary_dim] = r
        return w.reshape(-1, w.shape[-1])
    return (
        w.reshape(num_heads, w.shape[0] // num_heads // 2, 2, w.shape[1])
        .swapaxes(1, 2)
        .reshape(w.shape[0], w.shape[1])
    )


def _gptj_like_layers(b, sc, module_layers, num_heads, rotary_dim, *,
                      get_parts):
    """Shared GPT-J-style parallel-residual layer writer: one shared LN,
    permuted-for-sliced-rotary QKV (reference: transformers.py:740-760)."""
    for i, layer in enumerate(module_layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        ln, qw, kw, vw, qb, kb, vb, out, fc_in, fc_out = get_parts(layer)
        b.set_layer_norm(f"{ls}/shared_layer_norm", ln)
        qw = _permute_sliced_rotary(qw, num_heads, rotary_dim)
        kw = _permute_sliced_rotary(kw, num_heads, rotary_dim)
        b.add(f"{asc}/linear_0/weight", np.concatenate([qw, kw, vw], axis=0))
        if qb is not None:
            qb = _permute_sliced_rotary(qb[:, None], num_heads, rotary_dim)[:, 0]
            kb = _permute_sliced_rotary(kb[:, None], num_heads, rotary_dim)[:, 0]
            b.add(f"{asc}/linear_0/bias", np.concatenate([qb, kb, vb]))
        b.set_linear(f"{asc}/linear_1", out)
        b.set_linear(f"{ls}/ffn/linear_0", fc_in)
        b.set_linear(f"{ls}/ffn/linear_1", fc_out)
        b.add_attr(f"{asc}/rotary_dim", rotary_dim, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")


@register("GPTJConfig")
def load_gptj(b: ConvBuilder, model, config, tokenizer):
    """GPT-J: parallel residual + shared LN + partial interleaved rotary
    (reference: transformers.py:706-760)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    b.add_attr(f"{sc}/num_heads", config.n_head, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.activation_function]],
               "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    module = model.transformer
    b.set_embeddings(f"{sc}/embeddings", module.wte)
    b.set_layer_norm(f"{sc}/layer_norm", module.ln_f)
    b.set_linear(f"{sc}/projection", model.lm_head)

    def parts(layer):
        a = layer.attn
        return (layer.ln_1, _np(a.q_proj.weight), _np(a.k_proj.weight),
                _np(a.v_proj.weight), None, None, None,
                a.out_proj, layer.mlp.fc_in, layer.mlp.fc_out)

    _gptj_like_layers(b, sc, module.h, config.n_head, config.rotary_dim,
                      get_parts=parts)
    return {"layer_norm_epsilon": float(config.layer_norm_epsilon)}


@register("CodeGenConfig")
def load_codegen(b: ConvBuilder, model, config, tokenizer):
    """CodeGen: GPT-J layout after un-permuting the fused QVK projection
    (reference: transformers.py:763-850)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    b.add_attr(f"{sc}/num_heads", config.n_head, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.activation_function]],
               "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    module = model.transformer
    b.set_embeddings(f"{sc}/embeddings", module.wte)
    b.set_layer_norm(f"{sc}/layer_norm", module.ln_f)
    b.set_linear(f"{sc}/projection", model.lm_head)

    mp_num = 8 if getattr(config, "head_dim", None) in (128, 256) else 4
    embed_dim = config.n_embd
    base_perm = np.arange(0, mp_num * 3).reshape(-1, 3).T.flatten()
    local_dim = embed_dim // mp_num
    permutation = np.concatenate(
        [np.arange(i * local_dim, (i + 1) * local_dim) for i in base_perm])

    def parts(layer):
        qkv = _np(layer.attn.qkv_proj.weight)[permutation, :]
        # CodeGen stores QVK, not QKV (reference: transformers.py:838-841).
        qw, vw, kw = np.split(qkv, 3, axis=0)
        return (layer.ln_1, qw, kw, vw, None, None, None,
                layer.attn.out_proj, layer.mlp.fc_in, layer.mlp.fc_out)

    _gptj_like_layers(b, sc, module.h, config.n_head, config.rotary_dim,
                      get_parts=parts)
    return {"layer_norm_epsilon": float(config.layer_norm_epsilon)}


@register("GPTBigCodeConfig")
def load_gpt_bigcode(b: ConvBuilder, model, config, tokenizer):
    """GPT-BigCode / StarCoder: MQA with fused [Q|kv] projection
    (reference: transformers.py:613-670)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    b.add_attr(f"{sc}/num_heads", config.n_head, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.activation_function]],
               "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    module = model.transformer
    b.set_embeddings(f"{sc}/embeddings", module.wte)
    b.set_position_embeddings(f"{sc}/position_encodings", module.wpe)
    b.set_layer_norm(f"{sc}/layer_norm", module.ln_f)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.h):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{asc}/layer_norm", layer.ln_1)
        b.set_linear(f"{asc}/linear_0", layer.attn.c_attn)
        b.set_linear(f"{asc}/linear_1", layer.attn.c_proj)
        if config.multi_query:
            b.add_attr(f"{asc}/multi_query", 1, "int8")
        b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.ln_2)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.c_fc)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.c_proj)
    return {"layer_norm_epsilon": float(config.layer_norm_epsilon)}


@register("FalconConfig", "RWConfig")
def load_falcon(b: ConvBuilder, model, config, tokenizer):
    """Falcon / RefinedWeb: grouped fused QKV, parallel residual variants,
    rotary or ALiBi (reference: transformers.py:3085-3229)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    num_heads = config.num_attention_heads
    num_kv = getattr(config, "num_kv_heads", None)
    if getattr(config, "multi_query", False) and not getattr(
            config, "new_decoder_architecture", False):
        num_kv = 1
    alibi = bool(getattr(config, "alibi", False))
    head_dim = config.hidden_size // num_heads

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS["gelu"], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")
    if alibi:
        b.add_attr(f"{sc}/alibi", 1, "int8")
        b.add_attr(f"{sc}/scale_alibi", 1, "int8")

    module = model.transformer
    b.set_embeddings(f"{sc}/embeddings", module.word_embeddings)
    b.set_layer_norm(f"{sc}/layer_norm", module.ln_f)
    b.set_linear(f"{sc}/projection", model.lm_head)

    new_arch = getattr(config, "new_decoder_architecture", False)
    parallel = getattr(config, "parallel_attn", True)

    for i, layer in enumerate(module.h):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        att = layer.self_attention

        if new_arch and hasattr(layer, "ln_attn"):
            b.set_layer_norm(f"{ls}/input_layer_norm", layer.ln_attn)
            b.set_layer_norm(f"{ls}/post_attention_layer_norm", layer.ln_mlp)
        elif parallel:
            b.set_layer_norm(f"{ls}/shared_layer_norm", layer.input_layernorm)
        else:
            b.set_layer_norm(f"{asc}/layer_norm", layer.input_layernorm)
            b.set_layer_norm(f"{ls}/ffn/layer_norm",
                             layer.post_attention_layernorm)

        w = _np(att.query_key_value.weight)
        bias = att.query_key_value.bias
        if num_kv in (None, num_heads):
            # Interleaved per head: [h0q h0k h0v ...] when new_arch, plain
            # [Q|K|V] otherwise; HF stores grouped q+2 per kv group.
            if new_arch:
                w = w.reshape(num_heads, 3, head_dim, -1)
                fused = np.concatenate(
                    [w[:, 0].reshape(num_heads * head_dim, -1),
                     w[:, 1].reshape(num_heads * head_dim, -1),
                     w[:, 2].reshape(num_heads * head_dim, -1)], axis=0)
            else:
                fused = w
            b.add(f"{asc}/linear_0/weight", fused)
            if bias is not None:
                bb = _np(bias)
                if new_arch:
                    bb = bb.reshape(num_heads, 3, head_dim)
                    bb = np.concatenate([bb[:, 0].reshape(-1),
                                         bb[:, 1].reshape(-1),
                                         bb[:, 2].reshape(-1)])
                b.add(f"{asc}/linear_0/bias", bb)
        elif num_kv == 1:
            # MQA layout is already [Q... k v] (reference: 3157-3161).
            b.add(f"{asc}/linear_0/weight", w)
            if bias is not None:
                b.add(f"{asc}/linear_0/bias", _np(bias))
            b.add_attr(f"{asc}/multi_query", 1, "int8")
        else:
            # Grouped: (kv_groups, q_per_group + 2, head_dim, in)
            # (reference: 3177-3196).
            g = w.reshape(num_kv, num_heads // num_kv + 2, head_dim, -1)
            q, k, v = (g[:, :-2], g[:, -2:-1], g[:, -1:])
            fused = np.concatenate(
                [q.reshape(num_heads * head_dim, -1),
                 k.reshape(num_kv * head_dim, -1),
                 v.reshape(num_kv * head_dim, -1)], axis=0)
            b.add(f"{asc}/linear_0/weight", fused)
            if bias is not None:
                gb = _np(bias).reshape(num_kv, num_heads // num_kv + 2, head_dim)
                b.add(f"{asc}/linear_0/bias", np.concatenate(
                    [gb[:, :-2].reshape(-1), gb[:, -2:-1].reshape(-1),
                     gb[:, -1:].reshape(-1)]))
            b.add_attr(f"{asc}/num_heads_kv", int(num_kv), "int32")

        b.set_linear(f"{asc}/linear_1", att.dense)
        if not alibi:
            b.add_attr(f"{asc}/rotary_dim", 0, "int32")
            b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
            b.add_attr(f"{asc}/rotary_base",
                       float(getattr(config, "rope_theta", 10000.0)),
                       "float32")
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.dense_h_to_4h)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.dense_4h_to_h)
    return {"layer_norm_epsilon": float(
        getattr(config, "layer_norm_epsilon", 1e-5))}


@register("MPTConfig", "MptConfig")
def load_mpt(b: ConvBuilder, model, config, tokenizer):
    """MPT: ALiBi, bias-free, tied output embeddings
    (reference: transformers.py:1442-1495)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    b.add_attr(f"{sc}/num_heads", config.n_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS["gelu"], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")
    b.add_attr(f"{sc}/alibi", 1, "int8")

    module = model.transformer
    b.set_embeddings(f"{sc}/embeddings", module.wte)
    # MPT norms carry no bias; the reference registers a zero beta
    # (reference: transformers.py:1491-1494).
    b.add(f"{sc}/layer_norm/gamma", _np(module.norm_f.weight))
    b.add(f"{sc}/layer_norm/beta", np.zeros_like(_np(module.norm_f.weight)))
    # Tied projection.
    b.add(f"{sc}/projection/weight", _np(module.wte.weight))

    for i, layer in enumerate(module.blocks):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.add(f"{asc}/layer_norm/gamma", _np(layer.norm_1.weight))
        b.add(f"{asc}/layer_norm/beta",
              np.zeros_like(_np(layer.norm_1.weight)))
        b.set_linear(f"{asc}/linear_0", layer.attn.Wqkv)
        b.set_linear(f"{asc}/linear_1", layer.attn.out_proj)
        b.add(f"{ls}/ffn/layer_norm/gamma", _np(layer.norm_2.weight))
        b.add(f"{ls}/ffn/layer_norm/beta",
              np.zeros_like(_np(layer.norm_2.weight)))
        b.set_linear(f"{ls}/ffn/linear_0", layer.ffn.up_proj)
        b.set_linear(f"{ls}/ffn/linear_1", layer.ffn.down_proj)
    return {}


@register("PhiConfig")
def load_phi(b: ConvBuilder, model, config, tokenizer):
    """Phi-1/2 (modern HF layout): parallel residual with shared LN and
    partial rotary (reference: transformers.py:2858-2907 covers the legacy
    layout; this maps the upstream PhiForCausalLM modules)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    num_heads = config.num_attention_heads
    head_dim = config.hidden_size // num_heads
    rotary_dim = int(head_dim * getattr(config, "partial_rotary_factor", 1.0))

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.hidden_act]], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    module = model.model
    b.set_embeddings(f"{sc}/embeddings", module.embed_tokens)
    b.set_layer_norm(f"{sc}/layer_norm", module.final_layernorm)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{ls}/shared_layer_norm", layer.input_layernorm)
        b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                  layer.self_attn.v_proj)
        b.set_linear(f"{asc}/linear_1", layer.self_attn.dense)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.fc1)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.fc2)
        b.add_attr(f"{asc}/rotary_dim", rotary_dim, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        b.add_attr(f"{asc}/rotary_base",
                   float(getattr(config, "rope_theta", 10000.0)), "float32")
    return {"layer_norm_epsilon": float(config.layer_norm_eps)}


@register("Phi3Config")
def load_phi3(b: ConvBuilder, model, config, tokenizer):
    """Phi-3: llama-like with fused qkv/gate_up projections and Su (longrope)
    scaling factors (reference: transformers.py:2910-3070)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    num_heads = config.num_attention_heads
    num_heads_kv = getattr(config, "num_key_value_heads", num_heads)
    head_dim = config.hidden_size // num_heads

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS["swish"], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    rope_scaling = getattr(config, "rope_scaling", None)
    long_factor = short_factor = None
    scaling_type = None
    if rope_scaling:
        rtype = rope_scaling.get("rope_type", rope_scaling.get("type"))
        if rtype in ("su", "longrope"):
            scaling_type = 1
            long_factor = rope_scaling["long_factor"]
            short_factor = rope_scaling["short_factor"]
        elif rtype == "linear":
            scaling_type = 0

    module = model.model
    b.set_embeddings(f"{sc}/embeddings", module.embed_tokens)
    b.set_layer_norm(f"{sc}/layer_norm", module.norm, rms=True)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{asc}/layer_norm", layer.input_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/ffn/layer_norm",
                         layer.post_attention_layernorm, rms=True)
        b.set_linear(f"{asc}/linear_0", layer.self_attn.qkv_proj)
        b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
        gate, up = np.split(_np(layer.mlp.gate_up_proj.weight), 2, axis=0)
        b.add(f"{ls}/ffn/linear_0/weight", gate)
        b.add(f"{ls}/ffn/linear_0_noact/weight", up)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)

        if num_heads_kv != num_heads:
            b.add_attr(f"{asc}/num_heads_kv", num_heads_kv, "int32")
        b.add_attr(f"{asc}/rotary_dim", 0, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        b.add_attr(f"{asc}/rotary_base",
                   float(getattr(config, "rope_theta", 10000.0)), "float32")
        if scaling_type is not None:
            b.add_attr(f"{asc}/rotary_scaling_type", scaling_type, "int8")
            b.add_attr(f"{asc}/original_max_position_embeddings",
                       int(getattr(config,
                                   "original_max_position_embeddings", 0)),
                       "int32")
            b.add_attr(f"{asc}/max_position_embeddings",
                       int(getattr(config, "max_position_embeddings", 0)),
                       "int32")
        if long_factor is not None:
            b.add(f"{asc}/rotary_scaling_long_factor",
                  np.asarray(long_factor, np.float32))
            b.add(f"{asc}/rotary_scaling_short_factor",
                  np.asarray(short_factor, np.float32))
    return {"layer_norm_epsilon": float(config.rms_norm_eps)}


@register("PegasusConfig")
def load_pegasus(b: ConvBuilder, model, config, tokenizer):
    """Pegasus: pre-norm BART layout with sinusoidal positions and final
    norms (reference: transformers.py:529-540 via BartLoader)."""
    out = _load_bart_like(
        b, model, config, tokenizer,
        pos_offset=0, layernorm_embedding=False, final_norm=True,
        pre_norm=True)
    out = out or {}
    out["bos_token"] = getattr(tokenizer, "pad_token", None) or "<pad>"
    out["decoder_start_token"] = out["bos_token"]
    return out


@register("DistilBertConfig")
def load_distilbert(b: ConvBuilder, model, config, tokenizer):
    """DistilBERT encoder (reference: transformers.py:3231-3286)."""
    b.spec_name, b.revision = "TransformerEncoderSpec", 1
    sc = "encoder"
    b.add_attr(f"{sc}/num_heads", config.n_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 0, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS[config.activation]], "int8")
    b.add_attr(f"{sc}/embeddings_merge", 1, "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    base = getattr(model, "distilbert", None) or model.base_model
    emb = base.embeddings
    b.set_embeddings(f"{sc}/embeddings_0", emb.word_embeddings)
    b.set_position_embeddings(f"{sc}/position_encodings",
                              emb.position_embeddings)
    b.set_layer_norm(f"{sc}/layernorm_embedding", emb.LayerNorm)

    for i, layer in enumerate(base.transformer.layer):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        att = layer.attention
        b.set_qkv(asc, att.q_lin, att.k_lin, att.v_lin)
        b.set_linear(f"{asc}/linear_1", att.out_lin)
        b.set_layer_norm(f"{asc}/layer_norm", layer.sa_layer_norm)
        b.set_linear(f"{ls}/ffn/linear_0", layer.ffn.lin1)
        b.set_linear(f"{ls}/ffn/linear_1", layer.ffn.lin2)
        b.set_layer_norm(f"{ls}/ffn/layer_norm", layer.output_layer_norm)
    return {"layer_norm_epsilon": 1e-12}


@register("Gemma3Config", "Gemma3TextConfig")
def load_gemma3(b: ConvBuilder, model, config, tokenizer):
    """Gemma 3: sandwich norms + QK norms + interleaved local (sliding,
    rope 10k) / global (full, rope 1M) attention layers
    (reference: transformers.py:1848-2060)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    cfg = getattr(config, "text_config", config)
    num_heads = cfg.num_attention_heads
    num_heads_kv = getattr(cfg, "num_key_value_heads", num_heads)
    head_dim = cfg.head_dim

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    act = getattr(cfg, "hidden_activation", "gelu_pytorch_tanh")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS["gelu" if act == "gelu" else "gelu_tanh"],
               "int8")
    b.add_attr(f"{sc}/scale_embeddings", 1, "int8")

    rope_global = float(getattr(cfg, "rope_theta", 1_000_000))
    rope_local = float(getattr(cfg, "rope_local_base_freq", 10_000))
    sliding_window = int(getattr(cfg, "sliding_window", 1024) or 0)
    layer_types = getattr(cfg, "layer_types", None)
    if layer_types is None:
        pattern = getattr(cfg, "_sliding_window_pattern",
                          getattr(cfg, "sliding_window_pattern", 6))
        layer_types = [
            "full_attention" if (i + 1) % pattern == 0
            else "sliding_attention"
            for i in range(cfg.num_hidden_layers)]

    module = getattr(model.model, "language_model", model.model)
    b.set_embeddings(f"{sc}/embeddings", module.embed_tokens)
    b.set_layer_norm(f"{sc}/layer_norm", module.norm, rms=True, plus_one=True)
    b.set_linear(f"{sc}/projection", model.lm_head)

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{ls}/input_layer_norm", layer.input_layernorm,
                         rms=True, plus_one=True)
        b.set_layer_norm(f"{ls}/post_attention_layer_norm",
                         layer.post_attention_layernorm, rms=True,
                         plus_one=True)
        b.set_layer_norm(f"{ls}/pre_feedforward_layer_norm",
                         layer.pre_feedforward_layernorm, rms=True,
                         plus_one=True)
        b.set_layer_norm(f"{ls}/post_feedforward_layer_norm",
                         layer.post_feedforward_layernorm, rms=True,
                         plus_one=True)
        b.set_layer_norm(f"{asc}/q_norm", layer.self_attn.q_norm,
                         rms=True, plus_one=True)
        b.set_layer_norm(f"{asc}/k_norm", layer.self_attn.k_norm,
                         rms=True, plus_one=True)
        b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                  layer.self_attn.v_proj)
        b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.gate_proj)
        b.set_linear(f"{ls}/ffn/linear_0_noact", layer.mlp.up_proj)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)

        if num_heads_kv != num_heads:
            b.add_attr(f"{asc}/num_heads_kv", num_heads_kv, "int32")
        if head_dim != cfg.hidden_size // num_heads:
            b.add_attr(f"{asc}/head_dim", head_dim, "int32")
        b.add_attr(f"{asc}/rotary_dim", 0, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        if layer_types[i] == "full_attention":
            b.add_attr(f"{asc}/rotary_base", rope_global, "float32")
        else:
            b.add_attr(f"{asc}/rotary_base", rope_local, "float32")
            if sliding_window:
                b.add_attr(f"{asc}/sliding_window", sliding_window, "int32")
        scalar = getattr(cfg, "query_pre_attn_scalar", None)
        if scalar:
            b.add_attr(f"{asc}/queries_scale", float(scalar) ** -0.5,
                       "float32")
    return {"layer_norm_epsilon": float(cfg.rms_norm_eps)}


@register("T5GemmaConfig")
def load_t5gemma(b: ConvBuilder, model, config, tokenizer):
    """T5Gemma: Gemma2-style encoder-decoder with sandwich norms, rotary
    on both sides, and external pre/post cross-attention norms
    (reference: transformers.py:3807-4067)."""
    b.spec_name, b.revision = "TransformerSpec", 7
    enc_cfg = config.encoder
    dec_cfg = config.decoder
    module = model.model

    def act_of(cfg):
        a = getattr(cfg, "hidden_activation", "gelu_pytorch_tanh")
        return ACTIVATION_IDS["gelu" if a == "gelu" else "gelu_tanh"]

    def side_common(sc, cfg, mod):
        b.add_attr(f"{sc}/num_heads", cfg.num_attention_heads, "int16")
        b.add_attr(f"{sc}/pre_norm", 1, "int8")
        b.add_attr(f"{sc}/activation", act_of(cfg), "int8")
        b.add_attr(f"{sc}/scale_embeddings", 1, "int8")
        name = f"{sc}/embeddings_0" if sc == "encoder" else f"{sc}/embeddings"
        b.set_embeddings(name, mod.embed_tokens)
        b.set_layer_norm(f"{sc}/layer_norm", mod.norm, rms=True,
                         plus_one=True)

    def set_attn_common(asc, cfg, attn, layer_types, i):
        num_heads = cfg.num_attention_heads
        num_heads_kv = getattr(cfg, "num_key_value_heads", num_heads)
        head_dim = cfg.head_dim
        if num_heads_kv != num_heads:
            b.add_attr(f"{asc}/num_heads_kv", num_heads_kv, "int32")
        if head_dim != cfg.hidden_size // num_heads:
            b.add_attr(f"{asc}/head_dim", head_dim, "int32")
        b.add_attr(f"{asc}/rotary_dim", 0, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        b.add_attr(f"{asc}/rotary_base",
                   float(getattr(cfg, "rope_theta", 10000.0)), "float32")
        scalar = getattr(cfg, "query_pre_attn_scalar", None)
        if scalar:
            b.add_attr(f"{asc}/queries_scale", float(scalar) ** -0.5,
                       "float32")
        if layer_types is not None and i < len(layer_types) \
                and layer_types[i] == "sliding_attention" \
                and getattr(cfg, "sliding_window", 0):
            b.add_attr(f"{asc}/sliding_window",
                       int(cfg.sliding_window), "int32")

    for sc, cfg, mod in (("encoder", enc_cfg, module.encoder),
                         ("decoder", dec_cfg, module.decoder)):
        side_common(sc, cfg, mod)
        layer_types = getattr(cfg, "layer_types", None)
        for i, layer in enumerate(mod.layers):
            ls = f"{sc}/layer_{i}"
            asc = f"{ls}/self_attention"
            b.set_layer_norm(f"{ls}/input_layer_norm",
                             layer.pre_self_attn_layernorm, rms=True,
                             plus_one=True)
            b.set_layer_norm(f"{ls}/post_attention_layer_norm",
                             layer.post_self_attn_layernorm, rms=True,
                             plus_one=True)
            b.set_layer_norm(f"{ls}/pre_feedforward_layer_norm",
                             layer.pre_feedforward_layernorm, rms=True,
                             plus_one=True)
            b.set_layer_norm(f"{ls}/post_feedforward_layer_norm",
                             layer.post_feedforward_layernorm, rms=True,
                             plus_one=True)
            b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                      layer.self_attn.v_proj)
            b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
            set_attn_common(asc, cfg, layer.self_attn, layer_types, i)

            if sc == "decoder":
                csc = f"{ls}/attention"
                b.set_layer_norm(
                    f"{ls}/external_pre_encoder_attention_layer_norm",
                    layer.pre_cross_attn_layernorm, rms=True, plus_one=True)
                b.set_layer_norm(
                    f"{ls}/external_post_encoder_attention_layer_norm",
                    layer.post_cross_attn_layernorm, rms=True, plus_one=True)
                b.set_linear(f"{csc}/linear_0", layer.cross_attn.q_proj)
                kw = _np(layer.cross_attn.k_proj.weight)
                vw = _np(layer.cross_attn.v_proj.weight)
                b.add(f"{csc}/linear_1/weight",
                      np.concatenate([kw, vw], axis=0))
                b.set_linear(f"{csc}/linear_2", layer.cross_attn.o_proj)
                num_heads_kv = getattr(cfg, "num_key_value_heads",
                                       cfg.num_attention_heads)
                if num_heads_kv != cfg.num_attention_heads:
                    b.add_attr(f"{csc}/num_heads_kv", num_heads_kv, "int32")
                if cfg.head_dim != cfg.hidden_size // cfg.num_attention_heads:
                    b.add_attr(f"{csc}/head_dim", cfg.head_dim, "int32")
                scalar = getattr(cfg, "query_pre_attn_scalar", None)
                if scalar:
                    b.add_attr(f"{csc}/queries_scale",
                               float(scalar) ** -0.5, "float32")

            b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.gate_proj)
            b.set_linear(f"{ls}/ffn/linear_0_noact", layer.mlp.up_proj)
            b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)

    b.add_attr("encoder/embeddings_merge", 0, "int8")
    # Tied output projection (reference: transformers.py:3880-3882).
    b.set_linear("decoder/projection", module.decoder.embed_tokens)
    return {
        "layer_norm_epsilon": float(enc_cfg.rms_norm_eps),
        "decoder_start_token": getattr(tokenizer, "bos_token", "<s>") or "<s>",
    }


@register("Gemma4Config", "Gemma4TextConfig", "Gemma4UnifiedConfig",
          "Gemma4UnifiedTextConfig")
def load_gemma4(b: ConvBuilder, model, config, tokenizer):
    """Gemma 4 (31B layout): sandwich norms, learnable QK norms + pure-RMS
    V norm, interleaved sliding/full attention with per-layer head dims,
    KV head counts and RoPE bases, proportional partial RoPE on full
    layers, queries_scale 1.0, optional k==v weight sharing, per-layer
    output scalars (reference: transformers.py:2063-2375).
    KV-shared layers (E2B/E4B) are rejected, matching the reference."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    cfg = getattr(config, "text_config", config)

    num_kv_shared = getattr(cfg, "num_kv_shared_layers", 0)
    if num_kv_shared:
        raise NotImplementedError(
            "Gemma 4 KV-shared layers (num_kv_shared_layers=%d) are not "
            "yet supported. Use the 31B model which has no KV sharing."
            % num_kv_shared)

    num_heads = cfg.num_attention_heads
    num_heads_kv = getattr(cfg, "num_key_value_heads", num_heads)
    head_dim = cfg.head_dim
    global_head_dim = getattr(cfg, "global_head_dim", head_dim)
    num_global_kv = getattr(cfg, "num_global_key_value_heads", None)
    k_eq_v = bool(getattr(cfg, "attention_k_eq_v", False))

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    act = getattr(cfg, "hidden_activation", "gelu_pytorch_tanh")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS["gelu" if act == "gelu" else "gelu_tanh"],
               "int8")
    b.add_attr(f"{sc}/scale_embeddings", 1, "int8")

    # RoPE parameters nested per layer type; proportional partial RoPE on
    # full-attention layers maps to CT2-style rotary by rescaling the base
    # (reference: transformers.py:2110-2128).
    rope_params = getattr(cfg, "rope_parameters", None) or {}
    rope_local = float(rope_params.get("sliding_attention", {})
                       .get("rope_theta", 10_000))
    rope_theta = float(rope_params.get("full_attention", {})
                       .get("rope_theta", 1_000_000))
    g_partial = float(rope_params.get("full_attention", {})
                      .get("partial_rotary_factor", 1.0))
    g_rotary_dim = int(global_head_dim * g_partial)
    if 0 < g_rotary_dim < global_head_dim:
        rope_global = rope_theta ** (g_rotary_dim / global_head_dim)
    else:
        rope_global = rope_theta
        g_rotary_dim = 0  # 0 = full head_dim

    sliding_window = int(getattr(cfg, "sliding_window", 512) or 0)
    layer_types = getattr(cfg, "layer_types", None)
    if layer_types is None:
        layer_types = [
            "sliding_attention" if (i + 1) % 6 else "full_attention"
            for i in range(cfg.num_hidden_layers)]

    # HF proportional partial RoPE pairs channels [0:R/2] with
    # [HD/2:HD/2+R/2]; CT2 half-split rotary pairs [0:R/2] with [R/2:R].
    # Permute Q/K head channels (and QK norm gammas) to translate
    # (reference: transformers.py:2273-2283, 2338-2351).
    partial_perm = None
    if 0 < g_rotary_dim < global_head_dim:
        ghd, grd = global_head_dim, g_rotary_dim
        partial_perm = (
            list(range(0, grd // 2))
            + list(range(ghd // 2, ghd // 2 + grd // 2))
            + list(range(grd // 2, ghd // 2))
            + list(range(ghd // 2 + grd // 2, ghd)))

    module = getattr(model.model, "language_model", model.model)
    if any(_is_awq(l.self_attn.q_proj) for l in module.layers):
        raise NotImplementedError(
            "AWQ-quantized Gemma4 checkpoints are not supported by this "
            "converter yet (the partial-RoPE permutation must be applied "
            "to packed payloads)")
    b.set_embeddings(f"{sc}/embeddings", module.embed_tokens)
    # Gemma4 RMSNorm multiplies by gamma directly (not 1+gamma).
    b.set_layer_norm(f"{sc}/layer_norm", module.norm, rms=True)
    b.set_linear(f"{sc}/projection", model.lm_head)

    import torch as _torch

    for i, layer in enumerate(module.layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        full = layer_types[i] == "full_attention"
        b.set_layer_norm(f"{ls}/input_layer_norm", layer.input_layernorm,
                         rms=True)
        b.set_layer_norm(f"{ls}/post_attention_layer_norm",
                         layer.post_attention_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/pre_feedforward_layer_norm",
                         layer.pre_feedforward_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/post_feedforward_layer_norm",
                         layer.post_feedforward_layernorm, rms=True)

        q_gamma = _np(layer.self_attn.q_norm.weight)
        k_gamma = _np(layer.self_attn.k_norm.weight)
        if full and partial_perm is not None:
            q_gamma = q_gamma[partial_perm]
            k_gamma = k_gamma[partial_perm]
        b.add(f"{asc}/q_norm/gamma", q_gamma)
        b.add(f"{asc}/k_norm/gamma", k_gamma)
        # V norm has no learnable scale: pure RMS via all-ones gamma.
        b.add(f"{asc}/v_norm/gamma",
              np.ones_like(_np(layer.self_attn.k_norm.weight)))

        v_proj = (layer.self_attn.k_proj if (k_eq_v and full)
                  else layer.self_attn.v_proj)
        qw = _np(layer.self_attn.q_proj.weight)
        kw = _np(layer.self_attn.k_proj.weight)
        vw = _np(v_proj.weight)
        if full and partial_perm is not None:
            hd = global_head_dim
            qw = qw.reshape(-1, hd, qw.shape[1])[:, partial_perm, :].reshape(
                qw.shape)
            kw = kw.reshape(-1, hd, kw.shape[1])[:, partial_perm, :].reshape(
                kw.shape)
        b.add(f"{asc}/linear_0/weight",
              np.ascontiguousarray(np.concatenate([qw, kw, vw], axis=0)))
        b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.gate_proj)
        b.set_linear(f"{ls}/ffn/linear_0_noact", layer.mlp.up_proj)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)

        # Gemma4 disables the default 1/sqrt(d_head) query scaling.
        b.add_attr(f"{asc}/queries_scale", 1.0, "float32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        if full:
            b.add_attr(f"{asc}/rotary_dim", g_rotary_dim, "int32")
            b.add_attr(f"{asc}/rotary_base", rope_global, "float32")
            b.add_attr(f"{asc}/head_dim", global_head_dim, "int32")
            hkv = num_global_kv if num_global_kv is not None else num_heads_kv
            if hkv != num_heads:
                b.add_attr(f"{asc}/num_heads_kv", int(hkv), "int32")
        else:
            b.add_attr(f"{asc}/rotary_dim", 0, "int32")
            b.add_attr(f"{asc}/rotary_base", rope_local, "float32")
            if head_dim != cfg.hidden_size // num_heads:
                b.add_attr(f"{asc}/head_dim", head_dim, "int32")
            if num_heads_kv != num_heads:
                b.add_attr(f"{asc}/num_heads_kv", int(num_heads_kv), "int32")
            if sliding_window:
                b.add_attr(f"{asc}/sliding_window", sliding_window, "int32")

        lscalar = getattr(layer, "layer_scalar", None)
        if lscalar is not None:
            b.add_attr(f"{ls}/layer_scalar",
                       float(_torch.as_tensor(lscalar).float().item()),
                       "float32")

    out = {"layer_norm_epsilon": float(getattr(cfg, "rms_norm_eps", 1e-6))}
    softcap = getattr(cfg, "final_logit_softcapping", None)
    if softcap:
        b.add_attr(f"{sc}/final_logit_softcapping", float(softcap), "float32")
    # EOS from the chat template (reference: transformers.py:2245-2258).
    tmpl = getattr(tokenizer, "chat_template", None)
    if isinstance(tmpl, str) and tmpl.strip():
        out["eos_token"] = "<turn|>" if "<turn|>" in tmpl else "<end_of_turn>"
    return out


@register("MixFormerSequentialConfig")
def load_mixformer(b: ConvBuilder, model, config, tokenizer):
    """MixFormerSequential (phi-1/phi-1.5): GPT-J-style parallel residual
    with a shared layer norm, fused Wqkv, partial rotary
    (reference: transformers.py:2805-2855)."""
    b.spec_name, b.revision = "TransformerDecoderSpec", 8
    sc = "decoder"
    blocks = model.layers  # Sequential: [embedding, block..., causal head]

    b.add_attr(f"{sc}/num_heads", config.n_head, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation",
               ACTIVATION_IDS[_HF_ACTIVATIONS.get(
                   getattr(config, "activation_function", "gelu_new"),
                   "gelu_tanh")], "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    b.set_embeddings(f"{sc}/embeddings", blocks[0].wte)
    b.set_layer_norm(f"{sc}/layer_norm", blocks[-1].ln)
    b.set_linear(f"{sc}/projection", blocks[-1].linear)

    for i, layer in enumerate(blocks[1:-1]):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{ls}/shared_layer_norm", layer.ln)
        b.set_linear(f"{asc}/linear_0", layer.mixer.Wqkv)
        b.set_linear(f"{asc}/linear_1", layer.mixer.out_proj)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.fc1)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.fc2)
        b.add_attr(f"{asc}/rotary_dim", int(config.rotary_dim), "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
    return {}


@register("T5Gemma2Config")
def load_t5gemma2(b: ConvBuilder, model, config, tokenizer):
    """T5Gemma2: Gemma-style encoder-decoder where each decoder layer runs
    MERGED self+cross attention — the self K/V projections also project the
    encoder memory, stored as a fused memory_kv linear
    (reference: transformers.py:4069-4260; runtime merged layout:
    models/transformer.py merged_attention_block)."""
    b.spec_name, b.revision = "TransformerSpec", 7
    enc_cfg = getattr(model.config.encoder, "text_config",
                      model.config.encoder)
    dec_cfg = model.config.decoder
    module = model.model

    def act_of(cfg):
        a = getattr(cfg, "hidden_activation", "gelu_pytorch_tanh")
        return ACTIVATION_IDS["gelu" if a == "gelu" else "gelu_tanh"]

    def rope_of(cfg):
        rp = getattr(cfg, "rope_parameters", {}) or {}
        return (
            float(rp.get("full_attention", {}).get(
                "rope_theta", getattr(cfg, "rope_theta", 1_000_000))),
            float(rp.get("sliding_attention", {}).get("rope_theta", 10_000)),
            rp.get("full_attention", {}).get("rope_type", "default"),
            float(rp.get("full_attention", {}).get("factor", 1.0)),
        )

    def side_common(sc, cfg, mod):
        b.add_attr(f"{sc}/num_heads", cfg.num_attention_heads, "int16")
        b.add_attr(f"{sc}/pre_norm", 1, "int8")
        b.add_attr(f"{sc}/activation", act_of(cfg), "int8")
        embed_scale = getattr(mod.embed_tokens, "embed_scale", None)
        if embed_scale is not None:
            b.add_attr(f"{sc}/scale_embeddings", float(embed_scale),
                       "float32")
        else:
            b.add_attr(f"{sc}/scale_embeddings", 0, "int8")
        name = f"{sc}/embeddings_0" if sc == "encoder" else f"{sc}/embeddings"
        b.set_embeddings(name, mod.embed_tokens)
        b.set_layer_norm(f"{sc}/layer_norm", mod.norm, rms=True)

    def set_attn_attrs(asc, cfg, i, layer_types):
        num_heads = cfg.num_attention_heads
        num_heads_kv = getattr(cfg, "num_key_value_heads", num_heads)
        head_dim = cfg.head_dim
        if num_heads_kv != num_heads:
            b.add_attr(f"{asc}/num_heads_kv", num_heads_kv, "int32")
        if head_dim != cfg.hidden_size // num_heads:
            b.add_attr(f"{asc}/head_dim", head_dim, "int32")
        b.add_attr(f"{asc}/rotary_dim", 0, "int32")
        b.add_attr(f"{asc}/rotary_interleave", 0, "int8")
        g_theta, l_theta, g_type, g_factor = rope_of(cfg)
        full = (layer_types is None or i >= len(layer_types)
                or layer_types[i] == "full_attention")
        if full:
            b.add_attr(f"{asc}/rotary_base", g_theta, "float32")
            if g_type == "linear":
                b.add_attr(f"{asc}/rotary_scaling_type", 0, "int8")
                b.add_attr(f"{asc}/rotary_scaling_factor", g_factor,
                           "float32")
        else:
            b.add_attr(f"{asc}/rotary_base", l_theta, "float32")
            if getattr(cfg, "sliding_window", 0):
                b.add_attr(f"{asc}/sliding_window",
                           int(cfg.sliding_window), "int32")

    def maybe_qk_norms(asc, attn):
        if getattr(attn, "q_norm", None) is not None:
            b.set_layer_norm(f"{asc}/q_norm", attn.q_norm, rms=True)
        if getattr(attn, "k_norm", None) is not None:
            b.set_layer_norm(f"{asc}/k_norm", attn.k_norm, rms=True)

    # Encoder: sandwich-norm self-attention layers.
    enc = getattr(module.encoder, "text_model", module.encoder)
    side_common("encoder", enc_cfg, enc)
    enc_types = getattr(enc_cfg, "layer_types", None)
    for i, layer in enumerate(enc.layers):
        ls = f"encoder/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{ls}/input_layer_norm",
                         layer.pre_self_attn_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/post_attention_layer_norm",
                         layer.post_self_attn_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/pre_feedforward_layer_norm",
                         layer.pre_feedforward_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/post_feedforward_layer_norm",
                         layer.post_feedforward_layernorm, rms=True)
        b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                  layer.self_attn.v_proj)
        maybe_qk_norms(asc, layer.self_attn)
        b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.gate_proj)
        b.set_linear(f"{ls}/ffn/linear_0_noact", layer.mlp.up_proj)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)
        set_attn_attrs(asc, enc_cfg, i, enc_types)

    # Decoder: merged self+cross attention.
    dec = module.decoder
    side_common("decoder", dec_cfg, dec)
    dec_types = getattr(dec_cfg, "layer_types", None)
    for i, layer in enumerate(dec.layers):
        ls = f"decoder/layer_{i}"
        asc = f"{ls}/self_attention"
        b.set_layer_norm(f"{ls}/input_layer_norm",
                         layer.pre_self_attn_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/post_attention_layer_norm",
                         layer.post_self_attn_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/pre_feedforward_layer_norm",
                         layer.pre_feedforward_layernorm, rms=True)
        b.set_layer_norm(f"{ls}/post_feedforward_layer_norm",
                         layer.post_feedforward_layernorm, rms=True)
        b.set_qkv(asc, layer.self_attn.q_proj, layer.self_attn.k_proj,
                  layer.self_attn.v_proj)
        maybe_qk_norms(asc, layer.self_attn)
        # The same K/V projections re-project encoder memory at inference
        # (fused memory_kv linear, reference: transformers.py:4222-4229).
        kw = _np(layer.self_attn.k_proj.weight)
        vw = _np(layer.self_attn.v_proj.weight)
        b.add(f"{asc}/memory_kv/weight", np.concatenate([kw, vw], axis=0))
        b.set_linear(f"{asc}/linear_1", layer.self_attn.o_proj)
        b.set_linear(f"{ls}/ffn/linear_0", layer.mlp.gate_proj)
        b.set_linear(f"{ls}/ffn/linear_0_noact", layer.mlp.up_proj)
        b.set_linear(f"{ls}/ffn/linear_1", layer.mlp.down_proj)
        set_attn_attrs(asc, dec_cfg, i, dec_types)

    b.add_attr("encoder/embeddings_merge", 0, "int8")
    if hasattr(model.lm_head, "weight"):
        b.set_linear("decoder/projection", model.lm_head)
    else:
        b.set_linear("decoder/projection", dec.embed_tokens)
    return {
        "layer_norm_epsilon": float(getattr(enc_cfg, "rms_norm_eps", 1e-6)),
        "decoder_start_token": getattr(tokenizer, "bos_token", "<s>") or "<s>",
    }
