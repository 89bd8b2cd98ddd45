"""Programmatic model-directory builder (numpy only).

A copy of the encoder-decoder builder, the decoder-only builder and the
Whisper builder of ``ctranslate2_tpu/converters/builder.py``, with every
argument of theirs (ALiBi, parallel residual, sliding windows and
Gemma-style hybrid stacks, Shaw and T5 relative positions, merged
self+cross attention, source features): each writes the same
CTranslate2-format model directory, byte for byte, from the same seed, so
a model can be fabricated without importing the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from ..formats.model_file import ModelFile, make_variable

ACTIVATION_IDS = {
    "relu": 0, "gelu_tanh": 1, "swish": 2, "gelu": 3,
    "gelu_sigmoid": 4, "tanh": 5, "sigmoid": 6,
}


class SpecBuilder:
    """Accumulates variables under CT2 scope names."""

    def __init__(self, spec_name: str, spec_revision: int):
        self.mf = ModelFile(spec_name=spec_name, spec_revision=spec_revision,
                            binary_version=6)

    def add(self, name: str, value, dtype: Optional[str] = None):
        self.mf.variables[name] = make_variable(name, value, dtype)

    def add_attr(self, name: str, value, dtype: str):
        self.add(name, value, dtype)

    def quantize(self, quantization: Optional[str], group_size: int = 32):
        """Quantize linear/embedding weights in place
        (reference: python/ctranslate2/specs/model_spec.py:191-260)."""
        if quantization in (None, "float32"):
            return
        new_vars = {}
        for name, var in list(self.mf.variables.items()):
            if not name.endswith("/weight") or len(var.shape) < 2 \
                    or var.dtype_name != "float32":
                continue
            w = var.array
            if quantization in ("awq_gemm", "awq_gemv"):
                # AWQ applies to the layers' linears only; embeddings and
                # the logits projection stay float (reference:
                # python/ctranslate2/converters/transformers.py:1752-1754).
                if "/layer_" not in name or "embeddings" in name:
                    continue
                from ..ops.awq import AWQ_GEMM, AWQ_GEMV, quantize_awq

                qt = AWQ_GEMM if quantization == "awq_gemm" else AWQ_GEMV
                qw, scales, qz = quantize_awq(w, group_size, qt)
                new_vars[name] = make_variable(name, qw, "int32")
                new_vars[name + "_scale"] = make_variable(name + "_scale", scales)
                new_vars[name + "_zero"] = make_variable(name + "_zero", qz, "int32")
                self._awq_config = {
                    "quantization_type": qt,
                    "quantization_bits": 4,
                    "quantization_group_size": group_size,
                }
                continue
            if quantization in ("int8", "int8_float32", "int8_float16",
                                "int8_bfloat16"):
                amax = np.amax(np.abs(w), axis=tuple(range(1, w.ndim)))
                amax[amax == 0] = 127.0
                scale = 127.0 / amax
                q = np.clip(
                    np.rint(w * scale.reshape((-1,) + (1,) * (w.ndim - 1))),
                    -127, 127).astype(np.int8)
                new_vars[name] = make_variable(name, q, "int8")
                new_vars[name + "_scale"] = make_variable(
                    name + "_scale", scale.astype(np.float32))
            elif quantization == "int16":
                amax = np.amax(np.abs(w))
                scale = float(2 ** 10) / amax
                q = np.clip(np.rint(w * scale), -(2 ** 15), 2 ** 15 - 1).astype(np.int16)
                new_vars[name] = make_variable(name, q, "int16")
                new_vars[name + "_scale"] = make_variable(
                    name + "_scale", np.float32(scale))
            elif quantization in ("float16", "bfloat16"):
                new_vars[name] = make_variable(name, w, quantization)
            else:
                raise NotImplementedError(
                    f"quantization {quantization!r} is not ported yet")
        self.mf.variables.update(new_vars)

    def save(self, directory: str, config: Optional[dict] = None,
             vocabulary: Optional[Sequence[str]] = None,
             source_vocabulary: Optional[Sequence[str]] = None,
             target_vocabulary: Optional[Sequence[str]] = None):
        self.mf.config = config or {}
        self.mf.config.update(getattr(self, "_awq_config", {}))
        self.mf.dedupe_aliases()
        self.mf.save(directory)
        if vocabulary is not None:
            # Decoder-only specs name their single vocabulary "vocabulary"
            # (reference: src/models/language_model.cc:33); shared seq2seq
            # vocabularies use "shared_vocabulary".
            name = ("vocabulary.json"
                    if self.mf.spec_name == "TransformerDecoderSpec"
                    else "shared_vocabulary.json")
            with open(os.path.join(directory, name), "w",
                      encoding="utf-8") as f:
                json.dump(list(vocabulary), f)
        for fname, words in (("source_vocabulary.json", source_vocabulary),
                             ("target_vocabulary.json", target_vocabulary)):
            if words is not None:
                with open(os.path.join(directory, fname), "w",
                          encoding="utf-8") as f:
                    json.dump(list(words), f)


def _rand(rng, *shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _add_attention(b: SpecBuilder, scope: str, rng, d_model: int,
                   num_heads: int, self_attention: bool,
                   num_heads_kv: Optional[int] = None,
                   rotary_dim: Optional[int] = None,
                   rotary_interleave: bool = True,
                   head_dim: Optional[int] = None,
                   with_norm: bool = True,
                   rms_norm: bool = False):
    hd = head_dim or d_model // num_heads
    hkv = num_heads_kv if num_heads_kv is not None else num_heads
    if with_norm:
        b.add(f"{scope}/layer_norm/gamma", np.ones(d_model, np.float32))
        if not rms_norm:
            b.add(f"{scope}/layer_norm/beta", np.zeros(d_model, np.float32))
    if self_attention:
        qkv_out = num_heads * hd + 2 * hkv * hd
        b.add(f"{scope}/linear_0/weight", _rand(rng, qkv_out, d_model))
        b.add(f"{scope}/linear_0/bias", _rand(rng, qkv_out))
        b.add(f"{scope}/linear_1/weight", _rand(rng, d_model, num_heads * hd))
        b.add(f"{scope}/linear_1/bias", _rand(rng, d_model))
    else:
        b.add(f"{scope}/linear_0/weight", _rand(rng, num_heads * hd, d_model))
        b.add(f"{scope}/linear_0/bias", _rand(rng, num_heads * hd))
        b.add(f"{scope}/linear_1/weight", _rand(rng, 2 * hkv * hd, d_model))
        b.add(f"{scope}/linear_1/bias", _rand(rng, 2 * hkv * hd))
        b.add(f"{scope}/linear_2/weight", _rand(rng, d_model, num_heads * hd))
        b.add(f"{scope}/linear_2/bias", _rand(rng, d_model))
    if hkv != num_heads:
        b.add_attr(f"{scope}/num_heads_kv", hkv, "int32")
    if head_dim is not None:
        b.add_attr(f"{scope}/head_dim", head_dim, "int32")
    if rotary_dim is not None:
        b.add_attr(f"{scope}/rotary_dim", rotary_dim, "int32")
        b.add_attr(f"{scope}/rotary_interleave", 1 if rotary_interleave else 0, "int8")


def _add_ffn(b: SpecBuilder, scope: str, rng, d_model: int, d_ff: int,
             glu: bool = False, rms_norm: bool = False, bias: bool = True):
    b.add(f"{scope}/layer_norm/gamma", np.ones(d_model, np.float32))
    if not rms_norm:
        b.add(f"{scope}/layer_norm/beta", np.zeros(d_model, np.float32))
    b.add(f"{scope}/linear_0/weight", _rand(rng, d_ff, d_model))
    if bias:
        b.add(f"{scope}/linear_0/bias", _rand(rng, d_ff))
    if glu:
        b.add(f"{scope}/linear_0_noact/weight", _rand(rng, d_ff, d_model))
        if bias:
            b.add(f"{scope}/linear_0_noact/bias", _rand(rng, d_ff))
    b.add(f"{scope}/linear_1/weight", _rand(rng, d_model, d_ff))
    if bias:
        b.add(f"{scope}/linear_1/bias", _rand(rng, d_model))


def build_decoder_only_model(
    directory: str,
    *,
    vocab_size: int = 64,
    num_layers: int = 2,
    num_heads: int = 4,
    d_model: int = 32,
    d_ff: int = 64,
    num_heads_kv: Optional[int] = None,
    rotary_dim: Optional[int] = None,
    glu: bool = False,
    rms_norm: bool = False,
    activation: str = "relu",
    alibi: bool = False,
    alibi_positive: bool = True,
    parallel_residual: bool = False,
    shared_layer_norm: bool = False,
    sliding_window: int = 0,
    sliding_window_pattern: int = 1,  # >1: every Nth layer is GLOBAL
    # (Gemma-style hybrid window/global stacks)
    seed: int = 1234,
    quantization: Optional[str] = None,
    vocabulary: Optional[Sequence[str]] = None,
    tied_projection: bool = False,
    rel_position_max: int = 0,  # Shaw relative-position keys/values
    # (reference: src/layers/attention.cc:128-165)
    rel_bias_buckets: int = 0,  # T5 relative-bias table on layer 0
    rel_bias_max_distance: int = 16,
    # (reference: src/layers/attention.cc:51-126)
):
    """Fabricate a TransformerDecoderSpec model directory (GPT-style)."""
    rng = np.random.default_rng(seed)
    b = SpecBuilder("TransformerDecoderSpec", 8)
    sc = "decoder"

    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 1, "int8")
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS[activation], "int8")
    if sliding_window:
        b.add_attr(f"{sc}/sliding_window", sliding_window, "int32")
    if alibi:
        b.add_attr(f"{sc}/alibi", 1, "int8")
        if not alibi_positive:
            b.add_attr(f"{sc}/alibi_use_positive_positions", 0, "int8")
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

    emb = _rand(rng, vocab_size, d_model)
    b.add(f"{sc}/embeddings/weight", emb)
    relative = rel_position_max or rel_bias_buckets
    if rotary_dim is None and not alibi and not relative:
        # Learned position embeddings.
        b.add(f"{sc}/position_encodings/encodings", _rand(rng, 512, d_model))
    b.add(f"{sc}/layer_norm/gamma", np.ones(d_model, np.float32))
    if not rms_norm:
        b.add(f"{sc}/layer_norm/beta", np.zeros(d_model, np.float32))
    b.add(f"{sc}/projection/weight",
          emb.copy() if tied_projection else _rand(rng, vocab_size, d_model))

    for i in range(num_layers):
        ls = f"{sc}/layer_{i}"
        _add_attention(
            b, f"{ls}/self_attention", rng, d_model, num_heads,
            self_attention=True, num_heads_kv=num_heads_kv,
            rotary_dim=rotary_dim, rms_norm=rms_norm,
            with_norm=not (parallel_residual and shared_layer_norm))
        if rel_position_max:
            hd = d_model // num_heads
            b.add(f"{ls}/self_attention/relative_position_keys",
                  _rand(rng, 2 * rel_position_max + 1, hd))
            b.add(f"{ls}/self_attention/relative_position_values",
                  _rand(rng, 2 * rel_position_max + 1, hd))
        if rel_bias_buckets and i == 0:
            # T5 convention: the learned bias table lives on layer 0 and
            # is shared down the stack.
            b.add(f"{ls}/self_attention/relative_attention_bias",
                  _rand(rng, rel_bias_buckets, num_heads))
            b.add_attr(
                f"{ls}/self_attention/relative_attention_max_distance",
                rel_bias_max_distance, "int32")
        if sliding_window and (sliding_window_pattern <= 1 or
                               (i + 1) % sliding_window_pattern != 0):
            # Per-layer attr, matching the HF converter / reference
            # attention_spec serialization (with a pattern, every Nth
            # layer stays global — the Gemma hybrid layout).
            b.add_attr(f"{ls}/self_attention/sliding_window",
                       sliding_window, "int32")
        if parallel_residual:
            norm_scope = ("shared_layer_norm" if shared_layer_norm
                          else "input_layer_norm")
            b.add(f"{ls}/{norm_scope}/gamma", np.ones(d_model, np.float32))
            b.add(f"{ls}/{norm_scope}/beta", np.zeros(d_model, np.float32))
            if not shared_layer_norm:
                b.add(f"{ls}/post_attention_layer_norm/gamma",
                      np.ones(d_model, np.float32))
                b.add(f"{ls}/post_attention_layer_norm/beta",
                      np.zeros(d_model, np.float32))
            # Parallel-residual FFN has no layer norm of its own.
            b.add(f"{ls}/ffn/linear_0/weight", _rand(rng, d_ff, d_model))
            b.add(f"{ls}/ffn/linear_0/bias", _rand(rng, d_ff))
            b.add(f"{ls}/ffn/linear_1/weight", _rand(rng, d_model, d_ff))
            b.add(f"{ls}/ffn/linear_1/bias", _rand(rng, d_model))
        else:
            _add_ffn(b, f"{ls}/ffn", rng, d_model, d_ff, glu=glu,
                     rms_norm=rms_norm)

    b.quantize(quantization)
    vocab = vocabulary or default_vocab(vocab_size)
    b.save(directory,
           config={"unk_token": "<unk>", "bos_token": "<s>",
                   "eos_token": "</s>"},
           vocabulary=vocab)
    return directory


def build_seq2seq_model(
    directory: str,
    *,
    vocab_size: int = 64,
    num_layers: int = 2,
    num_heads: int = 4,
    d_model: int = 32,
    d_ff: int = 64,
    activation: str = "relu",
    seed: int = 1234,
    quantization: Optional[str] = None,
    merged_attention: bool = False,
    num_source_features: int = 1,
    features_merge: str = "concat",
    feature_vocab_size: int = 16,
    zero_extra_features: bool = False,
):
    """Fabricate a TransformerSpec encoder-decoder model directory.

    With ``merged_attention``, decoder layers carry a ``memory_kv``
    projection and no separate cross-attention (the T5Gemma2 layout,
    reference: src/layers/attention.cc:625-796).

    ``num_source_features > 1`` fabricates a source-factor model
    (embeddings_0..N + embeddings_merge + per-feature vocabularies,
    reference: src/layers/common.cc:49-148). With ``zero_extra_features``
    and ``features_merge="add"`` the model is numerically identical to its
    single-feature twin (same seed)."""
    rng = np.random.default_rng(seed)
    b = SpecBuilder("TransformerSpec", 7)

    for sc in ("encoder", "decoder"):
        b.add_attr(f"{sc}/num_heads", num_heads, "int16")
        b.add_attr(f"{sc}/pre_norm", 1, "int8")
        b.add_attr(f"{sc}/activation", ACTIVATION_IDS[activation], "int8")
        b.add(f"{sc}/embeddings/weight" if sc == "decoder"
              else f"{sc}/embeddings_0/weight",
              _rand(rng, vocab_size, d_model))
        b.add(f"{sc}/layer_norm/gamma", np.ones(d_model, np.float32))
        b.add(f"{sc}/layer_norm/beta", np.zeros(d_model, np.float32))
    b.add_attr("encoder/embeddings_merge",
               1 if features_merge in ("add", "sum") else 0, "int8")
    b.add("decoder/projection/weight", _rand(rng, vocab_size, d_model))
    b.add("decoder/projection/bias", _rand(rng, vocab_size))

    for i in range(num_layers):
        ls = f"encoder/layer_{i}"
        _add_attention(b, f"{ls}/self_attention", rng, d_model, num_heads, True)
        _add_ffn(b, f"{ls}/ffn", rng, d_model, d_ff)
    for i in range(num_layers):
        ls = f"decoder/layer_{i}"
        _add_attention(b, f"{ls}/self_attention", rng, d_model, num_heads, True)
        if merged_attention:
            b.add(f"{ls}/self_attention/memory_kv/weight",
                  _rand(rng, 2 * d_model, d_model))
            b.add(f"{ls}/self_attention/memory_kv/bias",
                  _rand(rng, 2 * d_model))
        else:
            _add_attention(b, f"{ls}/attention", rng, d_model, num_heads, False)
        _add_ffn(b, f"{ls}/ffn", rng, d_model, d_ff)

    if num_source_features > 1:
        rng2 = np.random.default_rng(seed + 99)
        extra = num_source_features - 1
        if features_merge in ("add", "sum"):
            dims = [d_model] * extra
        else:
            fd = 8
            dims = [fd] * extra
            # Shrink the main feature so concatenated dims sum to d_model.
            b.add("encoder/embeddings_0/weight",
                  _rand(rng2, vocab_size, d_model - fd * extra))
        for i, dim in enumerate(dims, start=1):
            w = (np.zeros((feature_vocab_size, dim), np.float32)
                 if zero_extra_features
                 else _rand(rng2, feature_vocab_size, dim))
            b.add(f"encoder/embeddings_{i}/weight", w)

    b.quantize(quantization)
    config = {"unk_token": "<unk>", "bos_token": "<s>",
              "eos_token": "</s>", "add_source_bos": False,
              "add_source_eos": False, "decoder_start_token": "<s>"}
    if num_source_features > 1:
        b.save(directory, config=config,
               target_vocabulary=default_vocab(vocab_size))
        vocab_sizes = [vocab_size] + [feature_vocab_size] * (
            num_source_features - 1)
        for i, vs in enumerate(vocab_sizes, start=1):
            with open(os.path.join(
                    directory, f"source_{i}_vocabulary.json"),
                    "w", encoding="utf-8") as f:
                json.dump(default_vocab(vs), f, ensure_ascii=False)
    else:
        b.save(directory, config=config,
               vocabulary=default_vocab(vocab_size))
    return directory


def build_whisper_model(
    directory: str,
    *,
    n_mels: int = 24,
    num_layers: int = 2,
    num_heads: int = 4,
    d_model: int = 32,
    d_ff: int = 64,
    num_text_tokens: int = 20,
    num_languages: int = 2,
    num_timestamps: int = 11,
    max_positions: int = 64,
    seed: int = 1234,
    quantization: Optional[str] = None,
):
    """Fabricate a WhisperSpec model directory with the reference vocabulary
    layout (reference: src/models/whisper.cc:74-78). Returns (directory,
    vocabulary)."""
    rng = np.random.default_rng(seed)
    b = SpecBuilder("WhisperSpec", 3)

    # Vocabulary layout: text..., <|endoftext|>, <|startoftranscript|>,
    # languages..., <|translate|>, <|transcribe|>, <|startoflm|>,
    # <|startofprev|>, <|nospeech|>, <|notimestamps|>, timestamps...
    vocab = [""] + [f"w{i}" for i in range(num_text_tokens - 1)]
    vocab.append("<|endoftext|>")
    vocab.append("<|startoftranscript|>")
    langs = ["en", "fr", "de", "es", "ja"][:num_languages]
    lang_ids = []
    for lang in langs:
        lang_ids.append(len(vocab))
        vocab.append(f"<|{lang}|>")
    vocab += ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
              "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"]
    for i in range(num_timestamps):
        vocab.append(f"<|{i * 0.02:.2f}|>")
    vocab_size = len(vocab)

    for sc in ("encoder", "decoder"):
        b.add_attr(f"{sc}/num_heads", num_heads, "int16")

    # Encoder: the convolution frontend and a Transformer stack.
    b.add("encoder/conv1/weight", _rand(rng, d_model, n_mels, 3))
    b.add("encoder/conv1/bias", _rand(rng, d_model))
    b.add("encoder/conv2/weight", _rand(rng, d_model, d_model, 3))
    b.add("encoder/conv2/bias", _rand(rng, d_model))
    b.add("encoder/position_encodings/encodings", _rand(rng, max_positions, d_model))
    b.add("encoder/layer_norm/gamma", np.ones(d_model, np.float32))
    b.add("encoder/layer_norm/beta", np.zeros(d_model, np.float32))
    for i in range(num_layers):
        ls = f"encoder/layer_{i}"
        _add_attention(b, f"{ls}/self_attention", rng, d_model, num_heads, True)
        _add_ffn(b, f"{ls}/ffn", rng, d_model, d_ff)

    # Decoder.
    b.add_attr("decoder/pre_norm", 1, "int8")
    b.add_attr("decoder/activation", ACTIVATION_IDS["gelu"], "int8")
    b.add("decoder/embeddings/weight", _rand(rng, vocab_size, d_model))
    b.add("decoder/position_encodings/encodings", _rand(rng, max_positions, d_model))
    b.add("decoder/layer_norm/gamma", np.ones(d_model, np.float32))
    b.add("decoder/layer_norm/beta", np.zeros(d_model, np.float32))
    b.add("decoder/projection/weight", _rand(rng, vocab_size, d_model))
    for i in range(num_layers):
        ls = f"decoder/layer_{i}"
        _add_attention(b, f"{ls}/self_attention", rng, d_model, num_heads, True)
        _add_attention(b, f"{ls}/attention", rng, d_model, num_heads, False)
        _add_ffn(b, f"{ls}/ffn", rng, d_model, d_ff)

    b.quantize(quantization)
    config = {
        "suppress_ids": [1, 2],
        "suppress_ids_begin": [vocab.index("<|notimestamps|>") - 1],
        "lang_ids": lang_ids,
        "alignment_heads": [[num_layers - 1, h] for h in range(num_heads // 2)],
    }
    b.save(directory, config=config)
    with open(os.path.join(directory, "vocabulary.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    return directory, vocab


def default_vocab(vocab_size: int):
    vocab = ["<unk>", "<s>", "</s>"]
    vocab += [f"tok{i}" for i in range(vocab_size - len(vocab))]
    return vocab
