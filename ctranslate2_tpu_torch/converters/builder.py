"""Programmatic model-directory builder (numpy only).

A copy of the encoder-decoder part of
``ctranslate2_tpu/converters/builder.py``: it writes the same
CTranslate2-format model directory, byte for byte, from the same seed, so
a full-width model can be fabricated without importing the JAX package.
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

    def quantize(self, quantization: Optional[str]):
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
            elif quantization in ("float16", "bfloat16"):
                new_vars[name] = make_variable(name, w, quantization)
            else:
                raise NotImplementedError(
                    f"quantization {quantization!r} is not ported yet")
        self.mf.variables.update(new_vars)

    def save(self, directory: str, config: Optional[dict] = None,
             vocabulary: Optional[Sequence[str]] = None):
        self.mf.config = config or {}
        self.mf.dedupe_aliases()
        self.mf.save(directory)
        if vocabulary is not None:
            with open(os.path.join(directory, "shared_vocabulary.json"), "w",
                      encoding="utf-8") as f:
                json.dump(list(vocabulary), f)


def _rand(rng, *shape):
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _add_attention(b: SpecBuilder, scope: str, rng, d_model: int,
                   num_heads: int, self_attention: bool):
    hd = d_model // num_heads
    b.add(f"{scope}/layer_norm/gamma", np.ones(d_model, np.float32))
    b.add(f"{scope}/layer_norm/beta", np.zeros(d_model, np.float32))
    if self_attention:
        qkv_out = 3 * num_heads * hd
        b.add(f"{scope}/linear_0/weight", _rand(rng, qkv_out, d_model))
        b.add(f"{scope}/linear_0/bias", _rand(rng, qkv_out))
        b.add(f"{scope}/linear_1/weight", _rand(rng, d_model, num_heads * hd))
        b.add(f"{scope}/linear_1/bias", _rand(rng, d_model))
    else:
        b.add(f"{scope}/linear_0/weight", _rand(rng, num_heads * hd, d_model))
        b.add(f"{scope}/linear_0/bias", _rand(rng, num_heads * hd))
        b.add(f"{scope}/linear_1/weight", _rand(rng, 2 * num_heads * hd, d_model))
        b.add(f"{scope}/linear_1/bias", _rand(rng, 2 * num_heads * hd))
        b.add(f"{scope}/linear_2/weight", _rand(rng, d_model, num_heads * hd))
        b.add(f"{scope}/linear_2/bias", _rand(rng, d_model))


def _add_ffn(b: SpecBuilder, scope: str, rng, d_model: int, d_ff: int):
    b.add(f"{scope}/layer_norm/gamma", np.ones(d_model, np.float32))
    b.add(f"{scope}/layer_norm/beta", np.zeros(d_model, np.float32))
    b.add(f"{scope}/linear_0/weight", _rand(rng, d_ff, d_model))
    b.add(f"{scope}/linear_0/bias", _rand(rng, d_ff))
    b.add(f"{scope}/linear_1/weight", _rand(rng, d_model, d_ff))
    b.add(f"{scope}/linear_1/bias", _rand(rng, d_model))


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
):
    """Fabricate a TransformerSpec encoder-decoder model directory with
    random weights from ``seed`` (pre-norm, sinusoidal positions, shared
    vocabulary)."""
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
    b.add_attr("encoder/embeddings_merge", 0, "int8")
    b.add("decoder/projection/weight", _rand(rng, vocab_size, d_model))
    b.add("decoder/projection/bias", _rand(rng, vocab_size))

    for i in range(num_layers):
        ls = f"encoder/layer_{i}"
        _add_attention(b, f"{ls}/self_attention", rng, d_model, num_heads, True)
        _add_ffn(b, f"{ls}/ffn", rng, d_model, d_ff)
    for i in range(num_layers):
        ls = f"decoder/layer_{i}"
        _add_attention(b, f"{ls}/self_attention", rng, d_model, num_heads, True)
        _add_attention(b, f"{ls}/attention", rng, d_model, num_heads, False)
        _add_ffn(b, f"{ls}/ffn", rng, d_model, d_ff)

    b.quantize(quantization)
    config = {"unk_token": "<unk>", "bos_token": "<s>",
              "eos_token": "</s>", "add_source_bos": False,
              "add_source_eos": False, "decoder_start_token": "<s>"}
    b.save(directory, config=config, vocabulary=default_vocab(vocab_size))
    return directory


def default_vocab(vocab_size: int):
    vocab = ["<unk>", "<s>", "</s>"]
    vocab += [f"tok{i}" for i in range(vocab_size - len(vocab))]
    return vocab
