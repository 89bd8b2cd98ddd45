"""Fairseq checkpoint (.pt) converter.

Capability parity with the reference converter
(reference: python/ctranslate2/converters/fairseq.py), re-designed to work
directly from the checkpoint's state dict and data-dir dictionaries — no
fairseq installation required (the reference rebuilds the fairseq model to
walk its modules; the weight names are identical either way).

Supports the transformer / transformer_align / bart / multilingual
seq2seq architectures and transformer_lm.

The port's copy of ``ctranslate2_tpu/converters/fairseq_conv.py``: it writes the
same model directory, byte for byte, and imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from .builder import ACTIVATION_IDS, SpecBuilder

_SUPPORTED_ACTIVATIONS = {
    "gelu": "gelu",
    "gelu_accurate": "gelu_tanh",
    "gelu_fast": "gelu_tanh",
    "relu": "relu",
    "swish": "swish",
}


def load_fairseq_dictionary(path: str) -> List[str]:
    """Fairseq dictionary file -> token list with the implicit specials
    (lua-heritage order: <s> <pad> </s> <unk>), mapping <pad> to <blank>
    (reference: fairseq.py:102-103 and fairseq Dictionary defaults)."""
    tokens = ["<s>", "<blank>", "</s>", "<unk>"]
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            token = line.rsplit(" ", 1)[0]
            tokens.append("<blank>" if token == "<pad>" else token)
    return tokens


def _fairseq_sinusoidal(num_positions: int, dim: int) -> np.ndarray:
    """Fairseq's sinusoidal table: [sin half | cos half] with its exact
    frequency spacing (fairseq SinusoidalPositionalEmbedding.get_embedding).
    """
    half = dim // 2
    emb = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    pos = np.arange(num_positions)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2:
        table = np.concatenate(
            [table, np.zeros((num_positions, 1))], axis=1)
    return table.astype(np.float32)


class FairseqConverter:
    """Converts models trained with Fairseq
    (reference: fairseq.py:105-206)."""

    def __init__(self, model_path: str, data_dir: str,
                 source_lang: Optional[str] = None,
                 target_lang: Optional[str] = None,
                 fixed_dictionary: Optional[str] = None,
                 no_default_special_tokens: bool = False,
                 user_dir: Optional[str] = None,
                 unsafe_deserialization: bool = False):
        self._model_path = model_path
        self._data_dir = data_dir
        self._source_lang = source_lang
        self._target_lang = target_lang
        self._fixed_dictionary = fixed_dictionary
        self._no_default_special_tokens = no_default_special_tokens
        self._unsafe = unsafe_deserialization

    def _find_dict(self, lang: Optional[str]) -> Optional[str]:
        if self._fixed_dictionary:
            return self._fixed_dictionary
        if lang:
            p = os.path.join(self._data_dir, f"dict.{lang}.txt")
            if os.path.isfile(p):
                return p
        hits = sorted(
            f for f in os.listdir(self._data_dir)
            if re.match(r"dict\..*\.txt$", f))
        if hits:
            return os.path.join(self._data_dir, hits[0])
        return None

    def convert(self, output_dir: str, quantization: Optional[str] = None,
                force: bool = False) -> str:
        import torch

        if os.path.exists(os.path.join(output_dir, "model.bin")) and not force:
            raise RuntimeError(
                f"The output directory {output_dir} already exists "
                "(use force=True to override)")

        ckpt = torch.load(self._model_path, map_location="cpu",
                          weights_only=not self._unsafe)
        args = ckpt.get("args")
        if args is None:
            args = ckpt["cfg"]["model"]

        def getarg(name, default=None):
            if isinstance(args, dict):
                return args.get(name, default)
            return getattr(args, name, default)

        activation_fn = getarg("activation_fn", "relu")
        if activation_fn not in _SUPPORTED_ACTIVATIONS:
            raise ValueError(
                f"Option --activation-fn {activation_fn} is not supported")
        if getarg("no_token_positional_embeddings", False):
            raise ValueError(
                "Option --no-token-positional-embeddings is not supported")
        act_id = ACTIVATION_IDS[_SUPPORTED_ACTIVATIONS[activation_fn]]

        variables = {
            k: np.asarray(v.float().numpy() if hasattr(v, "float") else v,
                          np.float32)
            for k, v in ckpt["model"].items()}

        is_lm = "transformer_lm" in str(getarg("arch", "transformer")) \
            and "decoder.layers.0.encoder_attn.q_proj.weight" not in variables \
            and "encoder.layers.0.self_attn.q_proj.weight" not in variables

        src_lang = self._source_lang or getarg("source_lang")
        tgt_lang = self._target_lang or getarg("target_lang")

        b = SpecBuilder(
            "TransformerDecoderSpec" if is_lm else "TransformerSpec",
            8 if is_lm else 7)

        pre_norm = bool(getarg("decoder_normalize_before", False))

        def set_linear(name, scope):
            b.add(f"{name}/weight", variables[f"{scope}.weight"])
            bias = variables.get(f"{scope}.bias")
            if bias is not None:
                b.add(f"{name}/bias", bias)

        def set_ln(name, scope):
            if f"{scope}.weight" not in variables:
                return False
            b.add(f"{name}/gamma", variables[f"{scope}.weight"])
            beta = variables.get(f"{scope}.bias")
            if beta is not None:
                b.add(f"{name}/beta", beta)
            return True

        def set_attention(name, scope, self_attention):
            if self_attention:
                b.add(f"{name}/linear_0/weight", np.concatenate(
                    [variables[f"{scope}.q_proj.weight"],
                     variables[f"{scope}.k_proj.weight"],
                     variables[f"{scope}.v_proj.weight"]], axis=0))
                if f"{scope}.q_proj.bias" in variables:
                    b.add(f"{name}/linear_0/bias", np.concatenate(
                        [variables[f"{scope}.q_proj.bias"],
                         variables[f"{scope}.k_proj.bias"],
                         variables[f"{scope}.v_proj.bias"]]))
                out_name = f"{name}/linear_1"
            else:
                set_linear(f"{name}/linear_0", f"{scope}.q_proj")
                b.add(f"{name}/linear_1/weight", np.concatenate(
                    [variables[f"{scope}.k_proj.weight"],
                     variables[f"{scope}.v_proj.weight"]], axis=0))
                if f"{scope}.k_proj.bias" in variables:
                    b.add(f"{name}/linear_1/bias", np.concatenate(
                        [variables[f"{scope}.k_proj.bias"],
                         variables[f"{scope}.v_proj.bias"]]))
                out_name = f"{name}/linear_2"
            set_linear(out_name, f"{scope}.out_proj")

        def set_side(side, module):
            num_heads = getarg(f"{module}_attention_heads", 8)
            b.add_attr(f"{side}/num_heads", num_heads, "int16")
            b.add_attr(f"{side}/pre_norm", 1 if pre_norm else 0, "int8")
            b.add_attr(f"{side}/activation", act_id, "int8")
            emb = variables[f"{module}.embed_tokens.weight"]
            name = (f"{side}/embeddings_0" if side == "encoder"
                    else f"{side}/embeddings")
            b.add(f"{name}/weight", emb)
            if not getarg("no_scale_embedding", False):
                b.add_attr(f"{side}/scale_embeddings", 1, "int8")
            else:
                b.add_attr(f"{side}/scale_embeddings", 0, "int8")

            # Learned positions carry weights; sinusoidal ones are
            # regenerated, both sliced past padding_idx
            # (reference: fairseq.py:297-301).
            learned = variables.get(f"{module}.embed_positions.weight")
            if learned is not None:
                b.add(f"{side}/position_encodings/encodings", learned[2:])
            else:
                dim = emb.shape[1]
                table = _fairseq_sinusoidal(
                    int(getarg("max_source_positions", 1024)) + 2, dim)
                b.add(f"{side}/position_encodings/encodings", table[2:])

            set_ln(f"{side}/layernorm_embedding",
                   f"{module}.layernorm_embedding")
            set_ln(f"{side}/layer_norm", f"{module}.layer_norm")
            if f"{module}.project_in_dim.weight" in variables:
                set_linear(f"{side}/project_in", f"{module}.project_in_dim")
            if f"{module}.project_out_dim.weight" in variables:
                set_linear(f"{side}/project_out", f"{module}.project_out_dim")

            i = 0
            while f"{module}.layers.{i}.fc1.weight" in variables:
                ls = f"{side}/layer_{i}"
                sscope = f"{module}.layers.{i}"
                set_attention(f"{ls}/self_attention", f"{sscope}.self_attn",
                              True)
                set_ln(f"{ls}/self_attention/layer_norm",
                       f"{sscope}.self_attn_layer_norm")
                if f"{sscope}.encoder_attn.q_proj.weight" in variables:
                    set_attention(f"{ls}/attention", f"{sscope}.encoder_attn",
                                  False)
                    set_ln(f"{ls}/attention/layer_norm",
                           f"{sscope}.encoder_attn_layer_norm")
                set_ln(f"{ls}/ffn/layer_norm", f"{sscope}.final_layer_norm")
                set_linear(f"{ls}/ffn/linear_0", f"{sscope}.fc1")
                set_linear(f"{ls}/ffn/linear_1", f"{sscope}.fc2")
                i += 1

        if not is_lm:
            set_side("encoder", "encoder")
            b.add_attr("encoder/embeddings_merge", 0, "int8")
        set_side("decoder", "decoder")
        set_linear("decoder/projection", "decoder.output_projection")

        config = {"unk_token": "<unk>", "bos_token": "<s>",
                  "eos_token": "</s>"}
        if is_lm:
            if not getarg("add_bos_token", False):
                config["bos_token"] = "</s>"
        elif self._no_default_special_tokens:
            config["decoder_start_token"] = None
        else:
            config["decoder_start_token"] = "</s>"
            config["add_source_eos"] = True

        b.quantize(quantization)
        os.makedirs(output_dir, exist_ok=True)
        if is_lm:
            d = self._find_dict(tgt_lang)
            b.save(output_dir, config=config,
                   vocabulary=load_fairseq_dictionary(d) if d else None)
        else:
            src_dict = self._find_dict(src_lang)
            tgt_dict = self._find_dict(tgt_lang) if tgt_lang else src_dict
            b.save(output_dir, config=config,
                   source_vocabulary=load_fairseq_dictionary(src_dict)
                   if src_dict else None,
                   target_vocabulary=load_fairseq_dictionary(tgt_dict)
                   if tgt_dict else None)
        return output_dir
