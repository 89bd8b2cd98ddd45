"""OpenNMT-py checkpoint (.pt) converter.

Capability parity with the reference converter
(reference: python/ctranslate2/converters/opennmt_py.py): supports the
Transformer seq2seq (`--decoder_type transformer`) and decoder-only
(`transformer_lm`) architectures, including relative positions, rotary /
ALiBi (`max_relative_positions` -1 / -2), GQA (`num_kv`), GLU FFN and RMS
norm options.

The port's copy of ``ctranslate2_tpu/converters/opennmt_py_conv.py``: it writes the
same model directory, byte for byte, and imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .builder import ACTIVATION_IDS, SpecBuilder

_SUPPORTED_ACTIVATIONS = {
    "gelu": "gelu",
    "fast_gelu": "gelu_tanh",
    "relu": "relu",
    "silu": "swish",
}

_MERGE_IDS = {"concat": 0, "sum": 1}


def get_vocabs(vocab):
    """(reference: opennmt_py.py:144-160)."""
    if isinstance(vocab, dict) and "src" in vocab:
        if isinstance(vocab["src"], list):
            src_vocabs = [vocab["src"]]
            tgt_vocabs = [vocab["tgt"]]
            src_feats = vocab.get("src_feats")
            if src_feats is not None:
                src_vocabs.extend(src_feats.values())
        else:
            src_vocabs = [field[1].vocab.itos for field in vocab["src"].fields]
            tgt_vocabs = [field[1].vocab.itos for field in vocab["tgt"].fields]
    else:
        src_vocabs = [vocab[0][1].itos]
        tgt_vocabs = [vocab[1][1].itos]
    return src_vocabs, tgt_vocabs


class OpenNMTPyConverter:
    """Converts models generated by OpenNMT-py
    (reference: opennmt_py.py:163-213)."""

    def __init__(self, model_path: str, unsafe_deserialization: bool = False):
        self._model_path = model_path
        self._unsafe = unsafe_deserialization

    def convert(self, output_dir: str, quantization: Optional[str] = None,
                force: bool = False) -> str:
        import torch

        if os.path.exists(os.path.join(output_dir, "model.bin")) and not force:
            raise RuntimeError(
                f"The output directory {output_dir} already exists "
                "(use force=True to override)")

        ckpt = torch.load(self._model_path, map_location="cpu",
                          weights_only=not self._unsafe)
        opt = ckpt["opt"]
        src_vocabs, tgt_vocabs = get_vocabs(ckpt["vocab"])

        variables = dict(ckpt["model"])
        variables.update(
            {f"generator.{k}": v for k, v in ckpt.get("generator", {}).items()})
        variables = {
            k: np.asarray(v.float().numpy() if hasattr(v, "float") else v,
                          np.float32)
            for k, v in variables.items()}

        def getopt(name, default=None):
            if isinstance(opt, dict):
                return opt.get(name, default)
            return getattr(opt, name, default)

        decoder_type = getopt("decoder_type", "transformer")
        activation_fn = getopt("pos_ffn_activation_fn", "relu")
        if activation_fn not in _SUPPORTED_ACTIVATIONS:
            raise ValueError(
                f"Option --pos_ffn_activation_fn {activation_fn} is not supported")
        if getopt("self_attn_type", "scaled-dot") != "scaled-dot":
            raise ValueError("Option --self_attn_type must be 'scaled-dot'")
        act_id = ACTIVATION_IDS[_SUPPORTED_ACTIVATIONS[activation_fn]]

        mrp = getopt("max_relative_positions", 0)
        with_relative = mrp > 0
        with_rotary = mrp == -1
        with_alibi = mrp == -2
        num_heads = getopt("heads", 8)

        if decoder_type == "transformer_lm":
            out = self._convert_lm(
                variables, opt=getopt, act_id=act_id, num_heads=num_heads,
                with_relative=with_relative, with_rotary=with_rotary,
                with_alibi=with_alibi)
        else:
            out = self._convert_seq2seq(
                variables, opt=getopt, act_id=act_id, num_heads=num_heads,
                with_relative=with_relative,
                num_source_embeddings=len(src_vocabs))

        b, config = out
        b.quantize(quantization)
        os.makedirs(output_dir, exist_ok=True)
        if decoder_type == "transformer_lm":
            b.save(output_dir, config=config, vocabulary=tgt_vocabs[0])
        elif len(src_vocabs) == 1:
            b.save(output_dir, config=config,
                   source_vocabulary=src_vocabs[0],
                   target_vocabulary=tgt_vocabs[0])
        else:
            import json

            b.save(output_dir, config=config,
                   target_vocabulary=tgt_vocabs[0])
            for i, v in enumerate(src_vocabs):
                with open(os.path.join(
                        output_dir, f"source_{i + 1}_vocabulary.json"),
                        "w", encoding="utf-8") as f:
                    json.dump(list(v), f, ensure_ascii=False)
        return output_dir

    # -- shared pieces ----------------------------------------------------

    def _set_linear(self, b, name, variables, scope):
        b.add(f"{name}/weight", variables[f"{scope}.weight"])
        bias = variables.get(f"{scope}.bias")
        if bias is not None:
            b.add(f"{name}/bias", bias)

    def _set_layer_norm(self, b, name, variables, scope, rms=False):
        gamma = variables.get(f"{scope}.weight")
        if gamma is None:
            # Older custom LayerNorm modules (reference: opennmt_py.py:322-329).
            gamma = variables[f"{scope}.a_2"]
            b.add(f"{name}/gamma", gamma)
            b.add(f"{name}/beta", variables[f"{scope}.b_2"])
            return
        b.add(f"{name}/gamma", gamma)
        beta = variables.get(f"{scope}.bias")
        if beta is not None and not rms:
            b.add(f"{name}/beta", beta)

    def _set_attention(self, b, name, variables, scope, self_attention,
                       with_relative=False):
        if self_attention:
            qw = variables[f"{scope}.linear_query.weight"]
            kw = variables[f"{scope}.linear_keys.weight"]
            vw = variables[f"{scope}.linear_values.weight"]
            b.add(f"{name}/linear_0/weight",
                  np.concatenate([qw, kw, vw], axis=0))
            qb = variables.get(f"{scope}.linear_query.bias")
            if qb is not None:
                b.add(f"{name}/linear_0/bias", np.concatenate(
                    [qb, variables[f"{scope}.linear_keys.bias"],
                     variables[f"{scope}.linear_values.bias"]]))
            out_name = f"{name}/linear_1"
        else:
            self._set_linear(b, f"{name}/linear_0", variables,
                             f"{scope}.linear_query")
            kw = variables[f"{scope}.linear_keys.weight"]
            vw = variables[f"{scope}.linear_values.weight"]
            b.add(f"{name}/linear_1/weight", np.concatenate([kw, vw], axis=0))
            kb = variables.get(f"{scope}.linear_keys.bias")
            if kb is not None:
                b.add(f"{name}/linear_1/bias", np.concatenate(
                    [kb, variables[f"{scope}.linear_values.bias"]]))
            out_name = f"{name}/linear_2"
        self._set_linear(b, out_name, variables, f"{scope}.final_linear")
        if with_relative:
            rel = variables.get(f"{scope}.relative_positions_embeddings.weight")
            if rel is not None:
                b.add(f"{name}/relative_position_keys", rel)
                b.add(f"{name}/relative_position_values", rel)

    def _set_ffn(self, b, name, variables, scope, rms=False):
        self._set_layer_norm(b, f"{name}/layer_norm", variables,
                             f"{scope}.layer_norm", rms=rms)
        self._set_linear(b, f"{name}/linear_0", variables, f"{scope}.w_1")
        self._set_linear(b, f"{name}/linear_1", variables, f"{scope}.w_2")
        if f"{scope}.w_3.weight" in variables:
            self._set_linear(b, f"{name}/linear_0_noact", variables,
                             f"{scope}.w_3")

    def _set_projection(self, b, variables):
        if "generator.weight" in variables:
            self._set_linear(b, "decoder/projection", variables, "generator")
        else:
            self._set_linear(b, "decoder/projection", variables, "generator.0")

    # -- architectures -----------------------------------------------------

    def _convert_seq2seq(self, variables, *, opt, act_id, num_heads,
                         with_relative, num_source_embeddings):
        b = SpecBuilder("TransformerSpec", 7)
        feat_merge = opt("feat_merge", "concat")

        for side in ("encoder", "decoder"):
            b.add_attr(f"{side}/num_heads", num_heads, "int16")
            b.add_attr(f"{side}/pre_norm", 1, "int8")
            b.add_attr(f"{side}/activation", act_id, "int8")
        b.add_attr("encoder/embeddings_merge",
                   _MERGE_IDS.get(feat_merge, 0), "int8")

        position_encoding = opt("position_encoding", not with_relative)
        for side, module, lscope in (
                ("encoder", "encoder", "encoder.transformer"),
                ("decoder", "decoder", "decoder.transformer_layers")):
            n_emb = num_source_embeddings if side == "encoder" else 1
            for i in range(n_emb):
                name = (f"{side}/embeddings_{i}" if side == "encoder"
                        else f"{side}/embeddings")
                b.add(f"{name}/weight", variables[
                    f"{module}.embeddings.make_embedding.emb_luts.{i}.weight"])
            pe = variables.get(f"{module}.embeddings.make_embedding.pe.pe")
            if pe is not None:
                b.add(f"{side}/position_encodings/encodings", pe.squeeze())
            elif not position_encoding:
                b.add_attr(f"{side}/scale_embeddings", 0, "int8")
            self._set_layer_norm(b, f"{side}/layer_norm", variables,
                                 f"{module}.layer_norm")

            i = 0
            while f"{lscope}.{i}.feed_forward.w_1.weight" in variables:
                ls = f"{side}/layer_{i}"
                sscope = f"{lscope}.{i}"
                self._set_attention(
                    b, f"{ls}/self_attention", variables,
                    f"{sscope}.self_attn", True, with_relative=with_relative)
                ln_name = ("layer_norm" if side == "encoder" else "layer_norm_1")
                self._set_layer_norm(
                    b, f"{ls}/self_attention/layer_norm", variables,
                    f"{sscope}.{ln_name}")
                if side == "decoder":
                    self._set_attention(b, f"{ls}/attention", variables,
                                        f"{sscope}.context_attn", False)
                    self._set_layer_norm(b, f"{ls}/attention/layer_norm",
                                         variables, f"{sscope}.layer_norm_2")
                self._set_ffn(b, f"{ls}/ffn", variables,
                              f"{sscope}.feed_forward")
                i += 1

        self._set_projection(b, variables)

        lambda_align = opt("lambda_align", 0)
        if lambda_align:
            b.add_attr("decoder/alignment_layer",
                       int(opt("alignment_layer", -1)), "int32")
            b.add_attr("decoder/alignment_heads",
                       int(opt("alignment_heads", 1)), "int32")

        config = {"unk_token": "<unk>", "bos_token": "<s>",
                  "eos_token": "</s>",
                  "decoder_start_token": opt("decoder_start_token", "<s>")}
        return b, config

    def _convert_lm(self, variables, *, opt, act_id, num_heads,
                    with_relative, with_rotary, with_alibi):
        b = SpecBuilder("TransformerDecoderSpec", 8)
        sc = "decoder"
        rms = opt("layer_norm", "standard") == "rms"
        num_kv = opt("num_kv", 0)
        glu = opt("pos_ffn_activation_fn", "relu") == "silu"
        sliding_window = opt("sliding_window", 0)

        b.add_attr(f"{sc}/num_heads", num_heads, "int16")
        b.add_attr(f"{sc}/pre_norm", 1, "int8")
        b.add_attr(f"{sc}/activation", act_id, "int8")
        if with_alibi:
            b.add_attr(f"{sc}/alibi", 1, "int8")
        if sliding_window:
            b.add_attr(f"{sc}/sliding_window", int(sliding_window), "int32")

        module = "decoder"
        b.add(f"{sc}/embeddings/weight", variables[
            f"{module}.embeddings.make_embedding.emb_luts.0.weight"])
        pe = variables.get(f"{module}.embeddings.make_embedding.pe.pe")
        if pe is not None:
            b.add(f"{sc}/position_encodings/encodings", pe.squeeze())
        else:
            b.add_attr(f"{sc}/scale_embeddings", 0, "int8")
        self._set_layer_norm(b, f"{sc}/layer_norm", variables,
                             f"{module}.layer_norm", rms=rms)

        i = 0
        while f"{module}.transformer_layers.{i}.feed_forward.w_1.weight" \
                in variables:
            ls = f"{sc}/layer_{i}"
            sscope = f"{module}.transformer_layers.{i}"
            self._set_attention(b, f"{ls}/self_attention", variables,
                                f"{sscope}.self_attn", True,
                                with_relative=with_relative)
            self._set_layer_norm(b, f"{ls}/self_attention/layer_norm",
                                 variables, f"{sscope}.layer_norm_1", rms=rms)
            if with_rotary:
                asc = f"{ls}/self_attention"
                b.add_attr(f"{asc}/rotary_dim", 0, "int32")
                b.add_attr(f"{asc}/rotary_interleave",
                           1 if opt("rotary_interleave", True) else 0, "int8")
            if num_kv and num_kv != num_heads:
                b.add_attr(f"{ls}/self_attention/num_heads_kv",
                           int(num_kv), "int32")
            if sliding_window:
                b.add_attr(f"{ls}/self_attention/sliding_window",
                           int(sliding_window), "int32")
            self._set_ffn(b, f"{ls}/ffn", variables,
                          f"{sscope}.feed_forward", rms=rms)
            i += 1

        self._set_projection(b, variables)
        config = {"unk_token": "<unk>", "bos_token": "<s>",
                  "eos_token": "</s>",
                  "layer_norm_epsilon": float(opt("norm_eps", 1e-6))}
        return b, config
