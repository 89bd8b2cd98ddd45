"""Eole checkpoint converter (reference:
python/ctranslate2/converters/eole_ct2.py:1-353).

Eole (the OpenNMT-py successor) stores state dicts with
``encoder.transformer_layers.N.self_attn.linear_query`` -style names.
``EoleConverter`` needs the ``eole`` package to load configs/vocabs
(lazy import, like the reference); the spec building itself runs from a
plain ``name -> array`` mapping and a config namespace, so it is
testable without eole installed (``build_from_state_dict``).

The port's copy of ``ctranslate2_tpu/converters/eole_conv.py``: it writes the
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
    "gated-silu": "swish",
}


def _var(variables, name):
    v = variables[name]
    if hasattr(v, "float"):
        v = v.float().numpy()
    return np.asarray(v, np.float32)


def _maybe(variables, name):
    try:
        return _var(variables, name)
    except KeyError:
        return None


class _Setters:
    def __init__(self, b: SpecBuilder, variables):
        self.b = b
        self.v = variables

    def linear(self, scope, name):
        self.b.add(f"{scope}/weight", _var(self.v, f"{name}.weight"))
        bias = _maybe(self.v, f"{name}.bias")
        if bias is not None:
            self.b.add(f"{scope}/bias", bias)

    def fused_linear(self, scope, names):
        ws = [_var(self.v, f"{n}.weight") for n in names]
        self.b.add(f"{scope}/weight", np.concatenate(ws, axis=0))
        bs = [_maybe(self.v, f"{n}.bias") for n in names]
        if all(b is not None for b in bs):
            self.b.add(f"{scope}/bias", np.concatenate(bs, axis=0))

    def layer_norm(self, scope, name, rms=False):
        gamma = _maybe(self.v, f"{name}.weight")
        if gamma is None:
            # Older custom LayerNorm modules (a_2/b_2).
            self.b.add(f"{scope}/gamma", _var(self.v, f"{name}.a_2"))
            self.b.add(f"{scope}/beta", _var(self.v, f"{name}.b_2"))
            return
        self.b.add(f"{scope}/gamma", gamma)
        beta = _maybe(self.v, f"{name}.bias")
        if beta is not None and not rms:
            self.b.add(f"{scope}/beta", beta)

    def embeddings(self, scope, name):
        self.b.add(f"{scope}/weight", _var(self.v, f"{name}.weight"))

    def position_encodings(self, scope, name):
        pe = _maybe(self.v, f"{name}.pe")
        if pe is not None:
            self.b.add(f"{scope}/encodings", np.squeeze(pe))

    def attention(self, scope, name, self_attention, relative=False):
        if self_attention:
            self.fused_linear(f"{scope}/linear_0", [
                f"{name}.linear_query", f"{name}.linear_keys",
                f"{name}.linear_values"])
            self.linear(f"{scope}/linear_1", f"{name}.final_linear")
            if relative:
                rel = _var(self.v,
                           f"{name}.relative_positions_embeddings.weight")
                self.b.add(f"{scope}/relative_position_keys", rel)
                self.b.add(f"{scope}/relative_position_values", rel)
        else:
            self.linear(f"{scope}/linear_0", f"{name}.linear_query")
            self.fused_linear(f"{scope}/linear_1", [
                f"{name}.linear_keys", f"{name}.linear_values"])
            self.linear(f"{scope}/linear_2", f"{name}.final_linear")

    def ffn(self, scope, name, glu=False):
        if glu:
            self.linear(f"{scope}/linear_0", f"{name}.gate_up_proj")
            self.linear(f"{scope}/linear_0_noact", f"{name}.up_proj")
        else:
            self.linear(f"{scope}/linear_0", f"{name}.gate_up_proj")
        self.linear(f"{scope}/linear_1", f"{name}.down_proj")


def _cfg(obj, name, default=None):
    return getattr(obj, name, default)


def build_from_state_dict(config, variables, *, decoder_only: bool):
    """Build a SpecBuilder from an eole config namespace + state dict.

    ``config`` mirrors ``PredictConfig.model``: attributes ``decoder``
    (``layers``, ``heads``, ``heads_kv``), optional ``encoder.layers``,
    ``embeddings.position_encoding_type``, ``mlp_activation_fn``,
    ``layer_norm`` ('rms'/'standard'), ``sliding_window``,
    ``rope_config.rotary_interleave``.
    """
    pe_type = _cfg(_cfg(config, "embeddings", None),
                   "position_encoding_type", None)
    pe_name = getattr(pe_type, "name", None) or str(pe_type or "")
    with_relative = pe_name.lower().endswith("relative")
    with_rotary = pe_name.lower().endswith("rotary")
    with_alibi = pe_name.lower().endswith("alibi")
    activation_fn = _cfg(config, "mlp_activation_fn", "relu")
    if activation_fn not in _SUPPORTED_ACTIVATIONS:
        raise ValueError(f"Activation {activation_fn} is not supported")
    act_id = ACTIVATION_IDS[_SUPPORTED_ACTIVATIONS[activation_fn]]
    glu = activation_fn == "gated-silu"
    rms = _cfg(config, "layer_norm", "standard") == "rms"
    num_heads = _cfg(config.decoder, "heads", 8)
    num_kv = _cfg(config.decoder, "heads_kv", 0) or 0
    if num_kv == num_heads:
        num_kv = 0
    sliding_window = int(_cfg(config, "sliding_window", 0) or 0)

    if not decoder_only:
        if with_rotary:
            raise ValueError(
                "Rotary embeddings are not supported yet for encoder/decoder "
                "models")
        if with_alibi:
            raise ValueError(
                "Alibi is not supported yet for encoder/decoder models")
        if sliding_window:
            raise ValueError(
                "Sliding window is not suported yet for encoder/decoder "
                "models")

    b = SpecBuilder(
        "TransformerDecoderSpec" if decoder_only else "TransformerSpec",
        8 if decoder_only else 7)
    s = _Setters(b, variables)

    def side(sc, prefix_emb, module, num_layers):
        b.add_attr(f"{sc}/num_heads", num_heads, "int16")
        b.add_attr(f"{sc}/pre_norm", 1, "int8")
        b.add_attr(f"{sc}/activation", act_id, "int8")
        if f"{prefix_emb}.pe.pe" in variables:
            s.position_encodings(f"{sc}/position_encodings",
                                 f"{prefix_emb}.pe")
        else:
            b.add_attr(f"{sc}/scale_embeddings", 0, "int8")
        emb_scope = (f"{sc}/embeddings_0" if sc == "encoder"
                     else f"{sc}/embeddings")
        s.embeddings(emb_scope, f"{prefix_emb}.embeddings")
        s.layer_norm(f"{sc}/layer_norm", f"{module}.layer_norm", rms=rms)
        for i in range(num_layers):
            ls = f"{sc}/layer_{i}"
            name = f"{module}.transformer_layers.{i}"
            asc = f"{ls}/self_attention"
            s.attention(asc, f"{name}.self_attn", self_attention=True,
                        relative=with_relative)
            s.layer_norm(f"{asc}/layer_norm", f"{name}.input_layernorm",
                         rms=rms)
            if sc == "decoder" and not decoder_only:
                csc = f"{ls}/attention"
                s.attention(csc, f"{name}.context_attn", self_attention=False)
                s.layer_norm(f"{csc}/layer_norm",
                             f"{name}.precontext_layernorm", rms=rms)
            s.ffn(f"{ls}/ffn", f"{name}.mlp", glu=glu)
            s.layer_norm(f"{ls}/ffn/layer_norm",
                         f"{name}.post_attention_layernorm", rms=rms)
            if num_kv:
                b.add_attr(f"{asc}/num_heads_kv", num_kv, "int32")
            if sc == "decoder":
                if with_rotary:
                    b.add_attr(f"{asc}/rotary_dim", 0, "int32")
                    interleave = _cfg(_cfg(config, "rope_config", None),
                                      "rotary_interleave", True)
                    b.add_attr(f"{asc}/rotary_interleave",
                               1 if interleave else 0, "int8")
                if sliding_window:
                    b.add_attr(f"{asc}/sliding_window", sliding_window,
                               "int32")
        if with_alibi and sc == "decoder":
            b.add_attr(f"{sc}/alibi", 1, "int8")

    if not decoder_only:
        side("encoder", "src_emb", "encoder", config.encoder.layers)
        b.add_attr("encoder/embeddings_merge", 0, "int8")
        lambda_align = _cfg(config.decoder, "lambda_align", 0)
        if lambda_align:
            b.add_attr("decoder/alignment_layer",
                       int(config.decoder.alignment_layer), "int16")
            b.add_attr("decoder/alignment_heads",
                       int(config.decoder.alignment_heads), "int16")
        else:
            b.add_attr("decoder/alignment_layer", -1, "int16")
            b.add_attr("decoder/alignment_heads", 1, "int16")
    side("decoder", "tgt_emb", "decoder", config.decoder.layers)
    s.linear("decoder/projection", "generator")
    return b


class EoleConverter:
    """Converts eole checkpoints (reference: eole_ct2.py:151-196)."""

    def __init__(self, model_path: str):
        self._model_path = model_path

    def convert(self, output_dir: str, quantization: Optional[str] = None,
                force: bool = False) -> str:
        import json

        from eole.config.run import PredictConfig
        from eole.inputters.inputter import vocabs_to_dict
        from eole.models.model import get_model_class

        if os.path.exists(os.path.join(output_dir, "model.bin")) and not force:
            raise RuntimeError(
                f"The output directory {output_dir} already exists "
                "(use force=True to override)")

        config = PredictConfig(model_path=self._model_path, src="dummy")
        model_class = get_model_class(config.model)
        model, vocabs, model_config = model_class.for_inference(config)
        vocabs_dict = vocabs_to_dict(vocabs)
        config.model = model_config

        decoder_only = (
            config.model.decoder.decoder_type == "transformer_lm")
        b = build_from_state_dict(config.model, model.state_dict(),
                                  decoder_only=decoder_only)

        model_cfg = {
            "bos_token": vocabs_dict["specials"]["bos_token"],
            "eos_token": vocabs_dict["specials"]["eos_token"],
            "unk_token": vocabs_dict["specials"]["unk_token"],
            "layer_norm_epsilon": float(getattr(config, "norm_eps", 1e-6)),
        }
        if not decoder_only:
            model_cfg["decoder_start_token"] = vocabs_dict[
                "decoder_start_token"]

        b.quantize(quantization)
        os.makedirs(output_dir, exist_ok=True)
        b.save(output_dir, config=model_cfg)
        src_vocab = vocabs_dict["src"]
        tgt_vocab = vocabs_dict["tgt"]
        if decoder_only:
            with open(os.path.join(output_dir, "vocabulary.json"), "w",
                      encoding="utf-8") as f:
                json.dump(tgt_vocab, f, ensure_ascii=False)
        else:
            with open(os.path.join(output_dir, "source_vocabulary.json"),
                      "w", encoding="utf-8") as f:
                json.dump(src_vocab, f, ensure_ascii=False)
            with open(os.path.join(output_dir, "target_vocabulary.json"),
                      "w", encoding="utf-8") as f:
                json.dump(tgt_vocab, f, ensure_ascii=False)
        return output_dir


def main():
    import argparse

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--model_path", required=True, help="Model path.")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--quantization", default=None)
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args()
    EoleConverter(args.model_path).convert(
        args.output_dir, quantization=args.quantization, force=args.force)


if __name__ == "__main__":
    main()
