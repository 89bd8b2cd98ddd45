"""Marian (.npz) and OPUS-MT converters.

Capability parity with the reference converters
(reference: python/ctranslate2/converters/marian.py,
python/ctranslate2/converters/opus_mt.py): reads a Marian ``model.npz``
(weights + embedded ``special:model.yml`` config) and YAML vocabularies,
producing a CT2-format model directory readable by this runtime.

The port's copy of ``ctranslate2_tpu/converters/marian_conv.py``: it writes the
same model directory, byte for byte, and imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

import numpy as np

from .builder import ACTIVATION_IDS, SpecBuilder

_SUPPORTED_ACTIVATIONS = {
    "gelu": "gelu_sigmoid",
    "relu": "relu",
    "swish": "swish",
}

_SUPPORTED_POSTPROCESS_EMB = {"", "d", "n", "nd"}


def _get_model_config(model) -> dict:
    import yaml

    config = model["special:model.yml"]
    config = config[:-1].tobytes()
    return yaml.safe_load(config)


def load_vocab(path: str) -> List[str]:
    """Parse a Marian YAML vocabulary (reference: marian.py:119-161 — pyyaml
    skips some entries so the file is parsed manually)."""
    with open(path, encoding="utf-8") as vocab:
        tokens = []
        token = None
        idx = None
        for i, line in enumerate(vocab):
            line = line.rstrip("\n\r")
            if not line:
                continue
            if line.startswith("? "):  # complex key mapping (key)
                token = line[2:]
            elif token is not None:  # complex key mapping (value)
                idx = line[2:]
            else:
                token, idx = line.rsplit(":", 1)

            if token is not None:
                if token.startswith('"') and token.endswith('"'):
                    token = re.sub(r"\\([^x])", r"\1", token)
                    token = token[1:-1]
                    if token.startswith("\\x"):
                        token = chr(int(token[2:], base=16))
                elif token.startswith("'") and token.endswith("'"):
                    token = token[1:-1].replace("''", "'")

            if idx is not None:
                try:
                    idx = int(idx.strip())
                except ValueError as e:
                    raise ValueError(
                        "Unexpected format at line %d: '%s'" % (i + 1, line)
                    ) from e
                tokens.append((idx, token))
                token = None
                idx = None

    return [token for _, token in sorted(tokens, key=lambda item: item[0])]


def _sinusoidal_table(dim: int, num_positions: int = 2048) -> np.ndarray:
    """Marian's sinusoidal layout: [sin block | cos block]
    (reference: marian.py:283-291)."""
    positions = np.arange(num_positions)
    timescales = np.power(10000, 2 * (np.arange(dim) // 2) / dim)
    enc = np.expand_dims(positions, 1) / np.expand_dims(timescales, 0)
    table = np.zeros_like(enc)
    table[:, : dim // 2] = np.sin(enc[:, 0::2])
    table[:, dim // 2:] = np.cos(enc[:, 1::2])
    return table.astype(np.float32)


class MarianConverter:
    """Converts models trained with Marian (reference: marian.py:22-110)."""

    def __init__(self, model_path: str, vocab_paths: List[str]):
        self._model_path = model_path
        self._vocab_paths = vocab_paths

    def convert(self, output_dir: str, quantization: Optional[str] = None,
                force: bool = False) -> str:
        if os.path.exists(os.path.join(output_dir, "model.bin")) and not force:
            raise RuntimeError(
                f"The output directory {output_dir} already exists "
                "(use force=True to override)")

        weights = np.load(self._model_path)
        config = _get_model_config(weights)
        vocabs = list(map(load_vocab, self._vocab_paths))

        activation = config["transformer-ffn-activation"]
        pre_norm = "n" in config["transformer-preprocess"]
        postprocess_emb = config["transformer-postprocess-emb"]

        if config["type"] != "transformer":
            raise ValueError("Option --type must be 'transformer'")
        if config.get("transformer-decoder-autoreg", "self-attention") \
                != "self-attention":
            raise ValueError(
                "Option --transformer-decoder-autoreg must be 'self-attention'")
        if config.get("transformer-no-projection"):
            raise ValueError("Option --transformer-no-projection is not supported")
        if activation not in _SUPPORTED_ACTIVATIONS:
            raise ValueError(
                f"Option --transformer-ffn-activation {activation} is not supported")
        if postprocess_emb not in _SUPPORTED_POSTPROCESS_EMB:
            raise ValueError(
                f"Option --transformer-postprocess-emb {postprocess_emb} "
                "is not supported")

        alignment_layer = config.get("transformer-guided-alignment-layer", "last")
        alignment_layer = (-1 if alignment_layer == "last"
                           else int(alignment_layer) - 1)
        layernorm_embedding = "n" in postprocess_emb

        b = SpecBuilder("TransformerSpec", 7)
        num_heads = config["transformer-heads"]
        act_id = ACTIVATION_IDS[_SUPPORTED_ACTIVATIONS[activation]]

        for side, depth_key in (("encoder", "enc-depth"),
                                ("decoder", "dec-depth")):
            sc = side
            b.add_attr(f"{sc}/num_heads", num_heads, "int16")
            b.add_attr(f"{sc}/pre_norm", 1 if pre_norm else 0, "int8")
            b.add_attr(f"{sc}/activation", act_id, "int8")
            b.add_attr(f"{sc}/scale_embeddings", 1, "int8")

            emb = weights.get(f"{sc}_Wemb")
            if emb is None:
                emb = weights["Wemb"]
            name = (f"{sc}/embeddings_0/weight" if side == "encoder"
                    else f"{sc}/embeddings/weight")
            b.add(name, np.asarray(emb, np.float32))
            dim = emb.shape[1]
            b.add(f"{sc}/position_encodings/encodings",
                  np.asarray(weights.get("Wpos", _sinusoidal_table(dim)),
                             np.float32))
            if layernorm_embedding:
                b.add(f"{sc}/layernorm_embedding/gamma",
                      weights[f"{sc}_emb_ln_scale_pre"].squeeze())
                b.add(f"{sc}/layernorm_embedding/beta",
                      weights[f"{sc}_emb_ln_bias_pre"].squeeze())
            if pre_norm:
                b.add(f"{sc}/layer_norm/gamma",
                      weights[f"{sc}_top_ln_scale"].squeeze())
                b.add(f"{sc}/layer_norm/beta",
                      weights[f"{sc}_top_ln_bias"].squeeze())

            def set_linear(name, scope, suffix="", reuse=None):
                w = weights.get(f"{scope}_W{suffix}")
                if w is None:
                    w = weights.get(f"{scope}_Wt{suffix}")
                    if w is None:
                        w = reuse
                else:
                    w = np.asarray(w).T
                b.add(f"{name}/weight", np.ascontiguousarray(
                    np.asarray(w, np.float32)))
                bias = weights.get(f"{scope}_b{suffix}")
                if bias is not None:
                    b.add(f"{name}/bias",
                          np.asarray(bias, np.float32).squeeze().reshape(-1))

            def set_ln(name, scope):
                # Pre-norm weights carry the "_pre" suffix
                # (reference: marian.py:252-258).
                for suffix in ("_pre", ""):
                    g = weights.get(f"{scope}_ln_scale{suffix}")
                    if g is not None:
                        b.add(f"{name}/gamma", np.asarray(g, np.float32).squeeze())
                        b.add(f"{name}/beta", np.asarray(
                            weights[f"{scope}_ln_bias{suffix}"],
                            np.float32).squeeze())
                        return

            def set_attention(ls, scope, self_attention):
                qw = np.asarray(weights[f"{scope}_Wq"], np.float32).T
                kw = np.asarray(weights[f"{scope}_Wk"], np.float32).T
                vw = np.asarray(weights[f"{scope}_Wv"], np.float32).T
                qb = np.asarray(weights[f"{scope}_bq"], np.float32).squeeze().reshape(-1)
                kb = np.asarray(weights[f"{scope}_bk"], np.float32).squeeze().reshape(-1)
                vb = np.asarray(weights[f"{scope}_bv"], np.float32).squeeze().reshape(-1)
                if self_attention:
                    b.add(f"{ls}/linear_0/weight",
                          np.concatenate([qw, kw, vw], axis=0))
                    b.add(f"{ls}/linear_0/bias", np.concatenate([qb, kb, vb]))
                else:
                    b.add(f"{ls}/linear_0/weight", qw)
                    b.add(f"{ls}/linear_0/bias", qb)
                    b.add(f"{ls}/linear_1/weight",
                          np.concatenate([kw, vw], axis=0))
                    b.add(f"{ls}/linear_1/bias", np.concatenate([kb, vb]))
                out_idx = 1 if self_attention else 2
                set_linear(f"{ls}/linear_{out_idx}", scope, "o")
                set_ln(f"{ls}/layer_norm", f"{scope}_Wo")

            for i in range(config[depth_key]):
                ms = f"{sc}_l{i + 1}"
                ls = f"{sc}/layer_{i}"
                set_attention(f"{ls}/self_attention", f"{ms}_self", True)
                if side == "decoder":
                    set_attention(f"{ls}/attention", f"{ms}_context", False)
                set_ln(f"{ls}/ffn/layer_norm", f"{ms}_ffn_ffn")
                set_linear(f"{ls}/ffn/linear_0", f"{ms}_ffn", "1")
                set_linear(f"{ls}/ffn/linear_1", f"{ms}_ffn", "2")

        b.add_attr("encoder/embeddings_merge", 0, "int8")
        b.add_attr("decoder/start_from_zero_embedding", 1, "int8")
        b.add_attr("decoder/alignment_layer", alignment_layer, "int32")
        b.add_attr("decoder/alignment_heads", 1, "int32")

        # Logits projection, possibly tied to the target embeddings
        # (reference: marian.py:180-186).
        w = weights.get("decoder_ff_logit_out_W")
        if w is not None:
            w = np.asarray(w, np.float32).T
        else:
            w = weights.get("decoder_ff_logit_out_Wt")
            if w is None:
                emb = weights.get("decoder_Wemb")
                w = np.asarray(emb if emb is not None else weights["Wemb"],
                               np.float32)
        b.add("decoder/projection/weight", np.ascontiguousarray(w))
        bias = weights.get("decoder_ff_logit_out_b")
        if bias is not None:
            b.add("decoder/projection/bias",
                  np.asarray(bias, np.float32).squeeze().reshape(-1))

        b.quantize(quantization)
        os.makedirs(output_dir, exist_ok=True)
        b.save(output_dir,
               config={"unk_token": "<unk>", "bos_token": "<s>",
                       "eos_token": "</s>", "add_source_eos": True,
                       "decoder_start_token": "</s>"},
               source_vocabulary=vocabs[0],
               target_vocabulary=vocabs[-1])
        return output_dir


class OpusMTConverter(MarianConverter):
    """Converts OPUS-MT model directories (reference: opus_mt.py:8-31)."""

    def __init__(self, model_dir: str):
        import glob

        npz = glob.glob(os.path.join(model_dir, "*.npz"))
        if not npz:
            raise RuntimeError(f"No .npz file found in {model_dir}")
        with open(os.path.join(model_dir, "decoder.yml"), encoding="utf-8") as f:
            import yaml

            decoder_config = yaml.safe_load(f)
        vocabs = decoder_config["vocabs"]
        super().__init__(
            npz[0], [os.path.join(model_dir, v) for v in vocabs])
