"""OpenAI GPT-2 (TensorFlow checkpoint) converter.

Capability parity with the reference converter
(reference: python/ctranslate2/converters/openai_gpt2.py): reads the
name-based TF checkpoint + ``hparams.json`` + ``encoder.json`` released at
github.com/openai/gpt-2.

The port's copy of ``ctranslate2_tpu/converters/openai_gpt2_conv.py``: it writes the
same model directory, byte for byte, and imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .builder import ACTIVATION_IDS, SpecBuilder


class OpenAIGPT2Converter:
    """Converts GPT-2 models from https://github.com/openai/gpt-2
    (reference: openai_gpt2.py:9-49)."""

    def __init__(self, model_dir: str):
        self._model_dir = model_dir

    def convert(self, output_dir: str, quantization: Optional[str] = None,
                force: bool = False) -> str:
        import tensorflow as tf

        if os.path.exists(os.path.join(output_dir, "model.bin")) and not force:
            raise RuntimeError(
                f"The output directory {output_dir} already exists "
                "(use force=True to override)")

        reader = tf.train.load_checkpoint(self._model_dir)
        weights = {
            name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map().keys()
        }

        with open(os.path.join(self._model_dir, "hparams.json")) as f:
            hparams = json.load(f)
        with open(os.path.join(self._model_dir, "encoder.json")) as f:
            vocab_map = json.load(f)
        vocab = [tok for tok, _ in sorted(vocab_map.items(),
                                          key=lambda item: item[1])]

        b = SpecBuilder("TransformerDecoderSpec", 8)
        sc = "decoder"
        b.add_attr(f"{sc}/num_heads", hparams["n_head"], "int16")
        b.add_attr(f"{sc}/pre_norm", 1, "int8")
        b.add_attr(f"{sc}/activation", ACTIVATION_IDS["gelu_tanh"], "int8")
        b.add_attr(f"{sc}/scale_embeddings", 0, "int8")

        def norm(name, scope):
            b.add(f"{name}/gamma", np.asarray(weights[f"{scope}/g"],
                                              np.float32))
            b.add(f"{name}/beta", np.asarray(weights[f"{scope}/b"],
                                             np.float32))

        def lin(name, scope):
            # OpenAI conv1d weights are [1, in, out]
            # (reference: openai_gpt2.py:67-69).
            w = np.asarray(weights[f"{scope}/w"], np.float32)
            b.add(f"{name}/weight",
                  np.ascontiguousarray(w.squeeze().T))
            b.add(f"{name}/bias", np.asarray(weights[f"{scope}/b"],
                                             np.float32))

        wte = np.asarray(weights["model/wte"], np.float32)
        b.add(f"{sc}/embeddings/weight", wte)
        b.add(f"{sc}/position_encodings/encodings",
              np.asarray(weights["model/wpe"], np.float32))
        b.add(f"{sc}/projection/weight", wte)  # tied
        norm(f"{sc}/layer_norm", "model/ln_f")

        for i in range(hparams["n_layer"]):
            ls = f"{sc}/layer_{i}"
            ms = f"model/h{i}"
            norm(f"{ls}/self_attention/layer_norm", f"{ms}/ln_1")
            lin(f"{ls}/self_attention/linear_0", f"{ms}/attn/c_attn")
            lin(f"{ls}/self_attention/linear_1", f"{ms}/attn/c_proj")
            norm(f"{ls}/ffn/layer_norm", f"{ms}/ln_2")
            lin(f"{ls}/ffn/linear_0", f"{ms}/mlp/c_fc")
            lin(f"{ls}/ffn/linear_1", f"{ms}/mlp/c_proj")

        b.quantize(quantization)
        os.makedirs(output_dir, exist_ok=True)
        b.save(output_dir,
               config={"unk_token": "<|endoftext|>",
                       "bos_token": "<|endoftext|>",
                       "eos_token": "<|endoftext|>"},
               vocabulary=vocab)
        return output_dir
