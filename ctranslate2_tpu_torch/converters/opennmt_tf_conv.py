"""OpenNMT-tf converter (reference:
python/ctranslate2/converters/opennmt_tf.py:1-455).

Converts a live, fully-built ``opennmt.models.Model`` (Transformer
encoder-decoder or LanguageModel) into the model.bin artifact this
runtime reads. The ``opennmt`` / ``tensorflow`` packages are imported
lazily — exactly like the reference, the converter only requires them
when actually used.

The port's copy of ``ctranslate2_tpu/converters/opennmt_tf_conv.py``: it writes the
same model directory, byte for byte, and imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Optional, Union

import numpy as np

from .builder import ACTIVATION_IDS, SpecBuilder

_SUPPORTED_ACTIVATIONS = {
    "gelu": "gelu_tanh",
    "relu": "relu",
    "swish": "swish",
}


class ConfigurationChecker:
    """Accumulates requirement failures (reference: converters/utils.py)."""

    def __init__(self):
        self._errors = []

    def __call__(self, condition: bool, message: str):
        if not condition:
            self._errors.append(message)

    def validate(self):
        if self._errors:
            raise ValueError("\n\n".join(self._errors))


def _get_inputters(inputter):
    import opennmt

    return (
        inputter.inputters
        if isinstance(inputter, opennmt.inputters.MultiInputter)
        else [inputter]
    )


def _load_vocab(vocab, unk_token="<unk>"):
    import opennmt

    if isinstance(vocab, opennmt.data.Vocab):
        tokens = list(vocab.words)
    elif isinstance(vocab, list):
        tokens = list(vocab)
    elif isinstance(vocab, str):
        tokens = opennmt.data.Vocab.from_file(vocab).words
    else:
        raise TypeError("Invalid vocabulary type")
    if unk_token not in tokens:
        tokens.append(unk_token)
    return tokens


class _TFSetters:
    """Writes OpenNMT-tf layer objects into SpecBuilder scopes."""

    def __init__(self, b: SpecBuilder):
        self.b = b

    def linear(self, scope, module):
        w = module.kernel.numpy()
        if not module.transpose:
            w = w.transpose()
        self.b.add(f"{scope}/weight", np.ascontiguousarray(w))
        if module.bias is not None:
            self.b.add(f"{scope}/bias", module.bias.numpy())

    def fused_linear(self, scope, modules):
        ws, bs = [], []
        for m in modules:
            w = m.kernel.numpy()
            if not m.transpose:
                w = w.transpose()
            ws.append(w)
            if m.bias is not None:
                bs.append(m.bias.numpy())
        self.b.add(f"{scope}/weight",
                   np.ascontiguousarray(np.concatenate(ws, axis=0)))
        if len(bs) == len(ws):
            self.b.add(f"{scope}/bias", np.concatenate(bs, axis=0))

    def layer_norm(self, scope, module):
        self.b.add(f"{scope}/gamma", module.gamma.numpy())
        self.b.add(f"{scope}/beta", module.beta.numpy())

    def norm_from_wrapper(self, scope, module):
        self.layer_norm(scope, module.output_layer_norm
                        if module.input_layer_norm is None
                        else module.input_layer_norm)

    def embeddings(self, scope, inputter):
        self.b.add(f"{scope}/weight", inputter.embedding.numpy())

    def position_encodings(self, scope, module):
        import opennmt

        if isinstance(module, opennmt.layers.PositionEmbedder):
            # Row 0 of the OpenNMT-tf table is the padding position
            # (reference: opennmt_tf.py:316-319).
            self.b.add(f"{scope}/encodings", module.embedding.numpy()[1:])

    def mha(self, scope, module, self_attention):
        layer = module.layer
        if self_attention:
            self.fused_linear(f"{scope}/linear_0", [
                layer.linear_queries, layer.linear_keys, layer.linear_values])
            if layer.maximum_relative_position is not None:
                self.b.add(f"{scope}/relative_position_keys",
                           layer.relative_position_keys.numpy())
                self.b.add(f"{scope}/relative_position_values",
                           layer.relative_position_values.numpy())
            self.linear(f"{scope}/linear_1", layer.linear_output)
        else:
            self.linear(f"{scope}/linear_0", layer.linear_queries)
            self.fused_linear(f"{scope}/linear_1",
                              [layer.linear_keys, layer.linear_values])
            self.linear(f"{scope}/linear_2", layer.linear_output)
        self.norm_from_wrapper(f"{scope}/layer_norm", module)

    def ffn(self, scope, module):
        self.linear(f"{scope}/linear_0", module.layer.inner)
        self.linear(f"{scope}/linear_1", module.layer.outer)
        self.norm_from_wrapper(f"{scope}/layer_norm", module)


class OpenNMTTFConverter:
    """Converts OpenNMT-tf models (reference: opennmt_tf.py:19-89)."""

    @classmethod
    def from_config(cls, config: Union[str, dict], auto_config: bool = False,
                    checkpoint_path: Optional[str] = None,
                    model: Optional[str] = None):
        from opennmt import config as config_util
        from opennmt.utils.checkpoint import Checkpoint

        if isinstance(config, str):
            config = config_util.load_config([config])
        else:
            config = copy.deepcopy(config)

        if model is None:
            model = config_util.load_model(config["model_dir"])
        elif os.path.exists(model):
            model = config_util.load_model_from_file(model)
        else:
            model = config_util.load_model_from_catalog(model)

        if auto_config:
            config_util.merge_config(config, model.auto_config())

        data_config = config_util.try_prefix_paths(
            config["model_dir"], config["data"])
        model.initialize(data_config)

        checkpoint = Checkpoint.from_config(config, model)
        checkpoint_path = checkpoint.restore(checkpoint_path=checkpoint_path)
        if checkpoint_path is None:
            raise RuntimeError("No checkpoint was restored")

        model.create_variables()
        return cls(model)

    def __init__(self, model):
        self._model = model

    def convert(self, output_dir: str, quantization: Optional[str] = None,
                force: bool = False) -> str:
        import json

        import opennmt

        if os.path.exists(os.path.join(output_dir, "model.bin")) and not force:
            raise RuntimeError(
                f"The output directory {output_dir} already exists "
                "(use force=True to override)")

        if isinstance(self._model, opennmt.models.LanguageModel):
            b, vocabs = self._build_decoder_only()
        else:
            b, vocabs = self._build_seq2seq()

        b.quantize(quantization)
        os.makedirs(output_dir, exist_ok=True)
        source_vocabs, target_vocab, config = vocabs
        b.save(output_dir, config=config)
        if source_vocabs is None:
            with open(os.path.join(output_dir, "vocabulary.json"), "w",
                      encoding="utf-8") as f:
                json.dump(target_vocab, f, ensure_ascii=False)
        else:
            for i, sv in enumerate(source_vocabs):
                name = ("source_vocabulary.json" if len(source_vocabs) == 1
                        else f"source_{i + 1}_vocabulary.json")
                with open(os.path.join(output_dir, name), "w",
                          encoding="utf-8") as f:
                    json.dump(sv, f, ensure_ascii=False)
            with open(os.path.join(output_dir, "target_vocabulary.json"),
                      "w", encoding="utf-8") as f:
                json.dump(target_vocab, f, ensure_ascii=False)
        return output_dir

    # ------------------------------------------------------------------

    def _check_seq2seq(self, model):
        import opennmt

        check = ConfigurationChecker()
        check(isinstance(model, opennmt.models.Transformer),
              "Only Transformer models are supported")
        check.validate()
        check(isinstance(model.encoder, opennmt.encoders.SelfAttentionEncoder),
              "Parallel encoders are not supported")
        check(isinstance(model.features_inputter,
                         (opennmt.inputters.WordEmbedder,
                          opennmt.inputters.ParallelInputter)),
              "Source inputter must be a WordEmbedder or a ParallelInputter")
        check.validate()

        mha = model.encoder.layers[0].self_attention.layer
        ffn = model.encoder.layers[0].ffn.layer
        with_relative_position = mha.maximum_relative_position is not None
        activation_name = ffn.inner.activation.__name__
        check(activation_name in _SUPPORTED_ACTIVATIONS,
              "Activation %s is not supported (supported activations are: %s)"
              % (activation_name, ", ".join(_SUPPORTED_ACTIVATIONS)))
        check(with_relative_position != bool(model.encoder.position_encoder),
              "Relative position representation and position encoding cannot "
              "be both enabled or both disabled")
        check(model.decoder.attention_reduction
              != opennmt.layers.MultiHeadAttentionReduction.AVERAGE_ALL_LAYERS,
              "Averaging all multi-head attention matrices is not supported")
        check.validate()
        return activation_name

    def _build_seq2seq(self):
        import opennmt

        model = self._model
        activation_name = self._check_seq2seq(model)

        source_inputters = _get_inputters(model.features_inputter)
        target_inputters = _get_inputters(model.labels_inputter)

        check = ConfigurationChecker()
        if len(source_inputters) > 1:
            reducer = model.features_inputter.reducer
            merge = None
            if isinstance(reducer, opennmt.layers.ConcatReducer):
                merge = 0
            elif isinstance(reducer, opennmt.layers.SumReducer):
                merge = 1
            check(all(isinstance(i, opennmt.inputters.WordEmbedder)
                      for i in source_inputters),
                  "All source inputters must WordEmbedders")
            check(merge is not None,
                  "Unsupported embeddings reducer %s" % reducer)
            check.validate()
        else:
            merge = 0

        alignment_heads = 1
        if (model.decoder.attention_reduction
                == opennmt.layers.MultiHeadAttentionReduction.AVERAGE_LAST_LAYER):
            alignment_heads = 0

        b = SpecBuilder("TransformerSpec", 7)
        s = _TFSetters(b)
        act_id = ACTIVATION_IDS[_SUPPORTED_ACTIVATIONS[activation_name]]

        enc, dec = model.encoder, model.decoder
        b.add_attr("encoder/num_heads",
                   enc.layers[0].self_attention.layer.num_heads, "int16")
        b.add_attr("encoder/pre_norm",
                   1 if enc.layer_norm is not None else 0, "int8")
        b.add_attr("encoder/activation", act_id, "int8")
        b.add_attr("encoder/embeddings_merge", merge, "int8")
        b.add_attr("decoder/num_heads",
                   dec.layers[0].self_attention.layer.num_heads, "int16")
        b.add_attr("decoder/pre_norm",
                   1 if dec.layer_norm is not None else 0, "int8")
        b.add_attr("decoder/activation", act_id, "int8")
        b.add_attr("decoder/alignment_layer", -1, "int16")
        b.add_attr("decoder/alignment_heads", alignment_heads, "int16")

        for i, inputter in enumerate(source_inputters):
            s.embeddings(f"encoder/embeddings_{i}", inputter)
        if enc.position_encoder is not None:
            s.position_encodings("encoder/position_encodings",
                                 enc.position_encoder)
        for i, layer in enumerate(enc.layers):
            ls = f"encoder/layer_{i}"
            s.mha(f"{ls}/self_attention", layer.self_attention,
                  self_attention=True)
            s.ffn(f"{ls}/ffn", layer.ffn)
        if enc.layer_norm is not None:
            s.layer_norm("encoder/layer_norm", enc.layer_norm)

        s.embeddings("decoder/embeddings", target_inputters[0])
        if dec.position_encoder is not None:
            s.position_encodings("decoder/position_encodings",
                                 dec.position_encoder)
        for i, layer in enumerate(dec.layers):
            ls = f"decoder/layer_{i}"
            s.mha(f"{ls}/self_attention", layer.self_attention,
                  self_attention=True)
            if layer.attention:
                s.mha(f"{ls}/attention", layer.attention[0],
                      self_attention=False)
            s.ffn(f"{ls}/ffn", layer.ffn)
        if dec.layer_norm is not None:
            s.layer_norm("decoder/layer_norm", dec.layer_norm)
        s.linear("decoder/projection", dec.output_layer)

        config = {
            "unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
            "add_source_bos": bool(source_inputters[0].mark_start),
            "add_source_eos": bool(source_inputters[0].mark_end),
        }
        source_vocabs = [
            _load_vocab(i.vocabulary_file) for i in source_inputters
        ]
        target_vocab = _load_vocab(target_inputters[0].vocabulary_file)
        return b, (source_vocabs, target_vocab, config)

    def _build_decoder_only(self):
        import opennmt

        model = self._model
        check = ConfigurationChecker()
        check(isinstance(model.decoder, opennmt.decoders.SelfAttentionDecoder),
              "Only self-attention decoders are supported")
        check.validate()

        mha = model.decoder.layers[0].self_attention.layer
        ffn = model.decoder.layers[0].ffn.layer
        activation_name = ffn.inner.activation.__name__
        check(activation_name in _SUPPORTED_ACTIVATIONS,
              "Activation %s is not supported (supported activations are: %s)"
              % (activation_name, ", ".join(_SUPPORTED_ACTIVATIONS)))
        check.validate()

        b = SpecBuilder("TransformerDecoderSpec", 8)
        s = _TFSetters(b)
        dec = model.decoder
        b.add_attr("decoder/num_heads", mha.num_heads, "int16")
        b.add_attr("decoder/pre_norm",
                   1 if dec.layer_norm is not None else 0, "int8")
        b.add_attr("decoder/activation",
                   ACTIVATION_IDS[_SUPPORTED_ACTIVATIONS[activation_name]],
                   "int8")

        s.embeddings("decoder/embeddings", model.features_inputter)
        if dec.position_encoder is not None:
            s.position_encodings("decoder/position_encodings",
                                 dec.position_encoder)
        for i, layer in enumerate(dec.layers):
            ls = f"decoder/layer_{i}"
            s.mha(f"{ls}/self_attention", layer.self_attention,
                  self_attention=True)
            s.ffn(f"{ls}/ffn", layer.ffn)
        if dec.layer_norm is not None:
            s.layer_norm("decoder/layer_norm", dec.layer_norm)
        s.linear("decoder/projection", dec.output_layer)

        vocab = _load_vocab(model.features_inputter.vocabulary_file)
        config = {"unk_token": "<unk>", "bos_token": "<s>",
                  "eos_token": "</s>"}
        return b, (None, vocab, config)


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--config", help="Path to the YAML configuration.")
    parser.add_argument("--auto_config", action="store_true",
                        help="Use the model automatic configuration values.")
    parser.add_argument("--model_path",
                        help="Checkpoint (directory) to load.")
    parser.add_argument("--model_type",
                        help="Model name in the catalog or path to the "
                             "model configuration.")
    parser.add_argument("--src_vocab",
                        help="Path to the source vocabulary.")
    parser.add_argument("--tgt_vocab",
                        help="Path to the target vocabulary.")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--quantization", default=None)
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args()

    config = args.config
    if not config:
        if not args.model_path or not args.src_vocab or not args.tgt_vocab:
            raise ValueError(
                "Options --model_path, --src_vocab, --tgt_vocab are required "
                "when a configuration is not set")
        model_dir = (args.model_path if os.path.isdir(args.model_path)
                     else os.path.dirname(args.model_path))
        config = {
            "model_dir": model_dir,
            "data": {
                "source_vocabulary": args.src_vocab,
                "target_vocabulary": args.tgt_vocab,
            },
        }

    converter = OpenNMTTFConverter.from_config(
        config, auto_config=args.auto_config,
        checkpoint_path=args.model_path, model=args.model_type)
    converter.convert(args.output_dir, quantization=args.quantization,
                      force=args.force)


if __name__ == "__main__":
    main()
