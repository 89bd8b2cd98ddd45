"""``ct2tpu-torch-transformers-converter``: HF checkpoint -> model directory
(parity with the reference console script ``ct2-transformers-converter``,
reference: python/setup.py:110-118, converters/transformers.py CLI), and
the Marian, OPUS-MT, OpenNMT-py and Fairseq console scripts.

The port's copy of ``ctranslate2_tpu/cli/convert.py``: the same options
and output, through the port's converters, with no JAX installed. The
eole and OpenNMT-tf scripts are the ``main`` of their converter modules."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "ct2tpu-torch-transformers-converter",
        description="Convert a Hugging Face Transformers checkpoint")
    p.add_argument("--model", required=True,
                   help="Local path of the model to convert")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--quantization", default=None,
                   choices=[None, "int8", "int8_float32", "int8_float16",
                            "int8_bfloat16", "int16", "float16", "bfloat16"])
    p.add_argument("--force", action="store_true")
    p.add_argument("--trust_remote_code", action="store_true")
    p.add_argument("--activation_scales", default=None,
                   help="Path to pre-computed SmoothQuant activation "
                        "scales (torch.load-able)")
    p.add_argument("--copy_files", nargs="+", default=None,
                   help="Filenames to copy from the model directory to "
                        "the converted directory")
    args = p.parse_args(argv)

    from ..converters.transformers_conv import TransformersConverter

    converter = TransformersConverter(
        args.model, trust_remote_code=args.trust_remote_code,
        activation_scales=args.activation_scales,
        copy_files=args.copy_files)
    out = converter.convert(args.output_dir, quantization=args.quantization,
                            force=args.force)
    print(out)
    return 0



def marian_main(argv=None) -> int:
    """``ct2tpu-torch-marian-converter`` (reference: converters/marian.py CLI)."""
    p = argparse.ArgumentParser("ct2tpu-torch-marian-converter")
    p.add_argument("--model_path", required=True,
                   help="Path to the model .npz file.")
    p.add_argument("--vocab_paths", required=True, nargs="+",
                   help="List of paths to the YAML vocabularies.")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--quantization", default=None)
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    from ..converters.marian_conv import MarianConverter

    print(MarianConverter(args.model_path, args.vocab_paths).convert(
        args.output_dir, quantization=args.quantization, force=args.force))
    return 0


def opus_mt_main(argv=None) -> int:
    """``ct2tpu-torch-opus-mt-converter`` (reference: converters/opus_mt.py CLI)."""
    p = argparse.ArgumentParser("ct2tpu-torch-opus-mt-converter")
    p.add_argument("--model_dir", required=True,
                   help="Path to the OPUS-MT model directory.")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--quantization", default=None)
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    from ..converters.marian_conv import OpusMTConverter

    print(OpusMTConverter(args.model_dir).convert(
        args.output_dir, quantization=args.quantization, force=args.force))
    return 0


def opennmt_py_main(argv=None) -> int:
    """``ct2tpu-torch-opennmt-py-converter``
    (reference: converters/opennmt_py.py CLI)."""
    p = argparse.ArgumentParser("ct2tpu-torch-opennmt-py-converter")
    p.add_argument("--model_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--quantization", default=None)
    p.add_argument("--force", action="store_true")
    p.add_argument("--unsafe_deserialization", action="store_true")
    args = p.parse_args(argv)
    from ..converters.opennmt_py_conv import OpenNMTPyConverter

    print(OpenNMTPyConverter(
        args.model_path,
        unsafe_deserialization=args.unsafe_deserialization).convert(
        args.output_dir, quantization=args.quantization, force=args.force))
    return 0


def fairseq_main(argv=None) -> int:
    """``ct2tpu-torch-fairseq-converter`` (reference: converters/fairseq.py CLI)."""
    p = argparse.ArgumentParser("ct2tpu-torch-fairseq-converter")
    p.add_argument("--model_path", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--source_lang")
    p.add_argument("--target_lang")
    p.add_argument("--fixed_dictionary")
    p.add_argument("--no_default_special_tokens", action="store_true")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--quantization", default=None)
    p.add_argument("--force", action="store_true")
    p.add_argument("--unsafe_deserialization", action="store_true")
    args = p.parse_args(argv)
    from ..converters.fairseq_conv import FairseqConverter

    print(FairseqConverter(
        args.model_path, args.data_dir,
        source_lang=args.source_lang, target_lang=args.target_lang,
        fixed_dictionary=args.fixed_dictionary,
        no_default_special_tokens=args.no_default_special_tokens,
        unsafe_deserialization=args.unsafe_deserialization).convert(
        args.output_dir, quantization=args.quantization, force=args.force))
    return 0


if __name__ == "__main__":
    sys.exit(main())
