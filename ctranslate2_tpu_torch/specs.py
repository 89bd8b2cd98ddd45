"""Converter-side spec layer (reference: python/ctranslate2/specs/).

The reference builds models through ``LayerSpec`` object trees; this
package, as ``ctranslate2_tpu``, uses a scope-path :class:`SpecBuilder`
plus small builder functions (``converters/builder.py``). This module
gives that surface the reference's import path (``ctranslate2.specs``-
style), with the names of ``ctranslate2_tpu.specs``.
"""

from .converters.builder import (
    ACTIVATION_IDS,
    SpecBuilder,
    build_decoder_only_model,
    build_seq2seq_model,
    build_whisper_model,
)
from .formats.model_file import (
    CURRENT_BINARY_VERSION,
    SKIP_CREATING_ALIAS,
    ModelFile,
    Variable,
    make_variable,
)
from .models.spec import (
    ArchSpec,
    AttentionSpec,
    DecoderLayerSpec,
    DecoderSpec,
    EmbeddingsSpec,
    EncoderLayerSpec,
    EncoderSpec,
    FFNSpec,
    RotarySpec,
    extract_arch,
)

__all__ = [
    "ACTIVATION_IDS",
    "ArchSpec",
    "AttentionSpec",
    "CURRENT_BINARY_VERSION",
    "DecoderLayerSpec",
    "DecoderSpec",
    "EmbeddingsSpec",
    "EncoderLayerSpec",
    "EncoderSpec",
    "FFNSpec",
    "ModelFile",
    "RotarySpec",
    "SKIP_CREATING_ALIAS",
    "SpecBuilder",
    "Variable",
    "build_decoder_only_model",
    "build_seq2seq_model",
    "build_whisper_model",
    "extract_arch",
    "make_variable",
]
