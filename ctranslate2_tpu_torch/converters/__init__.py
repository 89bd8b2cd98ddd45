"""Converters producing CT2-format model directories.

The port's copy of ``ctranslate2_tpu/converters/`` (the reference
converter registry, python/ctranslate2/converters/__init__.py):
Transformers, Marian / OPUS-MT, OpenNMT-py, Fairseq, eole, OpenNMT-tf and
OpenAI GPT-2. Each writes the same model directory as the JAX package's,
byte for byte, without JAX; torch, transformers, tensorflow, opennmt and
eole are imported only where a converter needs them.
"""

from .transformers_conv import TransformersConverter
from .marian_conv import MarianConverter, OpusMTConverter
from .opennmt_py_conv import OpenNMTPyConverter
from .fairseq_conv import FairseqConverter

try:  # TensorFlow is optional
    from .openai_gpt2_conv import OpenAIGPT2Converter
except ImportError:  # pragma: no cover
    OpenAIGPT2Converter = None
