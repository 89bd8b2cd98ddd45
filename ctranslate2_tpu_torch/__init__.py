"""ctranslate2_tpu_torch: the PyTorch and CUDA port of ctranslate2_tpu.

It reads the same CTranslate2 model directories and runs
``Translator.translate_batch`` / ``score_batch``,
``Generator.generate_batch`` / ``score_batch`` / ``forward_batch`` (argmax
or random sampling in both decode loops; attention, alignment, coverage,
prefix bias, vocabulary logits, alternatives, vocabulary maps, step
callbacks and static prompts through the host decode loops) and
``Encoder.forward_batch`` on
one NVIDIA Hopper card (or on the CPU when asked), with hand-written CUDA
kernels for the int8 matmul, the AWQ 4-bit matmuls, the beam reorder,
flash attention, decode attention over an int8 KV cache and the norms. It
imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .runtime.encoder import Encoder, EncoderForwardOutput
from .runtime.generator import Generator
from .runtime.translator import Translator
from .runtime.results import (AsyncResult, GenerationResult,
                              GenerationStepResult, ScoringResult,
                              TranslationResult)
from .models.loader import LoadedModel, load_model
from .kernels import launch_counts, reset_launches

__all__ = [
    "AsyncResult",
    "Encoder",
    "EncoderForwardOutput",
    "GenerationResult",
    "GenerationStepResult",
    "Generator",
    "LoadedModel",
    "ScoringResult",
    "Translator",
    "TranslationResult",
    "launch_counts",
    "load_model",
    "reset_launches",
]
