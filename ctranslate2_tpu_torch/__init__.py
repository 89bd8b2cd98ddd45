"""ctranslate2_tpu_torch: the PyTorch and CUDA port of ctranslate2_tpu.

It reads the same CTranslate2 model directories and runs
``Translator.translate_batch`` and ``Generator.generate_batch`` on one
NVIDIA Hopper card (or on the CPU when asked), with hand-written CUDA
kernels for the int8 matmul, the AWQ 4-bit matmuls, the beam reorder,
flash-attention prefill, decode attention over an int8 KV cache and the
norms. It imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .runtime.generator import Generator
from .runtime.translator import Translator
from .runtime.results import AsyncResult, GenerationResult, TranslationResult
from .models.loader import LoadedModel, load_model
from .kernels import launch_counts, reset_launches

__all__ = [
    "AsyncResult",
    "GenerationResult",
    "Generator",
    "LoadedModel",
    "Translator",
    "TranslationResult",
    "launch_counts",
    "load_model",
    "reset_launches",
]
