"""ctranslate2_tpu_torch: the PyTorch and CUDA port of ctranslate2_tpu.

It reads the same CTranslate2 model directories and runs
``Translator.translate_batch`` on one NVIDIA Hopper card (or on the CPU
when asked), with hand-written CUDA kernels for the int8 matmul and the
beam reorder. It imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .runtime.translator import Translator
from .runtime.results import AsyncResult, TranslationResult
from .models.loader import LoadedModel, load_model
from .kernels import launch_counts, reset_launches

__all__ = [
    "AsyncResult",
    "LoadedModel",
    "Translator",
    "TranslationResult",
    "launch_counts",
    "load_model",
    "reset_launches",
]
