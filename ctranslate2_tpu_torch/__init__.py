"""ctranslate2_tpu_torch: the PyTorch and CUDA port of ctranslate2_tpu.

It reads the same CTranslate2 model directories and runs
``Translator.translate_batch`` / ``score_batch`` / ``translate_file`` /
``score_file``, ``Generator.generate_batch`` / ``score_batch`` /
``forward_batch`` (argmax or random sampling in both decode loops;
attention, alignment, coverage, prefix bias, vocabulary logits,
alternatives, vocabulary maps, step callbacks and static prompts through
the host decode loops), the iterable and token-streaming helpers,
``Encoder.forward_batch`` and the speech models ``Whisper``, ``Wav2Vec2``
and ``Wav2Vec2Bert``, with model residency (``unload_model`` /
``load_model``) on every task class, and serving: the
``ContinuousBatcher``, ``ContinuousTranslator`` and ``ContinuousWhisper``
(continuous batching of decoder-only, encoder-decoder and Whisper models;
greedy, sampled and beam search, per-request options), the micro-batching
``ServingScheduler`` (``translation_scheduler``, ``generation_scheduler``)
and ``BufferedTranslationWrapper``, on
one NVIDIA Hopper card (or on the CPU when asked), with hand-written CUDA
kernels for the int8 matmul, the AWQ 4-bit matmuls, the beam reorder,
flash attention, decode attention over an int8 KV cache and the norms. It
imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .runtime.continuous import (ContinuousBatcher, ContinuousTranslator,
                                 ContinuousWhisper)
from .runtime.encoder import Encoder, EncoderForwardOutput
from .runtime.generator import Generator
from .runtime.translator import Translator
from .runtime.wav2vec2 import Wav2Vec2, Wav2Vec2Bert
from .runtime.whisper import (Whisper, WhisperAlignmentResult,
                              WhisperGenerationResult)
from .runtime.scheduler import (BufferedTranslationWrapper, ServingScheduler,
                                generation_scheduler, translation_scheduler)
from .runtime.results import (AsyncResult, ExecutionStats, GenerationResult,
                              GenerationStepResult, ScoringResult,
                              TranslationResult)
from .models.loader import LoadedModel, load_model
from .kernels import launch_counts, reset_launches

__all__ = [
    "AsyncResult",
    "BufferedTranslationWrapper",
    "ContinuousBatcher",
    "ContinuousTranslator",
    "ContinuousWhisper",
    "Encoder",
    "EncoderForwardOutput",
    "ExecutionStats",
    "GenerationResult",
    "GenerationStepResult",
    "Generator",
    "LoadedModel",
    "ScoringResult",
    "ServingScheduler",
    "Translator",
    "TranslationResult",
    "Wav2Vec2",
    "Wav2Vec2Bert",
    "Whisper",
    "WhisperAlignmentResult",
    "WhisperGenerationResult",
    "generation_scheduler",
    "launch_counts",
    "load_model",
    "reset_launches",
    "translation_scheduler",
]
