"""ctranslate2_tpu_torch: the PyTorch and CUDA port of ctranslate2_tpu.

It reads the same CTranslate2 model directories and runs
``Translator.translate_batch`` / ``score_batch`` / ``translate_file`` /
``score_file``, ``Generator.generate_batch`` / ``score_batch`` /
``forward_batch`` (argmax or random sampling in both decode loops;
attention, alignment, coverage, prefix bias, vocabulary logits,
alternatives, vocabulary maps, step callbacks and static prompts through
the host decode loops; lossless speculation), the iterable and
token-streaming helpers, ``Encoder.forward_batch`` and the speech models
``Whisper``, ``Wav2Vec2`` and ``Wav2Vec2Bert``, with model residency
(``unload_model`` / ``load_model``) and data-parallel replicas
(``device_index=[0, 1, ..]``) on every task class, and serving: the
``ContinuousBatcher``, ``ContinuousTranslator`` and ``ContinuousWhisper``
(continuous batching of decoder-only, encoder-decoder and Whisper models;
greedy, sampled and beam search, per-request options), the micro-batching
``ServingScheduler`` (``translation_scheduler``, ``generation_scheduler``)
and ``BufferedTranslationWrapper``; the ``ct2tpu-torch-translator`` client
(``cli/translate.py``), logging, the scope profiler and the package-level
helpers of ``ctranslate2_tpu``. It runs on one NVIDIA Hopper card (or on
the CPU when asked), with hand-written CUDA kernels for the int8 matmul,
the AWQ 4-bit matmuls, the beam reorder, flash attention, decode attention
over an int8 KV cache and the norms, and a native host core (C++, built
with g++ on first use) that indexes ``model.bin`` for zero-copy loading
and backs the scheduler's queue and the rebatching. It imports neither JAX
nor the JAX package.
"""

__version__ = "0.1.0"

from .formats.model_file import _DTYPE_IDS as _dtype_ids
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
from .utils.logging import get_log_level, set_log_level
from . import converters, models, specs

# The reference has one async result class a task (python/cpp/translator.cc
# etc.); here one future-backed wrapper plays all three.
AsyncTranslationResult = AsyncResult
AsyncGenerationResult = AsyncResult
AsyncScoringResult = AsyncResult


class DataType:
    """Names of the serializable tensor dtypes, in model.bin's dtype id
    order (reference: ctranslate2.DataType, include/ctranslate2/types.h)."""


for _name in _dtype_ids:
    setattr(DataType, _name, _name)
del _name


class Device:
    """Supported device kinds (reference: ctranslate2.Device)."""
    cpu = "cpu"
    cuda = "cuda"


def _process_group():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class MpiInfo:
    """Multi-process topology (reference: python/cpp/mpi.cc): from the
    ``torch.distributed`` process group when one is initialised, else one
    rank."""

    @staticmethod
    def getNRanks() -> int:
        dist = _process_group()
        return dist.get_world_size() if dist else 1

    @staticmethod
    def getCurRank() -> int:
        dist = _process_group()
        return dist.get_rank() if dist else 0

    @staticmethod
    def getLocalRank() -> int:
        """Node-local rank: from the launcher's environment where it sets
        one (the reference groups ranks by hostname, src/devices.cc:162-186),
        else the global rank, right for one process a host."""
        import os

        for var in ("OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID",
                    "LOCAL_RANK", "MPI_LOCALRANKID"):
            value = os.environ.get(var)
            if value is not None:
                return int(value)
        return MpiInfo.getCurRank()


def get_cuda_device_count() -> int:
    """The number of CUDA cards visible (reference: get_cuda_device_count)."""
    import torch

    return torch.cuda.device_count()


_RANDOM_SEED = 0


def set_random_seed(seed: int) -> None:
    """Stores a seed for ``get_random_seed`` (reference: set_random_seed,
    src/random.cc). As in ``ctranslate2_tpu``, sampling takes its seed from
    each call (``seed``, 0 by default), never from this value."""
    global _RANDOM_SEED
    _RANDOM_SEED = seed


def get_random_seed() -> int:
    return _RANDOM_SEED


def get_device_info() -> dict:
    """Topology introspection (the analog of the reference's MpiInfo
    binding, python/cpp/mpi.cc), with the keys of ``ctranslate2_tpu``'s."""
    count = get_cuda_device_count()
    return {
        "platform": "cuda" if count else "cpu",
        "process_index": MpiInfo.getCurRank(),
        "process_count": MpiInfo.getNRanks(),
        "local_device_count": max(count, 1),
        "device_count": max(count, 1) * MpiInfo.getNRanks(),
    }


def contains_model(path: str) -> bool:
    import os

    return os.path.isfile(os.path.join(path, "model.bin"))


def get_supported_compute_types(device: str = "auto") -> set:
    """Compute types that load and run on ``device`` (reference:
    ctranslate2.get_supported_compute_types, src/types.cc): ``"cuda"``,
    ``"cpu"`` or ``"auto"`` (the card). Every type of the policy runs on
    both (float16 and bfloat16 as float32 on the CPU, int16 dequantized at
    load), the reference's "supported = runnable"."""
    from .utils.dtypes import COMPUTE_TYPES

    device = (device or "auto").lower()
    if device not in ("auto", "cuda", "cpu"):
        raise ValueError(
            f"unsupported device {device!r} (this runtime supports "
            "'auto', 'cuda' and 'cpu')")
    return {t for t in COMPUTE_TYPES if t not in ("default", "auto")}

__all__ = [
    "AsyncGenerationResult",
    "AsyncResult",
    "AsyncScoringResult",
    "AsyncTranslationResult",
    "BufferedTranslationWrapper",
    "ContinuousBatcher",
    "ContinuousTranslator",
    "ContinuousWhisper",
    "DataType",
    "Device",
    "Encoder",
    "EncoderForwardOutput",
    "ExecutionStats",
    "GenerationResult",
    "GenerationStepResult",
    "Generator",
    "LoadedModel",
    "MpiInfo",
    "ScoringResult",
    "ServingScheduler",
    "Translator",
    "TranslationResult",
    "Wav2Vec2",
    "Wav2Vec2Bert",
    "Whisper",
    "WhisperAlignmentResult",
    "WhisperGenerationResult",
    "contains_model",
    "generation_scheduler",
    "get_cuda_device_count",
    "get_device_info",
    "get_log_level",
    "get_random_seed",
    "get_supported_compute_types",
    "launch_counts",
    "load_model",
    "reset_launches",
    "set_log_level",
    "set_random_seed",
    "translation_scheduler",
]
