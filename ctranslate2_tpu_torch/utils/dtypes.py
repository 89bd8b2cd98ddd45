"""Compute-type policy: how stored weight dtypes map to runtime dtypes.

Mirrors the reference's ComputeType resolution (reference:
include/ctranslate2/types.h:16-66, src/types.cc) for two platforms:

- ``cuda``: ``float16`` and ``bfloat16`` run as requested; a model stored
  in float32 runs in float32 unless a half type is asked for.
- ``cpu``: every float request runs in float32 (the test backend, as the
  JAX package does on its CPU).

``int8*`` keeps weights as int8 plus per-output-channel scales and runs
W8A8 matmuls (activations quantized per row at run time). ``int16`` has no
GPU kernel here: its weights are dequantized at load.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

COMPUTE_TYPES = (
    "default",
    "auto",
    "float32",
    "float16",
    "bfloat16",
    "int8",
    "int8_float32",
    "int8_float16",
    "int8_bfloat16",
    "int16",
)

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


@dataclass(frozen=True)
class DTypePolicy:
    """Resolved dtype plan for a loaded model."""

    weight_dtype: str  # "float32" | "float16" | "bfloat16" | "int8"
    activation_dtype: str  # "float32" | "float16" | "bfloat16"
    quantize_activations: bool  # W8A8 dynamic activation quantization

    @property
    def activation_torch(self) -> torch.dtype:
        return _TORCH_DTYPES[self.activation_dtype]

    @property
    def float_weight_torch(self) -> torch.dtype:
        """Dtype of the float (non-int8) weights."""
        return _TORCH_DTYPES.get(self.weight_dtype, self.activation_torch)


def _default_float(platform: str) -> str:
    return "float16" if platform == "cuda" else "float32"


def _half(name: str, platform: str) -> str:
    """``float16``/``bfloat16`` as asked on the card, float32 on the CPU."""
    return name if platform == "cuda" else "float32"


def resolve_compute_type(compute_type, weights_dtype: str,
                         platform: str) -> DTypePolicy:
    """Resolve a user compute-type request against the stored weight dtype.

    ``weights_dtype`` is the dtype of the model's linear weights on disk
    (one of float32/float16/bfloat16/int8/int16); ``platform`` is
    ``"cuda"`` or ``"cpu"``.
    """
    if isinstance(compute_type, dict):
        # Per-device mapping (reference: Translator(compute_type={"cuda":
        # "float16", "cpu": "int8"}), python/cpp/module.cc).
        compute_type = compute_type.get(platform) or "default"
    elif not isinstance(compute_type, (str, type(None))):
        raise TypeError(
            "compute_type must be a string or a {device: compute_type} "
            f"dict, got {type(compute_type).__name__}")
    compute_type = compute_type or "default"
    if compute_type not in COMPUTE_TYPES:
        raise ValueError(f"unknown compute type: {compute_type!r}")

    if compute_type in ("default", "auto"):
        # Keep the model's own quantization and float type.
        if weights_dtype == "int8":
            return DTypePolicy("int8", _default_float(platform), True)
        if weights_dtype in ("float16", "bfloat16"):
            f = _half(weights_dtype, platform)
            return DTypePolicy(f, f, False)
        if weights_dtype == "int16":
            f = _default_float(platform)
            return DTypePolicy(f, f, False)
        return DTypePolicy("float32", "float32", False)

    if compute_type == "float32":
        return DTypePolicy("float32", "float32", False)
    if compute_type in ("float16", "bfloat16"):
        f = _half(compute_type, platform)
        return DTypePolicy(f, f, False)
    if compute_type == "int16":
        f = _default_float(platform)
        return DTypePolicy(f, f, False)

    # int8 family: W8A8 with the activation float of the suffix.
    if compute_type == "int8_float32":
        act = "float32"
    elif compute_type in ("int8_float16", "int8_bfloat16"):
        act = _half(compute_type[len("int8_"):], platform)
    else:  # "int8"
        act = _default_float(platform)
    return DTypePolicy("int8", act, True)
