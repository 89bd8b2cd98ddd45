"""Layer normalization ops.

Semantics mirror the reference (reference: src/layers/common.cc:445-472):
a norm layer with ``beta`` is a full LayerNorm; gamma-only is RMSNorm,
optionally with the ``(1 + gamma)`` residual-weight variant. Statistics are
accumulated in float32 regardless of the activation dtype.

On a CUDA tensor every norm without ``use_residual`` runs the fused kernel
(``kernels/norms.py``): eager PyTorch spends a dozen launches on a norm and
the decode step is bound by launches. The kernel takes any width (16-byte
loads where it is a multiple of 8, scalar loads otherwise); it never gives
way to the plain functions. ``CT2TPU_PALLAS_NORMS=0`` (the JAX package's switch,
whose default there is off) takes the plain functions instead.
"""

from __future__ import annotations

import os

from ..kernels.norms import fused_norm, fused_norm_plain


def layer_norm(x, gamma, beta, epsilon: float = 1e-5):
    return fused_norm_plain(x, gamma, beta, eps=epsilon)


def rms_norm(x, gamma, epsilon: float = 1e-6, use_residual: bool = False):
    return fused_norm_plain(x, 1.0 + gamma.float() if use_residual else gamma,
                            None, eps=epsilon)


def _use_fused_norms(x) -> bool:
    return x.is_cuda and os.environ.get("CT2TPU_PALLAS_NORMS", "1") != "0"


def apply_norm(params: dict, x, epsilon: float, use_residual: bool = False):
    """Apply a norm given its param dict ({"gamma": ..., "beta"?: ...})."""
    if _use_fused_norms(x) and not use_residual:
        return fused_norm(x, params["gamma"], params.get("beta"), eps=epsilon)
    if "beta" in params:
        return layer_norm(x, params["gamma"], params["beta"], epsilon)
    return rms_norm(x, params["gamma"], epsilon, use_residual)
