"""Layer normalization ops.

Semantics mirror the reference (reference: src/layers/common.cc:445-472):
a norm layer with ``beta`` is a full LayerNorm; gamma-only is RMSNorm,
optionally with the ``(1 + gamma)`` residual-weight variant. Statistics are
accumulated in float32 regardless of the activation dtype.
"""

from __future__ import annotations

import torch


def layer_norm(x, gamma, beta, epsilon: float = 1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) / torch.sqrt(var + epsilon)
    out = normed * gamma.float() + beta.float()
    return out.to(x.dtype)


def rms_norm(x, gamma, epsilon: float = 1e-6, use_residual: bool = False):
    x32 = x.float()
    rms = torch.sqrt(torch.square(x32).mean(dim=-1, keepdim=True) + epsilon)
    inv_rms = torch.ones_like(rms) / rms
    g = gamma.float()
    if use_residual:
        g = 1.0 + g
    return (x32 * inv_rms * g).to(x.dtype)


def apply_norm(params: dict, x, epsilon: float, use_residual: bool = False):
    """Apply a norm given its param dict ({"gamma": ..., "beta"?: ...})."""
    if "beta" in params:
        return layer_norm(x, params["gamma"], params["beta"], epsilon)
    return rms_norm(x, params["gamma"], epsilon, use_residual)
