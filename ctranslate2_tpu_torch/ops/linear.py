"""Linear (dense) op with CT2-compatible weight quantization.

Capability parity with the reference Dense layer
(reference: src/layers/common.cc:266-442):

- float path: ``y = act(x @ w + b) (+ residual)``
- int8 path (W8A8 dynamic): activations are quantized per row with
  ``a_scale = 127 / amax(row)`` and rounded half to even, multiplied by the
  int8 weights with int32 accumulation (``kernels/quant_matmul.py``, a CUDA
  kernel on the card), dequantized with the outer product of the scales,
  then bias + activation + residual.
- int8 weight-only: weights dequantized to float32 on the fly
  (``w = q / scale``), used when activation quantization is disabled.

Param dict keys:
  ``w``      float weight (in, out)
  ``wq``     int8 weight (out, in): the model.bin layout, K-major for the
             kernel
  ``scale``  per-output-channel scale (out,)
  ``b``      optional bias (out,)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels.quant_matmul import matmul_w8a8


def quantize_per_row(x, round_before_cast: bool = True):
    """Quantize activations to int8 with per-row (last-axis) amax scales.

    Returns (q, scale) where ``x ≈ q / scale`` and scale has shape
    ``x.shape[:-1]``. ``torch.round`` rounds half to even, as ``jnp.rint``.
    """
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    # torch's ``scalar / tensor`` multiplies by a reciprocal; dividing two
    # tensors rounds once, as jnp does.
    scale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                        torch.ones_like(amax))
    scaled = x32 * scale[..., None]
    if round_before_cast:
        scaled = torch.round(scaled)
    q = scaled.clamp(-128, 127).to(torch.int8)
    return q, scale


def linear(
    params: dict,
    x,
    activation: Optional[Callable] = None,
    residual=None,
    quantize_activations: bool = True,
):
    """Apply a dense layer. ``x``: (..., in) -> (..., out)."""
    if "w4" in params or "w4p" in params:
        raise NotImplementedError("AWQ 4-bit weights are not ported yet")
    out_dtype = x.dtype
    bias = params.get("b")

    if "wq" in params:
        wq = params["wq"]  # [N, K]
        w_scale = params["scale"].float()
        if quantize_activations:
            q, a_scale = quantize_per_row(x)
            N, K = wq.shape
            lead = x.shape[:-1]
            y = matmul_w8a8(q.reshape(-1, K), wq, a_scale.reshape(-1),
                            w_scale).reshape(*lead, N)
        else:
            w = wq.float() / w_scale[:, None]
            y = torch.matmul(x.float(), w.t())
    else:
        y = torch.matmul(x, params["w"].to(x.dtype)).float()

    if bias is not None:
        y = y + bias.float()
    if activation is not None:
        y = activation(y)
    y = y.to(out_dtype)
    if residual is not None:
        y = y + residual.to(out_dtype)
    return y

