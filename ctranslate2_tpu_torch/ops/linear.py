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
- AWQ W4 (``w4`` or ``w4p``): float activations times the 4-bit payload,
  dequantized per group inside the kernel (``matmul_w4a16``,
  ``matmul_w4p``, CUDA kernels on the card) at every number of rows; the
  activations are not quantized.

Param dict keys:
  ``w``        float weight (in, out)
  ``wq``       int8 weight (out, in): the model.bin layout, K-major for the
               kernel
  ``scale``    per-output-channel scale (out,)
  ``w4``       AWQ int8 (q - zero) values (in, out)
  ``w4p``      AWQ packed nibbles (in/2, out): low nibble row r, high
               nibble row r + in/2
  ``g_scale``  AWQ per-group scales (in/G, out)
  ``g_zs``     AWQ per-group zero * scale (in/G, out), with ``w4p``
  ``b``        optional bias (out,)

An int8 linear also takes its input already quantized, as an
``Int8Activations``: the fused norm before it (``ops/norms.py``) quantizes
its output once for every linear that reads it. Every (q, scale) that feeds
a W8A8 product, the norm's and ``quantize_input``'s alike, passes once
through ``int8_activations``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..kernels.quant_matmul import matmul_w4a16, matmul_w4p, matmul_w8a8


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


class Int8Activations(NamedTuple):
    """Activations quantized per row for a W8A8 linear: ``q`` int8 [..., K],
    ``scale`` f32 [...] (x ≈ q / scale), and ``dtype``, the type of the
    activations they stand for (the linear's output type)."""
    q: torch.Tensor
    scale: torch.Tensor
    dtype: torch.dtype

    @property
    def shape(self):
        return self.q.shape


def int8_activations(q, scale, dtype) -> Int8Activations:
    """The one place every int8 activation of the model passes, once per
    quantization: a run can be watched, or fed another run's (q, scale),
    by patching this function."""
    return Int8Activations(q, scale, dtype)


def quantize_input(x) -> Int8Activations:
    """``x`` quantized per row for the int8 linears that read it."""
    q, scale = quantize_per_row(x)
    return int8_activations(q, scale, x.dtype)


def linear(
    params: dict,
    x,
    activation: Optional[Callable] = None,
    residual=None,
    quantize_activations: bool = True,
):
    """Apply a dense layer. ``x``: (..., in) -> (..., out); an
    ``Int8Activations`` feeds an int8 linear as it is."""
    out_dtype = x.dtype
    bias = params.get("b")
    prequantized = isinstance(x, Int8Activations)
    if prequantized and not ("wq" in params and quantize_activations):
        raise ValueError("int8 activations feed only an int8 (W8A8) linear")

    if "w4p" in params:
        w4p = params["w4p"]  # [K/2, N]
        K, N = 2 * w4p.shape[0], w4p.shape[1]
        y = matmul_w4p(x.reshape(-1, K), w4p, params["g_scale"],
                       params["g_zs"]).reshape(*x.shape[:-1], N)
    elif "w4" in params:
        w4 = params["w4"]  # [K, N]
        K, N = w4.shape
        y = matmul_w4a16(x.reshape(-1, K), w4,
                         params["g_scale"]).reshape(*x.shape[:-1], N)
    elif "wq" in params:
        wq = params["wq"]  # [N, K]
        w_scale = params["scale"].float()
        if quantize_activations:
            a = x if prequantized else quantize_input(x)
            N, K = wq.shape
            # The kernel takes contiguous rows: a strided input (a transposed
            # convolution output) quantizes into a strided q.
            y = matmul_w8a8(a.q.reshape(-1, K).contiguous(), wq,
                            a.scale.reshape(-1).contiguous(),
                            w_scale).reshape(*a.shape[:-1], N)
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

