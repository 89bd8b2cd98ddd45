"""Fused residual add + LayerNorm / RMSNorm + int8 quantization.

Counterpart of ``ctranslate2_tpu/kernels/norms.py::fused_norm``. The CUDA
kernel is ``csrc/fused_norm.cu``: one launch for a norm, and for the eager
work on either side of it in the port's layers, the residual add before it
(``residual``) and, under W8A8, the per-row int8 quantization of its output
(``quantize``, what ``ops/linear.py::quantize_per_row`` gives). It takes any
width: 16-byte loads where the width is a multiple of 8, one element a load
otherwise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build, count_launch
from ..ops.linear import quantize_per_row

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


class NormOut(NamedTuple):
    """The fused forms' outputs, None where not asked for: ``sum`` the new
    residual stream x + residual in x's type, ``y`` the norm's output in
    x's type, ``q`` int8 and ``scale`` f32 [...] its per-row
    quantization."""
    sum: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    q: Optional[torch.Tensor]
    scale: Optional[torch.Tensor]


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_norm")
    if not lib.ct2_fused_norm.argtypes:
        p = ctypes.c_void_p
        lib.ct2_fused_norm.restype = ctypes.c_int
        lib.ct2_fused_norm.argtypes = [p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                                 ctypes.c_float, ctypes.c_int, p]
    return lib


def _norm_plain(x, gamma, beta, eps):
    """The norm alone: float32 statistics, centered variance."""
    x32 = x.float()
    if beta is None:
        rms = torch.sqrt(torch.square(x32).mean(dim=-1, keepdim=True) + eps)
        # ``scalar / tensor`` multiplies by a reciprocal in torch; dividing
        # two tensors rounds once, as jnp does.
        inv_rms = torch.ones_like(rms) / rms
        return (x32 * inv_rms * gamma.float()).to(x.dtype)
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=-1, keepdim=True)
    normed = (x32 - mean) / torch.sqrt(var + eps)
    return (normed * gamma.float() + beta.float()).to(x.dtype)


def _outputs(s, y, q, scale, residual, quantize, keep_sum, keep_y):
    """The wrapper's return: y alone for the plain norm, else a NormOut."""
    if residual is None and not quantize:
        return y
    return NormOut(s if residual is not None and keep_sum else None,
                   y if keep_y else None, q, scale)


def fused_norm_plain(x, gamma, beta=None, *, eps: float = 1e-5, residual=None,
                     quantize: bool = False, keep_sum: bool = True,
                     keep_y: bool = True):
    """Plain PyTorch version, the eager sequence step by step: the add in
    x's type, the norm, then ``quantize_per_row`` of its output."""
    _check(x, gamma, beta, residual, quantize, keep_y)
    s = x if residual is None else x + residual
    y = _norm_plain(s, gamma, beta, eps)
    q, scale = quantize_per_row(y) if quantize else (None, None)
    return _outputs(s, y, q, scale, residual, quantize, keep_sum, keep_y)


def _check(x, gamma, beta, residual, quantize, keep_y):
    D = x.shape[-1]
    if gamma.shape != (D,) or (beta is not None and beta.shape != (D,)):
        raise ValueError(f"fused_norm takes gamma/beta of shape ({D},)")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("fused_norm takes a residual of x's shape and type, got "
                         f"{tuple(residual.shape)} {residual.dtype} for "
                         f"{tuple(x.shape)} {x.dtype}")
    if not (quantize or keep_y):
        raise ValueError("fused_norm writes y, its int8 quantization or both")
    devices = {t.device for t in (x, gamma, beta, residual) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"fused_norm operands lie on {sorted(map(str, devices))}")


def _rows(t, D):
    """``t`` as a contiguous [rows, D] on the kernel's 16-byte loads."""
    t2 = t.reshape(-1, D)
    if not t2.is_contiguous():
        t2 = t2.contiguous()
    if t2.data_ptr() % 32:
        t2 = t2.clone()  # a view that starts off the kernel's 16-byte loads
    return t2


def fused_norm(x, gamma, beta=None, *, eps: float = 1e-5, residual=None,
               quantize: bool = False, keep_sum: bool = True, keep_y: bool = True):
    """LayerNorm (``beta`` given) or RMSNorm over the last axis of ``x``
    [..., D]; ``gamma``/``beta`` [D].

    With ``residual`` (x's shape and type) the norm runs over
    ``x + residual`` rounded to x's type, which is also returned as the new
    residual stream unless ``keep_sum`` is False. With ``quantize`` the
    output is also quantized per row to int8 as ``quantize_per_row`` does
    it; ``keep_y=False`` then leaves y out. Returns y (x's shape and type)
    when neither is given, else a ``NormOut``."""
    _check(x, gamma, beta, residual, quantize, keep_y)
    if x.device.type == "cpu":
        return fused_norm_plain(x, gamma, beta, eps=eps, residual=residual,
                                quantize=quantize, keep_sum=keep_sum, keep_y=keep_y)
    if x.device.type != "cuda":
        raise ValueError(f"fused_norm has no kernel for {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_norm takes float32/float16/bfloat16, got {x.dtype}")
    D = x.shape[-1]
    x2 = _rows(x, D)
    r2 = None if residual is None else _rows(residual, D)
    gamma = gamma.float().contiguous()
    beta = None if beta is None else beta.float().contiguous()
    rows = x2.shape[0]
    s = torch.empty_like(x2) if r2 is not None and keep_sum else None
    y = torch.empty_like(x2) if keep_y else None
    q = (torch.empty((rows, D), dtype=torch.int8, device=x.device)
         if quantize else None)
    scale = (torch.empty((rows,), dtype=torch.float32, device=x.device)
             if quantize else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().ct2_fused_norm(
            x2.data_ptr(), ptr(r2), gamma.data_ptr(), ptr(beta), ptr(s), ptr(y),
            ptr(q), ptr(scale), rows, D, eps, DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"fused_norm launch failed with CUDA error {err}")
    count_launch("fused_norm")

    def like_x(t):
        return None if t is None else t.view(x.shape)

    return _outputs(like_x(s), like_x(y), like_x(q),
                    None if scale is None else scale.view(x.shape[:-1]),
                    residual, quantize, keep_sum, keep_y)
