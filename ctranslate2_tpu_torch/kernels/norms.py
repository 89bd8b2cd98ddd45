"""Fused LayerNorm / RMSNorm.

Counterpart of ``ctranslate2_tpu/kernels/norms.py::fused_norm``. The CUDA
kernel is ``csrc/fused_norm.cu``: one launch per norm where eager PyTorch
spends six or seven. It takes any width: 16-byte loads where the width is a
multiple of 8, one element a load otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, count_launch

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_norm")
    if not lib.ct2_fused_norm.argtypes:
        p = ctypes.c_void_p
        lib.ct2_fused_norm.restype = ctypes.c_int
        lib.ct2_fused_norm.argtypes = [p, p, p, p, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_float,
                                       ctypes.c_int, p]
    return lib


def fused_norm_plain(x, gamma, beta=None, *, eps: float = 1e-5):
    """Plain PyTorch version: float32 statistics, centered variance."""
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


def fused_norm(x, gamma, beta=None, *, eps: float = 1e-5):
    """LayerNorm (``beta`` given) or RMSNorm over the last axis of ``x``
    [..., D]; ``gamma``/``beta`` [D]. Returns x's shape and dtype."""
    D = x.shape[-1]
    if gamma.shape != (D,) or (beta is not None and beta.shape != (D,)):
        raise ValueError(f"fused_norm takes gamma/beta of shape ({D},)")
    devices = {t.device for t in (x, gamma, beta) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"fused_norm operands lie on {sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return fused_norm_plain(x, gamma, beta, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_norm has no kernel for {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_norm takes float32/float16/bfloat16, got {x.dtype}")
    x2 = x.reshape(-1, D)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    if x2.data_ptr() % 32:
        x2 = x2.clone()  # a view that starts off the kernel's 16-byte loads
    gamma = gamma.float().contiguous()
    beta = None if beta is None else beta.float().contiguous()
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().ct2_fused_norm(
            x2.data_ptr(), gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), out.data_ptr(),
            x2.shape[0], D, eps, DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"fused_norm launch failed with CUDA error {err}")
    count_launch("fused_norm")
    return out.reshape(x.shape)
