"""W8A8 matmul: int8 activations x int8 weights, f32 dequant epilogue.

Counterpart of ``ctranslate2_tpu/kernels/quant_matmul.py::matmul_w8a8``.
The CUDA kernel is ``csrc/w8a8_gemm.cu``. Weights keep the model.bin
layout, ``wq`` int8 [N, K] (out, in), which is what ``mma.sync``'s s8 form
takes for its B operand.
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch
from . import build


def _lib() -> ctypes.CDLL:
    lib = build.load("w8a8_gemm")
    if not lib.ct2_w8a8_gemm.argtypes:
        p = ctypes.c_void_p
        lib.ct2_w8a8_gemm.restype = ctypes.c_int
        lib.ct2_w8a8_gemm.argtypes = [p, p, p, p, p, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, p]
    return lib


def _check(q, wq, a_scale, w_scale):
    if q.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("matmul_w8a8 takes int8 activations and weights, got "
                        f"{q.dtype} and {wq.dtype}")
    if a_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("matmul_w8a8 takes float32 scales")
    if q.dim() != 2 or wq.dim() != 2 or q.shape[1] != wq.shape[1]:
        raise ValueError("matmul_w8a8 takes q [M, K] and wq [N, K], got "
                         f"{tuple(q.shape)} and {tuple(wq.shape)}")
    if a_scale.shape != (q.shape[0],) or w_scale.shape != (wq.shape[0],):
        raise ValueError("matmul_w8a8 takes a_scale [M] and w_scale [N]")
    devices = {t.device for t in (q, wq, a_scale, w_scale)}
    if len(devices) != 1:
        raise ValueError(f"matmul_w8a8 operands lie on {sorted(map(str, devices))}")


def matmul_w8a8_plain(q, wq, a_scale, w_scale):
    """Plain PyTorch version: the int8 product in float64 (exact, since
    |sum| < 2**53), rounded to float32 like an int32 accumulator, then the
    same epilogue as the kernel."""
    acc = torch.matmul(q.to(torch.float64), wq.to(torch.float64).t())
    a = torch.where(a_scale == 0, torch.ones_like(a_scale), a_scale)
    return acc.to(torch.float32) / (a[:, None] * w_scale[None, :])


def matmul_w8a8(q, wq, a_scale, w_scale):
    """``q`` int8 [M, K], ``wq`` int8 [N, K], ``a_scale`` f32 [M],
    ``w_scale`` f32 [N] -> f32 [M, N] = (q @ wq.T) / (a_scale ⊗ w_scale),
    with a zero ``a_scale`` read as 1."""
    _check(q, wq, a_scale, w_scale)
    if q.device.type == "cpu":
        return matmul_w8a8_plain(q, wq, a_scale, w_scale)
    if q.device.type != "cuda":
        raise ValueError(f"matmul_w8a8 has no kernel for {q.device}")
    for t in (q, wq, a_scale, w_scale):
        if not t.is_contiguous():
            raise ValueError("matmul_w8a8 takes contiguous tensors")
    M, K = q.shape
    N = wq.shape[0]
    if (M + 63) // 64 > 65535:
        raise ValueError(f"matmul_w8a8: M={M} exceeds the kernel's grid")
    out = torch.empty((M, N), dtype=torch.float32, device=q.device)
    vec = int(K % 16 == 0 and q.data_ptr() % 16 == 0
              and wq.data_ptr() % 16 == 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().ct2_w8a8_gemm(
            q.data_ptr(), wq.data_ptr(), a_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K, vec, stream)
    if err:
        raise RuntimeError(f"w8a8_gemm launch failed with CUDA error {err}")
    count_launch("matmul_w8a8")
    return out
