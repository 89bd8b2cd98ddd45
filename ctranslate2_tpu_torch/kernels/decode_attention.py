"""One-token attention over an int8-quantized KV cache.

Counterpart of ``ctranslate2_tpu/kernels/decode_attention.py``: keys and
values are cached as int8 with one float scale per (batch, head, position)
vector, which halves the cache bytes a decode step must read. The CUDA
kernel is ``csrc/decode_attention_int8.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, count_launch
from .norms import DTYPE_CODES

NEG_INF = -1e30
MAX_SPLITS = 64


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention_int8")
    if not lib.ct2_decode_attention_int8.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ct2_decode_attention_int8.restype = i
        lib.ct2_decode_attention_int8.argtypes = (
            [p] * 14 + [i] * 5 + [ctypes.c_float, i, i, i, p])
    return lib


def quantize_kv(x):
    """Per-vector symmetric int8 quantization over the last axis.

    Returns (q int8, scale f32) with ``x ~= q / scale``; zero vectors get
    scale 1. Plain torch, as the JAX package's is plain jnp.
    """
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    # Dividing two tensors rounds once, as jnp does (see ops/linear.py).
    scale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                        torch.ones_like(amax))
    q = torch.round(x32 * scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _fresh_window(lengths, window: int, has_fresh: bool):
    """``window`` counts the fresh token as one of its keys: the cache part
    then shows ``window - 1`` keys, or none when ``window == 1``."""
    if has_fresh and window > 0:
        if window == 1:
            return torch.zeros_like(lengths), 0
        return lengths, window - 1
    return lengths, window


def decode_attention_int8_plain(q, k8, k_scale, v8, v_scale, lengths, *,
                                k_new8=None, kn_scale=None, v_new8=None,
                                vn_scale=None, scale: float = 1.0,
                                window: int = 0):
    """Plain PyTorch version of ``decode_attention_int8``."""
    B, Hq, _, D = q.shape
    Hkv, C = k8.shape[1], k8.shape[2]
    G = Hq // Hkv
    has_fresh = k_new8 is not None
    lengths, window = _fresh_window(lengths, window, has_fresh)

    qg = q.float().reshape(B, Hkv, G, D) * scale
    s = torch.einsum("bhgd,bhcd->bhgc", qg, k8.float()) / k_scale[:, :, None, :]
    pos = torch.arange(C, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window > 0:
        mask = mask & (pos >= lengths[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    if has_fresh:
        lf = torch.einsum("bhgd,bhd->bhg", qg, k_new8[:, :, 0].float())
        lf = lf / kn_scale.reshape(B, Hkv, 1)
        s = torch.cat([s, lf[..., None]], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    # A row with no visible key at all has weights of zero.
    p = torch.where(m > NEG_INF / 2, p, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhgc,bhcd->bhgd",
                       p[..., :C] / v_scale[:, :, None, :], v8.float())
    if has_fresh:
        out = out + (p[..., C:] / vn_scale.reshape(B, Hkv, 1, 1)) \
            * v_new8[:, :, 0].float()[:, :, None, :]
    return (out / denom).reshape(B, Hq, 1, D)


def decode_attention_int8(q, k8, k_scale, v8, v_scale, lengths, *,
                          k_new8=None, kn_scale=None, v_new8=None,
                          vn_scale=None, scale: float = 1.0, window: int = 0):
    """Single-step attention over the int8 cache; returns f32 [B, Hq, 1, D].

    ``q`` [B, Hq, 1, D] float; ``k8``/``v8`` int8 [B, Hkv, C, D];
    ``k_scale``/``v_scale`` f32 [B, Hkv, C]; ``lengths`` int32 [B] valid cache
    lengths. When ``k_new8``/``v_new8`` (int8 [B, Hkv, 1, D], scales f32
    [B, Hkv, 1]) are given, ``lengths`` are the lengths BEFORE the append
    and the fresh token is merged in the kernel, so the caller can append
    to the cache after the attention.
    """
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"decode_attention_int8 takes q [B, Hq, 1, D], got {tuple(q.shape)}")
    B, Hq, _, D = q.shape
    Hkv, C = k8.shape[1], k8.shape[2]
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError("decode_attention_int8 takes an int8 cache")
    if k8.shape != (B, Hkv, C, D) or v8.shape != k8.shape or Hq % Hkv:
        raise ValueError("decode_attention_int8: cache shape does not match q")
    if k_scale.shape != (B, Hkv, C) or v_scale.shape != (B, Hkv, C):
        raise ValueError("decode_attention_int8 takes scales [B, Hkv, C]")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError("decode_attention_int8 takes int32 lengths [B]")
    has_fresh = k_new8 is not None
    if has_fresh != (v_new8 is not None):
        raise ValueError("decode_attention_int8 takes both fresh K and V or neither")
    fresh = (k_new8, kn_scale, v_new8, vn_scale) if has_fresh else ()
    devices = {t.device for t in (q, k8, k_scale, v8, v_scale, lengths) + fresh}
    if len(devices) != 1:
        raise ValueError(
            f"decode_attention_int8 operands lie on {sorted(map(str, devices))}")
    kwargs = dict(k_new8=k_new8, kn_scale=kn_scale, v_new8=v_new8,
                  vn_scale=vn_scale, scale=scale, window=window)
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k8, k_scale, v8, v_scale,
                                           lengths, **kwargs)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8 has no kernel for {q.device}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"decode_attention_int8 takes a float q, got {q.dtype}")
    if D % 16 or D > 256:
        raise ValueError("decode_attention_int8 takes a head dim that is a "
                         f"multiple of 16 and at most 256, got {D}")
    lengths, window = _fresh_window(lengths, window, has_fresh)
    q = q.contiguous()
    k_scale = k_scale.float()
    v_scale = v_scale.float()
    for t in (k8, v8, k_scale, v_scale, lengths):
        if not t.is_contiguous():
            raise ValueError("decode_attention_int8 takes a contiguous cache")
    if k8.data_ptr() % 16 or v8.data_ptr() % 16:
        raise ValueError("decode_attention_int8 takes a 16-byte aligned cache")
    ptrs = [None] * 4
    if has_fresh:
        if k_new8.dtype != torch.int8 or v_new8.dtype != torch.int8 \
                or k_new8.shape != (B, Hkv, 1, D) or v_new8.shape != (B, Hkv, 1, D):
            raise ValueError("decode_attention_int8 takes fresh K/V int8 [B, Hkv, 1, D]")
        fresh = [k_new8.contiguous(), kn_scale.float().reshape(B, Hkv).contiguous(),
                 v_new8.contiguous(), vn_scale.float().reshape(B, Hkv).contiguous()]
        ptrs = [t.data_ptr() for t in fresh]

    # Enough blocks for about two per SM, each with at least 128 keys.
    G = Hq // Hkv
    gt = 4 if D <= 128 else 2
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    blocks = B * Hkv * ((G + gt - 1) // gt)
    splits = max(1, min((2 * sms + blocks - 1) // max(blocks, 1),
                        (C + 127) // 128, MAX_SPLITS))
    part_m = torch.empty((B, Hq, splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hq, splits, D), dtype=torch.float32, device=q.device)
    out = torch.empty((B, Hq, 1, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().ct2_decode_attention_int8(
            q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), *ptrs,
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), B, Hkv, G, C, D, scale, window, splits,
            DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(
            f"decode_attention_int8 launch failed with CUDA error {err}")
    count_launch("decode_attention_int8")
    return out
