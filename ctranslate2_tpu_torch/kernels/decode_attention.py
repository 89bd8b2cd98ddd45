"""One-token attention over an int8-quantized KV cache.

Counterpart of ``ctranslate2_tpu/kernels/decode_attention.py``: keys and
values are cached as int8 with one float scale per (batch, head, position)
vector, which halves the cache bytes a decode step must read. The CUDA
kernel is ``csrc/decode_attention_int8.cu``: one launch a call, for any
head dim up to 256, its grid from ``decode_plan``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple

import torch

from . import build, count_launch
from .norms import DTYPE_CODES

NEG_INF = -1e30
CARD_SMS = 132  # streaming multiprocessors of the H100 SXM
DECODE_MAX_D = 256
DECODE_TILE = 64  # keys a ring stage (and the unit the splits deal out)
DECODE_BLOCKS_PER_SM = 2  # blocks an SM holds (registers): the grid's bound
DECODE_MAX_SPLITS = 64
DECODE_COUNTERS = 4096  # row-group counters a (device, stream) keeps


class DecodePlan(NamedTuple):
    lanes: int   # FMA path: lanes a key (each owns 16 dims), 8 for D <= 128, else 16
    gt: int      # query rows a block (1, 2 or 4)
    tile: int    # keys a ring stage
    splits: int  # slices of each row's visible keys, one block each
    grid: Tuple[int, int, int]  # (splits, Hkv x query tiles, B)
    counters: int  # row-group counters the cross-block merge uses (0: none)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_plan(B: int, Hkv: int, G: int, C: int, D: int,
                sms: int = CARD_SMS) -> DecodePlan:
    """The decode kernel's launch for q [B, Hkv * G, 1, D] over a cache of
    capacity C on a card of ``sms`` SMs. It reads no length, so one plan
    serves every step of a generation and a CUDA graph can hold the launch:
    the kernel cuts each row's visible keys into ``splits`` slices of whole
    tiles (``decode_split_range``), as many as keep the grid within
    ``DECODE_BLOCKS_PER_SM`` blocks an SM (one wave), no more than the
    capacity has tiles."""
    if not 1 <= D <= DECODE_MAX_D:
        raise ValueError(f"decode_attention_int8 takes head dims 1-{DECODE_MAX_D}, got {D}")
    lanes = 8 if D <= 128 else 16
    gt = 1 if G == 1 else 2 if G == 2 else 4
    tile = DECODE_TILE
    gtiles = _cdiv(G, gt)
    groups = B * Hkv * gtiles
    want = DECODE_BLOCKS_PER_SM * sms // max(groups, 1)
    splits = max(1, min(want, _cdiv(C, tile), DECODE_MAX_SPLITS))
    return DecodePlan(lanes, gt, tile, splits, (splits, Hkv * gtiles, B),
                      groups if splits > 1 else 0)


def decode_split_range(length: int, C: int, window: int, splits: int,
                       tile: int, split: int) -> Tuple[int, int]:
    """The cache keys [c0, c1) that block ``split`` of a row reads: the
    kernel's own rule (``decode_kernel`` in the CUDA source). The tiles of
    the visible keys [lo, hi) are dealt out evenly over the splits, the
    last tile ragged; an empty slice has c1 <= c0."""
    hi = min(max(length, 0), C)
    lo = max(hi - window, 0) if window > 0 else 0
    tiles = _cdiv(hi - lo, tile)
    return (lo + split * tiles // splits * tile,
            min(lo + (split + 1) * tiles // splits * tile, hi))


_counter_cache: Dict[Tuple[int, int], torch.Tensor] = {}
_counter_lock = threading.Lock()


def _counters(device, stream: int) -> torch.Tensor:
    """The cross-block merge's row-group counters for (device, stream):
    zeroed once when made; the last block of each group re-zeroes its own,
    so a call needs no memset. While a CUDA graph is being captured, a
    buffer that the stream does not have yet is made for that call alone
    (its zeroing becomes a node of the graph)."""
    key = (device.index, stream)
    with _counter_lock:
        buf = _counter_cache.get(key)
        if buf is None:
            buf = torch.zeros(DECODE_COUNTERS, dtype=torch.int32, device=device)
            if not torch.cuda.is_current_stream_capturing():
                _counter_cache[key] = buf
        return buf


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention_int8")
    if not lib.ct2_decode_attention_int8.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ct2_decode_attention_int8.restype = i
        lib.ct2_decode_attention_int8.argtypes = (
            [p] * 13 + [i] * 5 + [ctypes.c_float] + [i] * 5 + [p])
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
    to the cache after the attention. On the card the head dim may be any
    up to 256 (``DECODE_MAX_D``); above it the kernel raises.
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
    G = Hq // Hkv
    plan = decode_plan(B, Hkv, G, C, D,
                       torch.cuda.get_device_properties(q.device).multi_processor_count)
    lengths, window = _fresh_window(lengths, window, has_fresh)
    q = q.contiguous()
    k_scale = k_scale.float()
    v_scale = v_scale.float()
    for t in (k8, v8, k_scale, v_scale, lengths):
        if not t.is_contiguous():
            raise ValueError("decode_attention_int8 takes a contiguous cache")
    if k8.data_ptr() % 16 or v8.data_ptr() % 16:
        raise ValueError("decode_attention_int8 takes a 16-byte aligned cache")
    # The kernel copies the scale rows by aligned 16-byte chunks.
    k_scale, v_scale = (t if t.data_ptr() % 16 == 0 else t.clone()
                        for t in (k_scale, v_scale))
    ptrs = [None] * 4
    if has_fresh:
        if k_new8.dtype != torch.int8 or v_new8.dtype != torch.int8 \
                or k_new8.shape != (B, Hkv, 1, D) or v_new8.shape != (B, Hkv, 1, D):
            raise ValueError("decode_attention_int8 takes fresh K/V int8 [B, Hkv, 1, D]")
        fresh = [k_new8.contiguous(), kn_scale.float().reshape(B, Hkv).contiguous(),
                 v_new8.contiguous(), vn_scale.float().reshape(B, Hkv).contiguous()]
        ptrs = [t.data_ptr() for t in fresh]

    out = torch.empty((B, Hq, 1, D), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part = counters = None
        if plan.splits > 1:
            if plan.counters > DECODE_COUNTERS:
                raise ValueError(f"decode_attention_int8: {plan.counters} row groups "
                                 f"exceed the {DECODE_COUNTERS} counters")
            # Each split's (max, sum, accumulator) for every query row.
            part = torch.empty((B * Hq, plan.splits, D + 2), dtype=torch.float32,
                               device=q.device)
            counters = _counters(q.device, stream)
        err = _lib().ct2_decode_attention_int8(
            q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), *ptrs,
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            out.data_ptr(), B, Hkv, G, C, D, scale, window, plan.lanes, plan.gt,
            plan.splits, DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(
            f"decode_attention_int8 launch failed with CUDA error {err}")
    count_launch("decode_attention_int8")
    return out
