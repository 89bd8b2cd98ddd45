"""AWQ 4-bit group quantization: packing, unpacking, and the W4 load path.

A copy of the numpy layer of ``ctranslate2_tpu/ops/awq.py`` (the port
imports nothing of the JAX package), plus a torch counterpart of its
device-side load. Models carry int32-packed unsigned 4-bit weights with
per-group scales and packed zero-points (reference:
python/ctranslate2/converters/transformers.py:237-248). Two on-disk layouts
exist, selected by ``config.json["quantization_type"]``:

- AWQ_GEMM (1): ``weight`` [in, out/8] int32, nibbles in AWQ interleaved
  order; ``weight_scale`` [in/G, out]; ``weight_zero`` [in/G, out/8] int32
  (same interleave).
- AWQ_GEMV (2): ``weight`` [out, in/8] int32, natural LSB-first nibble
  order; ``weight_scale`` [out, in/G]; ``weight_zero`` [out, ceil(in/G/8)]
  int32.

Both are unpacked once at load into one of the two runtime layouts that
the W4 kernels take (``kernels/quant_matmul.py``): ``w4`` int8 (q - z)
values [K, N] with f32 scales [K/G, N], or ``w4p`` true 4-bit bytes
[K/2, N] (low nibble row r, high nibble row r + K/2) with f32 scales and
zero * scale terms [K/G, N].
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.transfer import to_device

# Nibble position of logical channel j inside a packed int32
# (llm-awq pack order; its inverse is [0, 4, 1, 5, 2, 6, 3, 7]).
AWQ_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])
AWQ_REVERSE_ORDER = np.array([0, 4, 1, 5, 2, 6, 3, 7])

AWQ_GEMM = 1
AWQ_GEMV = 2


def _unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """[..., n] int32 -> [..., n*8] uint8, LSB-first nibble order."""
    shifts = np.arange(0, 32, 4, dtype=np.uint32)
    vals = (packed.astype(np.uint32)[..., None] >> shifts) & 0xF
    return vals.reshape(packed.shape[:-1] + (-1,)).astype(np.uint8)


def _pack_nibbles(vals: np.ndarray) -> np.ndarray:
    """[..., n*8] uint8 -> [..., n] int32, LSB-first nibble order."""
    v = vals.astype(np.uint32).reshape(vals.shape[:-1] + (-1, 8))
    shifts = np.arange(0, 32, 4, dtype=np.uint32)
    return (v << shifts).sum(axis=-1, dtype=np.uint32).view(np.int32)


def _reorder_awq(vals: np.ndarray, reverse: bool) -> np.ndarray:
    """(Un)apply the AWQ nibble interleave on the last axis."""
    order = AWQ_REVERSE_ORDER if reverse else AWQ_ORDER
    idx = (np.arange(vals.shape[-1]) // 8) * 8 + order[np.arange(vals.shape[-1]) % 8]
    return vals[..., idx]


def unpack_awq_gemm(qweight: np.ndarray) -> np.ndarray:
    """[in, out/8] int32 (AWQ order) -> [in, out] uint8 4-bit values."""
    return _reorder_awq(_unpack_nibbles(qweight), reverse=True)


def pack_awq_gemm(w4: np.ndarray) -> np.ndarray:
    """[in, out] uint8 4-bit values -> [in, out/8] int32 (AWQ order)."""
    return _pack_nibbles(_reorder_awq(w4, reverse=False))


def unpack_awq_gemv(qweight: np.ndarray) -> np.ndarray:
    """[out, in/8] int32 (natural order) -> [out, in] uint8 values."""
    return _unpack_nibbles(qweight)


def pack_awq_gemv(w4: np.ndarray) -> np.ndarray:
    """[out, in] uint8 values -> [out, in/8] int32 (natural order)."""
    return _pack_nibbles(w4)


def dequantize_awq(qweight: np.ndarray, scales: np.ndarray,
                   qzeros: np.ndarray, quant_type: int = AWQ_GEMM):
    """Full numpy dequantization to a float32 ``(in, out)`` matrix."""
    w4, zeros, scales_io = unpack_to_in_out(qweight, scales, qzeros, quant_type)
    G = w4.shape[0] // zeros.shape[0]
    z = np.repeat(zeros.astype(np.float32), G, axis=0)
    s = np.repeat(scales_io.astype(np.float32), G, axis=0)
    return (w4.astype(np.float32) - z) * s


def _zeros_scales_in_out(scales: np.ndarray, qzeros: np.ndarray,
                         quant_type: int):
    """(zeros [in/G, out] uint8, scales [in/G, out] float32)."""
    if quant_type == AWQ_GEMM:
        return (_reorder_awq(_unpack_nibbles(qzeros), reverse=True),
                np.asarray(scales, dtype=np.float32))
    if quant_type == AWQ_GEMV:
        n_groups = scales.shape[1]
        return (_unpack_nibbles(qzeros)[:, :n_groups].T,
                np.ascontiguousarray(np.asarray(scales, np.float32).T))
    raise ValueError(f"unknown AWQ quantization type: {quant_type}")


def unpack_to_in_out(qweight: np.ndarray, scales: np.ndarray,
                     qzeros: np.ndarray, quant_type: int = AWQ_GEMM):
    """Normalize either on-disk layout to ``(in, out)`` orientation.

    Returns (w4 [in, out] uint8, zeros [in/G, out] uint8,
    scales [in/G, out] float32).
    """
    zeros, s = _zeros_scales_in_out(scales, qzeros, quant_type)
    if quant_type == AWQ_GEMM:
        return unpack_awq_gemm(qweight), zeros, s
    # GEMV stores (out, in); transpose to (in, out).
    return unpack_awq_gemv(qweight).T, zeros, s


def build_awq_linear(qweight: np.ndarray, scales: np.ndarray,
                     qzeros: np.ndarray, quant_type: int = AWQ_GEMM):
    """Load-time conversion to the unpacked runtime layout.

    Returns ``{"w4": int8 (in, out) holding (q - z), "g_scale": float32
    (in/G, out)}``: AWQ dequantization is exactly ``(q - z) * s`` with q
    and z in [0, 15], so (q - z) fits int8.
    """
    w4, zeros, s = unpack_to_in_out(qweight, scales, qzeros, quant_type)
    G = w4.shape[0] // zeros.shape[0]
    z = np.repeat(zeros, G, axis=0)
    qz = w4.astype(np.int16) - z.astype(np.int16)
    return {"w4": qz.astype(np.int8), "g_scale": s}


def quantize_awq(w: np.ndarray, group_size: int = 128,
                 quant_type: int = AWQ_GEMM):
    """Quantize a float (out, in) weight matrix to the AWQ on-disk layout
    (asymmetric 4-bit per input-dim group, like AutoAWQ's quantizer minus
    the activation-aware scale search).

    Returns (qweight, scales, qzeros) in the requested layout's
    orientation, ready to serialize as weight / weight_scale / weight_zero.
    """
    w_io = np.asarray(w, dtype=np.float32).T  # (in, out)
    K, N = w_io.shape
    if K % group_size:
        raise ValueError(f"in_dim {K} not divisible by group size {group_size}")
    g = w_io.reshape(K // group_size, group_size, N)
    wmax = g.max(axis=1)
    wmin = g.min(axis=1)
    scales = np.maximum((wmax - wmin) / 15.0, 1e-10).astype(np.float32)
    zeros = np.clip(np.rint(-wmin / scales), 0, 15).astype(np.uint8)
    q = np.clip(np.rint(g / scales[:, None, :]) + zeros[:, None, :],
                0, 15).astype(np.uint8)
    w4 = q.reshape(K, N)

    if quant_type == AWQ_GEMM:
        return pack_awq_gemm(w4), scales, pack_awq_gemm(zeros)
    if quant_type == AWQ_GEMV:
        zt = zeros.T  # (out, in/G); pad groups to a multiple of 8 to pack
        pad = (-zt.shape[1]) % 8
        if pad:
            zt = np.pad(zt, ((0, 0), (0, pad)))
        return pack_awq_gemv(w4.T), np.ascontiguousarray(scales.T), pack_awq_gemv(zt)
    raise ValueError(f"unknown AWQ quantization type: {quant_type}")


def build_awq_linear_packed(qweight: np.ndarray, scales: np.ndarray,
                            qzeros: np.ndarray, quant_type: int = AWQ_GEMM):
    """Load-time conversion to the true 4-bit runtime layout.

    The in-dim is split in half and two 4-bit values pack into one byte:
    low nibbles hold rows [0, K/2), high nibbles rows [K/2, K). Zero points
    fold into a per-group term ``zs = z * s`` applied as
    ``- rowsum(x_g) * zs[g]``, so the payload stays unsigned 4-bit.

    Returns {"w4p": int8 view of uint8 [K/2, N], "g_scale": f32 [K/G, N],
    "g_zs": f32 [K/G, N]}.
    """
    w4, zeros, s = unpack_to_in_out(qweight, scales, qzeros, quant_type)
    K = w4.shape[0]
    if K % 2:
        raise ValueError("packed W4 needs an even in-dim")
    lo = w4[: K // 2].astype(np.uint8)
    hi = w4[K // 2:].astype(np.uint8)
    return {
        "w4p": (lo | (hi << 4)).astype(np.uint8).view(np.int8),
        "g_scale": s.astype(np.float32),
        "g_zs": (zeros.astype(np.float32) * s).astype(np.float32),
    }


def unpack_w4p(w4p: np.ndarray):
    """[K/2, N] packed -> [K, N] uint8 values."""
    u = w4p.view(np.uint8)
    return np.concatenate([u & 0x0F, (u >> 4) & 0x0F], axis=0)


# ---------------------------------------------------------------------------
# Device-side load: the nibble unpack and reorder run as torch ops on the
# model's device, so an 8B load moves the raw int32 payloads to the card and
# unpacks them there instead of in strided numpy passes on the host.
# ---------------------------------------------------------------------------


def _torch_unpack_nibbles(packed: torch.Tensor, order=None) -> torch.Tensor:
    """int32 [..., n] -> uint8 [..., n*8]. ``order`` permutes the nibbles of
    each int32 by folding the permutation into the shift amounts. An
    arithmetic shift of a negative int32 fills the high bits with ones; the
    0xF mask keeps only the nibble asked for."""
    shifts = 4 * (np.arange(8) if order is None else np.asarray(order))
    shifts = torch.as_tensor(shifts, dtype=torch.int32, device=packed.device)
    vals = (packed.to(torch.int32)[..., None] >> shifts) & 0xF
    return vals.reshape(packed.shape[:-1] + (-1,)).to(torch.uint8)


def _torch_w4_in_out(qweight: torch.Tensor, quant_type: int) -> torch.Tensor:
    if quant_type == AWQ_GEMM:
        # Unpack and reorder fused: out[j] = (x >> 4*REVERSE_ORDER[j]) & 0xF.
        return _torch_unpack_nibbles(qweight, order=AWQ_REVERSE_ORDER)
    return _torch_unpack_nibbles(qweight).t().contiguous()  # GEMV stores (out, in)


def build_awq_linear_lazy(qweight: np.ndarray, scales: np.ndarray,
                          qzeros: np.ndarray, quant_type: int, packed: bool,
                          device="cpu") -> dict:
    """``build_awq_linear`` / ``build_awq_linear_packed`` with the payload
    unpacked on ``device`` (the JAX package defers the same work to one
    batched device dispatch). The zeros and scales are 1/G of the payload
    and are unpacked on the host, as there. Returns the same dict as torch
    tensors on ``device``."""
    device = torch.device(device)
    zeros, s = _zeros_scales_in_out(scales, qzeros, quant_type)
    qw = to_device(qweight, device)
    w4 = _torch_w4_in_out(qw, quant_type)
    del qw
    g_scale = torch.from_numpy(np.ascontiguousarray(s)).to(device)
    if packed:
        K = w4.shape[0]
        if K % 2:
            raise ValueError("packed W4 needs an even in-dim")
        w4p = (w4[: K // 2] | (w4[K // 2:] << 4)).view(torch.int8)
        zs = zeros.astype(np.float32) * s
        return {"w4p": w4p.contiguous(), "g_scale": g_scale,
                "g_zs": torch.from_numpy(np.ascontiguousarray(zs)).to(device)}
    G = w4.shape[0] // zeros.shape[0]
    z = torch.from_numpy(np.ascontiguousarray(zeros)).to(device)
    z = z.repeat_interleave(G, dim=0)
    qz = (w4.to(torch.int16) - z.to(torch.int16)).to(torch.int8)
    return {"w4": qz, "g_scale": g_scale}
