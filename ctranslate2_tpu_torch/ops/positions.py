"""Positional encodings: sinusoidal tables and rotary embeddings.

The sinusoidal table matches the reference's OpenNMT convention (reference:
src/layers/common.cc:203-236): timescale increment
``log(10000)/(depth/2 - 1)``, positions start at 1 (``(i + 1) * ts``),
layout ``concat([sin, cos], -1)``.

Rotary tables match reference: src/layers/attention_layer.cc:177-343,
including Linear / Su / Llama3 scaling and the Su long-context
attention-scale factor. The tables and the ALiBi slopes are built with
numpy, exactly as the JAX package builds them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def sinusoidal_position_encoding(max_time: int, depth: int) -> np.ndarray:
    """[max_time, depth] table; row t encodes position t+1."""
    half = depth // 2
    increment = math.log(10000.0) / (half - 1)
    timescales = np.exp(-increment * np.arange(half, dtype=np.float32))
    scaled = (np.arange(1, max_time + 1, dtype=np.float32)[:, None]) * timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=-1).astype(np.float32)


def rotary_tables(
    num_positions: int,
    dim: int,
    base: float = 10000.0,
    interleave: bool = True,
    scaling_type: Optional[str] = None,  # None | "linear" | "su" | "llama3"
    scaling_factor: float = 1.0,
    long_factor: Optional[np.ndarray] = None,
    short_factor: Optional[np.ndarray] = None,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position_embeddings: int = 0,
    max_position_embeddings: int = 0,
):
    """Build (sin, cos) tables of shape [num_positions, dim]."""
    half = dim // 2
    exponents = np.arange(half, dtype=np.float32) * 2.0 / dim

    if scaling_type == "su":
        use_long = (
            original_max_position_embeddings
            and num_positions > original_max_position_embeddings
        )
        factor = np.asarray(long_factor if use_long else short_factor, dtype=np.float32)
        inv_freq = 1.0 / (factor * np.power(base, exponents))
    else:
        inv_freq = 1.0 / np.power(base, exponents)
        if scaling_type == "llama3":
            old_len = float(original_max_position_embeddings)
            low_wavelen = old_len / low_freq_factor
            high_wavelen = old_len / high_freq_factor
            wavelen = 2.0 * math.pi / inv_freq
            smooth = (old_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
            smoothed = (1.0 - smooth) * inv_freq / scaling_factor + smooth * inv_freq
            inv_freq = np.where(
                wavelen < high_wavelen,
                inv_freq,
                np.where(wavelen > low_wavelen, inv_freq / scaling_factor, smoothed),
            )

    t = np.arange(num_positions, dtype=np.float32)
    if scaling_type == "linear":
        t = t / scaling_factor
    freqs = t[:, None] * inv_freq[None, :]  # [P, half]

    if interleave:
        # [f0, f0, f1, f1, ...]
        emb = np.repeat(freqs, 2, axis=-1)
    else:
        # [f0..f_half, f0..f_half]
        emb = np.concatenate([freqs, freqs], axis=-1)

    sin = np.sin(emb)
    cos = np.cos(emb)

    if (
        original_max_position_embeddings
        and max_position_embeddings
        and scaling_type != "llama3"
    ):
        scale = max_position_embeddings / original_max_position_embeddings
        if scale > 1:
            att = math.sqrt(1.0 + math.log(scale) / math.log(original_max_position_embeddings))
            sin = sin * att
            cos = cos * att

    return sin.astype(np.float32), cos.astype(np.float32)


def apply_rotary(x, sin, cos, interleave: bool, rotary_dim: int = 0):
    """Apply rotary embedding to x [..., T, D].

    ``sin``/``cos`` are [T, rotary_dim] slices aligned with x's time axis.
    Matches reference: src/ops/rotary_cpu.cc semantics: interleave rotates
    (even, odd) pairs; non-interleave rotates (first-half, second-half).
    """
    dim = rotary_dim or x.shape[-1]
    xr32 = x[..., :dim].float()
    rest = x[..., dim:]
    sin = sin.float()
    cos = cos.float()

    if interleave:
        x_even = xr32[..., 0::2]
        x_odd = xr32[..., 1::2]
        rotated = torch.stack([-x_odd, x_even], dim=-1).reshape(xr32.shape)
    else:
        half = dim // 2
        rotated = torch.cat([-xr32[..., half:], xr32[..., :half]], dim=-1)

    out = (xr32 * cos + rotated * sin).to(x.dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (power-of-2 law)."""
    closest_pow2 = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest_pow2) - 3)))
    slopes = [base ** (i + 1) for i in range(closest_pow2)]
    if closest_pow2 != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest_pow2) - 3)))
        slopes += [extra_base ** (i + 1)
                   for i in range(0, 2 * (num_heads - closest_pow2), 2)]
    return np.asarray(slopes, dtype=np.float32)
