"""Positional encodings: the sinusoidal table.

Matches the reference's OpenNMT convention (reference:
src/layers/common.cc:203-236): timescale increment
``log(10000)/(depth/2 - 1)``, positions start at 1 (``(i + 1) * ts``),
layout ``concat([sin, cos], -1)``. Rotary and ALiBi tables are not ported
yet.
"""

from __future__ import annotations

import math

import numpy as np


def sinusoidal_position_encoding(max_time: int, depth: int) -> np.ndarray:
    """[max_time, depth] table; row t encodes position t+1."""
    half = depth // 2
    increment = math.log(10000.0) / (half - 1)
    timescales = np.exp(-increment * np.arange(half, dtype=np.float32))
    scaled = (np.arange(1, max_time + 1, dtype=np.float32)[:, None]) * timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=-1).astype(np.float32)
