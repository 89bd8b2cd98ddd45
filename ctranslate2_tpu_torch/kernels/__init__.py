"""Hand-written CUDA kernels for Hopper and their launch counters.

Each kernel module holds a wrapper and its plain PyTorch version. The
wrapper takes the plain version only for tensors that lie on the CPU; for a
CUDA tensor it launches the kernel or raises. Every launch adds one to the
wrapper's entry in ``LAUNCHES``, so a run can show which kernels it went
through.
"""

from __future__ import annotations

import threading
from typing import Dict

LAUNCHES: Dict[str, int] = {
    "matmul_w8a8": 0, "gather_rows_fused": 0, "flash_attention": 0,
    "decode_attention_int8": 0, "fused_norm": 0, "matmul_w4a16": 0,
    "matmul_w4p": 0, "matmul_w4a16_fold": 0, "matmul_w4p_fold": 0}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` (called right after it launched)."""
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(LAUNCHES)
