"""Fused multi-array batch-row gather (the beam-reorder kernel).

Counterpart of ``ctranslate2_tpu/kernels/gather_rows.py::gather_rows_fused``.
The CUDA kernel is ``csrc/gather_rows.cu``: one launch copies the selected
rows of every array, out of place.
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch
from . import build


def _lib() -> ctypes.CDLL:
    lib = build.load("gather_rows")
    if not lib.ct2_gather_rows.argtypes:
        lib.ct2_gather_max_arrays.argtypes = []
        lib.ct2_gather_max_arrays.restype = ctypes.c_int
        lib.ct2_gather_rows.restype = ctypes.c_int
        lib.ct2_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def gather_rows_plain(arrays, rows):
    """Plain PyTorch version."""
    return [a.index_select(0, rows) for a in arrays]


def gather_rows_fused(arrays, rows):
    """Returns ``[a[rows] for a in arrays]``. Every array has the batch on
    axis 0 and ``rows`` (int32 [N]) selects N of its rows; dtypes and the
    other dimensions may differ between arrays."""
    arrays = list(arrays)
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError("gather_rows_fused takes int32 rows [N]")
    devices = {a.device for a in arrays} | {rows.device}
    if len(devices) != 1:
        raise ValueError(
            f"gather_rows_fused operands lie on {sorted(map(str, devices))}")
    device = rows.device
    if device.type == "cpu":
        return gather_rows_plain(arrays, rows)
    if device.type != "cuda":
        raise ValueError(f"gather_rows_fused has no kernel for {device}")
    if not arrays:
        return []
    for a in arrays:
        if not a.is_contiguous() or a.dim() < 1:
            raise ValueError("gather_rows_fused takes contiguous arrays")
    n = rows.shape[0]
    outs = [torch.empty((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=device) for a in arrays]
    lib = _lib()
    max_arrays = lib.ct2_gather_max_arrays()
    if len(arrays) > max_arrays:
        raise ValueError(f"gather_rows_fused takes at most {max_arrays} "
                         f"arrays per launch, got {len(arrays)}")
    count = len(arrays)
    table = (ctypes.c_longlong * count)
    srcs = table(*[a.data_ptr() for a in arrays])
    dsts = table(*[o.data_ptr() for o in outs])
    nbytes = table(*[a[0].numel() * a.element_size() if a.shape[0] else 0
                     for a in arrays])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ct2_gather_rows(srcs, dsts, nbytes, count,
                                  rows.data_ptr(), n, stream)
    if err:
        raise RuntimeError(f"gather_rows launch failed with CUDA error {err}")
    count_launch("gather_rows_fused")
    return outs
