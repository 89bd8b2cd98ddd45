"""1-D convolution (the speech frontends).

Port of ``ctranslate2_tpu/ops/conv.py``, which matches the reference's
ops::Conv1D (reference: src/ops/conv1d.cc, src/ops/conv1d_cpu.cc): input
[B, C_in, T], weight [C_out, C_in/groups, K], optional bias,
stride/padding/dilation/groups. The JAX package runs it through
``lax.conv_general_dilated``, not a Pallas kernel; the port runs the
library convolution in float32 (IEEE on the card, not TF32) and casts
back, as the JAX op does.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F


_CUDNN_FLAGS = threading.Lock()


@contextlib.contextmanager
def _ieee_float32(x):
    """On the card, cuDNN's convolutions in IEEE float32 for the call (its
    default takes TF32, 1e-3 off): the convolution is float32, as the JAX
    package's is. cuDNN's flags are process-wide: one call at a time sets
    and restores them."""
    if not x.is_cuda:
        yield
        return
    b = torch.backends.cudnn
    with _CUDNN_FLAGS:
        allow = b.allow_tf32
        b.allow_tf32 = False
        try:
            yield
        finally:
            b.allow_tf32 = allow


def conv1d(
    x,  # [B, C_in, T]
    weight,  # [C_out, C_in/groups, K]
    bias=None,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
    activation: Optional[Callable] = None,
):
    with _ieee_float32(x):
        out = F.conv1d(x.float(), weight.float(), None, stride=stride,
                       padding=padding, dilation=dilation, groups=groups)
    if bias is not None:
        out = out + bias.float()[None, :, None]
    if activation is not None:
        out = activation(out)
    return out.to(x.dtype)
