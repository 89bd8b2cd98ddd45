"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests import neither JAX nor the JAX package, so they run where only
PyTorch with CUDA is installed. On a machine with an H100, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.) Without a
card every test skips. W8A8 must be bit-equal to its plain version (the
int32 sum is exact and the epilogue is the same two IEEE f32 operations);
the gather must be equal.
"""

import numpy as np
import pytest
import torch

from ctranslate2_tpu_torch import kernels
from ctranslate2_tpu_torch.kernels.gather_rows import (
    gather_rows_fused, gather_rows_plain)
from ctranslate2_tpu_torch.kernels.quant_matmul import (
    matmul_w8a8, matmul_w8a8_plain)


def _w8a8_inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, (M, K)).astype(np.int8)
    q[M // 2] = 0
    wq = rng.integers(-127, 128, (N, K)).astype(np.int8)
    a_s = (rng.random(M) * 5 + 0.5).astype(np.float32)
    a_s[M // 3] = 0.0
    w_s = (rng.random(N) * 5 + 0.5).astype(np.float32)
    return q, wq, a_s, w_s


def _gather_inputs(seed=0):
    rng = np.random.default_rng(seed)
    N = 6
    arrays = [
        rng.standard_normal((N, 2, 8, 4)).astype(np.float32),
        rng.integers(-128, 128, (N, 3, 16)).astype(np.int8),
        rng.standard_normal((N, 5)).astype(np.float16),
        rng.integers(0, 1000, (N, 7)).astype(np.int32),
    ]
    rows = np.array([2, 2, 0, 5, 1, 2], np.int32)
    return arrays, rows


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(40, 256, 384), (128, 512, 32000),
                                   (7, 100, 50), (2048, 2048, 512)])
def test_w8a8_kernel_bit_equal_to_plain_on_card(M, K, N):
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(M, K, N)]
    before = kernels.launch_counts()["matmul_w8a8"]
    out = matmul_w8a8(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["matmul_w8a8"] == before + 1
    assert torch.equal(out, matmul_w8a8_plain(*args))


@pytest.mark.cuda
def test_gather_kernel_equal_to_plain_on_card():
    dev = _card()
    arrays, rows = _gather_inputs()
    arrays = [torch.from_numpy(a).to(dev) for a in arrays]
    arrays.append(torch.randn(6, 8, 64, 64, device=dev, dtype=torch.float16))
    rows = torch.from_numpy(rows).to(dev)
    out = gather_rows_fused(arrays, rows)
    torch.cuda.synchronize()
    for o, r in zip(out, gather_rows_plain(arrays, rows)):
        assert torch.equal(o, r)
