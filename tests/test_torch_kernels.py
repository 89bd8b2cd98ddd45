"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; those must be
bit-equal to the Pallas kernels run in interpret mode on the same numpy
inputs. test_torch_cuda.py holds the CUDA kernels against the plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctranslate2_tpu.kernels.gather_rows import gather_rows_fused as jgather
from ctranslate2_tpu.kernels.quant_matmul import matmul_w8a8 as jw8a8
from ctranslate2_tpu_torch import kernels
from ctranslate2_tpu_torch.kernels.gather_rows import gather_rows_fused
from ctranslate2_tpu_torch.kernels.quant_matmul import matmul_w8a8
from test_torch_cuda import _gather_inputs, _w8a8_inputs


@pytest.mark.parametrize("M,K,N", [(40, 256, 384), (7, 256, 384), (33, 512, 128)])
def test_w8a8_plain_bit_equal_to_pallas(M, K, N):
    q, wq, a_s, w_s = _w8a8_inputs(M, K, N)
    ref = jw8a8(jnp.asarray(q), jnp.asarray(wq.T), jnp.asarray(a_s),
                jnp.asarray(w_s), interpret=True)
    before = kernels.launch_counts()
    out = matmul_w8a8(*(torch.from_numpy(a) for a in (q, wq, a_s, w_s)))
    assert out.dtype == torch.float32 and out.shape == (M, N)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # The CPU path is the plain version: no kernel launch is counted.
    assert kernels.launch_counts() == before


def test_gather_plain_bit_equal_to_pallas():
    arrays, rows = _gather_inputs()
    ref = jgather([jnp.asarray(a) for a in arrays], jnp.asarray(rows),
                  interpret=True)
    before = kernels.launch_counts()
    out = gather_rows_fused([torch.from_numpy(a) for a in arrays],
                            torch.from_numpy(rows))
    assert kernels.launch_counts() == before
    assert len(out) == len(ref)
    for o, r, a in zip(out, ref, arrays):
        assert o.numpy().dtype == a.dtype
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("bad", ["dtype", "shape", "scale"])
def test_w8a8_rejects_bad_operands(bad):
    q, wq, a_s, w_s = (torch.from_numpy(a) for a in _w8a8_inputs(8, 64, 32))
    if bad == "dtype":
        q = q.float()
    elif bad == "shape":
        wq = wq[:, :32]
    else:
        a_s = a_s[:4]
    with pytest.raises((TypeError, ValueError)):
        matmul_w8a8(q, wq, a_s, w_s)


def test_gather_rejects_int64_rows():
    arrays, rows = _gather_inputs()
    with pytest.raises(TypeError):
        gather_rows_fused([torch.from_numpy(a) for a in arrays],
                          torch.from_numpy(rows.astype(np.int64)))
