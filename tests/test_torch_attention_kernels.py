"""The port's plain versions of the flash, int8-KV decode and norm kernels
against the JAX package's Pallas kernels in interpret mode on the CPU, on
the same numpy inputs.

The CUDA kernels themselves run only on a card (``tests/test_torch_cuda.py``
holds them against these plain versions there); on the CPU every wrapper
takes its plain version, so these tests go through the wrappers.

Tolerances are those of ``tests/test_kernels.py``: float32 sums run in
another order in the two frameworks. Flash: atol 2e-5 / rtol 1e-4; decode
and norm: 1e-5 / 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ctranslate2_tpu.kernels import decode_attention as jax_decode
from ctranslate2_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention)
from ctranslate2_tpu.kernels.norms import fused_norm as jax_fused_norm
from ctranslate2_tpu_torch import kernels
from ctranslate2_tpu_torch.kernels.decode_attention import (
    decode_attention_int8, decode_attention_int8_plain, quantize_kv)
from ctranslate2_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain, flash_head_dim)
from ctranslate2_tpu_torch.models import transformer as TT
from ctranslate2_tpu_torch.kernels.norms import fused_norm, fused_norm_plain

FLASH_CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(),
    "gqa_causal_lengths": dict(Hq=4, Hkv=2, causal=True, lengths=[54, 64]),
    "mqa_ragged": dict(B=1, Hq=4, Hkv=1, Tq=96, Tk=96, lengths=[86]),
    "ragged_edges": dict(Tq=50, Tk=77, lengths=[77, 31]),
    "q_offset": dict(B=1, Tq=32, Tk=64, causal=True, q_offset=32),
    "window": dict(causal=True, window=16, lengths=[54, 64]),
    "segments": dict(Tq=256, Tk=256, causal=True, segments=True,
                     block=128),
    "alibi_negative": dict(B=1, Hq=4, Hkv=4, causal=True, alibi=True,
                           alibi_positive=False),
    "alibi_positive": dict(B=1, Hq=4, Hkv=4, causal=True, alibi=True,
                           alibi_positive=True),
    "t5_bidirectional": dict(Hq=4, Hkv=4, rel=True, rel_bidirectional=True),
    "t5_causal": dict(Hq=4, Hkv=4, causal=True, rel=True,
                      rel_bidirectional=False),
    "head_dim_64": dict(D=64, causal=True),  # unpadded here, padded in Pallas
    "head_dim_256": dict(D=256, Hq=4, Hkv=2, causal=True, lengths=[54, 64]),
    "masked_row": dict(lengths=[0, 64]),
}


def _flash_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv = case.get("B", 2), case.get("Hq", 2), case.get("Hkv", 2)
    Tq, Tk, D = case.get("Tq", 64), case.get("Tk", 64), case.get("D", 32)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    kw = dict(scale=float(D) ** -0.5, causal=case.get("causal", False),
              q_offset=case.get("q_offset", 0), window=case.get("window", 0))
    arrays = {}
    if "lengths" in case:
        arrays["lengths"] = np.asarray(case["lengths"], np.int32)
    if case.get("segments"):
        arrays["segment_ids"] = np.asarray([[0] * 160 + [1] * 96] * B, np.int32)
    if case.get("alibi"):
        arrays["alibi_slopes"] = (0.5 ** np.arange(1, Hq + 1)).astype(np.float32)
        kw["alibi_positive"] = case["alibi_positive"]
    if case.get("rel"):
        # 12 buckets and a max distance of 50 put no integer distance on a
        # bucket boundary, where the two frameworks' logs could part.
        arrays["rel_bias_table"] = rng.standard_normal((12, Hq)).astype(np.float32)
        kw["rel_max_distance"] = 50
        kw["rel_bidirectional"] = case["rel_bidirectional"]
    return (q, k, v), kw, arrays


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_interpret(case):
    spec = FLASH_CASES[case]
    (q, k, v), kw, arrays = _flash_inputs(spec)
    block = spec.get("block", 32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
            block_k=block, **kw, **{n: jnp.asarray(a) for n, a in arrays.items()})
    before = kernels.launch_counts()["flash_attention"]
    out = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw,
        **{n: torch.from_numpy(a) for n, a in arrays.items()})
    # A CPU tensor takes the plain version and counts no launch.
    assert kernels.launch_counts()["flash_attention"] == before
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    if case == "masked_row":
        assert np.all(out.numpy()[0] == 0.0)


def test_flash_plain_rounds_weights_to_values_dtype():
    (q, k, v), kw, _ = _flash_inputs(dict(causal=True))
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = flash_attention_plain(*t, **kw)
    ref = flash_attention_plain(*[a.float() for a in t], **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


@pytest.mark.parametrize("D,expected", [(16, 64), (32, 64), (64, 64), (80, 128),
                                        (96, 128), (112, 128), (128, 128),
                                        (160, 256), (192, 256), (256, 256)])
def test_flash_head_dim_pads_to_the_next_instance(D, expected):
    assert flash_head_dim(D) == expected


@pytest.mark.parametrize("D", [257, 320, 512])
def test_flash_head_dim_raises_above_256(D):
    with pytest.raises(NotImplementedError, match="up to 256"):
        flash_head_dim(D)


def _padded_plain(q, k, v, **kw):
    """What the card runs for a head dim off 64/128/256: q, k and v zero-padded
    to ``flash_head_dim``, the caller's scale, the output sliced back."""
    D = q.shape[-1]
    Dk = flash_head_dim(D)
    pad = [torch.nn.functional.pad(t, (0, Dk - D)) for t in (q, k, v)]
    return flash_attention_plain(*pad, **kw)[..., :D]


@pytest.mark.parametrize("case", [dict(D=80, causal=True),
                                  dict(D=96, Hq=4, Hkv=2, lengths=[54, 64]),
                                  dict(D=32, Hq=4, Hkv=1, causal=True, window=16),
                                  dict(D=112, Tq=50, Tk=77, lengths=[77, 31]),
                                  dict(D=160, causal=True, window=16),
                                  dict(D=192, Hq=4, Hkv=2, lengths=[54, 64])])
def test_flash_plain_on_padded_head_dim_equals_unpadded(case):
    """Zero columns add exact zeros to Q.K^T and produce zero output columns;
    the CPU matmul may block a longer sum differently, hence 1e-6."""
    (q, k, v), kw, arrays = _flash_inputs(case)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    extra = {n: torch.from_numpy(a) for n, a in arrays.items()}
    out = _padded_plain(*t, **kw, **extra)
    ref = flash_attention_plain(*t, **kw, **extra)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_head_dim_80_matches_pallas_interpret(causal):
    """The padded plain version at D = 80 against the JAX kernel (which pads
    to 128 itself) in interpret mode; tolerance as the other flash cases."""
    _check_padded_against_pallas(80, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_padded_head_dim_192_matches_pallas_interpret(causal):
    """D = 192 runs padded to the 256 instance on the card; the JAX kernel
    pads it to 256 as well."""
    _check_padded_against_pallas(192, causal)


def _check_padded_against_pallas(D, causal):
    (q, k, v), kw, arrays = _flash_inputs(dict(D=D, Hq=4, Hkv=2, causal=causal,
                                               lengths=[54, 64]))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_k=32,
            **kw, **{n: jnp.asarray(a) for n, a in arrays.items()})
    out = _padded_plain(*[torch.from_numpy(a) for a in (q, k, v)], **kw,
                        **{n: torch.from_numpy(a) for n, a in arrays.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_flash_eligibility_does_not_depend_on_head_dim():
    """Up to the kernel's widest instance, ``_flash_eligible`` decides from
    the lengths and switches alone: a head dim the kernel pads changes
    nothing (wider heads take the plain attention:
    tests/test_torch_kernel_plans.py)."""
    class Card:  # stands in for a CUDA tensor: only is_cuda and shape are read
        is_cuda = True

        def __init__(self, T, D):
            self.shape = (1, 8, T, D)

    for T in (2047, 2048, 4096):
        decisions = {TT._flash_eligible(Card(T, D), Card(T, D))
                     for D in (16, 32, 64, 80, 96, 128, 256)}
        assert decisions == {T >= 2048}


DECODE_CASES = {
    "ragged": dict(lengths=[70, 17, 1]),
    "gqa_c_not_block_multiple": dict(Hq=8, Hkv=2, C=70, lengths=[70, 33, 5]),
    "mqa": dict(Hq=4, Hkv=1, lengths=[64, 40, 9]),
    "head_dim_64": dict(D=64, lengths=[96, 50, 2]),
    # The card's kernel takes any D up to 256: 256 (16 lanes a key), and
    # widths off a multiple of 16, whose rows start anywhere in a chunk.
    "head_dim_256": dict(D=256, lengths=[96, 41, 0]),
    "head_dim_72": dict(Hq=8, Hkv=2, C=70, D=72, lengths=[70, 33, 5]),
    "head_dim_200": dict(Hq=4, Hkv=1, D=200, lengths=[64, 0, 9]),
}


def _decode_inputs(case, fresh, seed=0):
    rng = np.random.default_rng(seed)
    Hq, Hkv = case.get("Hq", 4), case.get("Hkv", 2)
    C, D = case.get("C", 96), case.get("D", 32)
    lengths = np.asarray(case["lengths"], np.int32)
    B = len(lengths)
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    k8, ks = quantize_kv(torch.from_numpy(
        rng.standard_normal((B, Hkv, C, D)).astype(np.float32)))
    v8, vs = quantize_kv(torch.from_numpy(
        rng.standard_normal((B, Hkv, C, D)).astype(np.float32)))
    args = [q, k8.numpy(), ks.numpy(), v8.numpy(), vs.numpy(), lengths]
    kw = {}
    if fresh:
        kn, kns = quantize_kv(torch.from_numpy(
            rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)))
        vn, vns = quantize_kv(torch.from_numpy(
            rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)))
        kw = dict(k_new8=kn.numpy(), kn_scale=kns.numpy(), v_new8=vn.numpy(),
                  vn_scale=vns.numpy())
    return args, kw, float(D) ** -0.5


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("window", [0, 1, 7])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_pallas_interpret(case, window, fresh):
    args, kw, scale = _decode_inputs(DECODE_CASES[case], fresh)
    ref = jax_decode.decode_attention_int8(
        *[jnp.asarray(a) for a in args], scale=scale, window=window,
        block_c=32, interpret=True, **{n: jnp.asarray(a) for n, a in kw.items()})
    before = kernels.launch_counts()["decode_attention_int8"]
    out = decode_attention_int8(
        *[torch.from_numpy(a) for a in args], scale=scale, window=window,
        **{n: torch.from_numpy(a) for n, a in kw.items()})
    assert kernels.launch_counts()["decode_attention_int8"] == before
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_decode_plain_without_any_key_gives_zeros():
    args, _, scale = _decode_inputs(dict(lengths=[0, 3]), fresh=False)
    out = decode_attention_int8_plain(*[torch.from_numpy(a) for a in args],
                                      scale=scale)
    assert torch.all(out[0] == 0) and torch.any(out[1] != 0)


@pytest.mark.parametrize("shape", [(5, 8, 16, 32), (3, 1, 64), (2, 7, 24)])
def test_quantize_kv_bit_equal_to_jax(shape):
    rng = np.random.default_rng(4)
    # Multiples of 1/64 up to 127/64 in magnitude, with 127/64 in every
    # vector: the scale is exactly 64 and no value sits on a half step.
    x = rng.integers(-126, 127, shape).astype(np.float32) / 64.0
    x[..., 0] = 127.0 / 64.0
    x[0, ..., :] = 0.0  # zero vectors take scale 1
    q_ref, s_ref = jax_decode.quantize_kv(jnp.asarray(x))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    # Random values too: the scale is one IEEE division in both frameworks.
    y = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        quantize_kv(torch.from_numpy(y))[1].numpy(),
        np.asarray(jax_decode.quantize_kv(jnp.asarray(y))[1]))


@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("shape", [(3, 5, 128), (16, 256), (13, 384)])
def test_norm_plain_matches_pallas_interpret(shape, layer_norm):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = rng.standard_normal(shape[-1]).astype(np.float32)
    beta = rng.standard_normal(shape[-1]).astype(np.float32) if layer_norm else None
    ref = jax_fused_norm(jnp.asarray(x), jnp.asarray(gamma),
                         None if beta is None else jnp.asarray(beta),
                         eps=1e-5, interpret=True)
    before = kernels.launch_counts()["fused_norm"]
    out = fused_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                     None if beta is None else torch.from_numpy(beta), eps=1e-5)
    assert kernels.launch_counts()["fused_norm"] == before
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    plain = fused_norm_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                             None if beta is None else torch.from_numpy(beta),
                             eps=1e-5)
    assert torch.equal(out, plain)
