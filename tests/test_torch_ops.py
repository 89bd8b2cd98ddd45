"""The port's ops against the JAX package's, on the same numpy inputs.

Tolerance: float32 atol/rtol 1e-5 (the two frameworks sum in different
orders); int8 quantized values must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ctranslate2_tpu.decoding import processors as jproc
from ctranslate2_tpu.decoding.sampling import small_top_k as jsmall_top_k
from ctranslate2_tpu.ops import attention as jattn
from ctranslate2_tpu.ops import linear as jlin
from ctranslate2_tpu.ops import norms as jnorms
from ctranslate2_tpu.ops import positions as jpos
from ctranslate2_tpu.ops.activations import get_activation as jact
from ctranslate2_tpu_torch.decoding import processors as tproc
from ctranslate2_tpu_torch.decoding.sampling import small_top_k as tsmall_top_k
from ctranslate2_tpu_torch.ops import attention as tattn
from ctranslate2_tpu_torch.ops import linear as tlin
from ctranslate2_tpu_torch.ops import norms as tnorms
from ctranslate2_tpu_torch.ops import positions as tpos
from ctranslate2_tpu_torch.ops.activations import get_activation as tact

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


def test_quantize_per_row_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 96)).astype(np.float32)
    x[1, 2] = 0.0  # all-zero row: scale 1
    x[0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # exact halves round to even
    qj, sj = jlin.quantize_per_row(jnp.asarray(x))
    qt, st = tlin.quantize_per_row(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _linear_params(rng, K, N, kind):
    w = (rng.standard_normal((N, K)) * 0.1).astype(np.float32)  # (out, in)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    if kind == "float":
        return ({"w": jnp.asarray(w.T), "b": jnp.asarray(b)},
                {"w": torch.from_numpy(np.ascontiguousarray(w.T)),
                 "b": torch.from_numpy(b)})
    amax = np.abs(w).max(axis=1)
    scale = (127.0 / amax).astype(np.float32)
    q = np.clip(np.rint(w * scale[:, None]), -127, 127).astype(np.int8)
    return ({"wq": jnp.asarray(q.T), "scale": jnp.asarray(scale), "b": jnp.asarray(b)},
            {"wq": torch.from_numpy(q), "scale": torch.from_numpy(scale),
             "b": torch.from_numpy(b)})


@pytest.mark.parametrize("kind,quantize", [
    ("float", True), ("int8", True), ("int8", False)])
@pytest.mark.parametrize("epilogue", ["plain", "relu_residual"])
def test_linear_matches(kind, quantize, epilogue):
    rng = np.random.default_rng(1)
    K, N = 128, 256
    x = rng.standard_normal((3, 5, K)).astype(np.float32)
    res = rng.standard_normal((3, 5, N)).astype(np.float32)
    jp, tp = _linear_params(rng, K, N, kind)
    kw_j, kw_t = {}, {}
    if epilogue == "relu_residual":
        kw_j = dict(activation=jact("relu"), residual=jnp.asarray(res))
        kw_t = dict(activation=tact("relu"), residual=torch.from_numpy(res))
    yj = jlin.linear(jp, jnp.asarray(x), quantize_activations=quantize, **kw_j)
    yt = tlin.linear(tp, torch.from_numpy(x), quantize_activations=quantize, **kw_t)
    assert yt.dtype == torch.float32 and yt.shape == (3, 5, N)
    _close(yt, yj)


def test_linear_awq_raises():
    with pytest.raises(NotImplementedError):
        tlin.linear({"w4": torch.zeros(4, 4)}, torch.zeros(1, 4))


@pytest.mark.parametrize("beta", [True, False])
def test_norms_match(beta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3, 64)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(64).astype(np.float32)
    p = {"gamma": g}
    if beta:
        p["beta"] = rng.standard_normal(64).astype(np.float32)
    yj = jnorms.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), 1e-5)
    yt = tnorms.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), 1e-5)
    _close(yt, yj)


@pytest.mark.parametrize("name", ["relu", "gelu_tanh", "swish", "gelu",
                                  "gelu_sigmoid", "tanh", "sigmoid"])
def test_activations_match(name):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    _close(tact(name)(torch.from_numpy(x)), jact(name)(jnp.asarray(x)))


def test_sinusoidal_table_equal():
    np.testing.assert_array_equal(tpos.sinusoidal_position_encoding(77, 64),
                                  jpos.sinusoidal_position_encoding(77, 64))


def _qkv(rng, B, Hq, Hkv, T, C, D):
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, C, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, C, D)).astype(np.float32)
    return q, k, v


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("Hkv", [4, 2])
def test_dot_product_attention_matches(Hkv):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 4, Hkv, 6, 9, 16)
    lengths = np.array([9, 5], np.int64)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    jb = jattn.combine_bias(jattn.causal_mask_bias(6, 9, offset=3),
                            jattn.length_mask_bias(jnp.asarray(lengths), 9))
    tb = tattn.combine_bias(tattn.causal_mask_bias(6, 9, offset=3),
                            tattn.length_mask_bias(torch.from_numpy(lengths), 9))
    _close(tb, jb)
    _close(tattn.dot_product_attention(tq, tk, tv, bias=tb, queries_scale=0.25),
           jattn.dot_product_attention(jq, jk, jv, bias=jb, queries_scale=0.25))


def test_split_combine_heads_match():
    x = np.arange(2 * 3 * 12, dtype=np.float32).reshape(2, 3, 12)
    s = tattn.split_heads(torch.from_numpy(x), 4)
    _close(s, jattn.split_heads(jnp.asarray(x), 4))
    _close(tattn.combine_heads(s), x)


@pytest.mark.parametrize("chunked", [False, True])
def test_decode_step_attention_matches(chunked):
    rng = np.random.default_rng(4)
    C, pos = 64, 37
    q, k, v = _qkv(rng, 3, 4, 2, 1, C, 16)
    kn, vn = (rng.standard_normal((3, 2, 1, 16)).astype(np.float32) for _ in range(2))
    (jq, jk, jv, jkn, jvn), (tq, tk, tv, tkn, tvn) = _both(q, k, v, kn, vn)
    if chunked:
        yj = jattn.chunked_decode_attention(jq, jk, jv, jkn, jvn, pos,
                                            queries_scale=0.3, chunk=16)
        yt = tattn.chunked_decode_attention(tq, tk, tv, tkn, tvn, pos,
                                            queries_scale=0.3, chunk=16)
    else:
        yj = jattn.decode_step_attention(
            jq, jk, jv, jkn, jvn, pos, queries_scale=0.3,
            bias=jattn.causal_mask_bias(1, C, offset=pos))
        yt = tattn.decode_step_attention(
            tq, tk, tv, tkn, tvn, pos, queries_scale=0.3,
            bias=tattn.causal_mask_bias(1, C, offset=pos))
    _close(yt, yj)


@pytest.mark.parametrize("chunked", [False, True])
def test_beam_chain_attention_matches(chunked):
    rng = np.random.default_rng(5)
    B, K, C, pos = 2, 3, 64, 21
    N = B * K
    q, k, v = _qkv(rng, N, 4, 2, 1, C, 16)
    kn, vn = (rng.standard_normal((N, 2, 1, 16)).astype(np.float32) for _ in range(2))
    chain = rng.integers(0, K, (N, C)).astype(np.int32)
    chain[:, pos:] = -1
    (jq, jk, jv, jkn, jvn, jch), (tq, tk, tv, tkn, tvn, tch) = _both(
        q, k, v, kn, vn, chain)
    if chunked:
        yj = jattn.chunked_beam_chain_attention(
            jq, jk, jv, jch, jkn, jvn, pos, beam_size=K, queries_scale=0.3, chunk=16)
        yt = tattn.chunked_beam_chain_attention(
            tq, tk, tv, tch, tkn, tvn, pos, beam_size=K, queries_scale=0.3, chunk=16)
    else:
        yj = jattn.beam_chain_attention(
            jq, jk, jv, jch, beam_size=K, queries_scale=0.3,
            bias=jattn.causal_mask_bias(1, C, offset=pos), k_new=jkn, v_new=jvn)
        yt = tattn.beam_chain_attention(
            tq, tk, tv, tch, beam_size=K, queries_scale=0.3,
            bias=tattn.causal_mask_bias(1, C, offset=pos), k_new=tkn, v_new=tvn)
    _close(yt, yj)


@pytest.mark.parametrize("V", [50, 1200])
def test_small_top_k_matches_with_ties(V):
    rng = np.random.default_rng(6)
    x = np.round(rng.standard_normal((4, V)), 1).astype(np.float32)  # many ties
    x[:, 7] = x[:, 3] = x.max() + 1  # a tie at the top: lowest index first
    vj, ij = jsmall_top_k(jnp.asarray(x), 6)
    vt, it = tsmall_top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_processors_match():
    rng = np.random.default_rng(7)
    N, V, L, step = 4, 32, 10, 7
    logits = rng.standard_normal((N, V)).astype(np.float32)
    hist = rng.integers(0, 6, (N, L)).astype(np.int64)
    cond = np.array([True, False, True, False])
    (jl, jh, jc), (tl, th, tc) = _both(logits, hist, cond)
    pairs = [
        (jproc.disable_tokens(jl, (1, 5)), tproc.disable_tokens(tl, (1, 5))),
        (jproc.disable_tokens_if(jl, (2,), jc), tproc.disable_tokens_if(tl, (2,), tc)),
        (jproc.repetition_penalty(jl, jh, step, 1.3),
         tproc.repetition_penalty(tl, th, step, 1.3)),
        (jproc.no_repeat_ngram(jl, jh, step, 2), tproc.no_repeat_ngram(tl, th, step, 2)),
        (jproc.suppress_sequences_mask(jl, jh, step, ((3,), (1, 4), (2, 0, 5))),
         tproc.suppress_sequences_mask(tl, th, step, ((3,), (1, 4), (2, 0, 5)))),
    ]
    for j, t in pairs:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
