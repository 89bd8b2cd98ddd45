"""The CUDA kernels against their plain PyTorch versions, on the card, and
the Generator on the card against the Generator on the CPU.

These tests import neither JAX nor the JAX package, so they run where only
PyTorch with CUDA is installed. On a machine with an H100, from the
repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.) Without a
card every test skips. W8A8 must be bit-equal to its plain version on both
of its paths (split-K and wgmma; the int32 sum is exact in any order and the
epilogue is the same two IEEE f32 operations);
the gather must be equal. The flash, int8-KV decode, norm and W4 kernels
sum floats in another order than their plain versions and are held to the
tolerances below.
"""

import numpy as np
import pytest
import torch

import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch import kernels
from ctranslate2_tpu_torch.converters.builder import build_decoder_only_model
from ctranslate2_tpu_torch.kernels.decode_attention import (
    decode_attention_int8, decode_attention_int8_plain, quantize_kv)
from ctranslate2_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from ctranslate2_tpu_torch.kernels.gather_rows import (
    gather_rows_fused, gather_rows_plain)
from ctranslate2_tpu_torch.kernels.norms import fused_norm, fused_norm_plain
from ctranslate2_tpu_torch.kernels import quant_matmul as qm
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


W4_KERNELS = {  # name: (wrapper, plain version, packed payload, folded scale)
    "matmul_w4a16": (qm.matmul_w4a16, qm.matmul_w4a16_plain, False, False),
    "matmul_w4a16_fold": (qm.matmul_w4a16_fold, qm.matmul_w4a16_fold_plain, False, True),
    "matmul_w4p": (qm.matmul_w4p, qm.matmul_w4p_plain, True, False),
    "matmul_w4p_fold": (qm.matmul_w4p_fold, qm.matmul_w4p_fold_plain, True, True),
}


def _w4_inputs(M, K, N, G, packed, seed=0):
    """x float32 [M, K]; the payload (``w4`` q - z in [-15, 15] [K, N], or
    ``w4p`` nibbles [K/2, N]); f32 group scales and, packed, zero * scale
    terms [K/G, N] (None unpacked)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    gs = (rng.random((K // G, N)) * 0.1 + 0.01).astype(np.float32)
    if not packed:
        return x, rng.integers(-15, 16, (K, N)).astype(np.int8), gs, None
    q = rng.integers(0, 16, (K, N)).astype(np.uint8)
    w4p = (q[:K // 2] | (q[K // 2:] << 4)).view(np.int8)
    zs = (rng.integers(0, 16, (K // G, N)) * gs).astype(np.float32)
    return x, w4p, gs, zs


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


# (K, N) of the int8 linears on the main paths: the Generator at
# Llama-3-8B's widths and the Translator at Transformer-base's.
W8A8_MAIN_KN = [(4096, 6144), (4096, 4096), (4096, 14336), (14336, 4096),
                (4096, 128256), (512, 1536), (512, 512), (512, 2048),
                (2048, 512), (512, 32000)]
W8A8_MS = [1, 4, 8, 9, 16, 64, 65, 128, 300, 2048, 8192]
# Both paths at every main-path (K, N), every M; the vocabulary projection
# only where a main path runs it (decode rows).
W8A8_CASES = [(M, K, N) for M in W8A8_MS for K, N in W8A8_MAIN_KN
              if N != 128256 or M <= 300]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", W8A8_CASES)
def test_w8a8_paths_bit_equal_to_plain_on_card(M, K, N):
    """The split-K and wgmma paths, each at the split count ``w8a8_plan``
    gives this shape, bit-equal to the plain version."""
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(M, K, N, seed=M + K + N)]
    plan = qm.w8a8_plan(M, N, K)
    before = kernels.launch_counts()["matmul_w8a8"]
    out = matmul_w8a8(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["matmul_w8a8"] == before + 1
    assert torch.equal(out, matmul_w8a8_plain(*args)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 14336, 4096), (8192, 14336, 4096),
                                   (9, 14336, 6144), (300, 14336, 512)])
def test_w8a8_saturated_sums_bit_equal_on_card(M, K, N):
    """q = -128 and w = -127 throughout: every int32 partial sum reaches
    K * 16,256 (2.3e8 at K = 14,336), on both paths and across K splits."""
    dev = _card()
    q = torch.full((M, K), -128, dtype=torch.int8, device=dev)
    wq = torch.full((N, K), -127, dtype=torch.int8, device=dev)
    a_s = torch.full((M,), 0.75, device=dev)
    w_s = torch.full((N,), 1.5, device=dev)
    out = matmul_w8a8(q, wq, a_s, w_s)
    torch.cuda.synchronize()
    assert torch.equal(out, matmul_w8a8_plain(q, wq, a_s, w_s))
    assert abs(out[0, 0].item() / (K * 16256 / 1.125) - 1) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 100, 300), (300, 520, 200), (65, 100, 50),
                                   (2048, 520, 512)])
@pytest.mark.parametrize("offset", [0, 3])
def test_w8a8_ragged_path_bit_equal_on_card(M, K, N, offset):
    """K off a multiple of 16, or an activation that starts off 16 bytes:
    the ragged path (byte-wise loads)."""
    dev = _card()
    q, wq, a_s, w_s = [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(M, K, N)]
    buf = torch.empty(M * K + 16, dtype=torch.int8, device=dev)
    qv = buf[offset:offset + M * K].view(M, K)
    qv.copy_(q)
    assert qm.w8a8_plan(M, N, K, qv.data_ptr() % 16 == 0).path == "ragged"
    out = matmul_w8a8(qv, wq, a_s, w_s)
    torch.cuda.synchronize()
    assert torch.equal(out, matmul_w8a8_plain(qv, wq, a_s, w_s))


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


# float32: the sums run in another order. Half types: the plain version is
# computed in float32 from the same half inputs, and the kernel rounds P to
# the half type before P.V and its output once more.
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
             torch.float16: dict(atol=2e-3, rtol=0),
             torch.bfloat16: dict(atol=1.6e-2, rtol=0)}

FLASH_CASES = {
    "causal": dict(causal=True),
    "plain_lengths": dict(lengths=[37, 150]),
    "causal_offset": dict(causal=True, q_offset=5, Tq=60, Tk=150),
    "window": dict(causal=True, window=17),
    "segments": dict(causal=True, segments=True),
    "alibi_negative": dict(causal=True, alibi=True, alibi_positive=False),
    "alibi_positive": dict(causal=True, alibi=True, alibi_positive=True),
    "t5_causal": dict(causal=True, rel=True, rel_bidirectional=False),
    "t5_bidirectional": dict(rel=True, rel_bidirectional=True),
    "masked_rows": dict(lengths=[0, 150]),
}


def _flash_inputs(dev, dtype, D, Hq, Hkv, case, seed=0):
    rng = np.random.default_rng(seed)
    B = 2
    Tq, Tk = case.get("Tq", 150), case.get("Tk", 150)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device=dev, dtype=dtype)

    q, k, v = t(B, Hq, Tq, D), t(B, Hkv, Tk, D), t(B, Hkv, Tk, D)
    kw = dict(scale=D ** -0.5, causal=case.get("causal", False),
              q_offset=case.get("q_offset", 0), window=case.get("window", 0))
    if "lengths" in case:
        kw["lengths"] = torch.tensor(case["lengths"], dtype=torch.int32, device=dev)
    if case.get("segments"):
        seg = np.sort(rng.integers(0, 3, (B, Tk)), axis=1).astype(np.int32)
        kw["segment_ids"] = torch.from_numpy(seg).to(dev)
    if case.get("alibi"):
        kw["alibi_slopes"] = torch.from_numpy(
            (0.5 ** np.arange(1, Hq + 1)).astype(np.float32)).to(dev)
        kw["alibi_positive"] = case["alibi_positive"]
    if case.get("rel"):
        kw["rel_bias_table"] = torch.from_numpy(
            rng.standard_normal((12, Hq)).astype(np.float32)).to(dev)
        kw["rel_max_distance"] = 50
        kw["rel_bidirectional"] = case["rel_bidirectional"]
    return q, k, v, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype,D,Hq,Hkv", [
    (torch.float16, 128, 4, 2), (torch.bfloat16, 64, 4, 1),
    (torch.float32, 64, 4, 2), (torch.float32, 128, 2, 2),
    (torch.float16, 64, 2, 2)])
def test_flash_kernel_close_to_plain_on_card(case, dtype, D, Hq, Hkv):
    dev = _card()
    q, k, v, kw = _flash_inputs(dev, dtype, D, Hq, Hkv, FLASH_CASES[case])
    before = kernels.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, **FLASH_TOL[dtype])


# Ragged and aligned tile edges (the kernel's query tile is 128 rows, its
# key tile 64), chunked prefill, GQA 4 and an empty row.
FLASH_EDGE_CASES = {
    "t127": dict(causal=True, Tq=127, Tk=127),
    "t128": dict(causal=True, Tq=128, Tk=128),
    "t129": dict(causal=True, Tq=129, Tk=129),
    "t2048": dict(causal=True, Tq=2048, Tk=2048),
    "q127_k129": dict(Tq=127, Tk=129),
    "q129_k2048_lengths": dict(Tq=129, Tk=2048, lengths=[2048, 1000]),
    "chunked_prefill": dict(causal=True, q_offset=1000, Tq=129, Tk=1129),
    "row_of_length_0": dict(causal=True, lengths=[0, 129], Tq=129, Tk=129),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_EDGE_CASES))
@pytest.mark.parametrize("dtype,D", [(torch.float16, 128), (torch.bfloat16, 64),
                                     (torch.float16, 64), (torch.bfloat16, 128)])
def test_flash_kernel_edges_close_to_plain_on_card(case, dtype, D):
    dev = _card()
    q, k, v, kw = _flash_inputs(dev, dtype, D, 8, 2, FLASH_EDGE_CASES[case])
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), ref, **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views_on_card():
    dev = _card()
    B, T, Hq, Hkv, D = 2, 100, 4, 2, 64
    fused = torch.randn(B, T, (Hq + 2 * Hkv) * D, device=dev, dtype=torch.float16)
    split = lambda x, h: x.reshape(B, T, h, D).transpose(1, 2)  # noqa: E731
    q = split(fused[..., :Hq * D], Hq)
    k = split(fused[..., Hq * D:(Hq + Hkv) * D], Hkv)
    v = split(fused[..., (Hq + Hkv) * D:], Hkv)
    out = flash_attention(q, k, v, scale=D ** -0.5, causal=True)
    ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                scale=D ** -0.5, causal=True)
    torch.testing.assert_close(out.float(), ref, atol=2e-3, rtol=0)
    # Heads merge without a copy.
    assert out.transpose(1, 2).reshape(B, T, Hq * D).data_ptr() == out.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 80, 96])
def test_flash_kernel_pads_other_head_dims_on_card(D, dtype, causal):
    """A head dim up to 128 off 64/128 runs on zero-padded q, k and v with
    the caller's scale; the output is sliced back to D."""
    dev = _card()
    case = dict(causal=causal, lengths=[150, 101], Tq=150, Tk=150)
    q, k, v, kw = _flash_inputs(dev, dtype, D, 4, 2, case)
    before = kernels.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_refuses_other_head_dims_on_card():
    """Above 128 there is no instance (D = 256 needs its own register plan)."""
    dev = _card()
    q = torch.randn(1, 2, 8, 256, device=dev, dtype=torch.float16)
    before = kernels.launch_counts()["flash_attention"]
    with pytest.raises(NotImplementedError, match="256"):
        flash_attention(q, q, q)
    assert kernels.launch_counts()["flash_attention"] == before


def _decode_inputs(dev, qdtype, B, Hq, Hkv, C, D, lengths, fresh, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    q = t(B, Hq, 1, D).to(qdtype)
    k8, ks = quantize_kv(t(B, Hkv, C, D))
    v8, vs = quantize_kv(t(B, Hkv, C, D))
    kw = {}
    if fresh:
        kw["k_new8"], kw["kn_scale"] = quantize_kv(t(B, Hkv, 1, D))
        kw["v_new8"], kw["vn_scale"] = quantize_kv(t(B, Hkv, 1, D))
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, k8, ks, v8, vs, lengths), kw


@pytest.mark.cuda
@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("window", [0, 1, 9])
@pytest.mark.parametrize("qdtype,Hq,Hkv,C,D,lengths", [
    (torch.float32, 8, 2, 300, 64, [300, 17, 0]),
    (torch.float16, 32, 8, 2176, 128, [2048, 2111, 1]),
    (torch.bfloat16, 6, 1, 130, 32, [130, 64, 5]),
    (torch.float32, 4, 2, 70, 256, [70, 33, 2]),
])
def test_decode_kernel_close_to_plain_on_card(fresh, window, qdtype, Hq, Hkv,
                                              C, D, lengths):
    dev = _card()
    args, kw = _decode_inputs(dev, qdtype, len(lengths), Hq, Hkv, C, D,
                              lengths, fresh)
    before = kernels.launch_counts()["decode_attention_int8"]
    out = decode_attention_int8(*args, scale=D ** -0.5, window=window, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention_int8"] == before + 1
    ref = decode_attention_int8_plain(*args, scale=D ** -0.5, window=window, **kw)
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    # Sums in another order, fast exponentials.
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 4096), (4, 1, 4096), (3, 5, 512),
                                   (7, 24), (2, 17000 // 8 * 8)])
def test_norm_kernel_close_to_plain_on_card(layer_norm, dtype, shape):
    dev = _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = torch.randn(shape[-1], generator=g, device=dev)
    beta = torch.randn(shape[-1], generator=g, device=dev) if layer_norm else None
    before = kernels.launch_counts()["fused_norm"]
    out = fused_norm(x, gamma, beta, eps=1e-5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == before + 1
    ref = fused_norm_plain(x, gamma, beta, eps=1e-5)
    assert out.shape == x.shape and out.dtype == dtype
    _assert_norm_close(out, ref, beta)


def _assert_norm_close(out, ref, beta):
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
        return
    # One ulp of the output type: the float32 results differ in their last
    # bits and may round to neighbouring half values. Where beta cancels the
    # scaled value the ulp is that of the terms, not of the small sum.
    ulp = 2.0 ** (-10 if out.dtype == torch.float16 else -7)
    scale = ref.float().abs().clamp_min(2.0 ** -14)
    if beta is not None:
        scale = torch.maximum(scale, beta.abs().expand_as(scale))
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= ulp * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("D", [12, 100, 4097])
def test_apply_norm_takes_any_width_on_card(D, dtype, layer_norm, offset):
    """On the card every norm without use_residual goes through the kernel
    at any width (scalar loads off a multiple of 8), also from a view that
    starts off 16 bytes, and matches the plain version."""
    from ctranslate2_tpu_torch.ops.norms import apply_norm

    dev = _card()
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = 37
    flat = (torch.randn(rows * D + 1, generator=g, device=dev) * 2 + 0.5).to(dtype)
    x = flat[offset:offset + rows * D].view(rows, D)
    params = {"gamma": torch.randn(D, generator=g, device=dev)}
    if layer_norm:
        params["beta"] = torch.randn(D, generator=g, device=dev)
    before = kernels.launch_counts()["fused_norm"]
    out = apply_norm(params, x, 1e-5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == before + 1
    ref = fused_norm_plain(x, params["gamma"], params.get("beta"), eps=1e-5)
    assert out.shape == x.shape and out.dtype == dtype
    _assert_norm_close(out, ref, params.get("beta"))


@pytest.fixture(scope="module")
def small_decoder(tmp_path_factory):
    """A builder model whose head dim (64) the flash kernel takes."""
    path = str(tmp_path_factory.mktemp("decoder_cuda"))
    return build_decoder_only_model(
        path, vocab_size=200, num_layers=2, num_heads=4, d_model=256, d_ff=512,
        num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True, activation="swish")


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_generator_on_card_matches_cpu(small_decoder, monkeypatch, kv, beam_size):
    """float32 end to end on a small model: the card (flash prefill through
    ``flash_attention=True``, the int8-KV decode kernel, the norm kernel, the
    gather reorder of a prefilled cache under beam search) against the CPU."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    rng = np.random.default_rng(5)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (40, 33, 37)]
    opts = dict(max_length=12, min_length=12, include_prompt_in_result=False,
                beam_size=beam_size, return_scores=True)
    card = tt.Generator(small_decoder, compute_type="float32", flash_attention=True)
    cpu = tt.Generator(small_decoder, device="cpu", compute_type="float32")
    kernels.reset_launches()
    out = card.generate_batch(prompts, **opts)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ref = cpu.generate_batch(prompts, **opts)
    assert counts["flash_attention"] == 2 and counts["fused_norm"] > 0
    assert (counts["decode_attention_int8"] > 0) == (kv == "int8")
    assert (counts["gather_rows_fused"] > 0) == (beam_size > 1)
    for o, r in zip(out, ref):
        assert len(o.sequences_ids[0]) == 12
        if kv == "float":
            # float32 on both sides: only the summation order differs.
            assert o.sequences_ids == r.sequences_ids
            np.testing.assert_allclose(o.scores, r.scores, atol=1e-3)
        else:
            # A cached vector at a rounding tie may land one int8 step apart.
            np.testing.assert_allclose(o.scores[0], r.scores[0], atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 300])
@pytest.mark.parametrize("G", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(W4_KERNELS))
def test_w4_kernel_close_to_plain_on_card(name, dtype, G, M):
    dev = _card()
    fn, plain, packed, fold = W4_KERNELS[name]
    x, w, gs, zs = _w4_inputs(M, 512, 384, G, packed)
    args = [torch.from_numpy(x).to(dev, dtype)] + [
        torch.from_numpy(a).to(dev) for a in (w, gs, zs) if a is not None]
    before = kernels.launch_counts()[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    assert out.dtype == torch.float32 and out.shape == (M, 384)
    ref = plain(*args)
    bound = qm.w4_error_bound(args[0], args[1], args[2], args[3] if packed else None, fold)
    assert bool(((out - ref).abs() <= bound).all()), (out - ref).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(W4_KERNELS))
def test_w4_kernel_ragged_width_and_view_on_card(name):
    """N off a multiple of 16 (scalar payload loads) and an activation view
    that starts off 16 bytes (the wrapper copies it)."""
    dev = _card()
    fn, plain, packed, fold = W4_KERNELS[name]
    x, w, gs, zs = _w4_inputs(37, 256, 200, 32, packed, seed=1)
    xs = torch.from_numpy(np.concatenate([x, x], 1)).to(dev, torch.float16)[:, 3:3 + 256]
    args = [xs] + [torch.from_numpy(a).to(dev) for a in (w, gs, zs) if a is not None]
    out = fn(*args)
    ref = plain(*args)
    bound = qm.w4_error_bound(xs, args[1], args[2], args[3] if packed else None, fold)
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(W4_KERNELS))
@pytest.mark.parametrize("case", ["group_8", "half_off_group", "too_many_rows"])
def test_w4_kernel_refuses_shapes_outside_its_limits_on_card(name, case):
    """A shape the kernel cannot take raises and names it; it never takes
    the plain path on the card."""
    dev = _card()
    fn, _, packed, _ = W4_KERNELS[name]
    M, K, G = {"group_8": (4, 64, 8), "half_off_group": (4, 96, 32),
               "too_many_rows": (qm.W4_MAX_ROWS + 1, 64, 32)}[case]
    x, w, gs, zs = _w4_inputs(4, K, 32, G, packed)
    x = torch.empty((M, K), device=dev, dtype=torch.float16)  # no work is done
    args = [x] + [torch.from_numpy(a).to(dev) for a in (w, gs, zs) if a is not None]
    before = kernels.launch_counts()[name]
    if case == "half_off_group" and not packed:  # (K/2) % G binds only w4p
        fn(*args)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == before + 1
        return
    with pytest.raises(ValueError, match=str(tuple(x.shape))):
        fn(*args)
    assert kernels.launch_counts()[name] == before


W4_MAIN_KN = [(4096, 4096), (4096, 6144), (4096, 14336), (14336, 4096)]


def _w4_card_args(M, K, N, G, packed, dtype, seed=0):
    """The W4 operands on the card: x in ``dtype``, the payload and scales
    as ``_w4_inputs`` makes them (x drawn on the card: M x K can be large)."""
    dev = _card()
    _, w, gs, zs = _w4_inputs(1, K, N, G, packed, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    return [x] + [torch.from_numpy(a).to(dev) for a in (w, gs, zs) if a is not None]


def _w4_within_bound(out, args, packed):
    ref = (qm.matmul_w4p_plain if packed else qm.matmul_w4a16_plain)(*args)
    bound = qm.w4_error_bound(args[0], args[1], args[2], args[3] if packed else None, False)
    diff = (out - ref).abs()
    return bool((diff <= bound).all()), (diff / bound).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("K,N", W4_MAIN_KN + [(256, 4096)])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 33, 64, 65, 128])
@pytest.mark.parametrize("name", ["matmul_w4p", "matmul_w4a16"])
def test_w4_both_paths_within_bound_across_the_crossover_on_card(
        name, M, K, N, dtype, monkeypatch):
    """The wrapper's path (split-K up to M = 64, the tile above) and the
    path the plan did not pick, each within ``w4_error_bound`` of the plain
    version at the main-path (K, N), G = 128, and K = 256 (packed: K/2 is
    one group)."""
    fn, _, packed, _ = W4_KERNELS[name]
    args = _w4_card_args(M, K, N, 128, packed, dtype)
    plan = qm.w4_wrapper_plan(args[0], args[1], args[2], packed, False)
    assert plan.path == ("splitk" if M <= 64 else "tile")
    before = kernels.launch_counts()[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ok, worst = _w4_within_bound(out, args, packed)
    assert ok, (plan.path, worst)
    monkeypatch.setattr(qm, "W4_SPLITK_MAX_M", 0 if plan.path == "splitk" else 1 << 40)
    other = qm.w4_wrapper_plan(args[0], args[1], args[2], packed, False)
    assert other.path != plan.path
    out = qm._w4_run(*args[:3], args[3] if packed else None, packed, False, other)
    torch.cuda.synchronize()
    ok, worst = _w4_within_bound(out, args, packed)
    assert ok, (other.path, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 4096, 4096), (4, 14336, 4096), (33, 4096, 14336),
                                   (64, 4096, 6144)])
@pytest.mark.parametrize("name", ["matmul_w4p", "matmul_w4a16"])
def test_w4_splitk_is_the_same_run_to_run_on_card(name, M, K, N):
    """The split-K sum adds the slices in a fixed order: two calls on the
    same inputs are bit-equal (and the counters are left zero for the
    next)."""
    fn, _, packed, _ = W4_KERNELS[name]
    args = _w4_card_args(M, K, N, 128, packed, torch.float16, seed=2)
    plan = qm.w4_wrapper_plan(args[0], args[1], args[2], packed, False)
    assert plan.path == "splitk" and plan.splits > 1
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream().cuda_stream
    assert int(qm._w4_counters(args[0].device, stream).abs().sum()) == 0


@pytest.fixture(scope="module")
def awq_decoder(tmp_path_factory):
    """The small decoder with AWQ-GEMM linears (group 32)."""
    path = str(tmp_path_factory.mktemp("awq_decoder_cuda"))
    return build_decoder_only_model(
        path, vocab_size=200, num_layers=2, num_heads=4, d_model=256, d_ff=512,
        num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True, activation="swish",
        quantization="awq_gemm")


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("packed", ["1", "0"])
def test_awq_generator_on_card_matches_cpu(awq_decoder, monkeypatch, packed, beam_size):
    """float32 end to end: every AWQ linear on the card goes through its W4
    kernel (the FMA path), against the port on the CPU (the plain
    versions); only the summation order differs."""
    _card()
    monkeypatch.setenv("CT2TPU_W4_PACKED", packed)
    rng = np.random.default_rng(6)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (40, 33, 37)]
    opts = dict(max_length=12, min_length=12, include_prompt_in_result=False,
                beam_size=beam_size, return_scores=True)
    card = tt.Generator(awq_decoder, compute_type="float32")
    cpu = tt.Generator(awq_decoder, device="cpu", compute_type="float32")
    kernel, other, key = (("matmul_w4p", "matmul_w4a16", "w4p") if packed == "1"
                          else ("matmul_w4a16", "matmul_w4p", "w4"))
    assert key in card.model.params["decoder"]["layers"][0]["ffn"]["linear_1"]
    kernels.reset_launches()
    out = card.generate_batch(prompts, **opts)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ref = cpu.generate_batch(prompts, **opts)
    # 5 W4 linears a layer, 2 layers, one launch each a forward pass.
    assert counts[kernel] > 0 and counts[kernel] % 10 == 0
    assert counts[other] == 0 and counts["matmul_w8a8"] == 0
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-3)
