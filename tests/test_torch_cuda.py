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

It also holds the teacher-forced entry points (``score_batch``,
``forward_batch``, the Encoder) and random sampling on the card against the
port on the CPU, and the sampler's frequencies on the card; the mapped
model load against the copying reader and two Translator replicas on one
card, a CUDA stream each; and the JAX-free helpers other test files share: ``build_bert_model`` (a BERT-style
encoder-only model) and the sampler's expected frequencies.
"""

import math

import numpy as np
import pytest
import torch

import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch import kernels
from ctranslate2_tpu_torch.converters.builder import (
    ACTIVATION_IDS, SpecBuilder, build_decoder_only_model, build_seq2seq_model,
    default_vocab)
from ctranslate2_tpu_torch.decoding import sampling
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
                                     (torch.float16, 64), (torch.bfloat16, 128),
                                     (torch.float16, 256), (torch.bfloat16, 256)])
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


WIDE_HEAD_CASES = {
    "causal": dict(causal=True),
    "not_causal_lengths": dict(lengths=[37, 150]),
    "causal_lengths": dict(causal=True, lengths=[150, 101]),
    "window": dict(causal=True, window=17),
    "alibi": dict(causal=True, alibi=True, alibi_positive=False),
    "segments": dict(causal=True, segments=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WIDE_HEAD_CASES))
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [256, 192])
def test_flash_kernel_head_dim_256_on_card(D, dtype, case):
    """The D = 256 instance (one consumer warpgroup, 64-row query tiles; the
    float32 kernel with 16-key tiles), and D = 192 zero-padded to it, with
    GQA, lengths, a window, ALiBi and segment ids."""
    dev = _card()
    q, k, v, kw = _flash_inputs(dev, dtype, D, 4, 2, WIDE_HEAD_CASES[case])
    before = kernels.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_kernel_refuses_head_dims_above_256_on_card():
    dev = _card()
    q = torch.randn(1, 2, 8, 320, device=dev, dtype=torch.float16)
    before = kernels.launch_counts()["flash_attention"]
    with pytest.raises(NotImplementedError, match="up to 256"):
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
    # Gemma-2-9B's attention widths; head dims off a multiple of 16; rows
    # of length 0.
    (torch.float16, 16, 8, 2176, 256, [2048, 2111, 0, 1500]),
    (torch.bfloat16, 8, 2, 300, 72, [300, 0, 17]),
    (torch.float32, 5, 1, 70, 200, [0, 70, 9]),
    (torch.float16, 12, 4, 129, 37, [129, 64, 0, 1]),
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
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("Hq,Hkv,C,D,lengths", [
    (32, 8, 2176, 128, [2048, 2111, 2070, 2100]),  # the main path's shape
    (16, 8, 2176, 256, [2048, 0, 1, 2111]),
    (8, 2, 300, 72, [300, 17, 0]),
])
def test_decode_kernel_is_deterministic_and_capturable_on_card(Hq, Hkv, C, D,
                                                               lengths, window):
    """Splits merged in split order by the last block: two calls are
    bit-equal, a CUDA-graph replay equals the eager call, and the counters
    are left zero."""
    from ctranslate2_tpu_torch.kernels import decode_attention as da

    dev = _card()
    args, kw = _decode_inputs(dev, torch.float16, len(lengths), Hq, Hkv, C, D,
                              lengths, True, seed=3)
    kw.update(scale=D ** -0.5, window=window)
    plan = da.decode_plan(len(lengths), Hkv, Hq // Hkv, C, D,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.splits > 1
    first = decode_attention_int8(*args, **kw)
    second = decode_attention_int8(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        decode_attention_int8(*args, **kw)  # makes the stream's counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = decode_attention_int8(*args, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    ref = decode_attention_int8_plain(*args, **kw)
    torch.testing.assert_close(first, ref, atol=1e-4, rtol=1e-4)
    for s in (torch.cuda.current_stream(), stream):
        assert int(da._counters(dev, s.cuda_stream).abs().sum()) == 0


@pytest.mark.cuda
def test_decode_kernel_refuses_head_dims_above_256_on_card():
    dev = _card()
    args, kw = _decode_inputs(dev, torch.float16, 2, 4, 2, 16, 320, [16, 3], False)
    before = kernels.launch_counts()["decode_attention_int8"]
    with pytest.raises(ValueError, match="head dims 1-256"):
        decode_attention_int8(*args)
    assert kernels.launch_counts()["decode_attention_int8"] == before


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


# The fused forms (residual add, int8 quantization, both) at the main-path
# shapes and at the widths off a multiple of 8. The kernel's y may be one
# ulp from the plain version's, so its q cannot be bit-equal to the fully
# plain sequence's: q and scale are held bit-equal to quantize_per_row of the
# kernel's own y, and within one int8 step of the plain sequence on at most
# FUSED_STEP_SHARE of the entries (chip_smoke.py's FED_STEP_SHARE); the sum
# is bit-equal to the plain add.
FUSED_STEP_SHARE = 0.08
FUSED_MODES = {"residual": (True, False), "int8": (False, True),
               "residual_int8": (True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 4096), (4, 1, 4096), (64, 2, 512),
                                   (1920, 512), (37, 12), (37, 100), (37, 4097),
                                   (3, 17000)])
@pytest.mark.parametrize("mode", sorted(FUSED_MODES))
def test_fused_norm_forms_close_to_plain_on_card(mode, shape, dtype, layer_norm, offset):
    from ctranslate2_tpu_torch.ops.linear import quantize_per_row

    dev = _card()
    residual, quantize = FUSED_MODES[mode]
    g = torch.Generator(device="cuda").manual_seed(6)
    n = math.prod(shape)
    flat = (torch.randn(2 * n + 1, generator=g, device=dev) * 2 + 0.5).to(dtype)
    x = flat[offset:offset + n].view(shape)  # offset 1: off the 16-byte loads
    r = flat[n + 1:].view(shape) if residual else None
    gamma = torch.randn(shape[-1], generator=g, device=dev)
    beta = torch.randn(shape[-1], generator=g, device=dev) if layer_norm else None
    kw = dict(eps=1e-5, residual=r, quantize=quantize)
    before = kernels.launch_counts()["fused_norm"]
    out = fused_norm(x, gamma, beta, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == before + 1
    ref = fused_norm_plain(x, gamma, beta, **kw)
    assert out.y.shape == x.shape and out.y.dtype == dtype
    _assert_norm_close(out.y, ref.y, beta)
    if residual:
        assert torch.equal(out.sum, ref.sum)
    if quantize:
        q, scale = quantize_per_row(out.y)
        assert torch.equal(out.q, q) and torch.equal(out.scale, scale)
        step = (out.q.int() - ref.q.int()).abs()
        assert int(step.max()) <= 1
        assert (step > 0).float().mean().item() <= FUSED_STEP_SHARE
        # Left out where nothing reads them: the same q, no y, no sum.
        lean = fused_norm(x, gamma, beta, keep_sum=False, keep_y=False, **kw)
        assert lean.y is None and lean.sum is None
        assert torch.equal(lean.q, out.q) and torch.equal(lean.scale, out.scale)


@pytest.mark.cuda
@pytest.mark.parametrize("layer_norm", [True, False])
def test_add_and_norm_on_card_feeds_the_int8_linear(layer_norm):
    """``add_and_norm`` on the card: one norm launch for the add, the norm and
    the quantization; the int8 linear it feeds gives what it gives on the
    kernel's y quantized in the linear."""
    from ctranslate2_tpu_torch.ops import linear as L
    from ctranslate2_tpu_torch.ops.norms import add_and_norm

    dev = _card()
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((4, 3, 256), generator=g, device=dev).half()
    r = torch.randn((4, 3, 256), generator=g, device=dev).half()
    params = {"gamma": torch.randn(256, generator=g, device=dev)}
    if layer_norm:
        params["beta"] = torch.randn(256, generator=g, device=dev)
    lin = {"wq": torch.randint(-127, 128, (96, 256), generator=g, device=dev,
                               dtype=torch.int8),
           "scale": torch.full((96,), 127.0 / 0.05, device=dev)}
    before = kernels.launch_counts()["fused_norm"]
    s, h = add_and_norm(params, x, 1e-5, residual=r, quantize=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_norm"] == before + 1
    assert isinstance(h, L.Int8Activations) and torch.equal(s, x + r)
    y = fused_norm(s, params["gamma"], params.get("beta"), eps=1e-5)
    assert torch.equal(L.linear(lin, h), L.linear(lin, y))


@pytest.mark.cuda
def test_w8a8_splitk_workspace_reused_across_shapes_on_card():
    """The split-K workspace is kept per stream and left zeroed by each
    call: calls with shapes alternating, and after a larger one, stay
    bit-equal to the plain version."""
    dev = _card()
    shapes = [(4, 4096, 6144), (4, 14336, 4096), (64, 4096, 14336), (4, 4096, 6144),
              (9, 512, 2048), (64, 4096, 14336), (4, 14336, 4096), (1, 4096, 4096)]
    inputs = {sh: [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(*sh, seed=sum(sh))]
              for sh in set(shapes)}
    for M, K, N in shapes:
        assert qm.w8a8_plan(M, N, K).splits > 1
    for _ in range(2):
        for sh in shapes:
            out = matmul_w8a8(*inputs[sh])
            torch.cuda.synchronize()
            assert torch.equal(out, matmul_w8a8_plain(*inputs[sh])), sh
    stream = torch.cuda.current_stream().cuda_stream
    ws = qm._w8a8_workspace_cache[(inputs[shapes[0]][0].device.index, stream)]
    assert ws.numel() >= max(qm.w8a8_plan(M, N, K).workspace for M, K, N in shapes)
    assert int(ws.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_w8a8_splitk_in_a_captured_graph_on_card(warm):
    """Captured on a stream with no workspace yet (one made for the call
    inside the capture) or with one (the cached buffer): the replay equals
    the eager call, twice over."""
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(4, 4096, 6144, seed=11)]
    first = matmul_w8a8(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    if warm:
        with torch.cuda.stream(stream):
            matmul_w8a8(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = matmul_w8a8(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    assert (stream.cuda_stream in {k[1] for k in qm._w8a8_workspace_cache}) == warm


@pytest.mark.cuda
def test_w8a8_splitk_launches_no_memset_on_card():
    """After the stream's first call, split-K calls launch one kernel each
    and no memset (torch.profiler's device events over 20 calls; the
    profiler can drop a record of a window, so at least 18 of the 20
    kernels must show for the count of memsets to stand)."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(4, 4096, 14336, seed=12)]
    assert qm.w8a8_plan(4, 14336, 4096).splits > 1
    matmul_w8a8(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            matmul_w8a8(*args)
        torch.cuda.synchronize()
    names = {e.key: e.count for e in prof.key_averages()
             if (getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)) > 0}
    assert 18 <= sum(c for n, c in names.items() if "w8a8_splitk" in n) <= 20, names
    assert not any("memset" in n.lower() for n in names), names


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


@pytest.fixture(scope="module")
def wide_head_decoder(tmp_path_factory):
    """Gemma-style 256-wide heads: 4 query / 2 KV heads, d_model 1024."""
    path = str(tmp_path_factory.mktemp("decoder_head_dim_256_cuda"))
    return build_decoder_only_model(
        path, vocab_size=200, num_layers=2, num_heads=4, d_model=1024, d_ff=512,
        num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True, activation="swish")


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 2])
def test_generator_head_dim_256_kernels_on_and_off_on_card(wide_head_decoder,
                                                          monkeypatch, beam_size):
    """float32, int8 KV cache: flash (``flash_attention=True``) and the
    decode kernel at D = 256 give the tokens of the same model with both
    switched off (the plain attention over the dequantized cache)."""
    _card()
    monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    rng = np.random.default_rng(7)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (40, 33, 37)]
    opts = dict(max_length=12, min_length=12, include_prompt_in_result=False,
                beam_size=beam_size, return_scores=True)
    gen = tt.Generator(wide_head_decoder, compute_type="float32", flash_attention=True)
    kernels.reset_launches()
    out = gen.generate_batch(prompts, **opts)
    torch.cuda.synchronize()
    on = kernels.launch_counts()
    monkeypatch.setenv("CT2TPU_FLASH", "0")
    monkeypatch.setenv("CT2TPU_DECODE_KERNEL", "0")
    kernels.reset_launches()
    ref = gen.generate_batch(prompts, **opts)
    torch.cuda.synchronize()
    off = kernels.launch_counts()
    assert on["flash_attention"] == 2 and on["decode_attention_int8"] > 0
    assert off["flash_attention"] == 0 and off["decode_attention_int8"] == 0
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids
        # A K/V entry at a rounding tie of the int8 grid may land one step
        # apart (see tests/test_torch_generator.py).
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-3)


@pytest.fixture(scope="module")
def wider_head_decoder(tmp_path_factory):
    """Heads of 320, wider than the flash and decode kernels take: 4 query
    / 2 KV heads, d_model 1280."""
    path = str(tmp_path_factory.mktemp("decoder_head_dim_320_cuda"))
    return build_decoder_only_model(
        path, vocab_size=200, num_layers=2, num_heads=4, d_model=1280, d_ff=512,
        num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True, activation="swish")


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_generator_head_dim_320_runs_on_card(wider_head_decoder, monkeypatch, kv,
                                             beam_size):
    """float32, ``flash_attention=True`` (every prompt past the flash
    threshold): heads wider than the kernels take run through the plain
    attention on the card, launch neither kernel, and give the CPU's
    tokens. Scores: with the float cache within the 1e-3 of the head-dim-256
    test (only the summation order differs); with the int8 cache within the
    5e-2 that test_generator_on_card_matches_cpu states for it (a K/V entry
    at a rounding tie may land one int8 step apart on the two devices)."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    rng = np.random.default_rng(8)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (40, 33, 37)]
    opts = dict(max_length=12, min_length=12, include_prompt_in_result=False,
                beam_size=beam_size, return_scores=True)
    card = tt.Generator(wider_head_decoder, compute_type="float32", flash_attention=True)
    cpu = tt.Generator(wider_head_decoder, device="cpu", compute_type="float32")
    assert card.model.arch.decoder.layers[0].self_attention.head_dim == 320
    kernels.reset_launches()
    out = card.generate_batch(prompts, **opts)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ref = cpu.generate_batch(prompts, **opts)
    assert counts["flash_attention"] == 0 and counts["decode_attention_int8"] == 0
    assert counts["fused_norm"] > 0
    for o, r in zip(out, ref):
        assert len(o.sequences_ids[0]) == 12
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-3 if kv == "float" else 5e-2)


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


def _w4_within_bound(out, args, packed, fold=False):
    ref = getattr(qm, ("matmul_w4p" if packed else "matmul_w4a16")
                  + ("_fold" if fold else "") + "_plain")(*args)
    bound = qm.w4_error_bound(args[0], args[1], args[2], args[3] if packed else None, fold)
    diff = (out - ref).abs()
    return bool((diff <= bound).all()), (diff / bound).max().item()


def _w4_run_form(args, packed, fold, plan):
    """One W4 form on ``plan``'s path, as its wrapper computes it (the
    folded packed form also subtracts its zero-point term)."""
    zs = args[3] if packed else None
    out = qm._w4_run(*args[:3], None if fold else zs, packed, fold, plan)
    return qm._w4p_sub_zero_term(out, args[0], zs) if packed and fold else out


def _w4_wide_plan(M, N, K, packed):
    """The folded forms' wgmma plan with ``W4_WGMMA_WIDE_ROWS`` x rows a
    block at any M (the plan takes it only past one wave of blocks)."""
    return qm.w4_path_plan("wgmma", M, N, K, 128, packed, True, qm.W4_WGMMA_WIDE_ROWS)


W4_FORMS = ["matmul_w4p", "matmul_w4a16", "matmul_w4p_fold", "matmul_w4a16_fold"]
W4_FOLDED = ["matmul_w4p_fold", "matmul_w4a16_fold"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("K,N", W4_MAIN_KN + [(256, 4096)])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 33, 64, 65, 128])
@pytest.mark.parametrize("name", W4_FORMS)
def test_w4_both_paths_within_bound_across_the_crossover_on_card(
        name, M, K, N, dtype):
    """The wrapper's path (split-K up to M = 64 and for K = 14,336 over 32
    wgmma tiles, wgmma otherwise) and every other path, each within
    ``w4_error_bound`` of the plain version at the main-path (K, N),
    G = 128, and K = 256 (packed: K/2 is one group); the folded forms also
    on the wide wgmma block."""
    fn, _, packed, fold = W4_KERNELS[name]
    args = _w4_card_args(M, K, N, 128, packed, dtype)
    plan = qm.w4_wrapper_plan(args[0], args[1], args[2], packed, fold)
    few = math.ceil(M / 128) * math.ceil(N / 128) < qm.W4_WGMMA_MIN_TILES
    assert plan.path == ("splitk" if M <= 64 or (few and K >= qm.W4_SPLITK_LONG_K)
                         else "wgmma")
    before = kernels.launch_counts()[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ok, worst = _w4_within_bound(out, args, packed, fold)
    assert ok, (plan.path, worst)
    others = [qm.w4_path_plan(path, M, N, K, 128, packed, fold) for path in qm.W4_PATHS]
    for other in others + ([_w4_wide_plan(M, N, K, packed)] if fold else []):
        out = _w4_run_form(args, packed, fold, other)
        torch.cuda.synchronize()
        ok, worst = _w4_within_bound(out, args, packed, fold)
        assert ok, (other.path, other.mt, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [128, 400])
@pytest.mark.parametrize("M", [65, 128, 200, 1000])
@pytest.mark.parametrize("G", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("name", W4_FORMS)
def test_w4_wgmma_path_within_bound_on_card(name, dtype, G, M, N):
    """The wgmma path: every form and half type, group sizes whose ends
    fall on stage ends (64, 128) or inside one (32), M off a multiple of
    128 and a ragged last column tile (N = 400), within ``w4_error_bound``
    through the wrapper, which takes that path at these shapes; the folded
    forms also on the wide block."""
    fn, _, packed, fold = W4_KERNELS[name]
    args = _w4_card_args(M, 512, N, G, packed, dtype, seed=3)
    assert qm.w4_wrapper_plan(args[0], args[1], args[2], packed, fold).path == "wgmma"
    before = kernels.launch_counts()[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    assert out.shape == (M, N) and out.dtype == torch.float32
    ok, worst = _w4_within_bound(out, args, packed, fold)
    assert ok, worst
    if fold:
        out = _w4_run_form(args, packed, fold, _w4_wide_plan(M, N, 512, packed))
        torch.cuda.synchronize()
        ok, worst = _w4_within_bound(out, args, packed, fold)
        assert ok, ("wide", worst)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [32, 48])
@pytest.mark.parametrize("name", W4_FORMS)
def test_w4_wgmma_path_short_last_stage_on_card(name, G):
    """96 payload rows: the last 64-row stage of each half is short, and at
    G = 48 groups end inside stages (the folded forms also on the wide
    block, and with an odd stage count: 3 stages a half, the last short at
    G = 32)."""
    fn, _, packed, fold = W4_KERNELS[name]
    for rows in (96, 160 if G == 32 else 192) if fold else (96,):
        K = 2 * rows if packed else rows
        args = _w4_card_args(130, K, 48, G, packed, torch.float16, seed=6)
        plans = [qm.w4_path_plan("wgmma", 130, 48, K, G, packed, fold)]
        for plan in plans + ([_w4_wide_plan(130, 48, K, packed)] if fold else []):
            out = _w4_run_form(args, packed, fold, plan)
            torch.cuda.synchronize()
            ok, worst = _w4_within_bound(out, args, packed, fold)
            assert ok, (rows, plan.mt, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("name", W4_FORMS)
def test_w4_wgmma_path_at_full_width_on_card(name):
    """The AWQ prefill's shape: M = 8,192 (4 prompts of 2,048), K = N =
    4,096, G = 128 (the folded forms on the wide block)."""
    fn, _, packed, fold = W4_KERNELS[name]
    args = _w4_card_args(8192, 4096, 4096, 128, packed, torch.float16, seed=4)
    plan = qm.w4_wrapper_plan(args[0], args[1], args[2], packed, fold)
    assert plan.path == "wgmma" and plan.mt == (qm.W4_WGMMA_WIDE_ROWS if fold else 128)
    out = fn(*args)
    torch.cuda.synchronize()
    ok, worst = _w4_within_bound(out, args, packed, fold)
    assert ok, worst


def _same_in_a_graph(fn, args, first):
    """A CUDA-graph replay of ``fn(*args)`` equals ``first`` (a warm-up on
    the capture stream first: per-stream state is made outside the
    capture)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("name", W4_FORMS)
def test_w4_wgmma_path_is_the_same_run_to_run_and_in_a_graph_on_card(name):
    """Each output has one owner block and a fixed order of sums: two
    calls are bit-equal, and a CUDA-graph replay (the row-sum workspace
    made inside the capture) equals the eager call."""
    fn, _, packed, fold = W4_KERNELS[name]
    args = _w4_card_args(1000, 4096, 1040, 128, packed, torch.float16, seed=5)
    assert qm.w4_wrapper_plan(args[0], args[1], args[2], packed, fold).path == "wgmma"
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _same_in_a_graph(fn, args, first)


@pytest.mark.cuda
@pytest.mark.parametrize("name", W4_FOLDED)
def test_w4_fold_wide_wgmma_is_the_same_run_to_run_and_in_a_graph_on_card(name):
    """The same on the folded forms' wide block (M = 4,352: 34 x 32
    128-row tiles, past one wave)."""
    fn, _, packed, fold = W4_KERNELS[name]
    args = _w4_card_args(4352, 4096, 4096, 128, packed, torch.float16, seed=7)
    plan = qm.w4_wrapper_plan(args[0], args[1], args[2], packed, fold)
    assert plan.path == "wgmma" and plan.mt == qm.W4_WGMMA_WIDE_ROWS
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _same_in_a_graph(fn, args, first)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 4096, 4096), (4, 14336, 4096), (33, 4096, 14336),
                                   (64, 4096, 6144)])
@pytest.mark.parametrize("name", W4_FORMS)
def test_w4_splitk_is_the_same_run_to_run_on_card(name, M, K, N):
    """The split-K sum adds the slices in a fixed order: two calls on the
    same inputs are bit-equal (and the counters are left zero for the
    next), and a CUDA-graph replay equals the eager call."""
    fn, _, packed, fold = W4_KERNELS[name]
    args = _w4_card_args(M, K, N, 128, packed, torch.float16, seed=2)
    plan = qm.w4_wrapper_plan(args[0], args[1], args[2], packed, fold)
    assert plan.path == "splitk" and plan.splits > 1
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream().cuda_stream
    assert int(qm._w4_counters(args[0].device, stream).abs().sum()) == 0
    assert _same_in_a_graph(fn, args, first)


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


# ---------------------------------------------------------------------------
# Shared helpers: a BERT-style model and the sampler's expected frequencies.
# ---------------------------------------------------------------------------


def build_bert_model(directory, *, vocab_size, num_layers, num_heads, d_model,
                     d_ff, max_positions, type_vocab_size=2, seed=11,
                     quantization=None, pooler=True):
    """A BERT-style ``TransformerEncoderSpec`` directory with random weights
    from ``seed``, laid out as the JAX package's Transformers converter
    writes BERT: post-norm layers, word and token-type embeddings merged by
    addition, learned positions, ``layernorm_embedding``, no output norm,
    a ``pooler_dense`` head with tanh."""
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    b = SpecBuilder("TransformerEncoderSpec", 1)
    sc = "encoder"
    b.add_attr(f"{sc}/num_heads", num_heads, "int16")
    b.add_attr(f"{sc}/pre_norm", 0, "int8")
    # What the converter writes for BERT's hidden_act "gelu".
    b.add_attr(f"{sc}/activation", ACTIVATION_IDS["gelu_tanh"], "int8")
    b.add_attr(f"{sc}/embeddings_merge", 1, "int8")  # add
    b.add_attr(f"{sc}/scale_embeddings", 0, "int8")
    b.add(f"{sc}/embeddings_0/weight", rand(vocab_size, d_model, scale=0.5))
    b.add(f"{sc}/embeddings_1/weight", rand(type_vocab_size, d_model, scale=0.5))
    b.add(f"{sc}/position_encodings/encodings", rand(max_positions, d_model, scale=0.5))

    def layer_norm(scope):
        b.add(f"{scope}/gamma", 1.0 + rand(d_model))
        b.add(f"{scope}/beta", rand(d_model))

    def dense(scope, out_dim, in_dim):
        b.add(f"{scope}/weight", rand(out_dim, in_dim))
        b.add(f"{scope}/bias", rand(out_dim))

    layer_norm(f"{sc}/layernorm_embedding")
    for i in range(num_layers):
        ls = f"{sc}/layer_{i}"
        dense(f"{ls}/self_attention/linear_0", 3 * d_model, d_model)
        dense(f"{ls}/self_attention/linear_1", d_model, d_model)
        layer_norm(f"{ls}/self_attention/layer_norm")
        dense(f"{ls}/ffn/linear_0", d_ff, d_model)
        dense(f"{ls}/ffn/linear_1", d_model, d_ff)
        layer_norm(f"{ls}/ffn/layer_norm")
    if pooler:
        dense("pooler_dense", d_model, d_model)
        b.add_attr("pooler_activation", ACTIVATION_IDS["tanh"], "int8")
    b.quantize(quantization)
    b.save(directory, config={"unk_token": "<unk>", "bos_token": "<s>",
                              "eos_token": "</s>", "layer_norm_epsilon": 1e-12},
           vocabulary=default_vocab(vocab_size))
    return directory


def assert_frequencies(ids, expected, rows, sigmas=5.0):
    """Each word's count within ``sigmas`` standard errors of its expected
    count; no word of probability 0 drawn."""
    counts = np.bincount(ids, minlength=len(expected))
    assert counts[expected == 0].sum() == 0
    mean = rows * expected
    sd = np.sqrt(rows * expected * (1 - expected))
    assert np.all(np.abs(counts - mean) <= sigmas * sd + 1e-9), (counts, mean)


def draw_samples(log_probs, rows, topk, topp, temperature, seed=9):
    """``rows`` draws from one distribution by ``sample_tokens``, with
    ``noise_source`` on its device."""
    V = log_probs.shape[-1]
    batch = log_probs.expand(rows, V).contiguous()
    noise = sampling.noise_source(seed, log_probs.device)
    ids, scores = sampling.sample_tokens(
        batch, noise(0, sampling.sample_noise_shape(rows, V, topk), log_probs.device),
        topk=topk, topp=topp, temperature=temperature)
    assert torch.equal(scores, log_probs[ids])
    return ids


# ---------------------------------------------------------------------------
# Sampling, scoring and the Encoder on the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["sample_tokens"])
def test_sampler_frequencies_on_card(sampler):
    """100,000 draws from one 1,000-word distribution under top-k 50, top-p
    0.9 and temperature 0.7, with the card's own noise."""
    dev = _card()
    rows, topk, topp, temperature = 100_000, 50, 0.9, 0.7
    g = torch.Generator().manual_seed(6)
    lp = torch.log_softmax(torch.randn(1000, generator=g) * 2.0, -1).to(dev)
    ids = draw_samples(lp, rows, topk, topp, temperature)
    assert_frequencies(ids.cpu().numpy(), sampling.truncated_probabilities(
        lp.cpu().numpy(), topk, topp, temperature), rows)


@pytest.mark.cuda
def test_noise_source_on_card_is_deterministic():
    dev = _card()
    a, b = sampling.noise_source(3, dev), sampling.noise_source(3, dev)
    x, y = a(0, (4, 1000), dev), b(0, (4, 1000), dev)
    assert x.is_cuda and torch.equal(x, y)
    assert not torch.equal(a(1, (4, 1000), dev), x)


_NOISE_SOURCE = sampling.noise_source


def _shared_noise(seed, device):
    """Noise drawn on the CPU and moved to ``device``: the card and the CPU
    get the same draws."""
    cpu = _NOISE_SOURCE(seed, "cpu")
    return lambda step, shape, dev: cpu(step, shape, "cpu").to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [
    dict(sampling_topk=10), dict(sampling_topk=0, sampling_topp=0.9,
                                 sampling_temperature=0.8),
    dict(sampling_topk=20, num_hypotheses=3)], ids=["topk", "topp", "replicas"])
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_sampled_generate_on_card_matches_cpu(small_decoder, monkeypatch, kv, opts):
    """float32, both fed the same noise: the same tokens, scores within the
    tolerances of test_generator_on_card_matches_cpu."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    monkeypatch.setattr(sampling, "noise_source", _shared_noise)
    rng = np.random.default_rng(5)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (40, 33, 37)]
    kw = dict(max_length=12, include_prompt_in_result=False, return_scores=True,
              seed=4, **opts)
    card = tt.Generator(small_decoder, compute_type="float32", flash_attention=True)
    cpu = tt.Generator(small_decoder, device="cpu", compute_type="float32")
    kernels.reset_launches()
    out = card.generate_batch(prompts, **kw)
    counts = kernels.launch_counts()
    ref = cpu.generate_batch(prompts, **kw)
    assert (counts["decode_attention_int8"] > 0) == (kv == "int8")
    for o, r in zip(out, ref):
        if kv == "float":
            assert o.sequences_ids == r.sequences_ids
            np.testing.assert_allclose(o.scores, r.scores, atol=1e-3)
        else:
            np.testing.assert_allclose(o.scores[0], r.scores[0], atol=5e-2)


@pytest.mark.cuda
def test_generator_scoring_on_card_matches_cpu(small_decoder):
    """float32, ``flash_attention=True``: score_batch and forward_batch run
    the flash kernel (causal, per-row lengths) and the norm kernel, and
    agree with the CPU within 1e-3."""
    _card()
    rng = np.random.default_rng(7)
    rows = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (40, 2, 37, 61)]
    card = tt.Generator(small_decoder, compute_type="float32", flash_attention=True)
    cpu = tt.Generator(small_decoder, device="cpu", compute_type="float32")
    kernels.reset_launches()
    out = card.score_batch(rows, offset=1)
    lp = card.forward_batch(rows, return_log_probs=True)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 4 and counts["fused_norm"] > 0
    ref = cpu.score_batch(rows, offset=1)
    for o, r in zip(out, ref):
        assert o.tokens == r.tokens
        np.testing.assert_allclose(o.tokens_score, r.tokens_score, atol=1e-3)
    np.testing.assert_allclose(lp.cpu().numpy(),
                               cpu.forward_batch(rows, return_log_probs=True).numpy(),
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_type", ["float32", "int8_float32"])
def test_translator_scoring_on_card_matches_cpu(tmp_path, compute_type):
    """Scores within 1e-3 in float32; int8 only launches W8A8 (an activation
    at a half-step tie may round one step apart on the two devices)."""
    _card()
    path = build_seq2seq_model(str(tmp_path / "s2s"), vocab_size=200, d_model=256,
                               d_ff=512)
    rng = np.random.default_rng(8)
    source = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (9, 20, 14)]
    target = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (7, 12, 3)]
    card = tt.Translator(path, compute_type=compute_type)
    cpu = tt.Translator(path, device="cpu", compute_type=compute_type)
    kernels.reset_launches()
    out = card.score_batch(source, target)
    counts = kernels.launch_counts()
    ref = cpu.score_batch(source, target)
    assert counts["fused_norm"] > 0
    assert (counts["matmul_w8a8"] > 0) == (compute_type != "float32")
    for o, r in zip(out, ref):
        assert o.tokens == r.tokens
        np.testing.assert_allclose(o.tokens_score, r.tokens_score,
                                   atol=1e-3 if compute_type == "float32" else 5e-2)


@pytest.fixture(scope="module")
def small_bert(tmp_path_factory):
    return build_bert_model(str(tmp_path_factory.mktemp("bert_cuda")), vocab_size=200,
                            num_layers=2, num_heads=4, d_model=256, d_ff=512,
                            max_positions=128)


@pytest.mark.cuda
@pytest.mark.parametrize("flash", [False, True])
def test_encoder_on_card_matches_cpu(small_bert, flash):
    """float32: the post-norm BERT layers through the norm kernel (with the
    residual) and, with ``flash_attention=True``, the flash kernel
    (non-causal, per-row lengths), within 1e-3 of the CPU."""
    _card()
    rng = np.random.default_rng(9)
    rows = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (70, 5, 33)]
    types = [[int(t) for t in rng.integers(0, 2, len(r))] for r in rows]
    card = tt.Encoder(small_bert, compute_type="float32", flash_attention=flash)
    cpu = tt.Encoder(small_bert, device="cpu", compute_type="float32")
    kernels.reset_launches()
    out = card.forward_batch(rows, token_type_ids=types)
    counts = kernels.launch_counts()
    ref = cpu.forward_batch(rows, token_type_ids=types)
    assert counts["flash_attention"] == (2 if flash else 0)
    assert counts["fused_norm"] == 1 + 2 * 2
    np.testing.assert_allclose(out.last_hidden_state.cpu().numpy(),
                               ref.last_hidden_state.numpy(), atol=1e-3)
    np.testing.assert_allclose(out.pooler_output.cpu().numpy(),
                               ref.pooler_output.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# The host decode loops on the card.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_seq2seq(tmp_path_factory):
    path = build_seq2seq_model(str(tmp_path_factory.mktemp("s2s_host_cuda")),
                               vocab_size=200, d_model=256, d_ff=512)
    with open(f"{path}/vmap.txt", "w") as f:
        for i in range(190):
            f.write(f"tok{i}\t" + " ".join(f"tok{(i * 7 + j) % 190}"
                                           for j in range(20)) + "\n")
    return path


def _host_sources(seed=10):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (9, 20, 14, 3)]


HOST_TRANSLATE_OPTIONS = {
    "attention": dict(return_attention=True, replace_unknowns=True),
    "coverage": dict(coverage_penalty=0.2),
    "prefix_bias": dict(prefix_bias_beta=0.5),
    "logits": dict(return_logits_vocab=True),
    "alternatives": dict(return_alternatives=True, num_hypotheses=3),
    "vmap": dict(use_vmap=True),
    "callback": dict(callback=lambda r: False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("option,beam_size", [
    (option, beam) for option in sorted(HOST_TRANSLATE_OPTIONS) for beam in (1, 2)
    if option != "callback" or beam == 1])  # a callback streams greedy search
def test_translator_host_loops_on_card_match_cpu(small_seq2seq, monkeypatch, option,
                                                 beam_size):
    """float32: each host-loop option on the card against the CPU (the same
    tokens; scores, attention and logits within 1e-3); under beam search the
    host loop reorders through the gather kernel, chain mask or not."""
    _card()
    opts = dict(HOST_TRANSLATE_OPTIONS[option], beam_size=beam_size,
                max_decoding_length=12, return_scores=True)
    src = _host_sources()
    prefix = ([["tok5", "tok9", "tok3", "tok1"], None, ["tok7"], ["tok1", "tok2"]]
              if option in ("prefix_bias", "alternatives") else None)
    card = tt.Translator(small_seq2seq, compute_type="float32")
    cpu = tt.Translator(small_seq2seq, device="cpu", compute_type="float32")
    kernels.reset_launches()
    out = card.translate_batch(src, prefix, **opts)
    counts = kernels.launch_counts()
    ref = cpu.translate_batch(src, prefix, **opts)
    assert counts["fused_norm"] > 0
    host_beam = beam_size > 1 and option in ("attention", "coverage", "prefix_bias",
                                              "logits")
    if host_beam:
        assert counts["gather_rows_fused"] > 0
    for o, r in zip(out, ref):
        assert o.hypotheses == r.hypotheses
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-3)
        for a, b in zip(o.attention, r.attention):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)
        for a, b in zip(o.logits, r.logits):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 2])
def test_translator_host_loop_on_card_matches_device_loop(small_seq2seq, monkeypatch,
                                                          beam_size):
    """The host loop (attention, vocabulary logits) and the device loop
    (``CT2TPU_BEAM_CHAIN=0``: the gather reorder) give the same tokens and
    scores on the card."""
    _card()
    monkeypatch.setenv("CT2TPU_BEAM_CHAIN", "0")
    card = tt.Translator(small_seq2seq, compute_type="float32")
    opts = dict(beam_size=beam_size, max_decoding_length=12, return_scores=True)
    device = card.translate_batch(_host_sources(), **opts)
    kernels.reset_launches()
    host = card.translate_batch(_host_sources(), return_attention=True,
                                return_logits_vocab=True, **opts)
    counts = kernels.launch_counts()
    assert (counts["gather_rows_fused"] > 0) == (beam_size > 1)
    for h, d in zip(host, device):
        assert h.hypotheses == d.hypotheses
        np.testing.assert_allclose(h.scores, d.scores, atol=1e-5)


@pytest.mark.cuda
def test_restricted_w8a8_projection_on_card(small_seq2seq):
    """The vocabulary-restricted int8 projection (rows of ``wq`` and their
    scales, padded to a multiple of 256) is bit-equal to its plain version
    at every candidate count the plan may see."""
    _card()
    card = tt.Translator(small_seq2seq, compute_type="int8_float32")
    rng = np.random.default_rng(11)
    for n in (3, 120, 190):
        cand = sorted(rng.choice(200, n, replace=False).tolist())
        params, _, to_original = card._restricted_output_params(cand)
        proj = params["decoder"]["projection"]
        assert proj["wq"].shape[0] % 256 == 0 and proj["wq"].is_contiguous()
        for M in (1, 8, 128):
            q = torch.from_numpy(rng.integers(-128, 128, (M, 256)).astype(np.int8)).cuda()
            a_s = torch.from_numpy((rng.random(M) * 5 + 0.5).astype(np.float32)).cuda()
            out = matmul_w8a8(q, proj["wq"], a_s, proj["scale"].float())
            ref = matmul_w8a8_plain(q, proj["wq"], a_s, proj["scale"].float())
            assert torch.equal(out, ref)
            full = card.model.params["decoder"]["projection"]
            idx = torch.tensor(to_original, device="cuda")
            whole = matmul_w8a8_plain(q, full["wq"], a_s, full["scale"].float())
            assert torch.equal(out, whole.index_select(1, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_generator_host_loops_on_card(small_decoder, monkeypatch, kv):
    """float32: a callback's greedy host loop gives the device loop's tokens
    with one callback a token (the int8-KV decode kernel launched under the
    int8 cache); vocabulary logits, alternatives and a static prompt (flash
    prefill on the first call only) match the CPU within 1e-3."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    rng = np.random.default_rng(12)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (40, 33, 37)]
    kw = dict(max_length=10, include_prompt_in_result=False, return_scores=True)
    card = tt.Generator(small_decoder, compute_type="float32", flash_attention=True)
    cpu = tt.Generator(small_decoder, device="cpu", compute_type="float32")
    device = card.generate_batch(prompts, **kw)
    steps = []
    kernels.reset_launches()
    host = card.generate_batch(prompts, callback=lambda r: steps.append(r), **kw)
    counts = kernels.launch_counts()
    assert (counts["decode_attention_int8"] > 0) == (kv == "int8")
    assert [h.sequences_ids for h in host] == [d.sequences_ids for d in device]
    # One callback a token, the end token of a row that ends on it included.
    eos = card.model.target_vocabulary.eos_id
    for i, h in enumerate(host):
        streamed = [s.token_id for s in steps if s.batch_id == i]
        assert streamed in (h.sequences_ids[0], h.sequences_ids[0] + [eos])
    assert sum(s.is_last for s in steps) == len(prompts)

    sp = [f"tok{int(t)}" for t in rng.integers(0, 190, 64)]
    for opts in (dict(return_logits_vocab=True), dict(return_alternatives=True,
                                                      num_hypotheses=3),
                 dict(static_prompt=sp), dict(static_prompt=sp, beam_size=2)):
        kernels.reset_launches()
        out = card.generate_batch(prompts, **kw, **opts)
        counts = kernels.launch_counts()
        ref = cpu.generate_batch(prompts, **kw, **opts)
        if "static_prompt" in opts:
            # The first call prefills the prompt through flash; later ones reuse it.
            assert counts["flash_attention"] == (2 if opts.get("beam_size", 1) == 1
                                                 else 0)
        for o, r in zip(out, ref):
            if kv == "float":
                assert o.sequences_ids == r.sequences_ids
                np.testing.assert_allclose(o.scores, r.scores, atol=1e-3)
                for a, b in zip(o.logits, r.logits):
                    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)
            else:
                # A cached vector at a rounding tie may land one int8 step apart.
                np.testing.assert_allclose(o.scores[0], r.scores[0], atol=5e-2)


# ---------------------------------------------------------------------------
# The architecture features (ALiBi, T5 and Shaw positions, windows and ring
# caches, merged attention, sandwich and parallel-residual layers): the
# kernels at the four families' shapes, and the models on the card against
# the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("qdtype", [torch.float16, torch.bfloat16, torch.float32])
def test_decode_kernel_falcon_groups_close_to_plain_on_card(qdtype, window, fresh):
    """Falcon-7B: 71 query heads on one KV head of 64 (the group tiles of
    ``decode_plan`` leave a ragged last tile), at its main path's cache."""
    dev = _card()
    lengths = [2048, 2111, 1, 1500]
    args, kw = _decode_inputs(dev, qdtype, len(lengths), 71, 1, 2176, 64, lengths, fresh)
    before = kernels.launch_counts()["decode_attention_int8"]
    out = decode_attention_int8(*args, scale=64 ** -0.5, window=window, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention_int8"] == before + 1
    ref = decode_attention_int8_plain(*args, scale=64 ** -0.5, window=window, **kw)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


# (K, N) of the int8 linears of the four families: Falcon-7B (fused QKV
# 4,672 at K 4,544, the FFN 18,176), Gemma-2-9B, MPT-7B and Flan-T5-large,
# projections included.
ARCH_KN = [(4544, 4672), (4544, 4544), (4544, 18176), (18176, 4544), (4544, 65024),
           (3584, 8192), (4096, 3584), (3584, 14336), (14336, 3584), (3584, 256000),
           (4096, 12288), (4096, 16384), (16384, 4096), (4096, 50432),
           (1024, 3072), (1024, 1024), (1024, 2048), (1024, 2816), (2816, 1024),
           (1024, 32128)]
ARCH_VOCAB_N = (65024, 256000, 50432, 32128)
# Every M at every (K, N); a vocabulary projection at decode rows only.
ARCH_W8A8_CASES = [(K, N, M) for K, N in ARCH_KN for M in (2, 4, 32, 128, 8192)
                   if N not in ARCH_VOCAB_N or M <= 128]


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M", ARCH_W8A8_CASES)
def test_w8a8_architecture_shapes_bit_equal_on_card(K, N, M):
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(M, K, N, seed=M + K + N)]
    out = matmul_w8a8(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, matmul_w8a8_plain(*args)), qm.w8a8_plan(M, N, K)


ARCH_FLASH = {  # the families' prefill attention, one or two rows of it
    "mpt_alibi": (torch.float16, 1, 32, 32, 2048, 128,
                  dict(causal=True, alibi="positive")),
    "alibi_negative": (torch.bfloat16, 1, 32, 32, 2048, 128,
                       dict(causal=True, alibi="negative")),
    "flan_t5_encoder": (torch.float16, 2, 16, 16, 1024, 64,
                        dict(t5=True, lengths=[1024, 700])),
    "gemma2_window": (torch.float16, 1, 16, 8, 8256, 256, dict(causal=True, window=4096)),
    "falcon_71_to_1": (torch.float16, 1, 71, 1, 2048, 64, dict(causal=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ARCH_FLASH))
def test_flash_architecture_shapes_close_to_plain_on_card(case):
    from ctranslate2_tpu_torch.ops.positions import alibi_slopes

    dev = _card()
    dtype, B, Hq, Hkv, T, D, opts = ARCH_FLASH[case]
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    kw = dict(scale=D ** -0.5, causal=opts.get("causal", False),
              window=opts.get("window", 0))
    if "lengths" in opts:
        kw["lengths"] = torch.tensor(opts["lengths"], dtype=torch.int32, device=dev)
    if "alibi" in opts:
        kw.update(alibi_slopes=torch.from_numpy(alibi_slopes(Hq)).to(dev),
                  alibi_positive=opts["alibi"] == "positive")
    if opts.get("t5"):
        kw.update(rel_bias_table=torch.randn((32, Hq), generator=g, device=dev) * 0.5,
                  rel_max_distance=128, rel_bidirectional=True)
    before = kernels.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(out.float(), ref, **FLASH_TOL[dtype])


ARCH_AB = dict(vocab_size=200, num_layers=2, num_heads=4, d_model=256, d_ff=512)
ARCH_DECODERS = {
    "alibi": dict(alibi=True),
    "alibi_negative": dict(alibi=True, alibi_positive=False),
    "alibi_scaled": dict(alibi=True),  # ``scale_alibi`` written after the build
    "shaw": dict(rel_position_max=8),
    "t5_bias": dict(rel_bias_buckets=32, rel_bias_max_distance=128),
    "window": dict(sliding_window=64, rotary_dim=0),
    "hybrid_windows": dict(sliding_window=64, rotary_dim=0, sliding_window_pattern=2),
    "parallel_shared_norm": dict(parallel_residual=True, shared_layer_norm=True,
                                 rotary_dim=0),
    "parallel_two_norms": dict(parallel_residual=True, rotary_dim=0),
}


def _arch_prompts(length, seed=5, rows=3):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(3, 190, length)] for _ in range(rows)]


def _card_and_cpu(cls, source, vocab=None):
    card = cls(source, compute_type="float32", flash_attention=True)
    cpu = cls(source, device="cpu", compute_type="float32", flash_attention=True)
    if vocab is not None:
        for m in (card.model, cpu.model):
            m.target_vocabulary = vocab
            m.source_vocabularies = [vocab]
    return card, cpu


def _kv_tol(kv):
    """Scores and per-step log-probs: 1e-3 with the float KV cache; with
    the int8 one ``chip_smoke.py``'s ``INT8_KV_LOGPROB_TOL`` (a cached
    vector at a rounding tie may land one int8 step apart)."""
    return 1e-3 if kv == "float" else _chip_smoke().INT8_KV_LOGPROB_TOL


def _same_on_card(out, ref, kv, hyps="sequences_ids"):
    """The same tokens in every hypothesis, and scores within ``_kv_tol``."""
    for o, r in zip(out, ref):
        assert getattr(o, hyps) == getattr(r, hyps)
        np.testing.assert_allclose(o.scores, r.scores, atol=_kv_tol(kv), rtol=0)


def _same_steps_on_card(run, kv):
    """``run(return_logits_vocab=True)`` on the card against the CPU
    (``run`` takes the device): the same tokens, and every step's
    log-probs over the vocabulary within ``_kv_tol``."""
    out, ref = run("card", return_logits_vocab=True), run("cpu", return_logits_vocab=True)
    _same_on_card(out, ref, kv)
    for o, r in zip(out, ref):
        assert len(o.logits) == len(r.logits)
        for steps_o, steps_r in zip(o.logits, r.logits):
            assert len(steps_o) == len(steps_r)
            for lo, lr in zip(steps_o, steps_r):
                lo = torch.log_softmax(torch.as_tensor(lo).double().cpu(), -1)
                lr = torch.log_softmax(torch.as_tensor(lr).double().cpu(), -1)
                assert (lo - lr).abs().max().item() <= _kv_tol(kv)


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("feature", sorted(ARCH_DECODERS))
def test_architecture_generator_on_card_matches_cpu(tmp_path, monkeypatch, feature, kv,
                                                    beam_size):
    """float32, 2 layers: the card (flash with slopes or windows through
    ``flash_attention=True``; the decode kernel or the dequantized cache;
    ring caches past 2 x Wr under greedy search) against the CPU."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    path = build_decoder_only_model(str(tmp_path / feature),
                                    **{**ARCH_AB, **ARCH_DECODERS[feature]})
    if feature == "alibi_scaled":
        from ctranslate2_tpu_torch.formats.model_file import (load_model_file,
                                                              make_variable)

        mf = load_model_file(path)
        mf.variables["decoder/scale_alibi"] = make_variable("decoder/scale_alibi",
                                                            np.int8(1))
        mf.save(path)
    card, cpu = _card_and_cpu(tt.Generator, path)
    assert card.model.arch.decoder.scale_alibi == (feature == "alibi_scaled")
    prompts = _arch_prompts(300 if "window" in feature else 100)
    opts = dict(max_length=8, min_length=8, include_prompt_in_result=False,
                beam_size=beam_size, return_scores=True)
    kernels.reset_launches()
    out = card.generate_batch(prompts, **opts)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    # Shaw keys and values decline the flash kernel; so does the decoder's T5
    # bias, whose table the JAX package gives the kernel in the encoder only.
    assert (counts["flash_attention"] > 0) == (feature not in ("shaw", "t5_bias"))
    assert counts["fused_norm"] > 0
    _same_on_card(out, cpu.generate_batch(prompts, **opts), kv)
    gens = {"card": card, "cpu": cpu}
    _same_steps_on_card(lambda dev, **kw: gens[dev].generate_batch(prompts, **opts, **kw),
                        kv)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_ring_on_and_off_agree_on_card(tmp_path, monkeypatch, kv):
    """Hybrid windows past 2 x Wr on the card: ring caches (with int8 KV,
    the ring dequantized) against linear caches (with int8 KV, the decode
    kernel with the window)."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    path = build_decoder_only_model(str(tmp_path / "hybrid"),
                                    **{**ARCH_AB, **ARCH_DECODERS["hybrid_windows"]})
    card = tt.Generator(path, compute_type="float32", flash_attention=True)
    opts = dict(max_length=8, include_prompt_in_result=False, return_scores=True)
    prompts = _arch_prompts(300, seed=6)
    monkeypatch.setenv("CT2TPU_WINDOW_RING", "1")
    on = card.generate_batch(prompts, **opts)
    monkeypatch.setenv("CT2TPU_WINDOW_RING", "0")
    kernels.reset_launches()
    off = card.generate_batch(prompts, **opts)
    torch.cuda.synchronize()
    if kv == "int8":
        assert kernels.launch_counts()["decode_attention_int8"] > 0
    _same_on_card(on, off, kv)


def _chip_smoke():
    """The repository's ``chip_smoke.py`` (JAX-free), for its family
    fabricators; the card tests run from the repository root."""
    import importlib
    import sys

    root = __file__.rsplit("/tests/", 1)[0]
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_sandwich_gemma2_layout_on_card_matches_cpu(monkeypatch, kv):
    """Gemma-2's layout (sandwich norms, hybrid windows, softcap, scaled
    embeddings) at small widths, int8 payloads run in float32."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    cs = _chip_smoke()
    mf = cs.build_gemma2_modelfile(2, cfg=cs.GEMMA2_AB)
    vocab = cs.family_vocab(cs.GEMMA2_AB["vocab"])
    card, cpu = _card_and_cpu(tt.Generator, mf, vocab)
    prompts = cs.family_prompts(cs.GEMMA2_AB["vocab"], 2, 300, 5)
    opts = dict(max_length=8, min_length=8, include_prompt_in_result=False,
                return_scores=True)
    _same_on_card(card.generate_batch(prompts, **opts), cpu.generate_batch(prompts, **opts),
                  kv)
    gens = {"card": card, "cpu": cpu}
    _same_steps_on_card(lambda dev, **kw: gens[dev].generate_batch(prompts, **opts, **kw),
                        kv)


def _shaw_seq2seq(path):
    from ctranslate2_tpu_torch.formats.model_file import load_model_file, make_variable

    build_seq2seq_model(path, vocab_size=200, num_layers=2, num_heads=4, d_model=256,
                        d_ff=512)
    mf = load_model_file(path)
    rng = np.random.default_rng(11)
    for name in list(mf.variables):
        if name.endswith("/self_attention/linear_1/weight"):
            scope = name[:-len("/linear_1/weight")]
            for table in ("relative_position_keys", "relative_position_values"):
                mf.variables[f"{scope}/{table}"] = make_variable(
                    f"{scope}/{table}",
                    (rng.standard_normal((17, 64)) * 0.05).astype(np.float32))
    mf.save(path)
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("model", ["shaw", "merged", "flan_t5_layout"])
def test_architecture_translator_on_card_matches_cpu(tmp_path, model, beam_size):
    """Shaw positions in every self-attention, merged self+cross attention,
    and Flan-T5's layout (the T5 bias through the encoder's flash table)."""
    _card()
    vocab, size, prefix = None, 200, "tok"
    if model == "shaw":
        source = _shaw_seq2seq(str(tmp_path / "shaw"))
    elif model == "merged":
        source = build_seq2seq_model(str(tmp_path / "merged"), vocab_size=200,
                                     num_layers=2, num_heads=4, d_model=256, d_ff=512,
                                     merged_attention=True)
    else:
        cs = _chip_smoke()
        source = cs.build_flan_t5_modelfile(2, cfg=cs.FLAN_T5_AB)
        size, prefix = cs.FLAN_T5_AB["vocab"], "t"
        vocab = cs.family_vocab(size)
    card, cpu = _card_and_cpu(tt.Translator, source, vocab)
    rng = np.random.default_rng(7)
    sources = [[f"{prefix}{int(t)}" for t in rng.integers(10, size - 13, 150)]
               for _ in range(3)]
    opts = dict(beam_size=beam_size, max_decoding_length=8, min_decoding_length=8,
                return_scores=True)
    kernels.reset_launches()
    out = card.translate_batch(sources, **opts)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    # Shaw keys and values decline the flash kernel; the others' encoders take it.
    assert (counts["flash_attention"] > 0) == (model != "shaw")
    _same_on_card(out, cpu.translate_batch(sources, **opts), "float", hyps="hypotheses")


# ---------------------------------------------------------------------------
# The file and streaming helpers and the speech models on the card against
# the port on the CPU (float32), and the kernels at the shapes the speech
# paths give them.
# ---------------------------------------------------------------------------

# (M, K, N) of the speech paths: Whisper-large-v3's projection (N 51,866, off
# a multiple of 8) at beam 5 x 4 rows and at the prefill, its encoder
# linears at 4 x 1,500 frames, Wav2Vec2's CTC head at 8 x 999 frames.
W8A8_SPEECH_CASES = [(20, 1280, 51866), (8, 1280, 51866), (148, 1280, 51866),
                     (1, 1280, 51866), (6000, 1280, 1280), (6000, 1280, 3840),
                     (6000, 5120, 1280), (7992, 1024, 32), (7992, 512, 1024),
                     (8, 1024, 32), (4000, 1024, 2048), (20, 1280, 2561)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", W8A8_SPEECH_CASES)
def test_w8a8_speech_shapes_bit_equal_on_card(M, K, N):
    dev = _card()
    args = [torch.from_numpy(a).to(dev) for a in _w8a8_inputs(M, K, N, seed=M + N)]
    out = matmul_w8a8(*args)
    torch.cuda.synchronize()
    assert out.shape == (M, N) and torch.equal(out, matmul_w8a8_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [512, 1280, 160])
def test_norm_on_transposed_conv_rows_on_card(width):
    """The feature convolutions' [B, C, T] output read as [B, T, C] rows:
    the wrapper takes the strided view."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(width)
    x = torch.randn((3, width, 77), generator=g, device=dev).transpose(1, 2)
    gamma = torch.randn(width, generator=g, device=dev)
    beta = torch.randn(width, generator=g, device=dev)
    out = fused_norm(x, gamma, beta, eps=1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, fused_norm_plain(x, gamma, beta, eps=1e-5),
                               atol=1e-5, rtol=1e-5)


def _whisper_pair(tmp_path, kv, monkeypatch):
    from ctranslate2_tpu_torch.converters.builder import build_whisper_model

    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    else:
        monkeypatch.delenv("CT2TPU_KV_CACHE", raising=False)
    path, vocab = build_whisper_model(str(tmp_path / "whisper"), d_model=64, d_ff=128,
                                      num_layers=2, max_positions=128)
    card = tt.Whisper(path, compute_type="float32")
    cpu = tt.Whisper(path, device="cpu", compute_type="float32")
    return card, cpu, vocab


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_whisper_on_card_matches_cpu(tmp_path, monkeypatch, kv):
    _card()
    card, cpu, vocab = _whisper_pair(tmp_path, kv, monkeypatch)
    feats = np.random.default_rng(3).standard_normal((3, 24, 200)).astype(np.float32)
    mem, mem_cpu = card.encode(feats), cpu.encode(feats)
    torch.testing.assert_close(mem.cpu(), mem_cpu, atol=1e-4, rtol=1e-4)
    sot = ["<|startoftranscript|>", "<|en|>", "<|transcribe|>"]
    prev = ["<|startofprev|>", "w3", "w9", "w4"] + sot
    tol = 1e-4 if kv == "float" else 5e-2
    for prompt, kw in ((sot, dict(beam_size=2)), (prev, dict(beam_size=3)),
                       (sot + ["<|notimestamps|>"], dict(beam_size=1)),
                       ([sot[0]], dict(beam_size=1))):
        opts = dict(max_length=40, return_scores=True, return_no_speech_prob=True, **kw)
        kernels.reset_launches()
        a = card.generate(mem, [prompt] * 3, **opts)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        b = cpu.generate(mem_cpu, [prompt] * 3, **opts)
        assert [x.sequences_ids for x in a] == [x.sequences_ids for x in b]
        np.testing.assert_allclose([x.scores[0] for x in a], [x.scores[0] for x in b],
                                   atol=tol, rtol=0)
        np.testing.assert_allclose([x.no_speech_prob for x in a],
                                   [x.no_speech_prob for x in b], atol=1e-4, rtol=0)
        assert counts["fused_norm"] > 0
        assert (counts["decode_attention_int8"] > 0) == (kv == "int8")
        if kw["beam_size"] > 1 and len(prompt) > 1:  # a cached prompt: no chain mask
            assert counts["gather_rows_fused"] > 0
    la, lb = card.detect_language(mem), cpu.detect_language(mem_cpu)
    for x, y in zip(la, lb):
        np.testing.assert_allclose([p for _, p in x], [dict(y)[t] for t, _ in x],
                                   atol=1e-4, rtol=0)
    start = [vocab.index(t) for t in sot]
    texts = [[3, 4, 5, 6], [7, 8], [9, 10, 11]]
    aa = card.align(mem, start, texts, [200, 120, 0])
    ab = cpu.align(mem_cpu, start, texts, [200, 120, 0])
    assert [x.alignments for x in aa] == [x.alignments for x in ab]
    np.testing.assert_allclose([p for x in aa for p in x.text_token_probs],
                               [p for x in ab for p in x.text_token_probs], atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("flash", [False, True])
def test_speech_encoders_on_card_match_cpu(flash):
    _card()
    cs = _chip_smoke()
    mf = cs.build_wav2vec2_modelfile(2, dict(cs.WAV2VEC2_LARGE, d_model=64, heads=4,
                                             d_ff=128, conv_dim=32))
    audio = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1, 16000)).astype(np.float32))
    kernels.reset_launches()
    out = tt.Wav2Vec2(mf, compute_type="float32", flash_attention=flash).encode(
        audio, to_cpu=True)
    counts = kernels.launch_counts()
    ref = tt.Wav2Vec2(mf, device="cpu", compute_type="float32").encode(audio)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert counts["fused_norm"] > 0 and (counts["flash_attention"] == 2) == flash
    mf = cs.build_w2v_bert_modelfile(2, dict(cs.W2V_BERT_2, d_model=64, heads=4, d_ff=128,
                                             input_dim=24, left=8, right=4))
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 75, 24)).astype(np.float32))
    out = tt.Wav2Vec2Bert(mf, compute_type="float32").encode(feats, to_cpu=True)
    ref = tt.Wav2Vec2Bert(mf, device="cpu", compute_type="float32").encode(feats)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_file_and_stream_helpers_on_card_match_cpu(tmp_path):
    _card()
    path = build_seq2seq_model(str(tmp_path / "s2s"), vocab_size=128, num_layers=2,
                               num_heads=4, d_model=64, d_ff=128)
    card = tt.Translator(path, compute_type="float32")
    cpu = tt.Translator(path, device="cpu", compute_type="float32")
    rng = np.random.default_rng(4)
    lines = [" ".join(f"tok{int(t)}" for t in rng.integers(0, 120, rng.integers(2, 15)))
             for _ in range(21)]
    src = tmp_path / "src.txt"
    src.write_text("".join(line + "\n" for line in lines))
    outs = []
    for tr, name in ((card, "card.txt"), (cpu, "cpu.txt")):
        tr.translate_file(str(src), str(tmp_path / name), read_batch_size=4,
                          max_batch_size=3, beam_size=2, max_decoding_length=10,
                          with_scores=True)
        outs.append([line.split(" ||| ") for line in
                     (tmp_path / name).read_text().splitlines()])
    assert [t for _, t in outs[0]] == [t for _, t in outs[1]]
    np.testing.assert_allclose([float(s) for s, _ in outs[0]], [float(s) for s, _ in outs[1]],
                               atol=1e-4, rtol=0)
    gpath = build_decoder_only_model(str(tmp_path / "dec"), vocab_size=96, num_layers=2,
                                     num_heads=4, d_model=64, d_ff=96)
    gc_, gp = tt.Generator(gpath, compute_type="float32"), tt.Generator(
        gpath, device="cpu", compute_type="float32")
    prompt = ["<s>", "tok4", "tok17"]
    a = [(s.token_id, s.log_prob) for s in gc_.generate_tokens(prompt, max_length=12,
                                                              return_log_prob=True)]
    b = [(s.token_id, s.log_prob) for s in gp.generate_tokens(prompt, max_length=12,
                                                             return_log_prob=True)]
    assert [t for t, _ in a] == [t for t, _ in b]
    np.testing.assert_allclose([p for _, p in a], [p for _, p in b], atol=1e-4, rtol=0)
    stream = gc_.generate_tokens(prompt, max_length=40, min_length=40)
    next(stream)
    stream.close()
    assert not stream._thread.is_alive()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3])
def test_w8a8_linear_takes_strided_activations_on_card(rows):
    """A transposed convolution output ([B, C, T] read as [B, T, C]) into an
    int8 linear: one batch row quantizes into a strided q, which the linear
    hands the kernel as contiguous rows."""
    from ctranslate2_tpu_torch.ops.linear import linear

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn((rows, 64, 30), generator=g, device=dev).transpose(1, 2)
    params = {"wq": torch.randint(-127, 128, (48, 64), generator=g, device=dev,
                                  dtype=torch.int8),
              "scale": torch.rand(48, generator=g, device=dev) + 0.5}
    out = linear(params, x)
    torch.cuda.synchronize()
    assert torch.equal(out, linear(params, x.contiguous()))


@pytest.mark.cuda
def test_conv1d_is_ieee_float32_on_card():
    """With TF32 allowed for cuDNN (its default), the convolution still
    runs in IEEE float32, and the setting is left as it was."""
    from ctranslate2_tpu_torch.ops.conv import conv1d

    dev = _card()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 128, 300)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 128, 3)).astype(np.float32))
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = conv1d(x.to(dev), w.to(dev), stride=2, padding=1)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    torch.testing.assert_close(out.cpu(), conv1d(x, w, stride=2, padding=1),
                               atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# Serving: per-row positions, the continuous batcher, model residency.
# ---------------------------------------------------------------------------

def _per_row_step(model, lengths, capacity, kv, seed=0):
    """Per-row decode on ``model``: each row prefilled alone to its length
    (0: empty) and inserted into a slot cache, then two steps at a
    position vector. Returns the two steps' logits (float32, on the CPU)."""
    from ctranslate2_tpu_torch.models import transformer as T

    dev = model.device
    dtype = torch.int8 if kv == "int8" else torch.float32
    rng = np.random.default_rng(seed)
    cache = T.init_self_cache(model.arch, len(lengths), capacity, dtype=dtype,
                              device=dev, ring=True)
    for r, n in enumerate(lengths):
        if n:
            sub = T.init_self_cache(model.arch, 1, n, dtype=dtype, device=dev, ring=True)
            ids = torch.from_numpy(rng.integers(3, 190, (1, n))).to(dev)
            T.decoder_forward(model.arch, model.params, model.consts, ids, 0, sub,
                              quantize_acts=False, return_logits=False,
                              fresh_prefill=True)
            T.cache_insert_row(cache, sub, r)
    out = []
    for step in range(2):
        pos = torch.tensor(lengths, dtype=torch.int32) + step
        ids = torch.from_numpy(rng.integers(3, 190, (len(lengths), 1)))
        logits, cache = T.decoder_forward(
            model.arch, model.params, model.consts, ids.to(dev), pos.to(dev), cache,
            quantize_acts=False, pos_bound=int(pos.max()))
        out.append(logits.float().cpu())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_per_row_decode_on_card_matches_cpu(small_decoder, kv):
    """Rows of lengths 0, 1, 130 and 300 in a 384-slot cache: the int8
    cache through the decode kernel's per-row lengths, the float cache
    through the length-adaptive read, against the CPU."""
    _card()
    card = tt.load_model(small_decoder, compute_type="float32", device="cuda")
    cpu = tt.load_model(small_decoder, compute_type="float32", device="cpu")
    lengths = [0, 1, 130, 300]
    kernels.reset_launches()
    got = _per_row_step(card, lengths, 384, kv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    ref = _per_row_step(cpu, lengths, 384, kv)
    # Two steps a layer, and the one-token row's prefill, a decode step too.
    layers = len(card.arch.decoder.layers)
    assert counts["decode_attention_int8"] == (3 * layers if kv == "int8" else 0)
    tol = 5e-2 if kv == "int8" else 1e-3
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_continuous_batcher_on_card_matches_generate_batch(small_decoder, monkeypatch, kv):
    """float32: the batcher's greedy tokens equal ``generate_batch``'s on the
    card, request by request, with more requests than slots; a sampled
    request repeats itself under its seed."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    gen = tt.Generator(small_decoder, compute_type="float32")
    rng = np.random.default_rng(8)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (5, 40, 17, 3, 64)]
    refs = [gen.generate_batch([p], max_length=16, include_prompt_in_result=False)[0]
            for p in prompts]
    cb = tt.ContinuousBatcher(gen, num_slots=3, capacity=256, steps_per_sync=4)
    try:
        kernels.reset_launches()
        futures = [cb.submit(p, max_length=16) for p in prompts]
        sampled = [cb.submit(prompts[0], max_length=16, sampling_topk=0, seed=3)
                   for _ in range(2)]
        out = [f.result(timeout=300) for f in futures]
        a, b = (f.result(timeout=300).sequences_ids for f in sampled)
        counts = kernels.launch_counts()
    finally:
        cb.close()
    assert [o.sequences_ids for o in out] == [r.sequences_ids for r in refs]
    assert a == b
    assert counts["fused_norm"] > 0
    assert (counts["decode_attention_int8"] > 0) == (kv == "int8")


@pytest.mark.cuda
def test_unload_frees_the_card_and_load_restores(small_decoder):
    _card()
    gen = tt.Generator(small_decoder, compute_type="float32")
    prompt = [["tok4", "tok9", "tok2"]]
    before = gen.generate_batch(prompt, max_length=8, static_prompt=["tok7"])
    weights = sum(t.numel() * t.element_size() for t in _tensors(gen.model.params))
    torch.cuda.synchronize()
    loaded = torch.cuda.memory_allocated()
    gen.unload_model(to_cpu=True)
    unloaded = torch.cuda.memory_allocated()
    assert loaded - unloaded >= weights
    assert all(t.device.type == "cpu" for t in _tensors(gen._unloaded_params))
    gen.load_model()
    assert torch.cuda.memory_allocated() - unloaded >= weights
    assert all(t.is_cuda for t in _tensors(gen.model.params))
    assert gen.generate_batch(prompt, max_length=8,
                              static_prompt=["tok7"])[0].sequences_ids == \
        before[0].sequences_ids


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["float", "int8"])
def test_beam_batcher_on_card_gathers_once_a_step(small_decoder, monkeypatch, kv):
    """float32, beam 2: the beam batcher's hypotheses and scores equal
    ``generate_batch(beam_size=2)``'s on the card, with more requests than
    slots; every beam step reorders the slot cache in exactly one gather
    launch, and no kernel's plain version runs on the card."""
    _card()
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    cs = _chip_smoke()
    gen = tt.Generator(small_decoder, compute_type="float32")
    rng = np.random.default_rng(9)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (5, 40, 17, 3)]
    refs = [gen.generate_batch([p], max_length=12, beam_size=2, return_scores=True,
                               include_prompt_in_result=False)[0] for p in prompts]
    cb = tt.ContinuousBatcher(gen, num_slots=2, capacity=128, steps_per_sync=4,
                              beam_size=2)
    plain = {}
    try:
        with cs.plain_calls_on_card(plain):
            torch.cuda.synchronize()
            kernels.reset_launches()
            steps0 = cb.num_steps
            out = [f.result(timeout=300) for f in [cb.submit(p, max_length=12)
                                                   for p in prompts]]
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            steps = cb.num_steps - steps0
    finally:
        cb.close()
    for o, r in zip(out, refs):
        assert o.sequences_ids[0] == r.sequences_ids[0]
        assert abs(o.scores[0] - r.scores[0]) < (1e-3 if kv == "float" else 2e-2)
    assert steps > 0 and counts["gather_rows_fused"] == steps
    assert (counts["decode_attention_int8"] > 0) == (kv == "int8")
    assert not plain


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [1, 2])
def test_continuous_translator_on_card_matches_cpu(small_seq2seq, beam):
    """float32: ``ContinuousTranslator`` on the card gives the CPU's tokens,
    scores within 1e-3, with a target prefix; under beam search one gather
    a step."""
    _card()
    rng = np.random.default_rng(12)
    sources = [[f"tok{int(t)}" for t in rng.integers(3, 190, n)] for n in (6, 14, 3)]
    kw = dict(num_slots=2, capacity=64, max_source_len=16, steps_per_sync=3,
              beam_size=beam)
    out = {}
    for device in ("cuda", "cpu"):
        tr = tt.Translator(small_seq2seq, compute_type="float32", device=device)
        cb = tt.ContinuousTranslator(tr, **kw)
        try:
            kernels.reset_launches()
            fs = [cb.submit(s, max_length=12) for s in sources]
            fs.append(cb.submit(sources[0], max_length=12, target_prefix=["tok4", "tok8"]))
            out[device] = ([f.result(timeout=300) for f in fs], kernels.launch_counts(),
                           cb.num_steps)
        finally:
            cb.close()
    (card, counts, steps), (cpu, _, _) = out["cuda"], out["cpu"]
    for a, b in zip(card, cpu):
        assert a.sequences_ids == b.sequences_ids
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-3, rtol=0)
    assert counts["gather_rows_fused"] == (steps if beam > 1 else 0)
    assert counts["fused_norm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("draft", [False, True])
def test_speculative_verify_on_card_launches_no_decode_kernel(small_decoder, monkeypatch,
                                                              draft):
    """int8 KV cache, float32: a verify dispatch (T = 4) dequantizes the
    target's cache for the plain attention, so the decode kernel launches
    only for the draft model's T = 1 feeds: 4 a draft layer and dispatch,
    none without a draft; no kernel's plain version runs on the card. The
    tokens are ``generate_batch``'s."""
    _card()
    monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    cs = _chip_smoke()
    gen = tt.Generator(small_decoder, compute_type="float32")
    rng = np.random.default_rng(14)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (5, 40, 17)]
    refs = [gen.generate_batch([p], max_length=12, include_prompt_in_result=False)[0]
            for p in prompts]
    kw = dict(draft_model=gen) if draft else {}
    cb = tt.ContinuousBatcher(gen, num_slots=3, capacity=128, speculation_k=4, **kw)
    plain = {}
    try:
        with cs.plain_calls_on_card(plain):
            torch.cuda.synchronize()
            kernels.reset_launches()
            steps0 = cb.num_steps
            out = [f.result(timeout=300) for f in [cb.submit(p, max_length=12)
                                                   for p in prompts]]
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            steps = cb.num_steps - steps0
    finally:
        cb.close()
    assert [o.sequences_ids for o in out] == [r.sequences_ids for r in refs]
    layers = len(gen.model.arch.decoder.layers)
    assert steps > 0
    assert counts["decode_attention_int8"] == (4 * layers * steps if draft else 0)
    assert counts["fused_norm"] > 0 and not plain


@pytest.mark.cuda
def test_speculation_on_card_matches_cpu(small_decoder, small_seq2seq):
    """float32: ``generate_batch(speculation_k=4)``, the batcher with
    prompt lookup and with a draft, and ``ContinuousTranslator`` with a
    target prefix give the CPU's tokens on the card, scores within 1e-3."""
    _card()
    rng = np.random.default_rng(15)
    prompts = [[f"tok{int(t)}" for t in rng.integers(0, 190, n)] for n in (5, 40, 17, 3)]
    prompts[3] = prompts[0] * 4
    sources = [[f"tok{int(t)}" for t in rng.integers(3, 190, n)] for n in (6, 14, 3)]
    out = {}
    for device in ("cuda", "cpu"):
        gen = tt.Generator(small_decoder, compute_type="float32", device=device)
        got = [gen.generate_batch(prompts, max_length=16, speculation_k=4,
                                  return_scores=True)]
        for kw in (dict(), dict(draft_model=gen)):
            cb = tt.ContinuousBatcher(gen, num_slots=2, capacity=128, speculation_k=4, **kw)
            try:
                got.append([f.result(timeout=300) for f in [
                    cb.submit(p, max_length=16) for p in prompts]])
            finally:
                cb.close()
        tr = tt.Translator(small_seq2seq, compute_type="float32", device=device)
        cb = tt.ContinuousTranslator(tr, num_slots=2, capacity=64, max_source_len=16,
                                     speculation_k=4)
        try:
            fs = [cb.submit(s, max_length=12) for s in sources]
            fs.append(cb.submit(sources[0], max_length=12, target_prefix=["tok4", "tok8"]))
            got.append([f.result(timeout=300) for f in fs])
        finally:
            cb.close()
        out[device] = got
    for card, cpu in zip(out["cuda"], out["cpu"]):
        for a, b in zip(card, cpu):
            assert a.sequences_ids == b.sequences_ids
            np.testing.assert_allclose(a.scores, b.scores, atol=1e-3, rtol=0)


def _param_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _param_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _param_leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


@pytest.fixture(scope="module")
def small_seq2seq_int8(tmp_path_factory):
    return build_seq2seq_model(str(tmp_path_factory.mktemp("s2s_int8_cuda")),
                               vocab_size=200, d_model=256, d_ff=512,
                               quantization="int8")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_mapped_load_to_the_card_equals_the_copying_reader(
        small_seq2seq, small_seq2seq_int8, quantized):
    """The native index over a map of model.bin and the copying reader give
    bit-equal parameters on the card; the map's pages are dropped from the
    process after the upload and read back from the file on demand."""
    from ctranslate2_tpu_torch.formats.model_file import (load_model_file,
                                                          load_model_file_copied)
    from ctranslate2_tpu_torch.models.loader import load_model

    _card()
    path = small_seq2seq_int8 if quantized else small_seq2seq
    mapped = load_model(path, device="cuda")
    copied = load_model(load_model_file_copied(path), device="cuda")
    a, b = _param_leaves(mapped.params), _param_leaves(copied.params)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.is_cuda and x.dtype == y.dtype and torch.equal(x, y)
    assert mapped.mf.mapping is not None and copied.mf.mapping is None
    plain = load_model_file_copied(path)
    for name, var in mapped.mf.variables.items():
        assert var.array.tobytes() == plain.variables[name].array.tobytes()
    assert load_model_file(path).mapping is not None


@pytest.mark.cuda
def test_two_replicas_on_one_card_with_streams(small_seq2seq_int8):
    _card()
    rng = np.random.default_rng(4)
    source = [[f"tok{i}" for i in rng.integers(0, 190, rng.integers(3, 15))]
              for _ in range(8)]
    opts = dict(max_decoding_length=16)
    one = tt.Translator(small_seq2seq_int8, device="cuda", compute_type="int8")
    expected = [r.hypotheses for r in one.translate_batch(source, **opts)]
    t = tt.Translator(small_seq2seq_int8, device="cuda", device_index=[0, 0],
                      compute_type="int8")
    assert t.num_replicas == 2 and len(t._replica_streams) == 2
    streams = {s.cuda_stream for s in t._replica_streams}
    assert len(streams) == 2
    assert torch.cuda.default_stream(0).cuda_stream not in streams
    m0, m1 = t._all_models()
    assert m0.params is m1.params

    def job_stream():
        return torch.cuda.current_stream().cuda_stream

    assert {t._pool.submit(job_stream).result() for _ in range(8)} <= streams
    calls = [t.translate_batch(source, max_batch_size=2, asynchronous=True, **opts)
             for _ in range(4)]
    for call in calls:
        assert [r.result().hypotheses for r in call] == expected
    t.unload_model(to_cpu=True)
    assert m0.params is None and m1.params is None
    t.load_model()
    m0, m1 = t._all_models()
    assert m0.params is m1.params
    assert all(x.is_cuda for x in _param_leaves(m0.params))
    assert [r.hypotheses for r in t.translate_batch(
        source, max_batch_size=2, **opts)] == expected


@pytest.mark.cuda
def test_replica_stream_jobs_are_ordered_against_the_submitter():
    """A job on a replica's stream waits for the work its submitter queued
    (here a fill behind a spin of the default stream), and a card tensor
    it returns is complete and recorded on the submitter's stream."""
    from ctranslate2_tpu_torch.runtime.pool import WorkerPool

    _card()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    pool = WorkerPool(num_workers=1, device=[dev], streams=[stream])
    try:
        for _ in range(3):
            x = torch.zeros(1 << 20, device=dev)
            torch.cuda._sleep(100_000_000)  # tens of ms on the default stream
            x.fill_(1.0)
            out = pool.submit(lambda: (x + 1.0, [x * 3.0])).result()
            assert torch.equal(out[0], torch.full_like(x, 2.0))
            assert torch.equal(out[1][0], torch.full_like(x, 3.0))
    finally:
        pool.close()


@pytest.mark.cuda
def test_encoder_replicas_on_one_card_equal_one_replica(small_bert):
    """``Encoder(device_index=[0, 0]).forward_batch_async``: card tensors
    made on the replicas' streams and read on the caller's, bit-equal to
    one replica's."""
    _card()
    rng = np.random.default_rng(12)
    batches = [[[f"tok{int(t)}" for t in rng.integers(0, 190, n)]
                for n in rng.integers(3, 90, 4)] for _ in range(6)]
    one = tt.Encoder(small_bert, compute_type="float32")
    expected = [one.forward_batch(b) for b in batches]
    two = tt.Encoder(small_bert, compute_type="float32", device_index=[0, 0])
    assert two.num_replicas == 2 and two.num_workers == 2
    for _ in range(2):
        pending = [two.forward_batch_async(b) for b in batches]
        for p, ref in zip(pending, expected):
            out = p.result()
            assert out.last_hidden_state.is_cuda
            assert torch.equal(out.last_hidden_state, ref.last_hidden_state)
            assert torch.equal(out.pooler_output, ref.pooler_output)
