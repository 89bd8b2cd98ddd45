"""The AWQ-W4 slice of the port against the JAX package, on the CPU.

- ``ops/awq.py``: the numpy layer is bit-identical to the JAX package's, for
  both on-disk layouts; the torch device-side unpack equals
  ``build_awq_linear`` / ``build_awq_linear_packed`` bit for bit;
- the port's builder writes the JAX builder's files byte for byte for
  ``awq_gemm`` and ``awq_gemv``;
- each of the four W4 plain versions matches its Pallas kernel run in
  interpret mode (``jax.default_matmul_precision("highest")``, as
  tests/test_awq.py does) within rtol 2e-5 / atol 1e-4: both sum float32
  products, in other orders;
- ``linear()`` on ``w4`` and ``w4p`` params matches the JAX ``linear()`` (its
  XLA dequantize-then-dot path on the CPU) within 1e-5 relative;
- ``build_params`` on an AWQ model equals ``params_from_numpy`` of the JAX
  package's params, packed and unpacked;
- ``Generator.generate_batch`` is token-identical to the JAX Generator, with
  scores within 1e-4 (float32 on both sides; only the summation order of
  the W4 products differs).

The card's kernels are held against these plain versions in
tests/test_torch_cuda.py.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
from ctranslate2_tpu.kernels import quant_matmul as jqm
from ctranslate2_tpu.models import loader as jloader
from ctranslate2_tpu.ops import awq as jawq
from ctranslate2_tpu.ops.linear import linear as jlinear
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch import kernels
from ctranslate2_tpu_torch.converters import builder as tbuilder
from ctranslate2_tpu_torch.kernels import quant_matmul as tqm
from ctranslate2_tpu_torch.models.loader import _weights_dtype
from ctranslate2_tpu_torch.models.params import ParamsBuilder, params_from_numpy
from ctranslate2_tpu_torch.ops import awq as tawq
from ctranslate2_tpu_torch.ops.linear import linear as tlinear
from ctranslate2_tpu_torch.utils.dtypes import resolve_compute_type
from test_torch_cuda import W4_KERNELS, _w4_inputs

MODEL = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=128,
             num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
             activation="swish")
LAYOUTS = {"gemm": jawq.AWQ_GEMM, "gemv": jawq.AWQ_GEMV}


def _awq_weight(out_dim, in_dim, G, layout, seed=0):
    """A float (out, in) weight and its AWQ payload in ``layout``."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_dim, in_dim)) * 0.1).astype(np.float32)
    return w, jawq.quantize_awq(w, group_size=G, quant_type=LAYOUTS[layout])


# ---------------------------------------------------------------------------
# ops/awq.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [16, 32])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_awq_numpy_layer_bit_identical(layout, G):
    qt = LAYOUTS[layout]
    w, _ = _awq_weight(48, 96, G, layout)
    ours = tawq.quantize_awq(w, G, qt)
    ref = jawq.quantize_awq(w, G, qt)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("dequantize_awq", "unpack_to_in_out", "build_awq_linear",
                 "build_awq_linear_packed"):
        a, b = getattr(tawq, name)(*ref, qt), getattr(jawq, name)(*ref, qt)
        pairs = (zip(a.values(), b.values()) if isinstance(a, dict)
                 else zip(a, b) if isinstance(a, tuple) else [(a, b)])
        for x, y in pairs:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    packed = tawq.build_awq_linear_packed(*ref, qt)["w4p"]
    np.testing.assert_array_equal(tawq.unpack_w4p(packed), jawq.unpack_w4p(packed))
    unpack, pack = ((tawq.unpack_awq_gemm, jawq.pack_awq_gemm) if layout == "gemm"
                    else (tawq.unpack_awq_gemv, jawq.pack_awq_gemv))
    vals = np.random.default_rng(1).integers(0, 16, (24, 40), dtype=np.uint8)
    np.testing.assert_array_equal(unpack(pack(vals)), vals)
    np.testing.assert_array_equal(
        (tawq.pack_awq_gemm if layout == "gemm" else tawq.pack_awq_gemv)(vals),
        pack(vals))
    np.testing.assert_array_equal(tawq.AWQ_ORDER, jawq.AWQ_ORDER)
    np.testing.assert_array_equal(tawq.AWQ_REVERSE_ORDER, jawq.AWQ_REVERSE_ORDER)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_device_side_unpack_bit_identical(layout, packed):
    """The torch load (nibble order folded into the shift amounts) equals the
    numpy ``build_awq_linear`` / ``build_awq_linear_packed``, negative int32
    payload words included."""
    qt = LAYOUTS[layout]
    _, payload = _awq_weight(80, 128, 32, layout, seed=2)
    assert (payload[0] < 0).any()
    ours = tawq.build_awq_linear_lazy(*payload, qt, packed=packed, device="cpu")
    ref = (jawq.build_awq_linear_packed if packed else jawq.build_awq_linear)(
        *payload, qt)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].numpy().dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key].numpy(), ref[key], err_msg=key)


@pytest.mark.parametrize("quantization", ["awq_gemm", "awq_gemv"])
@pytest.mark.parametrize("kwargs", [MODEL, dict(MODEL, tied_projection=True, seed=3)],
                         ids=["untied", "tied"])
def test_builder_writes_the_same_awq_files(tmp_path, quantization, kwargs):
    a = jbuilder.build_decoder_only_model(str(tmp_path / "jax"),
                                          quantization=quantization, **kwargs)
    b = tbuilder.build_decoder_only_model(str(tmp_path / "port"),
                                          quantization=quantization, **kwargs)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "config.json" in names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert (sorted(match), mismatch, errors) == (names, [], [])


# ---------------------------------------------------------------------------
# The W4 plain versions against the Pallas kernels (interpret mode).
# ---------------------------------------------------------------------------

# (M, K, N, G, block_k): one group per k-step, several per k-step, G = 32.
PALLAS_SHAPES = [(5, 512, 256, 128, 128), (3, 1024, 128, 128, 512),
                 (4, 512, 256, 32, 128), (9, 256, 128, 32, 32)]


@pytest.mark.parametrize("M,K,N,G,block_k", PALLAS_SHAPES)
@pytest.mark.parametrize("name", sorted(W4_KERNELS))
def test_w4_plain_matches_pallas_interpret(name, M, K, N, G, block_k):
    fn, plain, packed, _ = W4_KERNELS[name]
    arrays = [a for a in _w4_inputs(M, K, N, G, packed, seed=M) if a is not None]
    if packed:
        block_k = min(block_k, K // 2)
    with jax.default_matmul_precision("highest"):
        ref = getattr(jqm, name)(*(jnp.asarray(a) for a in arrays),
                                 block_k=block_k, interpret=True)
    before = kernels.launch_counts()
    out = fn(*(torch.from_numpy(a) for a in arrays))
    assert kernels.launch_counts() == before  # the CPU path launches nothing
    assert out.dtype == torch.float32 and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        plain(*(torch.from_numpy(a) for a in arrays)).numpy(), out.numpy(),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["activation_dtype", "payload_dtype", "scale_rows",
                                 "payload_rows", "devices_differ"])
@pytest.mark.parametrize("name", sorted(W4_KERNELS))
def test_w4_wrappers_reject_bad_operands(name, bad):
    fn, _, packed, _ = W4_KERNELS[name]
    args = [torch.from_numpy(a) for a in _w4_inputs(4, 128, 64, 32, packed)
            if a is not None]
    if bad == "activation_dtype":
        args[0] = args[0].double()
    elif bad == "payload_dtype":
        args[1] = args[1].to(torch.int16)
    elif bad == "scale_rows":
        args[2] = args[2][:3]
    elif bad == "payload_rows":
        args[1] = args[1][:-16]
    else:
        args[2] = args[2].to("meta")
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


def test_w4_supported_limits():
    """The port's own limits: G divides K and is a multiple of 16; packed,
    (K/2) % G == 0; M up to 65,535 tiles of 64 rows (the grid's y limit).
    The TPU's G % 128 and N % 128 lane limits do not apply."""
    assert tqm.w4a16_supported((4, 512), (512, 200), (16, 200))  # G 32, N 200
    assert tqm.w4p_supported((4, 512), (256, 200), (16, 200))
    assert not tqm.w4a16_supported((4, 64), (64, 32), (8, 32))  # G 8
    assert not tqm.w4p_supported((4, 96), (48, 32), (3, 32))  # K/2 = 48, G 32
    assert tqm.w4a16_supported((4, 96), (96, 32), (3, 32))
    assert not tqm.w4p_supported((4, 96), (40, 32), (3, 32))  # not K/2 rows
    assert tqm.w4a16_supported((8192 * 4, 64), (64, 32), (2, 32))
    assert tqm.w4p_supported((tqm.W4_MAX_ROWS, 64), (32, 32), (2, 32))
    assert not tqm.w4a16_supported((tqm.W4_MAX_ROWS + 1, 64), (64, 32), (2, 32))
    assert not tqm.w4a16_supported((4, 100), (100, 32), (3, 32))  # G does not divide


# ---------------------------------------------------------------------------
# linear() and params.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(3,), (2, 5)])
@pytest.mark.parametrize("G", [32, 128])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_linear_w4_matches_jax(layout, packed, G, lead):
    qt = LAYOUTS[layout]
    _, payload = _awq_weight(96, 256, G, layout, seed=G)
    jp = (jawq.build_awq_linear_packed if packed else jawq.build_awq_linear)(*payload, qt)
    rng = np.random.default_rng(4)
    jp["b"] = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal(lead + (256,)).astype(np.float32)
    res = rng.standard_normal(lead + (96,)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jlinear({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x),
                      activation=jax.nn.silu, residual=jnp.asarray(res))
    tp = params_from_numpy({"lin": jp}, None)["lin"]
    assert sorted(tp) == sorted(jp)
    assert tp["w4p" if packed else "w4"].dtype == torch.int8
    out = tlinear(tp, torch.from_numpy(x), activation=torch.nn.functional.silu,
                  residual=torch.from_numpy(res))
    assert tuple(out.shape) == lead + (96,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def awq_dirs(tmp_path_factory):
    dirs = {}
    for q in ("awq_gemm", "awq_gemv"):
        dirs[q] = tbuilder.build_decoder_only_model(
            str(tmp_path_factory.mktemp(q)), quantization=q, **MODEL)
    return dirs


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("packed", ["0", "1"])
@pytest.mark.parametrize("quantization", ["awq_gemm", "awq_gemv"])
def test_params_from_numpy_equals_awq_load(awq_dirs, monkeypatch, quantization, packed):
    monkeypatch.setenv("CT2TPU_W4_PACKED", packed)
    jm = ct.Generator(awq_dirs[quantization], device="cpu").model
    tm = tt.load_model(awq_dirs[quantization], device="cpu")
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.arch)
    a, b = dict(_leaves(carried)), dict(_leaves(tm.params))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name
    key = "w4p" if packed == "1" else "w4"
    qkv = tm.params["decoder"]["layers"][0]["self_attention"]["qkv"]
    assert sorted(qkv) == sorted(["b", "g_scale", key] + (["g_zs"] if key == "w4p" else []))
    # The layers' linears are W4; the projection stays float.
    assert "w" in tm.params["decoder"]["projection"]


@pytest.mark.parametrize("packed", [False, True])
def test_split_linear_slices_w4_leaves_like_jax(awq_dirs, packed):
    """A fused W4 linear split along its output axis (g_scale and g_zs
    sliced with the payload) equals the JAX package's unfused split."""
    from ctranslate2_tpu.models.params import ParamsBuilder as JParamsBuilder

    path = awq_dirs["awq_gemm"]
    jm = jloader.load_model(path, fuse_qkv=False)
    tm = tt.load_model(path, device="cpu")
    scope = "decoder/layer_1/self_attention/linear_0"
    jb = JParamsBuilder(jm.mf, jm.policy)
    fused = tawq.build_awq_linear_lazy(
        jm.mf.get(scope + "/weight").array, jm.mf.get(scope + "/weight_scale").as_float32(),
        jm.mf.get(scope + "/weight_zero").array, jawq.AWQ_GEMM, packed=packed)
    parts = ParamsBuilder(tm.mf, tm.policy, "cpu")._split_linear(fused, [64, 32, 32])
    jfused = (jawq.build_awq_linear_packed if packed else jawq.build_awq_linear)(
        jm.mf.get(scope + "/weight").array, jm.mf.get(scope + "/weight_scale").as_float32(),
        jm.mf.get(scope + "/weight_zero").array, jawq.AWQ_GEMM)
    jparts = jb._split_linear(jfused, [64, 32, 32])
    for p, jp in zip(parts, jparts):
        assert p.keys() == jp.keys()
        for key in p:
            assert p[key].is_contiguous()
            np.testing.assert_array_equal(p[key].numpy(), np.asarray(jp[key]))


def test_awq_compute_type_policy(awq_dirs):
    """An AWQ model runs float16 activations on the card and float32 on the
    CPU; its layer linears stay W4 whatever the compute type asks."""
    mf = tt.load_model(awq_dirs["awq_gemm"], device="cpu").mf
    assert _weights_dtype(mf) == "float16"
    card = resolve_compute_type("default", _weights_dtype(mf), "cuda")
    assert (card.activation_dtype, card.quantize_activations) == ("float16", False)
    for compute_type in ("int8", "float32", "bfloat16"):
        tm = tt.load_model(awq_dirs["awq_gemm"], compute_type=compute_type, device="cpu")
        assert "w4" in tm.params["decoder"]["layers"][0]["ffn"]["linear_1"]


# ---------------------------------------------------------------------------
# Generator.generate_batch.
# ---------------------------------------------------------------------------

def _prompts(seed=0, lengths=(9, 5, 7, 12)):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(0, 90, n)] for n in lengths]


@pytest.mark.parametrize("beam_size", [1, 2])
@pytest.mark.parametrize("include_prompt", [True, False])
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("packed", ["0", "1"])
@pytest.mark.parametrize("quantization", ["awq_gemm", "awq_gemv"])
def test_awq_generate_batch_token_identical(awq_dirs, monkeypatch, quantization,
                                            packed, kv, include_prompt, beam_size):
    monkeypatch.setenv("CT2TPU_W4_PACKED", packed)
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    jg = ct.Generator(awq_dirs[quantization], device="cpu")
    tg = tt.Generator(awq_dirs[quantization], device="cpu")
    assert ("w4p" in tg.model.params["decoder"]["layers"][1]["ffn"]["linear_0"]) \
        == (packed == "1")
    prompts = _prompts(beam_size)  # ragged
    opts = dict(max_length=10, return_scores=True, beam_size=beam_size,
                num_hypotheses=beam_size, include_prompt_in_result=include_prompt)
    ref = jg.generate_batch(prompts, **opts)
    out = tg.generate_batch(prompts, **opts)
    assert len(out) == len(ref) == len(prompts)
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids
        assert o.sequences == r.sequences
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("packed", ["0", "1"])
@pytest.mark.parametrize("quantization", ["awq_gemm", "awq_gemv"])
def test_awq_translator_token_identical(tmp_path, monkeypatch, quantization, packed):
    """An encoder-decoder model with AWQ layer linears: the cross-attention
    K/V projection is one fused W4 linear split along its output axis
    (``_split_linear`` slices the payload, ``g_scale`` and ``g_zs``); the
    builders write the same files, and beam search gives the same tokens."""
    monkeypatch.setenv("CT2TPU_W4_PACKED", packed)
    kwargs = dict(quantization=quantization, vocab_size=60, num_layers=2, num_heads=4,
                  d_model=64, d_ff=128)
    path = tbuilder.build_seq2seq_model(str(tmp_path / "port"), **kwargs)
    ref_path = jbuilder.build_seq2seq_model(str(tmp_path / "jax"), **kwargs)
    names = sorted(os.listdir(path))
    match, mismatch, errors = filecmp.cmpfiles(path, ref_path, names, shallow=False)
    assert (sorted(match), mismatch, errors) == (names, [], [])
    jt = ct.Translator(path, device="cpu")
    tr = tt.Translator(path, device="cpu")
    k = tr.model.params["decoder"]["layers"][0]["attention"]["k"]
    assert ("w4p" in k) == (packed == "1") and k["g_scale"].shape == (2, 64)
    rng = np.random.default_rng(5)
    sources = [[f"tok{int(t)}" for t in rng.integers(0, 50, n)] for n in (5, 9, 3)]
    opts = dict(beam_size=2, max_decoding_length=10, return_scores=True)
    for o, r in zip(tr.translate_batch(sources, **opts), jt.translate_batch(sources, **opts)):
        assert o.hypotheses == r.hypotheses
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-4, rtol=1e-4)
