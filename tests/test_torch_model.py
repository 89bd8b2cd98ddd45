"""The port's Transformer forwards against the JAX package's, on one
builder model (2+2 layers, d_model 64, vocabulary 128), float32 and int8.

Both packages load the same model.bin. The port runs once on params from
its own loader and once on the JAX package's params carried across with
``params_from_numpy``; the two param sets must be equal. Logits agree
within 1e-4 (float32 on the CPU, sums in different orders; under int8 an
activation whose scaled value lands within an ulp of a rounding boundary
may quantize one step apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ctranslate2_tpu.converters.builder import build_seq2seq_model
from ctranslate2_tpu.models import loader as jloader
from ctranslate2_tpu.models import transformer as JT
from ctranslate2_tpu.ops import attention as jattn
from ctranslate2_tpu_torch.models import loader as tloader
from ctranslate2_tpu_torch.models import transformer as TT
from ctranslate2_tpu_torch.models.params import params_from_numpy
from ctranslate2_tpu_torch.ops import attention as tattn

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", params=["float32", "int8"])
def models(request, tmp_path_factory):
    quant = None if request.param == "float32" else "int8"
    path = str(tmp_path_factory.mktemp(f"seq2seq_{request.param}"))
    build_seq2seq_model(path, vocab_size=128, num_layers=2, num_heads=4,
                        d_model=64, d_ff=128, quantization=quant)
    jm = jloader.load_model(path)
    tm = tloader.load_model(path, device="cpu")
    return jm, tm


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_params_from_numpy_equals_loader(models):
    jm, tm = models
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.arch)
    a, b = dict(_leaves(carried)), dict(_leaves(tm.params))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def _inputs():
    rng = np.random.default_rng(0)
    lengths = np.array([11, 4, 16], np.int64)
    ids = np.zeros((3, 16), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(3, 128, n)
    return ids, lengths


@pytest.mark.parametrize("carried", [False, True])
def test_encoder_memory_decoder_logits_match(models, carried):
    jm, tm = models
    arch = tm.arch
    qa = tm.policy.quantize_activations
    assert qa == jm.policy.quantize_activations
    params = (params_from_numpy(jax.tree.map(np.asarray, jm.params), arch)
              if carried else tm.params)
    ids, lengths = _inputs()
    C = 64
    jc = jm.ensure_consts(C)
    tc = tm.ensure_consts(C)

    jmem = JT.encoder_forward(jm.arch, jm.params, jc, jnp.asarray(ids),
                              jnp.asarray(lengths), quantize_acts=qa)
    tmem = TT.encoder_forward(arch, params, tc, torch.from_numpy(ids),
                              torch.from_numpy(lengths), quantize_acts=qa)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)

    jkv = JT.precompute_memory(jm.arch, jm.params, jmem, quantize_acts=qa)
    tkv = TT.precompute_memory(arch, params, tmem, quantize_acts=qa)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a["k"].numpy(), np.asarray(b["k"]), **TOL)
        np.testing.assert_allclose(a["v"].numpy(), np.asarray(b["v"]), **TOL)

    jbias = jattn.length_mask_bias(jnp.asarray(lengths), 16)
    tbias = tattn.length_mask_bias(torch.from_numpy(lengths), 16)
    jcache = JT.init_self_cache(jm.arch, 3, C)
    tcache = TT.init_self_cache(arch, 3, C)
    tokens = np.array([[1], [1], [1]], np.int64)
    steps = np.random.default_rng(1).integers(3, 128, (5, 3))
    for pos in range(5):
        jl, jcache, _ = JT.decoder_forward(
            jm.arch, jm.params, jc, jnp.asarray(tokens), pos, jcache, jkv,
            jbias, quantize_acts=qa)
        tl, tcache = TT.decoder_forward(
            arch, params, tc, torch.from_numpy(tokens), pos, tcache, tkv,
            tbias, quantize_acts=qa)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tokens = steps[pos][:, None]
    for a, b in zip(tcache, jcache):
        np.testing.assert_allclose(a["k"].numpy(), np.asarray(b["k"]), **TOL)

    # Full-sequence mode (no cache): causal masking over T positions.
    seq = np.concatenate([np.ones((3, 1), np.int64), steps[:4].T], axis=1)
    jl, _, _ = JT.decoder_forward(jm.arch, jm.params, jc, jnp.asarray(seq), 0,
                                  None, jkv, jbias, quantize_acts=qa)
    tl, _ = TT.decoder_forward(arch, params, tc, torch.from_numpy(seq), 0,
                               None, tkv, tbias, quantize_acts=qa)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_cache_gather_rows_matches(models):
    jm, tm = models
    rng = np.random.default_rng(2)
    cache = [{"k": rng.standard_normal((4, 4, 8, 16)).astype(np.float32),
              "v": rng.standard_normal((4, 4, 8, 16)).astype(np.float32)}
             for _ in tm.arch.decoder.layers]
    rows = np.array([1, 1, 3, 0], np.int32)
    jout = JT.cache_gather_rows(jax.tree.map(jnp.asarray, cache), jnp.asarray(rows))
    tout = TT.cache_gather_rows(
        [{k: torch.from_numpy(v) for k, v in c.items()} for c in cache],
        torch.from_numpy(rows))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a["k"].numpy(), np.asarray(b["k"]))
        np.testing.assert_array_equal(a["v"].numpy(), np.asarray(b["v"]))


def test_unported_flash_length_raises_on_card(monkeypatch):
    """Where the JAX package takes its flash kernel (uncached
    self-attention of T, S >= CT2TPU_FLASH_MIN_LEN on its accelerator), the
    port on the card used to raise; it now dispatches to its own flash
    kernel under the same static conditions. The CPU and CT2TPU_FLASH=0
    take the plain attention, and ``flash_min_len`` (the
    ``flash_attention=True`` constructor flag) replaces the threshold."""
    class Card:  # stands in for a CUDA tensor: only is_cuda and shape are read
        is_cuda = True
        shape = (1, 8, 2048, 64)

    assert TT._flash_eligible(Card(), Card())
    short = Card()
    short.shape = (1, 8, 2047, 64)
    assert not TT._flash_eligible(short, Card())
    assert not TT._flash_eligible(Card(), short)
    assert TT._flash_eligible(short, short, min_len=0)
    assert not TT._flash_eligible(torch.zeros(1, 1, 2048, 4), torch.zeros(1, 1, 2048, 4))
    monkeypatch.setenv("CT2TPU_FLASH_MIN_LEN", "1024")
    assert TT._flash_eligible(short, short)
    monkeypatch.setenv("CT2TPU_FLASH", "0")
    assert not TT._flash_eligible(Card(), Card())
    assert not hasattr(TT, "_check_flash")


@pytest.fixture(scope="module")
def int8_at_float32(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("seq2seq_int8_as_float32"))
    build_seq2seq_model(path, vocab_size=128, num_layers=2, num_heads=4,
                        d_model=64, d_ff=128, quantization="int8")
    return (jloader.load_model(path, compute_type="float32"),
            tloader.load_model(path, compute_type="float32", device="cpu"))


def test_int8_file_at_float32_equals_jax_params(int8_at_float32):
    """An int8 file loaded at float32: the port dequantizes in torch on the
    model's device, bit for bit as the JAX package does on the host."""
    jm, tm = int8_at_float32
    carried = params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.arch)
    a, b = dict(_leaves(carried)), dict(_leaves(tm.params))
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("case", ["per_row", "one_scale", "scalar_scale", "int16_legacy",
                                  "conv_per_channel"])
def test_dequantize_equals_numpy_division(case):
    from ctranslate2_tpu_torch.formats.model_file import make_variable
    from ctranslate2_tpu_torch.models.params import _dequantize

    rng = np.random.default_rng(3)
    shape = (5, 3, 4) if case == "conv_per_channel" else (37, 29)
    dtype = np.int16 if case == "int16_legacy" else np.int8
    q = rng.integers(-127, 128, shape).astype(dtype)
    var = make_variable("w", q)
    s = {"per_row": rng.random(shape[0], np.float32) * 300 + 1,
         "one_scale": np.array([123.4567], np.float32),
         "scalar_scale": np.float32(987.654),
         "int16_legacy": None,
         "conv_per_channel": rng.random(shape[0], np.float32) * 300 + 1}[case]
    scale = None if s is None else make_variable("s", s)
    if s is None:
        want = q.astype(np.float32) / 1000.0
    elif np.size(s) == 1:
        want = q.astype(np.float32) / float(np.reshape(s, ()))
    else:
        want = q.astype(np.float32) / s.reshape((-1,) + (1,) * (q.ndim - 1))
    got = _dequantize(var, scale, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
