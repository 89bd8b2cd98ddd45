"""The fused norm's forms on the CPU against the JAX package's eager
sequence, and the port's models on the fused structure against the JAX
package.

``fused_norm_plain`` (and ``fused_norm`` on a CPU tensor) computes, step by
step: the residual add in x's type, the norm, ``quantize_per_row`` of its
output. The JAX side is the same sequence: the jnp add in x's type,
``ctranslate2_tpu.kernels.norms.fused_norm(..., interpret=True)``, then
``ctranslate2_tpu.ops.linear.quantize_per_row``. Tolerances: the sum
bit-equal; y within atol/rtol 1e-5 (float32 statistics summed in other
orders, as test_norm_plain_matches_pallas_interpret); q and scale bit-equal
to JAX's ``quantize_per_row`` of the port's own y (the scale is one IEEE
division, the rounding half to even in both).

In a pre-norm layer the residual add moves from the linear before the norm
into the norm, and under W8A8 the norm quantizes once for every int8 linear
that reads its output (the fused QKV, the cross-attention query, both GLU
linears, the projection after the output norm); the encoder's memory is
quantized once for every decoder layer's cross K and V. Every quantization
passes once through ``ops.linear.int8_activations``, which the model tests
below count. Their outputs stay token-identical to the JAX package (the
int8 inputs are the tie-free ones of test_torch_translator.py and
test_torch_generator.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters.builder import (build_decoder_only_model,
                                                build_seq2seq_model)
from ctranslate2_tpu.kernels.norms import fused_norm as jax_fused_norm
from ctranslate2_tpu.models import loader as jloader
from ctranslate2_tpu.models import transformer as JT
from ctranslate2_tpu.ops import attention as jattn
from ctranslate2_tpu.ops.linear import quantize_per_row as jax_quantize_per_row
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch import kernels
from ctranslate2_tpu_torch.kernels.norms import NormOut, fused_norm, fused_norm_plain
from ctranslate2_tpu_torch.models import loader as tloader
from ctranslate2_tpu_torch.models import transformer as TT
from ctranslate2_tpu_torch.ops import attention as tattn
from ctranslate2_tpu_torch.ops import linear as L
from ctranslate2_tpu_torch.ops.norms import add_and_norm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float16": (jnp.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODES = {"norm": (False, False), "residual": (True, False),
         "int8": (False, True), "residual_int8": (True, True)}


def _inputs(D, layer_norm, seed=0, rows=9):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, D)) * 2 + 0.5).astype(np.float32)
    r = rng.standard_normal((rows, D)).astype(np.float32)
    x[3] = 0.0  # a row of zeros, in x and in x + r
    r[3] = 0.0
    gamma = rng.standard_normal(D).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32) if layer_norm else None
    return x, r, gamma, beta


def _jax_sequence(x, r, gamma, beta, jdt, residual):
    s = jnp.asarray(x).astype(jdt)
    if residual:
        s = s + jnp.asarray(r).astype(jdt)
    y = jax_fused_norm(s, jnp.asarray(gamma),
                       None if beta is None else jnp.asarray(beta),
                       eps=1e-5, interpret=True)
    return s, y


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("D", [40, 100])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer_norm", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_forms_match_jax_sequence(mode, layer_norm, dtype, D):
    residual, quantize = MODES[mode]
    jdt, tdt = DTYPES[dtype]
    x, r, gamma, beta = _inputs(D, layer_norm)
    s_ref, y_ref = _jax_sequence(x, r, gamma, beta, jdt, residual)
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
            None if beta is None else torch.from_numpy(beta))
    kw = dict(eps=1e-5, residual=torch.from_numpy(r).to(tdt) if residual else None,
              quantize=quantize)
    before = kernels.launch_counts()["fused_norm"]
    out = fused_norm(*args, **kw)
    assert kernels.launch_counts()["fused_norm"] == before  # the CPU launches none
    plain = fused_norm_plain(*args, **kw)
    if not (residual or quantize):
        assert torch.equal(out, plain)
        out = NormOut(None, out, None, None)
    else:
        assert all(a is b is None or torch.equal(a, b) for a, b in zip(out, plain))
    assert out.y.dtype == tdt and out.y.shape == x.shape
    np.testing.assert_allclose(out.y.float().numpy(), _f32(y_ref), atol=1e-5, rtol=1e-5)
    if residual:
        assert out.sum.dtype == tdt
        np.testing.assert_array_equal(out.sum.float().numpy(), _f32(s_ref))
    else:
        assert out.sum is None
    if quantize:
        q_ref, scale_ref = jax_quantize_per_row(jnp.asarray(out.y.float().numpy()).astype(jdt))
        assert out.q.dtype == torch.int8 and out.scale.dtype == torch.float32
        np.testing.assert_array_equal(out.q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(out.scale.numpy(), np.asarray(scale_ref))
    else:
        assert out.q is None and out.scale is None


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layer_norm", [True, False])
def test_rows_of_zeros_quantize_with_scale_one(layer_norm, dtype):
    """A row whose output is all zeros (x + r = 0; LayerNorm's beta 0 there
    too) takes scale 1 and q 0, as the JAX package's quantize_per_row."""
    jdt, tdt = DTYPES[dtype]
    x, r, gamma, beta = _inputs(24, layer_norm, seed=1, rows=5)
    r[1] = -x[1]
    if layer_norm:
        beta[:] = 0.0
    out = fused_norm_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
                           None if beta is None else torch.from_numpy(beta),
                           eps=1e-5, residual=torch.from_numpy(r).to(tdt),
                           quantize=True)
    assert out.scale[1].item() == 1.0 and out.scale[3].item() == 1.0
    assert not out.q[1].any() and not out.q[3].any()
    q_ref, scale_ref = jax_quantize_per_row(jnp.asarray(out.y.float().numpy()).astype(jdt))
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(scale_ref))


@pytest.mark.parametrize("keep_sum,keep_y", [(True, False), (False, True), (False, False)])
def test_fused_forms_leave_out_what_is_not_kept(keep_sum, keep_y):
    x, r, gamma, _ = _inputs(16, False, rows=4)
    xt, rt, gt = map(torch.from_numpy, (x, r, gamma))
    full = fused_norm(xt, gt, eps=1e-5, residual=rt, quantize=True)
    out = fused_norm(xt, gt, eps=1e-5, residual=rt, quantize=True,
                     keep_sum=keep_sum, keep_y=keep_y)
    assert (out.sum is not None) == keep_sum and (out.y is not None) == keep_y
    assert torch.equal(out.q, full.q) and torch.equal(out.scale, full.scale)
    with pytest.raises(ValueError, match="writes y"):
        fused_norm(xt, gt, eps=1e-5, residual=rt, keep_y=False)
    with pytest.raises(ValueError, match="residual of x's shape and type"):
        fused_norm(xt, gt, eps=1e-5, residual=rt.double())


@pytest.mark.parametrize("layer_norm", [True, False])
def test_add_and_norm_quantizes_through_the_seam(monkeypatch, layer_norm):
    x, r, gamma, beta = _inputs(32, layer_norm, seed=2, rows=4)
    params = {"gamma": torch.from_numpy(gamma)}
    if layer_norm:
        params["beta"] = torch.from_numpy(beta)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    seen = []
    seam = L.int8_activations
    monkeypatch.setattr(L, "int8_activations",
                        lambda q, scale, dtype: seen.append(q) or seam(q, scale, dtype))
    s, h = add_and_norm(params, xt, 1e-5, residual=rt, quantize=True)
    assert len(seen) == 1 and isinstance(h, L.Int8Activations) and h.q is seen[0]
    assert torch.equal(s, xt + rt) and h.dtype == torch.float32
    q, scale = L.quantize_per_row(fused_norm_plain(xt + rt, params["gamma"],
                                                   params.get("beta"), eps=1e-5))
    assert torch.equal(h.q, q) and torch.equal(h.scale, scale)
    s, y = add_and_norm(params, xt, 1e-5, residual=rt, keep_sum=False)
    assert s is None and len(seen) == 1
    assert torch.equal(y, fused_norm_plain(xt + rt, params["gamma"],
                                           params.get("beta"), eps=1e-5))


def test_linear_takes_int8_activations():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 48)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (24, 48)).astype(np.int8))
    params = {"wq": wq, "scale": torch.full((24,), 127.0 / 0.05),
              "b": torch.from_numpy(rng.standard_normal(24).astype(np.float32))}
    y = L.linear(params, L.quantize_input(x))
    assert y.shape == (2, 3, 24) and y.dtype == torch.float32
    assert torch.equal(y, L.linear(params, x))
    with pytest.raises(ValueError, match="only an int8"):
        L.linear({"w": torch.zeros(48, 24)}, L.quantize_input(x))
    with pytest.raises(ValueError, match="only an int8"):
        L.linear(params, L.quantize_input(x), quantize_activations=False)


# ---------------------------------------------------------------------------
# Models on the fused structure.
# ---------------------------------------------------------------------------


class _Watch:
    """Counts the quantizations (calls of the seam) and records, for each
    linear call, the params it ran and the Int8Activations it was given."""

    def __init__(self, monkeypatch):
        self.quantized = 0
        self.calls = []
        seam, lin = L.int8_activations, TT.linear

        def counted(q, scale, dtype):
            self.quantized += 1
            return seam(q, scale, dtype)

        def logged(params, x, *args, **kwargs):
            self.calls.append((params, x if isinstance(x, L.Int8Activations) else None))
            return lin(params, x, *args, **kwargs)

        monkeypatch.setattr(L, "int8_activations", counted)
        monkeypatch.setattr(TT, "linear", logged)

    def fed(self, params):
        """The Int8Activations given to each call of ``params``."""
        return [a for p, a in self.calls if p is params]


DECODER = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
               num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
               activation="swish")


@pytest.fixture(scope="module")
def int8_decoder(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decoder_int8_fusion"))
    return build_decoder_only_model(path, quantization="int8", **DECODER)


def _prompts(seed=0, lengths=(9, 5, 7, 12)):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(0, 90, n)] for n in lengths]


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_int8_glu_decoder_token_identical_to_jax(int8_decoder, monkeypatch, kv):
    if kv == "int8":
        monkeypatch.setenv("CT2TPU_KV_CACHE", "int8")
    opts = dict(max_length=12, return_scores=True, include_prompt_in_result=False)
    ref = ct.Generator(int8_decoder, device="cpu").generate_batch(_prompts(), **opts)
    out = tt.Generator(int8_decoder, device="cpu").generate_batch(_prompts(), **opts)
    for o, r in zip(out, ref):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=1e-4, rtol=1e-4)


def test_int8_glu_decoder_quantizes_once_per_norm(int8_decoder, monkeypatch):
    """One quantization for the fused QKV, one for the GLU pair, one for the
    projection after the output norm (all made by the norms), and one each
    for the output projection and linear_1 (quantize_input): 4 a layer + 1."""
    m = tloader.load_model(int8_decoder, device="cpu")
    arch, dp = m.arch, m.params["decoder"]
    layers = len(arch.decoder.layers)
    watch = _Watch(monkeypatch)
    ids = torch.from_numpy(np.random.default_rng(4).integers(3, 90, (2, 6)))
    TT.decoder_forward(arch, m.params, m.ensure_consts(16), ids, 0, None,
                       quantize_acts=True)
    assert watch.quantized == 4 * layers + 1
    for lp in dp["layers"]:
        ffn = lp["ffn"]
        (glu_a,), (glu_b,) = watch.fed(ffn["linear_0"]), watch.fed(ffn["linear_0_noact"])
        assert glu_a is not None and glu_a is glu_b  # one quantization, two linears
        assert watch.fed(lp["self_attention"]["qkv"])[0] is not None
        assert watch.fed(ffn["linear_1"]) == [None]  # quantized inside linear
    assert watch.fed(dp["projection"])[0] is not None
    assert len(watch.calls) == 5 * layers + 1


@pytest.fixture(scope="module")
def seq2seq_models(tmp_path_factory):
    out = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"seq2seq_fusion_{dtype}"))
        build_seq2seq_model(path, vocab_size=128, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, quantization=quant)
        out[dtype] = path
    return out


def _source(n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [[f"tok{i}" for i in rng.integers(0, 125, rng.integers(3, 15))]
            for _ in range(n)]


@pytest.mark.parametrize("beam", [1, 2])
def test_int8_seq2seq_token_identical_to_jax(seq2seq_models, beam):
    opts = dict(beam_size=beam, max_decoding_length=24, return_scores=True)
    ref = ct.Translator(seq2seq_models["int8"], device="cpu").translate_batch(_source(), **opts)
    out = tt.Translator(seq2seq_models["int8"], device="cpu").translate_batch(_source(), **opts)
    assert [r.hypotheses for r in out] == [r.hypotheses for r in ref]
    np.testing.assert_allclose([s for r in out for s in r.scores],
                               [s for r in ref for s in r.scores], atol=1e-4, rtol=1e-4)


def test_int8_seq2seq_quantizes_memory_once(seq2seq_models, monkeypatch):
    """Encoder: 4 quantizations a layer (QKV and linear_0 by the norms, the
    output projection and linear_1 inside their linears); one for every
    decoder layer's cross K and V; decoder: 6 a layer (QKV, cross query and
    linear_0 by the norms) and the projection's, by the output norm."""
    m = tloader.load_model(seq2seq_models["int8"], device="cpu")
    arch, params = m.arch, m.params
    ne, nd = len(arch.encoder.layers), len(arch.decoder.layers)
    consts = m.ensure_consts(16)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(3, 128, (3, 7)))
    lengths = torch.tensor([7, 4, 6])
    watch = _Watch(monkeypatch)
    memory = TT.encoder_forward(arch, params, consts, ids, lengths, quantize_acts=True)
    assert watch.quantized == 4 * ne
    mem_kv = TT.precompute_memory(arch, params, memory, quantize_acts=True)
    assert watch.quantized == 4 * ne + 1
    fed = [a for lp in params["decoder"]["layers"] for n in ("k", "v")
           for a in watch.fed(lp["attention"][n])]
    assert len(fed) == 2 * nd and all(a is fed[0] for a in fed) and fed[0] is not None
    start = torch.ones((3, 1), dtype=torch.long)
    TT.decoder_forward(arch, params, consts, start, 0, None, mem_kv,
                       tattn.length_mask_bias(lengths, 7), quantize_acts=True)
    assert watch.quantized == 4 * ne + 1 + 6 * nd + 1
    assert watch.fed(params["decoder"]["projection"])[0] is not None


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_post_norm_layers_match_jax(seq2seq_models, dtype):
    """Post-norm layers (norm(y + x) after each block: the add inside the
    norm, its sum not kept) give the JAX package's memory and logits within
    1e-4. The builders write pre-norm models, so both packages' arch specs
    are switched."""
    path = seq2seq_models[dtype]
    jm, tm = jloader.load_model(path), tloader.load_model(path, device="cpu")

    def post(arch):
        return dataclasses.replace(
            arch, encoder=dataclasses.replace(arch.encoder, pre_norm=False),
            decoder=dataclasses.replace(arch.decoder, pre_norm=False))

    jarch, tarch = post(jm.arch), post(tm.arch)
    qa = tm.policy.quantize_activations
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 128, (3, 9))
    lengths = np.array([9, 5, 7])
    jc, tc = jm.ensure_consts(16), tm.ensure_consts(16)
    jmem = JT.encoder_forward(jarch, jm.params, jc, jnp.asarray(ids),
                              jnp.asarray(lengths), quantize_acts=qa)
    tmem = TT.encoder_forward(tarch, tm.params, tc, torch.from_numpy(ids),
                              torch.from_numpy(lengths), quantize_acts=qa)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), atol=1e-4, rtol=1e-4)
    jkv = JT.precompute_memory(jarch, jm.params, jmem, quantize_acts=qa)
    tkv = TT.precompute_memory(tarch, tm.params, tmem, quantize_acts=qa)
    seq = rng.integers(3, 128, (3, 5))
    jl, _, _ = JT.decoder_forward(jarch, jm.params, jc, jnp.asarray(seq), 0, None,
                                  jkv, jattn.length_mask_bias(jnp.asarray(lengths), 9),
                                  quantize_acts=qa)
    tl, _ = TT.decoder_forward(tarch, tm.params, tc, torch.from_numpy(seq), 0, None,
                               tkv, tattn.length_mask_bias(torch.from_numpy(lengths), 9),
                               quantize_acts=qa)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
