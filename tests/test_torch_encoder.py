"""The port's ``Encoder`` against the JAX package's, on the CPU.

The encoder-only model is a BERT-style ``TransformerEncoderSpec``
fabricated with the port's ``SpecBuilder`` (``build_bert_model`` in
tests/test_torch_cuda.py, which imports no JAX), laid out as the JAX
package's Transformers converter writes BERT (post-norm layers, word and
token-type embeddings merged by addition, learned positions,
``layernorm_embedding``, no output norm, a ``pooler_dense`` head with
tanh): 2 layers, d_model 64, 4 heads, ffn 128, 96 words, float32 and int8.
Its variable names and attributes are those the converter writes for a
tiny ``transformers.BertModel``, and the port's Encoder on that converted
model matches the Hugging Face model itself within 2e-3 (the converter
test's tolerance).

``last_hidden_state`` and ``pooler_output`` agree with
``ctranslate2_tpu.Encoder(..., device="cpu")`` within 1e-5 in float32; in
int8 (W8A8) within 1e-4, on fixed inputs free of half-step ties (see
tests/test_torch_translator.py). Of seeds 0-6 of ``_rows``, seed 4
without token types and seed 5 with them put an activation within an ulp
of a half step, which parts the two packages by about 5e-3; the tie test
shows on both that the half step is all that parts them: the two
packages' int8 activations are equal up to the first linear where they
part, there they part by one step at entries within 1e-4 of a step from
a half step, and the port fed the JAX package's int8 activations at every
linear agrees with it within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

import ctranslate2_tpu as ct
from ctranslate2_tpu.ops import linear as jlinear
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.ops import linear as tlinear
from ctranslate2_tpu_torch.converters import builder as tbuilder
from ctranslate2_tpu_torch.formats.model_file import load_model_file
from ctranslate2_tpu_torch.models.params import ParamsBuilder, params_from_numpy
from test_torch_cuda import build_bert_model

TOL = {"float32": 1e-5, "int8": 1e-4}
BERT = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=128,
            max_positions=64)


@pytest.fixture(scope="module")
def bert_dirs(tmp_path_factory):
    return {dtype: build_bert_model(str(tmp_path_factory.mktemp(f"bert_{dtype}")),
                                    quantization=quant, **BERT)
            for dtype, quant in (("float32", None), ("int8", "int8"))}


@pytest.fixture(scope="module")
def encoders(bert_dirs):
    return {dtype: (ct.Encoder(path, device="cpu"), tt.Encoder(path, device="cpu"))
            for dtype, path in bert_dirs.items()}


def _rows(seed=2):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(i)}" for i in rng.integers(0, 90, n)] for n in (5, 12, 9, 1)]


def _types(rows, seed=1):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 2, len(r))] for r in rows]


def _assert_same(out, ref, tol):
    h = np.asarray(ref.last_hidden_state)
    assert tuple(out.last_hidden_state.shape) == h.shape
    np.testing.assert_allclose(out.last_hidden_state.numpy(), h, atol=tol, rtol=0)
    if ref.pooler_output is None:
        assert out.pooler_output is None
    else:
        np.testing.assert_allclose(out.pooler_output.numpy(),
                                   np.asarray(ref.pooler_output), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("with_types", [False, True])
def test_forward_batch_matches(encoders, dtype, with_types):
    je, te = encoders[dtype]
    rows = _rows()
    types = _types(rows) if with_types else None
    out = te.forward_batch(rows, token_type_ids=types)
    _assert_same(out, je.forward_batch(rows, token_type_ids=types), TOL[dtype])
    assert out.pooler_output.shape == (len(rows), BERT["d_model"])
    assert out.last_hidden_state.shape == (len(rows), 16, BERT["d_model"])


# Half steps: how near one the JAX package's scaled activation must lie
# (in int8 steps) where the two packages' int8 activations first part.
TIE_DISTANCE = 1e-4


@pytest.mark.parametrize("seed,with_types", [(4, False), (5, True)])
def test_int8_disagreement_is_a_half_step_tie(encoders, monkeypatch, seed, with_types):
    """On inputs where the int8 Encoders disagree, the two packages' int8
    activations (every (q, scale) a linear takes, in program order) are
    equal up to the first place they part, and there they part by one step
    at half-step ties only; everything after follows from it: the port fed
    the JAX package's (q, scale) through ``int8_activations`` agrees with
    JAX within the float32 tolerance."""
    je, te = encoders["int8"]
    rows = _rows(seed)
    types = _types(rows) if with_types else None

    recorded = []  # JAX's (q, scale, x * scale), in program order
    quantize = jlinear.quantize_per_row

    def record(x, round_before_cast=True):
        q, scale = quantize(x, round_before_cast)
        jax.debug.callback(lambda q, scale, x: recorded.append((
            np.array(q), np.array(scale), np.array(x, np.float32) * np.array(scale)[..., None])),
            q, scale, x, ordered=True)
        return q, scale

    monkeypatch.setattr(jlinear, "quantize_per_row", record)
    jax.clear_caches()
    try:
        ref = je.forward_batch(rows, token_type_ids=types)
    finally:
        monkeypatch.setattr(jlinear, "quantize_per_row", quantize)
        jax.clear_caches()
    assert len(recorded) == 4 * BERT["num_layers"] + 1  # + the pooler

    seam = tlinear.int8_activations
    own = []

    def watch(q, scale, dtype):
        own.append((q.numpy().copy(), scale.numpy().copy()))
        return seam(q, scale, dtype)

    monkeypatch.setattr(tlinear, "int8_activations", watch)
    free = te.forward_batch(rows, token_type_ids=types)
    assert np.abs(free.last_hidden_state.numpy()
                  - np.asarray(ref.last_hidden_state)).max() > TOL["int8"]
    assert [q.shape for q, _ in own] == [q.shape for q, _, _ in recorded]
    parted = [i for i, ((q, _), (q_jax, _, _)) in enumerate(zip(own, recorded))
              if not np.array_equal(q, q_jax)]
    first = parted[0]
    for (_, scale), (_, scale_jax, _) in zip(own[:first], recorded[:first]):
        np.testing.assert_allclose(scale, scale_jax, rtol=1e-6, atol=0)
    q, (q_jax, _, scaled) = own[first][0], recorded[first]
    step = np.abs(q.astype(np.int32) - q_jax.astype(np.int32))
    assert step.max() == 1
    assert np.abs(scaled - np.floor(scaled) - 0.5)[step > 0].max() <= TIE_DISTANCE

    fed = iter(recorded)

    def replay(q, scale, dtype):
        q_jax, scale_jax, _ = next(fed)
        return seam(torch.from_numpy(q_jax), torch.from_numpy(scale_jax), dtype)

    monkeypatch.setattr(tlinear, "int8_activations", replay)
    _assert_same(te.forward_batch(rows, token_type_ids=types), ref, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_token_types_change_the_output(encoders, dtype):
    _, te = encoders[dtype]
    rows = _rows()
    plain = te.forward_batch(rows)
    zeros = te.forward_batch(rows, token_type_ids=[[0] * len(r) for r in rows])
    typed = te.forward_batch(rows, token_type_ids=_types(rows))
    assert torch.equal(plain.last_hidden_state, zeros.last_hidden_state)
    assert not torch.equal(plain.last_hidden_state, typed.last_hidden_state)


@pytest.mark.parametrize("kind", ["ids", "array", "tensor"])
def test_id_inputs_equal_token_inputs(encoders, kind):
    je, te = encoders["float32"]
    rows = _rows()
    vocab = te.model.source_vocabularies[0]
    ids = [[vocab.to_id(t) for t in r] for r in rows]
    ref = te.forward_batch(rows)
    lengths = None
    inputs = ids
    if kind != "ids":
        dense = np.zeros((len(ids), 13), np.int64)
        for i, r in enumerate(ids):
            dense[i, :len(r)] = r
        lengths = [len(r) for r in ids]
        inputs = dense if kind == "array" else torch.from_numpy(dense)
    out = te.forward_batch(inputs, lengths)
    assert torch.equal(out.last_hidden_state, ref.last_hidden_state)
    assert torch.equal(out.pooler_output, ref.pooler_output)
    _assert_same(out, je.forward_batch(dense if kind != "ids" else ids, lengths),
                 TOL["float32"])


def test_forward_batch_async(encoders):
    je, te = encoders["int8"]
    rows = _rows(seed=4)
    types = _types(rows)
    future = te.forward_batch_async(rows, token_type_ids=types)
    _assert_same(future.result(), je.forward_batch(rows, token_type_ids=types),
                 TOL["int8"])


def test_flash_attention_flag_changes_nothing_on_cpu(bert_dirs, encoders):
    te = tt.Encoder(bert_dirs["float32"], device="cpu", flash_attention=True)
    rows = _rows()
    assert torch.equal(te.forward_batch(rows).last_hidden_state,
                       encoders["float32"][1].forward_batch(rows).last_hidden_state)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_encoder_of_a_seq2seq_model(tmp_path, dtype):
    path = tbuilder.build_seq2seq_model(str(tmp_path / "s2s"), vocab_size=128,
                                        quantization=dtype if dtype == "int8" else None)
    rows = _rows(seed=6)
    out = tt.Encoder(path, device="cpu").forward_batch(rows)
    assert out.pooler_output is None
    _assert_same(out, ct.Encoder(path, device="cpu").forward_batch(rows), TOL[dtype])


def test_encoder_entry_checks(tmp_path, bert_dirs, monkeypatch):
    decoder = tbuilder.build_decoder_only_model(str(tmp_path / "dec"))
    with pytest.raises(ValueError, match="does not have an encoder"):
        tt.Encoder(decoder, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Encoder(bert_dirs["float32"])
    te = tt.Encoder(bert_dirs["int8"], device="cpu")
    assert te.device == "cpu" and te.compute_type == "int8_float32"
    assert not te.model.is_sequence_to_sequence and not te.model.is_decoder_only


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_params_from_numpy_equals_loader_encoder_only(bert_dirs, dtype):
    """The encoder-only tree (two embeddings, learned positions, the
    embedding norm, post-norm layers) and the pooler linear, carried
    across from the JAX package, equal the port's own load."""
    from ctranslate2_tpu.models import loader as jloader
    from ctranslate2_tpu.models import params as jparams

    jm = jloader.load_model(bert_dirs[dtype])
    tm = tt.load_model(bert_dirs[dtype], device="cpu")
    assert set(jm.params) == {"encoder"}
    trees = {
        "model": (params_from_numpy(jax.tree.map(np.asarray, jm.params), tm.arch),
                  tm.params),
        "pooler": (params_from_numpy(jax.tree.map(np.asarray, jparams.finalize_params(
                       jparams.ParamsBuilder(jm.mf, jm.policy).linear("pooler_dense"))),
                       tm.arch),
                   ParamsBuilder(tm.mf, tm.policy, "cpu").linear("pooler_dense")),
    }
    for carried, own in trees.values():
        a, b = dict(_leaves(carried)), dict(_leaves(own))
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            assert torch.equal(a[name], b[name]), name
    names = dict(_leaves(trees["model"][0]))
    assert "/encoder/layernorm_embedding/beta" in names
    assert "/encoder/position_encodings" in names
    assert len(tm.params["encoder"]["embeddings"]) == 2


# ---------------------------------------------------------------------------
# Against a converted transformers.BertModel.
# ---------------------------------------------------------------------------


class _Tokenizer:
    bos_token, eos_token, unk_token, pad_token = "<s>", "</s>", "<unk>", "<pad>"

    def __init__(self, vocab_size):
        self._vocab = {f"tk{i}": i for i in range(vocab_size)}
        self._vocab.update({"<s>": 0, "</s>": 1, "<unk>": 2, "<pad>": 3})

    def get_vocab(self):
        return self._vocab


@pytest.fixture(scope="module")
def converted_bert(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    from ctranslate2_tpu.converters.transformers_conv import TransformersConverter

    torch.manual_seed(0)
    cfg = transformers.BertConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64)
    model = transformers.BertModel(cfg).eval()
    out = str(tmp_path_factory.mktemp("converted_bert") / "model")
    TransformersConverter(model=model, tokenizer=_Tokenizer(64)).convert(out, force=True)
    return model, out


def test_fabricated_layout_is_the_converters(converted_bert, bert_dirs):
    _, path = converted_bert
    ours = load_model_file(bert_dirs["float32"])
    theirs = load_model_file(path)
    assert (ours.spec_name, ours.spec_revision) == (theirs.spec_name, theirs.spec_revision)

    def names(mf):
        # The converter stores equal arrays once, the others as aliases.
        return set(mf.variables) | {a for a in mf.aliases
                                    if not a.endswith(("_scale", "_zero"))}

    assert names(ours) == names(theirs)
    for name in ("encoder/pre_norm", "encoder/embeddings_merge", "encoder/activation",
                 "pooler_activation"):
        assert ours.attribute(name, None) == theirs.attribute(name, None), name


def test_converted_bert_matches_transformers(converted_bert):
    model, path = converted_bert
    ids = [[4, 9, 17, 23, 5], [7, 8, 30, 0, 0]]
    types = [[0, 0, 1, 1, 1], [0, 1, 1, 0, 0]]
    lengths = [5, 3]
    out = tt.Encoder(path, device="cpu").forward_batch(
        np.asarray(ids), lengths, token_type_ids=types)
    mask = torch.tensor([[1] * n + [0] * (5 - n) for n in lengths])
    with torch.no_grad():
        theirs = model(torch.tensor(ids), attention_mask=mask,
                       token_type_ids=torch.tensor(types))
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out.last_hidden_state[i, :n].numpy(),
                                   theirs.last_hidden_state[i, :n].numpy(),
                                   atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(out.pooler_output.numpy(),
                               theirs.pooler_output.numpy(), atol=2e-3, rtol=1e-3)
