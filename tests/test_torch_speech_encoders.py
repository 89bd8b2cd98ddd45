"""The speech encoders of the port against the JAX package's, on the CPU:
``Wav2Vec2`` and ``Wav2Vec2Bert`` on directories that the JAX package's
``TransformersConverter`` writes from small random Hugging Face models
(the configurations of tests/test_transformers_converters.py), float32 and
int8, and ``ops/conv.py::conv1d`` against the JAX op.

Logits agree within ``TOL[dtype]`` (1e-5 in float32, 1e-4 in int8: under
W8A8 the inputs are fixed ones on which no activation sits at a half-step
tie); ``conv1d`` within 1e-6.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ctranslate2_tpu as ct
from ctranslate2_tpu.ops.conv import conv1d as jconv1d
from ctranslate2_tpu.runtime.wav2vec2 import Wav2Vec2 as JWav2Vec2
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.ops.conv import conv1d as tconv1d

TOL = {"float32": 1e-5, "int8": 1e-4}
COMPUTE = {"float32": "float32", "int8": "int8_float32"}

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
cs = importlib.import_module("chip_smoke")  # JAX-free: its speech fabricators


class _Tokenizer:
    bos_token, eos_token, unk_token, pad_token = "<s>", "</s>", "<unk>", "<pad>"

    def __init__(self, vocab_size):
        self._vocab = {f"tk{i}": i for i in range(vocab_size)}
        self._vocab.update({"<s>": 0, "</s>": 1, "<unk>": 2, "<pad>": 3})

    def get_vocab(self):
        return self._vocab


def _convert(model, path, vocab_size, quantization=None):
    from ctranslate2_tpu.converters.transformers_conv import TransformersConverter

    TransformersConverter(model=model, tokenizer=_Tokenizer(vocab_size)).convert(
        str(path), quantization=quantization, force=True)
    return str(path)


@pytest.fixture(scope="module")
def wav2vec2_dirs(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Wav2Vec2Config(
        vocab_size=32, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        conv_dim=(16, 16, 32), conv_stride=(5, 2, 2),
        conv_kernel=(10, 3, 3), num_feat_extract_layers=3,
        do_stable_layer_norm=True, feat_extract_norm="layer",
        num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16)
    model = transformers.Wav2Vec2ForCTC(cfg).eval()
    return {dtype: _convert(model, tmp_path_factory.mktemp(f"w2v_{dtype}"), 32,
                            None if dtype == "float32" else "int8")
            for dtype in TOL}


@pytest.fixture(scope="module")
def w2v_bert_dirs(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Wav2Vec2BertConfig(
        hidden_size=32, num_hidden_layers=2, num_adapter_layers=1,
        num_attention_heads=4, intermediate_size=64,
        feature_projection_input_dim=48, output_hidden_size=32,
        vocab_size=20, left_max_position_embeddings=8,
        right_max_position_embeddings=8,
        position_embeddings_type="relative_key",
        conv_depthwise_kernel_size=31, add_adapter=True,
        layerdrop=0.0, feat_proj_dropout=0.0, hidden_dropout=0.0)
    model = transformers.Wav2Vec2BertForCTC(cfg).eval()
    return {dtype: _convert(model, tmp_path_factory.mktemp(f"w2vbert_{dtype}"), 20,
                            None if dtype == "float32" else "int8")
            for dtype in TOL}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("samples", [400, 1234])
def test_wav2vec2_logits_match(wav2vec2_dirs, dtype, samples):
    audio = np.random.default_rng(samples).standard_normal(
        (3, 1, samples)).astype(np.float32)
    ref = JWav2Vec2(wav2vec2_dirs[dtype], device="cpu",
                    compute_type=COMPUTE[dtype]).encode(audio, to_cpu=True)
    port = tt.Wav2Vec2(wav2vec2_dirs[dtype], device="cpu", compute_type=COMPUTE[dtype])
    out = port.encode(audio, to_cpu=True)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.shape == ref.shape and ref.shape[-1] == 32
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL[dtype], rtol=0)
    assert port.model.policy.quantize_activations == (dtype == "int8")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("frames", [12, 37])
def test_wav2vec2bert_logits_match(w2v_bert_dirs, dtype, frames):
    feats = np.random.default_rng(frames).standard_normal(
        (2, frames, 48)).astype(np.float32)
    ref = ct.Wav2Vec2Bert(w2v_bert_dirs[dtype], compute_type=COMPUTE[dtype]).encode(
        feats, to_cpu=True)
    port = tt.Wav2Vec2Bert(w2v_bert_dirs[dtype], device="cpu",
                           compute_type=COMPUTE[dtype])
    out = port.encode(feats, to_cpu=True)
    assert out.shape == ref.shape and ref.shape[1] == (frames + 1) // 2
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL[dtype], rtol=0)
    assert port.compute_type == ("int8" if dtype == "int8" else "float32")
    assert port.spec.num_encoder_layers == 2 and port.spec.num_adapter_layers == 1


def test_speech_encoders_want_cuda_by_default(wav2vec2_dirs, w2v_bert_dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.Wav2Vec2(wav2vec2_dirs["float32"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.Wav2Vec2Bert(w2v_bert_dirs["float32"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.Wav2Vec2(wav2vec2_dirs["float32"], tensor_parallel=True)


def test_speech_encoders_reject_other_models(wav2vec2_dirs, w2v_bert_dirs):
    with pytest.raises(ValueError, match="not a Wav2Vec2Bert"):
        tt.Wav2Vec2Bert(wav2vec2_dirs["float32"], device="cpu")
    with pytest.raises(ValueError, match="not a Whisper"):
        tt.Whisper(wav2vec2_dirs["float32"], device="cpu")


CONV_CASES = {
    "plain": dict(),
    "stride_2_pad_1": dict(stride=2, padding=1),
    "stride_5": dict(stride=5),
    "dilation_2": dict(dilation=2, padding=2),
    "groups_4": dict(groups=4, padding=3),
    "depthwise": dict(groups=16, padding=1),
}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv1d_matches(case, bias):
    kw = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    groups = kw.get("groups", 1)
    x = rng.standard_normal((2, 16, 40)).astype(np.float32)
    w = rng.standard_normal((32, 16 // groups, 5)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32) if bias else None
    ref = np.asarray(jconv1d(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), **kw))
    out = tconv1d(torch.from_numpy(x), torch.from_numpy(w),
                  None if b is None else torch.from_numpy(b), **kw)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_conv1d_keeps_the_input_type():
    x = torch.randn(1, 4, 9, dtype=torch.float64)
    out = tconv1d(x, torch.randn(6, 4, 3), torch.randn(6), activation=torch.relu)
    assert out.dtype == torch.float64 and bool((out >= 0).all())


# ---------------------------------------------------------------------------
# chip_smoke.py's fabricators, at 2 layers and narrow widths: the JAX
# package's readers take their layouts, and both packages give the same
# outputs (float32 over the int8 payloads).
# ---------------------------------------------------------------------------

WHISPER_NARROW = dict(cs.WHISPER_LARGE_V3, d_model=64, heads=4, d_ff=128, n_mels=16,
                      source_positions=50, target_positions=64, text_tokens=40,
                      languages=3, timestamps=20)
# The positional convolution keeps its 128 taps in 16 groups: the reference
# fixes them (src/layers/wav2vec2.cc:30-46).
WAV2VEC2_NARROW = dict(cs.WAV2VEC2_LARGE, d_model=64, heads=4, d_ff=128, conv_dim=32)
W2V_BERT_NARROW = dict(cs.W2V_BERT_2, d_model=64, heads=4, d_ff=128, input_dim=24,
                       left=8, right=4)


def test_whisper_fabricator_loads_in_both(tmp_path):
    mf, vocab = cs.build_whisper_modelfile(2, WHISPER_NARROW)
    assert len(vocab) == 40 + 2 + 3 + 6 + 20
    path = cs.save_whisper(mf, vocab, str(tmp_path / "whisper"))
    jw = ct.Whisper(path, device="cpu", compute_type="float32")
    pw = tt.Whisper(path, device="cpu", compute_type="float32")
    assert pw.num_languages == jw.num_languages == 3 and pw.n_mels == 16
    feats = np.random.default_rng(0).standard_normal((2, 16, 100)).astype(np.float32)
    np.testing.assert_allclose(pw.encode(feats).numpy(), np.asarray(jw.encode(feats)),
                               atol=TOL["float32"], rtol=0)
    prompts = [["<|startoftranscript|>", "<|en|>", "<|transcribe|>"]] * 2
    ref = jw.generate(feats, prompts, beam_size=2, max_length=20, return_scores=True)
    out = pw.generate(feats, prompts, beam_size=2, max_length=20, return_scores=True)
    assert [r.sequences_ids for r in out] == [r.sequences_ids for r in ref]
    np.testing.assert_allclose([r.scores[0] for r in out], [r.scores[0] for r in ref],
                               atol=TOL["float32"], rtol=0)
    cfg = pw.model.config
    assert cfg["lang_ids"] == [vocab.index("<|en|>") + i for i in range(3)]
    bias = pw.model.mf.get("decoder/layer_1/attention/linear_1/bias").array
    assert not bias[:64].any() and bias[64:].any()  # K's half of the bias is zero


def test_wav2vec2_fabricator_loads_in_both(tmp_path):
    mf = cs.build_wav2vec2_modelfile(2, WAV2VEC2_NARROW)
    mf.save(str(tmp_path / "w2v"))
    audio = np.random.default_rng(1).standard_normal((2, 1, 4000)).astype(np.float32)
    ref = JWav2Vec2(str(tmp_path / "w2v"), device="cpu", compute_type="float32").encode(
        audio, to_cpu=True)
    out = tt.Wav2Vec2(mf, device="cpu", compute_type="float32").encode(audio, to_cpu=True)
    assert out.shape == ref.shape == (2, 12, 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL["float32"], rtol=0)


def test_w2v_bert_fabricator_loads_in_both(tmp_path):
    mf = cs.build_w2v_bert_modelfile(2, W2V_BERT_NARROW)
    mf.save(str(tmp_path / "w2vbert"))
    feats = np.random.default_rng(2).standard_normal((2, 30, 24)).astype(np.float32)
    ref = ct.Wav2Vec2Bert(str(tmp_path / "w2vbert"), compute_type="float32").encode(
        feats, to_cpu=True)
    port = tt.Wav2Vec2Bert(mf, device="cpu", compute_type="float32")
    out = port.encode(feats, to_cpu=True)
    assert out.shape == ref.shape == (2, 15, 32)
    assert (port.spec.rel_left_max, port.spec.rel_right_max, port.spec.num_heads) == (8, 4, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL["float32"], rtol=0)
