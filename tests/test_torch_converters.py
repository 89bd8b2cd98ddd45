"""The port's checkpoint converters against the JAX package's, on the CPU.

Every source that ``test_framework_converters.py`` and
``test_framework_converters2.py`` fabricate (a Marian ``.npz`` and its
OPUS-MT directory, OpenNMT-py seq2seq and language-model checkpoints, a
Fairseq checkpoint, an OpenAI GPT-2 TensorFlow checkpoint, eole state
dicts, OpenNMT-tf model objects) is converted by both packages, without
quantization and under int8, and the two model directories must be
byte-identical: ``model.bin``, ``config.json`` and every vocabulary file.
One source (eole's language model) also runs every quantization mode the
builders take, AWQ included. The
port's own models run on the CPU from the converted directories: the
Marian and OpenNMT-py ones equal the JAX package's translations. A
subprocess in which ``jax`` and ``ctranslate2_tpu`` cannot be imported
converts through the port's CLI, with the same bytes. TensorFlow is
optional, as in the JAX tests (``importorskip``); the mock ``opennmt`` of
``test_framework_converters2.py`` stands in for OpenNMT-tf. The fabricated
sources are that file's and ``test_framework_converters.py``'s helpers,
imported, so both packages' tests read the same checkpoints.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_framework_converters import (D, FF, H, LAYERS, V, _make_marian_npz, _onmt_attn,
                                       _onmt_ffn, _onmt_ln, _r, _write_marian_vocab)
from test_framework_converters2 import (D as D2, FF as FF2, HEADS as HEADS2, VOCAB as VOCAB2,
                                        _TFLayer, _TFLinear, _TFNorm, _eole_config,
                                        _eole_state_dict, _save_eole, mock_opennmt)  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ["ctranslate2_tpu", "ctranslate2_tpu_torch"]
QUANTIZATIONS = [None, "int8"]
# Every mode ``SpecBuilder.quantize`` takes.
ALL_MODES = [None, "float32", "int8", "int8_float32", "int8_float16", "int8_bfloat16",
             "int16", "float16", "bfloat16", "awq_gemm", "awq_gemv"]
# The interpreter of the CLI subprocess: ``jax`` and the JAX package fail
# to import, as on a machine that has only the port.
NO_JAX = """
import sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ctranslate2_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
"""


def converters(pkg):
    return importlib.import_module(f"{pkg}.converters")


def onmt_vocab():
    return ["<unk>", "<blank>", "<s>", "</s>"] + [f"tok{i}" for i in range(V - 4)]


def write_onmt_seq2seq(path, seed=2):
    """``test_opennmt_py_seq2seq``'s checkpoint."""
    rng = np.random.default_rng(seed)
    model = {}
    pe = _r(rng, 64, 1, D)
    for side, lscope in (("encoder", "encoder.transformer"),
                         ("decoder", "decoder.transformer_layers")):
        model[f"{side}.embeddings.make_embedding.emb_luts.0.weight"] = _r(rng, V, D)
        model[f"{side}.embeddings.make_embedding.pe.pe"] = pe
        _onmt_ln(rng, model, f"{side}.layer_norm")
        for i in range(LAYERS):
            _onmt_attn(rng, model, f"{lscope}.{i}.self_attn")
            _onmt_ffn(rng, model, f"{lscope}.{i}.feed_forward")
            if side == "encoder":
                _onmt_ln(rng, model, f"{lscope}.{i}.layer_norm")
            else:
                _onmt_attn(rng, model, f"{lscope}.{i}.context_attn")
                _onmt_ln(rng, model, f"{lscope}.{i}.layer_norm_1")
                _onmt_ln(rng, model, f"{lscope}.{i}.layer_norm_2")
    torch.save({"model": {k: torch.tensor(v) for k, v in model.items()},
                "generator": {"weight": torch.tensor(_r(rng, V, D)),
                              "bias": torch.tensor(_r(rng, V))},
                "opt": {"decoder_type": "transformer", "encoder_type": "transformer",
                        "heads": H, "position_encoding": True,
                        "pos_ffn_activation_fn": "relu"},
                "vocab": {"src": onmt_vocab(), "tgt": onmt_vocab()}}, path)


def write_onmt_lm(path):
    """``test_opennmt_py_lm``'s checkpoint (rotary)."""
    rng = np.random.default_rng(3)
    model = {"decoder.embeddings.make_embedding.emb_luts.0.weight": _r(rng, V, D)}
    _onmt_ln(rng, model, "decoder.layer_norm")
    for i in range(LAYERS):
        _onmt_attn(rng, model, f"decoder.transformer_layers.{i}.self_attn")
        _onmt_ffn(rng, model, f"decoder.transformer_layers.{i}.feed_forward")
        _onmt_ln(rng, model, f"decoder.transformer_layers.{i}.layer_norm_1")
    torch.save({"model": {k: torch.tensor(v) for k, v in model.items()},
                "generator": {"weight": torch.tensor(_r(rng, V, D)),
                              "bias": torch.tensor(_r(rng, V))},
                "opt": {"decoder_type": "transformer_lm", "encoder_type": "transformer_lm",
                        "heads": H, "position_encoding": False,
                        "max_relative_positions": -1, "pos_ffn_activation_fn": "relu"},
                "vocab": {"src": onmt_vocab(), "tgt": onmt_vocab()}}, path)


def write_fairseq(tmp):
    """``test_fairseq_seq2seq``'s checkpoint and data directory."""
    rng = np.random.default_rng(4)
    model = {}

    def attn(scope):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            model[f"{scope}.{p}.weight"] = _r(rng, D, D)
            model[f"{scope}.{p}.bias"] = _r(rng, D)

    def ln(scope):
        model[f"{scope}.weight"] = np.ones(D, np.float32)
        model[f"{scope}.bias"] = np.zeros(D, np.float32)

    for side in ("encoder", "decoder"):
        model[f"{side}.embed_tokens.weight"] = _r(rng, V, D)
        for i in range(LAYERS):
            s = f"{side}.layers.{i}"
            attn(f"{s}.self_attn")
            ln(f"{s}.self_attn_layer_norm")
            if side == "decoder":
                attn(f"{s}.encoder_attn")
                ln(f"{s}.encoder_attn_layer_norm")
            model[f"{s}.fc1.weight"] = _r(rng, FF, D)
            model[f"{s}.fc1.bias"] = _r(rng, FF)
            model[f"{s}.fc2.weight"] = _r(rng, D, FF)
            model[f"{s}.fc2.bias"] = _r(rng, D)
            ln(f"{s}.final_layer_norm")
    model["decoder.output_projection.weight"] = _r(rng, V, D)
    data = tmp / "data"
    data.mkdir()
    for lang in ("src", "tgt"):
        with open(data / f"dict.{lang}.txt", "w") as f:
            for i in range(V - 4):
                f.write(f"tok{i} 1\n")
    path = str(tmp / "fairseq.pt")
    torch.save({"args": None,
                "cfg": {"model": {"arch": "transformer", "activation_fn": "relu",
                                  "encoder_attention_heads": H, "decoder_attention_heads": H,
                                  "decoder_normalize_before": False, "source_lang": "src",
                                  "target_lang": "tgt", "max_source_positions": 64}},
                "model": {k: torch.tensor(v) for k, v in model.items()}}, path)
    return path, str(data)


def write_gpt2_tf(model_dir):
    """``test_openai_gpt2``'s TensorFlow checkpoint, hparams and encoder."""
    tf = pytest.importorskip("tensorflow")
    rng = np.random.default_rng(5)
    model_dir.mkdir()
    g = tf.Graph()
    with g.as_default():
        def var(name, val):
            tf.compat.v1.get_variable(name, initializer=val)

        var("model/wte", _r(rng, V, D))
        var("model/wpe", _r(rng, 64, D))
        var("model/ln_f/g", np.ones(D, np.float32))
        var("model/ln_f/b", np.zeros(D, np.float32))
        for i in range(LAYERS):
            var(f"model/h{i}/ln_1/g", np.ones(D, np.float32))
            var(f"model/h{i}/ln_1/b", np.zeros(D, np.float32))
            var(f"model/h{i}/attn/c_attn/w", _r(rng, 1, D, 3 * D))
            var(f"model/h{i}/attn/c_attn/b", _r(rng, 3 * D))
            var(f"model/h{i}/attn/c_proj/w", _r(rng, 1, D, D))
            var(f"model/h{i}/attn/c_proj/b", _r(rng, D))
            var(f"model/h{i}/ln_2/g", np.ones(D, np.float32))
            var(f"model/h{i}/ln_2/b", np.zeros(D, np.float32))
            var(f"model/h{i}/mlp/c_fc/w", _r(rng, 1, D, FF))
            var(f"model/h{i}/mlp/c_fc/b", _r(rng, FF))
            var(f"model/h{i}/mlp/c_proj/w", _r(rng, 1, FF, D))
            var(f"model/h{i}/mlp/c_proj/b", _r(rng, D))
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(model_dir / "model.ckpt"))
    with open(model_dir / "hparams.json", "w") as f:
        json.dump({"n_layer": LAYERS, "n_head": H, "n_embd": D, "n_vocab": V,
                   "n_ctx": 64}, f)
    with open(model_dir / "encoder.json", "w") as f:
        json.dump({("<|endoftext|>" if i == 0 else f"tok{i}"): i for i in range(V)}, f)


def onmt_tf_models(onmt, kind):
    """``test_opennmt_tf_seq2seq``'s or ``test_opennmt_tf_language_model``'s
    model object over the mock ``opennmt``."""
    if kind == "lm":
        class LMDecoder(onmt.decoders.SelfAttentionDecoder):
            def __init__(self):
                self.layers = [_TFLayer(D2, HEADS2, FF2) for _ in range(2)]
                self.position_encoder = onmt.layers.PositionEmbedder()
                self.layer_norm = _TFNorm(D2)
                self.output_layer = _TFLinear(VOCAB2, D2)

        class LM(onmt.models.LanguageModel):
            def __init__(self):
                self.decoder = LMDecoder()
                self.features_inputter = onmt.inputters.WordEmbedder("vocab")
        return LM()

    class Encoder(onmt.encoders.SelfAttentionEncoder):
        def __init__(self):
            self.layers = [_TFLayer(D2, HEADS2, FF2) for _ in range(2)]
            self.position_encoder = onmt.layers.PositionEmbedder()
            self.layer_norm = _TFNorm(D2)

    class Decoder:
        def __init__(self):
            self.layers = [_TFLayer(D2, HEADS2, FF2, cross=True) for _ in range(2)]
            self.position_encoder = onmt.layers.PositionEmbedder()
            self.layer_norm = _TFNorm(D2)
            self.output_layer = _TFLinear(VOCAB2, D2)
            self.attention_reduction = \
                onmt.layers.MultiHeadAttentionReduction.FIRST_HEAD_LAST_LAYER

    class Model(onmt.models.Transformer):
        def __init__(self):
            self.encoder = Encoder()
            self.decoder = Decoder()
            self.features_inputter = onmt.inputters.WordEmbedder("src.vocab")
            self.labels_inputter = onmt.inputters.WordEmbedder("tgt.vocab")
    return Model()


def source(name, tmp, request):
    """A function (package, output directory, quantization) that converts
    source ``name`` (written under ``tmp`` once) with that package."""
    if name in ("marian", "opus_mt"):
        model_dir = tmp / "opus"
        model_dir.mkdir()
        npz = str(model_dir / "model.intgemm.npz")
        _make_marian_npz(npz, np.random.default_rng(0 if name == "marian" else 1))
        vocab = str(model_dir / "opus.spm32k-spm32k.vocab.yml")
        _write_marian_vocab(vocab)
        if name == "marian":
            return lambda pkg, out, q: converters(pkg).MarianConverter(
                npz, [vocab, vocab]).convert(out, quantization=q, force=True)
        import yaml

        with open(model_dir / "decoder.yml", "w") as f:
            yaml.dump({"vocabs": [os.path.basename(vocab)] * 2}, f)
        return lambda pkg, out, q: converters(pkg).OpusMTConverter(
            str(model_dir)).convert(out, quantization=q, force=True)
    if name in ("onmt_py", "onmt_py_lm"):
        path = str(tmp / "onmt.pt")
        (write_onmt_seq2seq if name == "onmt_py" else write_onmt_lm)(path)
        return lambda pkg, out, q: converters(pkg).OpenNMTPyConverter(path).convert(
            out, quantization=q, force=True)
    if name == "fairseq":
        path, data = write_fairseq(tmp)
        return lambda pkg, out, q: converters(pkg).FairseqConverter(
            path, data, source_lang="src", target_lang="tgt").convert(
            out, quantization=q, force=True)
    if name == "gpt2_tf":
        write_gpt2_tf(tmp / "gpt2")
        return lambda pkg, out, q: converters(pkg).OpenAIGPT2Converter(
            str(tmp / "gpt2")).convert(out, quantization=q, force=True)
    if name in ("eole", "eole_lm"):
        lm = name == "eole_lm"
        kw = dict(glu=True, rms=True, rotary=True) if lm else {}
        cfg, sd = _eole_config(lm, **kw), _eole_state_dict(lm, **kw)

        def eole(pkg, out, q):
            b = importlib.import_module(f"{pkg}.converters.eole_conv").build_from_state_dict(
                cfg, sd, decoder_only=lm)
            b.quantize(q)
            _save_eole(b, out, decoder_only=lm)
        return eole
    onmt = request.getfixturevalue("mock_opennmt")
    model = onmt_tf_models(onmt, "lm" if name == "onmt_tf_lm" else "s2s")
    return lambda pkg, out, q: importlib.import_module(
        f"{pkg}.converters.opennmt_tf_conv").OpenNMTTFConverter(model).convert(
        out, quantization=q, force=True)


SOURCES = ["marian", "opus_mt", "onmt_py", "onmt_py_lm", "fairseq", "gpt2_tf", "eole",
           "eole_lm", "onmt_tf", "onmt_tf_lm"]


def assert_same_directories(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "model.bin" in names and "config.json" in names
    assert any(n.endswith("vocabulary.json") for n in names), names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def convert_both(make, tmp, quantization):
    outs = [str(tmp / f"out_{pkg}") for pkg in PACKAGES]
    for pkg, out in zip(PACKAGES, outs):
        make(pkg, out, quantization)
    assert_same_directories(*outs)
    return outs


@pytest.mark.parametrize("quantization", QUANTIZATIONS)
@pytest.mark.parametrize("name", SOURCES)
def test_port_writes_the_jax_directory(name, quantization, tmp_path, request):
    convert_both(source(name, tmp_path, request), tmp_path, quantization)


@pytest.mark.parametrize("quantization", ALL_MODES)
def test_every_quantization_mode(quantization, tmp_path, request):
    # eole's language model: widths of 32 and 64, whole AWQ groups of 32.
    convert_both(source("eole_lm", tmp_path, request), tmp_path, quantization)


@pytest.mark.parametrize("name", ["marian", "onmt_py", "fairseq"])
def test_converted_translator_equals_jax(name, tmp_path, request):
    import ctranslate2_tpu
    import ctranslate2_tpu_torch

    jax_dir, port_dir = convert_both(source(name, tmp_path, request), tmp_path, None)
    batch = [["tok5", "tok6", "tok7"], ["tok9"]]
    kw = dict(beam_size=2, max_decoding_length=6, return_scores=True)
    want = ctranslate2_tpu.Translator(jax_dir).translate_batch(batch, **kw)
    got = ctranslate2_tpu_torch.Translator(port_dir, device="cpu").translate_batch(batch, **kw)
    assert [r.hypotheses for r in got] == [r.hypotheses for r in want]
    np.testing.assert_allclose([r.scores for r in got], [r.scores for r in want],
                               atol=1e-4, rtol=0)


def test_converted_language_model_equals_jax(tmp_path, request):
    import ctranslate2_tpu
    import ctranslate2_tpu_torch

    jax_dir, port_dir = convert_both(source("onmt_py_lm", tmp_path, request), tmp_path, None)
    prompts = [["tok5", "tok6"], ["tok3", "tok8", "tok1"]]
    want = ctranslate2_tpu.Generator(jax_dir).generate_batch(prompts, max_length=6)
    got = ctranslate2_tpu_torch.Generator(port_dir, device="cpu").generate_batch(
        prompts, max_length=6)
    assert [r.sequences_ids for r in got] == [r.sequences_ids for r in want]


def test_cli_converts_without_jax(tmp_path, request):
    """The port's CLI, in a process where ``jax`` and ``ctranslate2_tpu``
    cannot be imported, writes the JAX package's bytes; the port loads and
    runs the result there."""
    onmt = str(tmp_path / "onmt.pt")
    write_onmt_seq2seq(onmt)
    marian = source("marian", tmp_path, request)
    model_dir = tmp_path / "opus"
    npz, vocab = (str(model_dir / "model.intgemm.npz"),
                  str(model_dir / "opus.spm32k-spm32k.vocab.yml"))
    script = NO_JAX + f"""
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.cli import convert

convert.opennmt_py_main(["--model_path", {onmt!r}, "--output_dir", {str(tmp_path / "cli_onmt")!r},
                         "--quantization", "int8"])
convert.marian_main(["--model_path", {npz!r}, "--vocab_paths", {vocab!r}, {vocab!r},
                     "--output_dir", {str(tmp_path / "cli_marian")!r}])
for d in ("cli_onmt", "cli_marian"):
    r = tt.Translator({str(tmp_path)!r} + "/" + d, device="cpu").translate_batch(
        [["tok5", "tok6"]], beam_size=2, max_decoding_length=4)
    assert r[0].hypotheses[0], d
try:
    import ctranslate2_tpu
except ImportError:
    print("JAX_BLOCKED")
print("CLI_OK", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ctranslate2_tpu")))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert "JAX_BLOCKED" in lines and "CLI_OK []" in lines, run.stdout
    converters("ctranslate2_tpu").OpenNMTPyConverter(onmt).convert(
        str(tmp_path / "jax_onmt"), quantization="int8")
    marian("ctranslate2_tpu", str(tmp_path / "jax_marian"), None)
    assert_same_directories(str(tmp_path / "cli_onmt"), str(tmp_path / "jax_onmt"))
    assert_same_directories(str(tmp_path / "cli_marian"), str(tmp_path / "jax_marian"))
