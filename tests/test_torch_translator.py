"""End to end: the port's ``Translator.translate_batch`` on the CPU against
the JAX package's, on builder models (2+2 layers, d_model 64, vocabulary
128). Hypotheses must be token-identical; scores agree within 1e-4.

Under int8 (W8A8) the activations are rounded to int8 at every linear. The
two frameworks sum floats in different orders, so an activation that lands
within an ulp of a half step can round one step apart in the two packages;
the beams may then part. The inputs are therefore fixed ones on which no
such tie occurs (seeds 2 to 4 of ``_source`` all qualify; seeds 0 and 1 do
not), and the W8A8 product itself is held bit-equal in
test_torch_kernels.py.

``CT2TPU_BEAM_CHAIN=0`` turns chain-mask beam attention off, so the beam
loop reorders the cache with the fused gather every step;
``CT2TPU_DECODE_CHUNK=16`` makes the 64-slot caches take the chunked
(length-adaptive) attention paths. Both packages read both variables.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters.builder import build_seq2seq_model
import ctranslate2_tpu_torch as tt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    dirs = {}
    for dtype, quant in (("float32", None), ("int8", "int8")):
        path = str(tmp_path_factory.mktemp(f"seq2seq_{dtype}"))
        build_seq2seq_model(path, vocab_size=128, num_layers=2, num_heads=4,
                            d_model=64, d_ff=128, quantization=quant)
        dirs[dtype] = path
    return dirs


@pytest.fixture(scope="module")
def translators(model_dirs):
    """(jax, port) translator pairs, one per (dtype, environment): the JAX
    package reads the variables when it builds a decode loop."""
    cache = {}

    def get(dtype, env):
        key = (dtype, tuple(sorted(env.items())))
        if key not in cache:
            cache[key] = (ct.Translator(model_dirs[dtype], device="cpu"),
                          tt.Translator(model_dirs[dtype], device="cpu"))
        return cache[key]

    return get


def _source(n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [[f"tok{i}" for i in rng.integers(0, 125, rng.integers(3, 15))]
            for _ in range(n)]


PREFIX = [["tok5", "tok9"], None, ["tok7"], None, ["tok1", "tok2", "tok3"]]


def _compare(translators, monkeypatch, dtype, env, source, prefix=None, **opts):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jt, pt = translators(dtype, env)
    opts.setdefault("max_decoding_length", 24)
    opts.setdefault("return_scores", True)
    rj = jt.translate_batch(source, prefix, **opts)
    rp = pt.translate_batch(source, prefix, **opts)
    assert [r.hypotheses for r in rp] == [r.hypotheses for r in rj]
    if opts["return_scores"]:
        np.testing.assert_allclose([s for r in rp for s in r.scores],
                                   [s for r in rj for s in r.scores],
                                   atol=1e-4, rtol=1e-4)
    return rp


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2, 4])
@pytest.mark.parametrize("with_prefix", [False, True])
def test_translate_batch_token_identical(translators, monkeypatch, dtype,
                                         beam, with_prefix):
    _compare(translators, monkeypatch, dtype, {}, _source(),
             PREFIX if with_prefix else None, beam_size=beam)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [2, 4])
def test_translate_batch_without_beam_chain(translators, monkeypatch, dtype, beam):
    _compare(translators, monkeypatch, dtype, {"CT2TPU_BEAM_CHAIN": "0"},
             _source(seed=3), PREFIX, beam_size=beam)


@pytest.mark.parametrize("beam,chain", [(1, "1"), (2, "1"), (2, "0")])
def test_translate_batch_chunked_attention(translators, monkeypatch, beam, chain):
    _compare(translators, monkeypatch, "int8",
             {"CT2TPU_DECODE_CHUNK": "16", "CT2TPU_BEAM_CHAIN": chain},
             _source(seed=2), beam_size=beam, max_decoding_length=40)


def test_translate_batch_options(translators, monkeypatch, model_dirs):
    source = _source(seed=2)
    _compare(translators, monkeypatch, "float32", {}, source, beam_size=3,
             num_hypotheses=2, length_penalty=0.0, repetition_penalty=1.5,
             no_repeat_ngram_size=2, disable_unk=True,
             suppress_sequences=[["tok4", "tok5"]], min_decoding_length=4,
             max_batch_size=2)
    _compare(translators, monkeypatch, "float32", {}, source, beam_size=1,
             repetition_penalty=1.5, min_decoding_length=4, return_end_token=True)
    # Empty sources are answered without running the model.
    out = _compare(translators, monkeypatch, "int8", {}, [[], source[0]], beam_size=2)
    assert out[0].hypotheses == [[]]


def test_translator_needs_cuda_unless_cpu_is_asked(model_dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Translator(model_dirs["float32"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Translator(model_dirs["int8"], device="cuda", compute_type="int8")


@pytest.mark.parametrize("option", [
    dict(return_attention=True), dict(coverage_penalty=0.2),
    dict(prefix_bias_beta=0.5), dict(return_logits_vocab=True),
    dict(return_alternatives=True), dict(use_vmap=True)])
def test_unported_options_raise(translators, option):
    """These options were unported until the host decode loops came; now
    each runs (tests/test_torch_host_loops.py holds them against the JAX
    package)."""
    _, pt = translators("float32", {})
    out = pt.translate_batch(_source(2), max_decoding_length=4, **option)
    assert len(out) == len(_source(2)) and all(r.hypotheses for r in out)


def test_import_does_not_load_jax():
    """Every module of the port, the lazily imported ones too (the
    streaming helpers, the decode loops, the speech modules), imports
    neither JAX nor the JAX package."""
    code = ("import importlib, pkgutil, sys, ctranslate2_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "[importlib.import_module(n) for n in names]; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'ctranslate2_tpu' or m.startswith('ctranslate2_tpu.')]; "
            "print(len(names), bad); sys.exit(1 if bad or len(names) < 40 else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
