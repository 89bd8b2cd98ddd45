"""The port's host-side copies (model.bin reader/writer, vocabularies,
``extract_arch``, builder, dtype policy) against the JAX package's."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from ctranslate2_tpu.converters.builder import build_seq2seq_model as jbuild
from ctranslate2_tpu.formats import model_file as jmf
from ctranslate2_tpu.formats.vocabulary import Vocabulary as JVocabulary
from ctranslate2_tpu.models.spec import extract_arch as jextract
from ctranslate2_tpu_torch.converters.builder import build_seq2seq_model as tbuild
from ctranslate2_tpu_torch.formats import model_file as tmf
from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary as TVocabulary
from ctranslate2_tpu_torch.models.spec import extract_arch as textract
from ctranslate2_tpu_torch.utils.dtypes import resolve_compute_type


@pytest.mark.parametrize("quantization", [None, "int8", "float16"])
def test_builder_copy_writes_the_same_files(tmp_path, quantization):
    kw = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=32, d_ff=64,
              seed=7, quantization=quantization)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jbuild(a, **kw)
    tbuild(b, **kw)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_model_file_and_arch_parse_equal(tmp_path, quantization):
    path = str(tmp_path)
    jbuild(path, vocab_size=64, num_layers=2, num_heads=4, d_model=32,
           d_ff=64, quantization=quantization)
    j = jmf.load_model_file(path)
    t = tmf.load_model_file(path)
    assert (t.spec_name, t.spec_revision, t.binary_version) == (
        j.spec_name, j.spec_revision, j.binary_version)
    assert t.config == j.config and t.aliases == j.aliases
    assert t.variables.keys() == j.variables.keys()
    for name, var in j.variables.items():
        assert t.variables[name].dtype_name == var.dtype_name
        np.testing.assert_array_equal(t.variables[name].array, var.array)
    assert dataclasses.asdict(textract(t)) == dataclasses.asdict(jextract(j))

    # The writer round-trips, and in-memory loading reads the same pack.
    t.save(str(tmp_path / "resaved"))
    again = tmf.load_model_file(str(tmp_path / "resaved"))
    with open(os.path.join(path, "model.bin"), "rb") as f:
        mem = tmf.load_model_file_from_files("m", {"model.bin": f.read()})
    for other in (again, mem):
        assert other.variables.keys() == t.variables.keys()
        for name, var in t.variables.items():
            np.testing.assert_array_equal(other.variables[name].array, var.array)


def test_vocabulary_matches(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("<unk>\n<s>\n</s>\nhello\nworld\nhello\n", encoding="utf-8")
    j = JVocabulary.from_text_file(str(path))
    t = TVocabulary.from_text_file(str(path))
    batch = [["hello", "nope", "world"], ["world"]]
    assert len(t) == len(j)
    assert t.tokens_to_ids(batch, add_bos=True, add_eos=True) == \
        j.tokens_to_ids(batch, add_bos=True, add_eos=True)
    assert t.ids_to_tokens([[0, 3, 5]]) == j.ids_to_tokens([[0, 3, 5]])


@pytest.mark.parametrize("compute_type,weights,platform,expected", [
    ("default", "float32", "cuda", ("float32", "float32", False)),
    ("default", "int8", "cuda", ("int8", "float16", True)),
    ("float16", "float32", "cuda", ("float16", "float16", False)),
    ("bfloat16", "float32", "cuda", ("bfloat16", "bfloat16", False)),
    ("int8", "float32", "cuda", ("int8", "float16", True)),
    ("int8_float32", "int8", "cuda", ("int8", "float32", True)),
    ("int8_bfloat16", "int8", "cuda", ("int8", "bfloat16", True)),
    ("float16", "float32", "cpu", ("float32", "float32", False)),
    ("int8_float16", "int8", "cpu", ("int8", "float32", True)),
    ("default", "float16", "cpu", ("float32", "float32", False)),
])
def test_compute_type_policy(compute_type, weights, platform, expected):
    p = resolve_compute_type(compute_type, weights, platform)
    assert (p.weight_dtype, p.activation_dtype, p.quantize_activations) == expected


def test_vocabulary_map_matches(tmp_path):
    from ctranslate2_tpu.formats.vocabulary_map import VocabularyMap as JMap
    from ctranslate2_tpu_torch.formats.vocabulary_map import VocabularyMap as TMap

    tokens = ["<unk>", "<s>", "</s>", "a", "b", "c", "x", "y", "z"]
    lines = ["\tz", "a\tx", "a b\ty z", "c\t"]
    j = JMap.from_lines(lines, JVocabulary(tokens))
    t = TMap.from_lines(lines, TVocabulary(tokens))
    source = [["a", "b"], ["c", "a"]]
    assert t.get_candidates(source, [[5]]) == j.get_candidates(source, [[5]])
