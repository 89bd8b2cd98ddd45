"""The port's native host core (``ctranslate2_tpu_torch/native``) on the CPU.

- The extension is built into the port's ``_build/`` and loaded under its
  package-qualified name: it is not the JAX package's module, even with
  both packages imported in one process.
- ``Vocabulary``, ``rebatch`` (random lengths with ties) and
  ``RequestQueue`` behave as their plain versions (the port's Python
  vocabulary, ``rebatch_input_plain``, ``_PyQueue``) and the JAX package's.
- ``parse_model_index`` reads binary versions 1-6 and in-memory models as
  ``_parse_model_bin`` does: names, dtypes, shapes, bytes, aliases.
- A model loaded through the index over a copy-on-write map translates
  token for token as the JAX package's ``Translator`` on the same file,
  float32 and int8; unaligned payloads and in-place ops on CPU parameters
  over the map neither fault nor reach the file.

The mapped load to a card, against the copying reader, is a card-only test
of ``tests/test_torch_cuda.py``.
"""

import mmap
import os
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
import ctranslate2_tpu.native as jnative
from ctranslate2_tpu.runtime.batching import rebatch_input as jax_rebatch_input
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch import native
from ctranslate2_tpu_torch.converters.builder import build_seq2seq_model
from ctranslate2_tpu_torch.formats import model_file as tmf
from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary, VocabularyInfo
from ctranslate2_tpu_torch.kernels.build import build_dir
from ctranslate2_tpu_torch.models.loader import load_model
from ctranslate2_tpu_torch.runtime.batching import (rebatch_input,
                                                    rebatch_input_plain)
from ctranslate2_tpu_torch.runtime.scheduler import ServingScheduler, _PyQueue

SEQ2SEQ = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64, d_ff=128)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    return {dtype: build_seq2seq_model(str(tmp_path_factory.mktemp(dtype)),
                                       quantization=quant, **SEQ2SEQ)
            for dtype, quant in (("float32", None), ("int8", "int8"))}


def _source(n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [[f"tok{i}" for i in rng.integers(0, 125, rng.integers(3, 15))]
            for _ in range(n)]


def test_native_module_is_the_ports_own():
    module = native.load()
    assert module.__name__ == "ctranslate2_tpu_torch.native.ct2tpu_host"
    assert sys.modules[module.__name__] is module
    assert os.path.dirname(module.__file__) == os.path.abspath(build_dir())
    assert module.__file__ == native.module_path()
    assert native.rebatch is module.rebatch
    assert "ctranslate2_tpu_torch" in module.__doc__
    # The JAX package's module, loaded in the same process, is another one.
    assert jnative.available
    theirs = sys.modules["ct2tpu_host"]
    assert theirs is not module and theirs.__file__ != module.__file__
    assert jnative.rebatch is not native.rebatch
    assert jnative.Vocabulary is not native.Vocabulary
    assert jnative.RequestQueue is not native.RequestQueue


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    broken = tmp_path / "ct2tpu_host.cpp"
    broken.write_text(open(native.SOURCE).read() + "\nint broken(;\n")
    monkeypatch.setenv("CT2TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="(?s)native host core failed.*error"):
        native.build()
    assert not [n for n in os.listdir(tmp_path / "build") if n.endswith(".so")]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("batch_type,max_batch_size",
                         [("examples", 0), ("examples", 1), ("examples", 3),
                          ("tokens", 10), ("tokens", 40)])
def test_rebatch_equals_plain_and_jax(seed, batch_type, max_batch_size):
    rng = np.random.default_rng(seed)
    # Few distinct lengths: many ties, whose order the stable sort keeps.
    lengths = [int(n) for n in rng.integers(1, 6, rng.integers(0, 40))]
    ours = rebatch_input(lengths, max_batch_size, batch_type)
    assert ours == rebatch_input_plain(lengths, max_batch_size, batch_type)
    assert ours == jax_rebatch_input(lengths, max_batch_size, batch_type)
    assert sorted(i for b in ours for i in b) == list(range(len(lengths)))


@pytest.mark.parametrize("seed", range(3))
def test_vocabulary_equals_python_and_jax(seed):
    rng = np.random.default_rng(seed)
    tokens = ["<blank>", "<s>", "</s>"] + [f"w{i}" for i in range(50)] + ["w7", "é", "☃"]
    batch = [[tokens[i] if i < len(tokens) else f"oov{i}"
              for i in rng.integers(0, len(tokens) + 10, rng.integers(0, 12))]
             for _ in range(6)]
    plain = Vocabulary(tokens, VocabularyInfo(unk_token="<unk>"))
    ours = native.Vocabulary(tokens, "<unk>")
    theirs = jnative.Vocabulary(tokens, "<unk>")
    ids = ours.tokens_to_ids(batch)
    assert ids == [[plain.to_id(t) for t in row] for row in batch]
    assert ids == theirs.tokens_to_ids(batch)
    assert ours.size() == len(plain) == theirs.size()
    assert ours.ids_to_tokens(ids) == [[plain.to_token(i) for i in row] for row in ids]


def _write_str(f, s):
    raw = s.encode("utf-8")
    f.write(struct.pack("<H", len(raw) + 1) + raw + b"\0")


def write_model_bin(path, mf, version):
    """``mf`` in binary version ``version``'s layout: no spec name before
    2, no aliases before 3, item sizes instead of dtype ids before 4
    (where only float32, int8 and int16 can be told apart)."""
    variables = [(n, v) for n, v in mf.variables.items()
                 if version >= 4 or v.dtype_name in ("float32", "int8", "int16")]
    with open(path, "wb") as f:
        f.write(struct.pack("<I", version))
        if version >= 2:
            _write_str(f, mf.spec_name)
            f.write(struct.pack("<I", mf.spec_revision))
        f.write(struct.pack("<I", len(variables)))
        for name, var in variables:
            _write_str(f, name)
            f.write(struct.pack("<B", var.array.ndim))
            f.write(struct.pack(f"<{var.array.ndim}I", *var.array.shape))
            payload = np.ascontiguousarray(var.array).tobytes()
            if version >= 4:
                f.write(struct.pack("<BI", tmf._DTYPE_IDS.index(var.dtype_name),
                                    len(payload)))
            else:
                f.write(struct.pack("<BI", var.array.itemsize, var.array.size))
            f.write(payload)
        if version >= 3:
            f.write(struct.pack("<I", len(mf.aliases)))
            for alias, target in mf.aliases.items():
                _write_str(f, alias)
                _write_str(f, target)


def _assert_same_parse(indexed, plain):
    version, spec, revision, variables, aliases = indexed
    assert (version, spec, revision) == plain[:3]
    assert list(variables) == list(plain[3]) and aliases == plain[4]
    for name, var in plain[3].items():
        ours = variables[name]
        assert ours.dtype_name == var.dtype_name and ours.shape == var.shape
        assert ours.array.dtype == var.array.dtype
        assert ours.array.tobytes() == var.array.tobytes()


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5, 6])
def test_parse_model_index_equals_plain_parse(model_dirs, tmp_path, version):
    mf = tmf.load_model_file_copied(model_dirs["int8"])
    mf.aliases = {"decoder/embeddings/weight": "encoder/embeddings/weight"}
    path = str(tmp_path / "model.bin")
    write_model_bin(path, mf, version)
    with open(path, "rb") as f:
        plain = tmf._parse_model_bin(f)
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    assert plain[3], "no variable written"
    _assert_same_parse(tmf._indexed_model_bin(buf), plain)
    with open(path, "rb") as f:
        data = f.read()
    _assert_same_parse(tmf._indexed_model_bin(data), plain)
    # The index reads the header only: every payload is a view into the map.
    assert all(np.shares_memory(v.array, np.frombuffer(buf, np.uint8))
               for v in tmf._indexed_model_bin(buf)[3].values() if v.array.size)


def test_loaders_read_what_the_copying_reader_reads(model_dirs):
    for path in model_dirs.values():
        plain = tmf.load_model_file_copied(path)
        with open(os.path.join(path, "model.bin"), "rb") as f:
            data = f.read()
        for mf in (tmf.load_model_file(path),
                   tmf.load_model_file_from_files("m", {"model.bin": data})):
            _assert_same_parse((mf.binary_version, mf.spec_name, mf.spec_revision,
                                mf.variables, mf.aliases),
                               (plain.binary_version, plain.spec_name,
                                plain.spec_revision, plain.variables, plain.aliases))
        assert tmf.load_model_file(path).config == plain.config


def test_malformed_and_future_files_raise(model_dirs, tmp_path):
    with open(os.path.join(model_dirs["float32"], "model.bin"), "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="Invalid model.bin"):
        tmf._indexed_model_bin(data[:len(data) // 2])
    with pytest.raises(ValueError, match="unsupported binary version"):
        tmf._indexed_model_bin(struct.pack("<I", 7) + data[4:])


QUEUES = {"native": lambda n: native.RequestQueue(n), "plain": lambda n: _PyQueue(n)}


@pytest.mark.parametrize("kind", list(QUEUES))
def test_request_queue_semantics(kind):
    q = QUEUES[kind](2)
    q.put("a")
    q.put("b")
    # Bounded: a third put waits until a collect makes room.
    done = threading.Event()
    putter = threading.Thread(target=lambda: (q.put("c"), done.set()))
    putter.start()
    assert not done.wait(0.2) and q.size() == 2
    assert q.collect(1, 0.0) == ["a"]
    assert done.wait(5)
    putter.join()
    # min_items: waits until there are that many, up to the timeout.
    t0 = time.monotonic()
    assert q.collect(5, 300.0, 3) == ["b", "c"]
    assert time.monotonic() - t0 >= 0.25
    # An empty queue gives nothing after the timeout.
    t0 = time.monotonic()
    assert q.collect(5, 50.0) == []
    assert time.monotonic() - t0 >= 0.04
    # max_items caps a collect; 0 takes everything.
    for x in range(2):
        q.put(x)
    assert q.collect(1, 10.0) == [0] and q.collect(0, 10.0) == [1]
    # close wakes a waiting collector at once.
    out = []
    waiter = threading.Thread(target=lambda: out.append(q.collect(5, 30000.0)))
    waiter.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    q.close()
    waiter.join(5)
    assert out == [[]] and time.monotonic() - t0 < 2


def test_scheduler_runs_on_the_native_queue():
    sched = ServingScheduler(lambda xs, opts: [x * opts["k"] for x in xs],
                             max_batch_size=4, batch_timeout_ms=20.0)
    try:
        assert type(sched._queue) is native.RequestQueue
        futures = [sched.submit(i, k=3) for i in range(10)]
        assert [f.result(10) for f in futures] == [3 * i for i in range(10)]
    finally:
        sched.close()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("beam", [1, 2])
def test_mapped_model_translates_like_jax(model_dirs, dtype, beam):
    path = model_dirs[dtype]
    port = tt.Translator(path, device="cpu")
    # Zero-copy: every variable views the map, and so do the CPU parameters
    # that keep a payload as stored (the int8 weights; the float32 ones are
    # transposed).
    lo, hi = _map_range(port.model.mf)
    assert all(lo <= v.array.ctypes.data <= hi for v in port.model.mf.variables.values())
    shared = [t for t in _leaves(port.model.params) if lo <= t.data_ptr() < hi]
    assert shared if dtype == "int8" else True
    ref = ct.Translator(path, device="cpu")
    source = _source()
    opts = dict(beam_size=beam, max_decoding_length=16, return_scores=True)
    ours = port.translate_batch(source, **opts)
    theirs = ref.translate_batch(source, **opts)
    assert [r.hypotheses for r in ours] == [r.hypotheses for r in theirs]
    np.testing.assert_allclose([s for r in ours for s in r.scores],
                               [s for r in theirs for s in r.scores],
                               atol=1e-4, rtol=1e-4)


def _map_range(mf):
    """The address range of the map that ``mf``'s variables view."""
    base = next(iter(mf.variables.values())).array
    while not isinstance(base, mmap.mmap):
        base = base.obj if isinstance(base, memoryview) else base.base
    view = np.frombuffer(base, np.uint8)
    return view.ctypes.data, view.ctypes.data + view.size


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def test_unaligned_payload_and_cpu_inplace_ops(model_dirs):
    path = model_dirs["float32"]
    mf = tmf.load_model_file(path)
    unaligned = [n for n, v in mf.variables.items()
                 if v.array.dtype == np.float32 and not v.array.flags.aligned]
    assert unaligned, "the file places every float32 payload aligned"
    with open(os.path.join(path, "model.bin"), "rb") as f:
        on_disk = f.read()
    source = _source()
    port = tt.Translator(path, device="cpu")
    before = [r.hypotheses for r in port.translate_batch(source, max_decoding_length=16)]
    for t in _leaves(port.model.params):
        assert t.data_ptr() % t.element_size() == 0
        t.mul_(1)  # writes every parameter in place
    for t in _leaves(port.model.params):
        if t.is_floating_point():
            t.add_(0.5)
            t.sub_(0.5)
    # The writes stay in this process: the file is unchanged.
    with open(os.path.join(path, "model.bin"), "rb") as f:
        assert f.read() == on_disk
    # An in-memory model's read-only bytes: the CPU parameters are copies.
    mem = load_model(path, device="cpu", compute_type="float32",
                     files={"model.bin": on_disk})
    for t in _leaves(mem.params):
        t.mul_(1)
    again = tt.Translator(path, device="cpu")
    assert [r.hypotheses for r in again.translate_batch(
        source, max_decoding_length=16)] == before


def test_save_over_the_mapped_file(model_dirs, tmp_path):
    """Saving a mapped ModelFile back where it was loaded from replaces the
    file: the map, still read by the save, keeps the old pages."""
    path = str(tmp_path / "m")
    build_seq2seq_model(path, **SEQ2SEQ)
    mf = tmf.load_model_file(path)
    mf.variables["extra"] = tmf.make_variable("extra", np.arange(5, dtype=np.float32))
    mf.save(path)
    again = tmf.load_model_file_copied(path)
    assert list(again.variables) == list(mf.variables)
    for name, var in mf.variables.items():
        assert again.variables[name].array.tobytes() == var.array.tobytes()
    assert not [n for n in os.listdir(path) if n.endswith(".tmp")]
