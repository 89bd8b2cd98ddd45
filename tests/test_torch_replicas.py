"""Data-parallel replicas (``device_index=[0, 1, ..]``) of the port, on the
CPU, on builder models (2 layers), against the port with one replica and
the JAX package (reference: one model replica a listed device with a
shared worker pool, replica_pool.h:19-300, docs/parallel.md).

- ``resolve_devices`` and ``resolve_device`` with a list.
- Two CPU replicas: ``num_replicas`` 2, ``inter_threads`` workers a replica,
  one shared parameter tree, a position table, lock and engine each.
- The barrier probe: both workers inside a job at once, each on its own
  replica.
- Translations, generations, encoder outputs and speech outputs through
  both workers equal the one-replica port's and the JAX package's.
- ``unload_model`` / ``load_model`` drop and restore every replica's
  weights, the shared tree once.

Two replicas on one card, a CUDA stream each, are card-only tests of
``tests/test_torch_cuda.py``.
"""

import threading

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.models.loader import resolve_device, resolve_devices
import chip_smoke as cs
from test_torch_cuda import build_bert_model
from test_torch_residency_scheduler import (WAV2VEC2_NARROW, WHISPER_NARROW,
                                            make, run)

SEQ2SEQ = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64, d_ff=128)
DECODER = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96,
               num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
               activation="swish")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = lambda name: str(tmp_path_factory.mktemp(name))  # noqa: E731
    out = {"translator": jbuilder.build_seq2seq_model(d("s2s"), **SEQ2SEQ),
           "int8": jbuilder.build_seq2seq_model(d("s2s8"), quantization="int8",
                                                **SEQ2SEQ),
           "generator": jbuilder.build_decoder_only_model(d("dec"), **DECODER),
           "encoder": build_bert_model(d("bert"), vocab_size=96, num_layers=2,
                                       num_heads=4, d_model=64, d_ff=128,
                                       max_positions=64)}
    mf, vocab = cs.build_whisper_modelfile(2, WHISPER_NARROW)
    out["whisper"] = cs.save_whisper(mf, vocab, d("whisper"))
    out["wav2vec2"] = d("w2v")
    cs.build_wav2vec2_modelfile(2, WAV2VEC2_NARROW).save(out["wav2vec2"])
    return out


def _source(n=8, seed=4):
    rng = np.random.default_rng(seed)
    return [[f"tok{i}" for i in rng.integers(0, 125, rng.integers(3, 15))]
            for _ in range(n)]


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert resolve_devices("cpu", [0, 1]) == [cpu, cpu]
    assert resolve_devices("cpu", 0) == [cpu]
    assert resolve_devices("cpu", (3,)) == [cpu]
    assert resolve_device("cpu", [0, 1]) == cpu
    with pytest.raises(ValueError, match="empty"):
        resolve_devices("cpu", [])
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_devices("tpu", [0, 1])
    if not torch.cuda.is_available():
        # No fallback to the CPU: the card is asked for and missing.
        for device in (None, "auto", "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_devices(device, [0, 1])


@pytest.mark.parametrize("inter_threads", [1, 2])
def test_two_cpu_replicas(paths, inter_threads):
    t = tt.Translator(paths["translator"], device="cpu", device_index=[0, 1],
                      inter_threads=inter_threads)
    assert t.num_replicas == 2 and t.num_translators == 2 * inter_threads
    assert t.num_workers == 2 * inter_threads
    (m0, e0), (m1, e1) = t._replicas
    assert m0 is t.model and e0 is t.engine  # the user's thread: replica 0
    assert m1.params is m0.params  # one tree on one device
    assert m1.consts is not m0.consts and m1._consts_lock is not m0._consts_lock
    assert e1 is not e0 and e1.model is m1 and e0.model is m0
    # Growing one replica's position tables leaves the other's alone.
    before = m0.consts["max_positions"]
    assert m1.ensure_consts(5000)["max_positions"] >= 5000
    assert m0.consts["max_positions"] == before
    one = tt.Translator(paths["translator"], device="cpu")
    assert one.num_replicas == 1 and one._replicas is None


def test_replicas_execute_concurrently(paths):
    t = tt.Translator(paths["translator"], device="cpu", device_index=[0, 1])
    seen = []
    barrier = threading.Barrier(2, timeout=20)

    def probe():
        # Both workers must be inside a job at once to pass the barrier,
        # and each must see its own replica.
        barrier.wait()
        seen.append((id(t.model), id(t.engine)))

    futures = [t._pool.submit(probe) for _ in range(2)]
    for f in futures:
        f.result(timeout=30)
    assert len(set(seen)) == 2
    assert {m for m, _ in seen} == {id(m) for m in t._all_models()}


@pytest.fixture(scope="module")
def translators(paths):
    """(JAX, JAX with two replicas, port, port with two replicas) a model."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            path = paths[dtype]
            cache[dtype] = (ct.Translator(path, device="cpu"),
                            ct.Translator(path, device="cpu", device_index=[0, 1]),
                            tt.Translator(path, device="cpu"),
                            tt.Translator(path, device="cpu", device_index=[0, 1]))
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["translator", "int8"])
@pytest.mark.parametrize("beam", [1, 2])
def test_replica_translations_equal_one_replica_and_jax(translators, dtype, beam):
    jax_one, jax_two, one, two = translators(dtype)
    source = _source()
    opts = dict(beam_size=beam, max_decoding_length=16, return_scores=True)
    # Batches of 2 through both workers, several calls in flight at once.
    calls = [two.translate_batch(source, max_batch_size=2, asynchronous=True, **opts)
             for _ in range(3)]
    ref = jax_one.translate_batch(source, **opts)
    expected = [r.hypotheses for r in ref]
    assert [r.hypotheses for r in one.translate_batch(source, **opts)] == expected
    if (dtype, beam) == ("translator", 2):
        assert [r.hypotheses for r in jax_two.translate_batch(
            source, max_batch_size=4, **opts)] == expected
    for call in calls:
        results = [r.result() for r in call]
        assert [r.hypotheses for r in results] == expected
        np.testing.assert_allclose([s for r in results for s in r.scores],
                                   [s for r in ref for s in r.scores],
                                   atol=1e-4, rtol=1e-4)
    if beam == 1:
        targets = [h[0] for h in expected]
        np.testing.assert_allclose(
            [s for r in two.score_batch(source, targets, max_batch_size=3)
             for s in r.tokens_score],
            [s for r in jax_one.score_batch(source, targets) for s in r.tokens_score],
            atol=1e-4, rtol=1e-4)


def test_generator_replicas(paths):
    path = paths["generator"]
    prompts = [[f"tok{i}" for i in row] for row in
               np.random.default_rng(1).integers(3, 90, (6, 5))]
    opts = dict(max_length=8, static_prompt=["tok5", "tok6"])
    ref = ct.Generator(path, device="cpu").generate_batch(prompts, **opts)
    g = tt.Generator(path, device="cpu", device_index=[0, 1])
    assert g.num_replicas == 2 and g.num_generators == 2
    calls = [g.generate_batch(prompts, max_batch_size=2, asynchronous=True, **opts)
             for _ in range(3)]
    for call in calls:
        assert [r.result().sequences_ids for r in call] == [r.sequences_ids for r in ref]
    # A replica prefills the static prompt into a cache of its own.
    keys = set(g._static_prompt_cache)
    assert {key[2] for key in keys} <= {0, 1}
    assert len({key[:2] for key in keys}) == 1


@pytest.mark.parametrize("kind", ["encoder", "whisper", "wav2vec2"])
def test_other_task_classes_with_replicas(paths, kind):
    one = make(kind, tt, paths[kind])
    cls = type(one)
    kw = dict(compute_type="float32") if kind in ("whisper", "wav2vec2") else {}
    two = cls(paths[kind], device="cpu", device_index=[0, 1], **kw)
    assert two.num_replicas == 2 and two.num_workers == 2
    expected = run(kind, one)
    ref = run(kind, make(kind, ct, paths[kind]))
    # On a worker of each replica (Whisper.generate itself queues on the
    # pool: a worker runs its body).
    barrier = threading.Barrier(2, timeout=30)

    def job():
        barrier.wait()
        if kind != "whisper":
            return id(two.model), run(kind, two)
        # run()'s Whisper call, without the queue.
        feats = np.random.default_rng(0).standard_normal((2, 16, 100)).astype(np.float32)
        prompts = [["<|startoftranscript|>", "<|en|>", "<|transcribe|>"]] * 2
        return id(two.model), [r.sequences_ids for r in two._generate_impl(
            feats, prompts, max_length=12)]

    outs = [f.result(60) for f in [two._pool.submit(job) for _ in range(2)]]
    assert len({m for m, _ in outs}) == 2
    for _, out in outs:
        if isinstance(expected, np.ndarray):
            np.testing.assert_array_equal(out, expected)
            np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
        else:
            assert out == expected == ref
    if kind == "encoder":
        poolers = two._poolers
        assert len(poolers) == 2 and poolers[0][0]["w"] is poolers[1][0]["w"]


def test_unload_reload_replicas(paths):
    t = tt.Translator(paths["translator"], device="cpu", device_index=[0, 1])
    source = _source()
    before = [r.hypotheses for r in t.translate_batch(source, max_decoding_length=16)]
    t.unload_model(to_cpu=True)
    assert not t.model_is_loaded
    for m in t._all_models():
        assert m.params is None and m.consts == {}
    t.unload_model()  # already unloaded: nothing to do
    t.load_model()
    assert t.model_is_loaded
    m0, m1 = t._all_models()
    assert m1.params is m0.params  # moved once, shared again
    assert m0.consts is not m1.consts and m0.consts["max_positions"] > 0
    calls = [t.translate_batch(source, max_batch_size=2, asynchronous=True,
                               max_decoding_length=16) for _ in range(2)]
    for call in calls:
        assert [r.result().hypotheses for r in call] == before
    # Without a host copy a reload raises, on every replica alike.
    t.unload_model()
    assert all(m.params is None for m in t._all_models())
    with pytest.raises(RuntimeError, match="host copy"):
        t.load_model()
