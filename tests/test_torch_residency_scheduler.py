"""Model residency, the micro-batching scheduler and the parts of serving
left for later, on the CPU.

- ``model_is_loaded`` / ``unload_model`` / ``load_model`` /
  ``num_replicas`` / ``tensor_parallel`` on every task class (Translator,
  Generator, Encoder, Whisper, Wav2Vec2 on builder and fabricated models,
  2 layers) behave as the JAX package's do, call for call: the weights
  drop, a host copy brings back the same outputs, a reload without one
  raises, and an unload while a batch runs is a no-op. Wav2Vec2Bert,
  which has no such surface in the JAX package, gets the same.
  ``Translator.num_translators`` and ``WorkerPool.map_ordered`` too.
- ``ServingScheduler`` (``translation_scheduler``, ``generation_scheduler``)
  and ``BufferedTranslationWrapper`` give the batch calls' results, one
  request at a time, as the JAX package's do; the queue blocks when full
  and wakes on close.
- ``ContinuousBatcher`` raises ``NotImplementedError`` for speculation
  (under beam serving too), draft models and multi-host serving.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
from ctranslate2_tpu.converters import builder as jbuilder
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.runtime.base import move_tree
from ctranslate2_tpu_torch.runtime.pool import WorkerPool
from ctranslate2_tpu_torch.runtime.scheduler import _PyQueue
import chip_smoke as cs
from test_torch_cuda import build_bert_model

SEQ2SEQ = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64, d_ff=96)
DECODER = dict(SEQ2SEQ, num_heads_kv=2, rotary_dim=0, glu=True, rms_norm=True,
               activation="swish")
WHISPER_NARROW = dict(cs.WHISPER_LARGE_V3, d_model=64, heads=4, d_ff=128, n_mels=16,
                      source_positions=50, target_positions=64, text_tokens=40,
                      languages=3, timestamps=20)
WAV2VEC2_NARROW = dict(cs.WAV2VEC2_LARGE, d_model=64, heads=4, d_ff=128, conv_dim=32)
W2V_BERT_NARROW = dict(cs.W2V_BERT_2, d_model=64, heads=4, d_ff=128, input_dim=24,
                       left=8, right=4)


def sources(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [[f"tok{int(t)}" for t in rng.integers(3, 90, rng.integers(3, 10))]
            for _ in range(n)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = lambda name: str(tmp_path_factory.mktemp(name))  # noqa: E731
    out = {"translator": jbuilder.build_seq2seq_model(d("s2s"), **SEQ2SEQ),
           "generator": jbuilder.build_decoder_only_model(d("dec"), **DECODER),
           "encoder": build_bert_model(d("bert"), vocab_size=96, num_layers=2,
                                       num_heads=4, d_model=64, d_ff=128,
                                       max_positions=64)}
    mf, vocab = cs.build_whisper_modelfile(2, WHISPER_NARROW)
    out["whisper"] = cs.save_whisper(mf, vocab, d("whisper"))
    out["wav2vec2"] = d("w2v")
    cs.build_wav2vec2_modelfile(2, WAV2VEC2_NARROW).save(out["wav2vec2"])
    out["w2v_bert"] = d("w2vbert")
    cs.build_w2v_bert_modelfile(2, W2V_BERT_NARROW).save(out["w2v_bert"])
    return out


def make(kind, module, path):
    cls = {"translator": module.Translator, "generator": module.Generator,
           "encoder": module.Encoder, "whisper": module.Whisper,
           "wav2vec2": module.Wav2Vec2}[kind]
    kw = dict(compute_type="float32") if kind in ("whisper", "wav2vec2") else {}
    return cls(path, device="cpu", **kw)


def run(kind, obj):
    """One call's output of a task object, as numpy or token lists."""
    if kind == "translator":
        return [r.hypotheses for r in obj.translate_batch(sources(), max_decoding_length=8)]
    if kind == "generator":
        return [r.sequences_ids for r in obj.generate_batch(
            sources(), max_length=8, static_prompt=["tok5", "tok6"])]
    if kind == "encoder":
        out = obj.forward_batch(sources())
        return np.asarray(out.last_hidden_state)
    if kind == "whisper":
        feats = np.random.default_rng(0).standard_normal((2, 16, 100)).astype(np.float32)
        prompts = [["<|startoftranscript|>", "<|en|>", "<|transcribe|>"]] * 2
        return [r.sequences_ids for r in obj.generate(feats, prompts, max_length=12)]
    audio = np.random.default_rng(1).standard_normal((2, 1, 4000)).astype(np.float32)
    return np.asarray(obj.encode(audio, to_cpu=True))


def same(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("kind", ["translator", "generator", "encoder", "whisper",
                                  "wav2vec2"])
def test_residency_like_jax(paths, kind):
    port, ref = make(kind, tt, paths[kind]), make(kind, ct, paths[kind])
    before = run(kind, port)
    for obj in (port, ref):
        assert obj.model_is_loaded and obj.num_replicas == 1
        assert obj.tensor_parallel is False
    if kind == "generator":
        assert port._static_prompt_cache
    for obj in (port, ref):
        obj.unload_model(to_cpu=True)
        assert not obj.model_is_loaded and obj.model.params is None
        obj.unload_model()  # already unloaded: nothing to do
        assert not obj.model_is_loaded
    assert port.model.consts == {}
    if kind == "generator":
        assert not port._static_prompt_cache
    if kind == "encoder":
        assert port._pooler is None
    for obj in (port, ref):
        obj.load_model()
        assert obj.model_is_loaded and obj.model.params is not None
        obj.load_model()  # already loaded: nothing to do
    assert same(run(kind, port), before)
    assert all(t.device.type == "cpu" for t in _leaves(port.model.params))
    for obj in (port, ref):
        obj.unload_model()
        assert not obj.model_is_loaded
        with pytest.raises(RuntimeError, match="without keeping a host copy"):
            obj.load_model()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def test_unload_is_a_noop_while_a_batch_runs(paths):
    """As in the JAX package and the reference (replica_pool.h:110-116)."""
    for module in (tt, ct):
        tr = make("translator", module, paths["translator"])
        release = threading.Event()
        blocker = tr._pool.submit(release.wait, 30)
        while tr.num_active_batches == 0:
            time.sleep(0.01)
        tr.unload_model(to_cpu=True)
        assert tr.model_is_loaded and tr.model.params is not None
        release.set()
        blocker.result(timeout=30)
        deadline = time.time() + 30
        while tr.num_active_batches and time.time() < deadline:
            time.sleep(0.01)
        tr.unload_model()
        assert not tr.model_is_loaded


def test_w2v_bert_residency(paths):
    """The JAX package's Wav2Vec2Bert has no residency surface; the port's
    has the task classes' one."""
    assert not hasattr(ct.Wav2Vec2Bert, "unload_model")
    port = tt.Wav2Vec2Bert(paths["w2v_bert"], device="cpu", compute_type="float32")
    feats = np.random.default_rng(2).standard_normal((2, 30, 24)).astype(np.float32)
    before = port.encode(feats, to_cpu=True)
    assert port.model_is_loaded and port.num_replicas == 1 and not port.tensor_parallel
    assert port.num_active_batches == 0
    port.unload_model(to_cpu=True)
    assert not port.model_is_loaded and port.params is None
    port.load_model()
    assert torch.equal(port.encode(feats, to_cpu=True), before)
    port.unload_model()
    with pytest.raises(RuntimeError, match="host copy"):
        port.load_model()


def test_move_tree_keeps_layout_and_sharing():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    tree = {"a": x, "b": [x.t(), x[1:3]], "c": (torch.ones(2, dtype=torch.int8),)}
    out = move_tree(tree, "cpu")
    assert out["a"] is x and out["b"][0].stride() == (1, 6)
    assert isinstance(out["b"], list) and isinstance(out["c"], tuple)


def test_num_translators_and_map_ordered(paths):
    tr = tt.Translator(paths["translator"], device="cpu", inter_threads=3)
    assert tr.num_translators == 3 == tr.num_workers
    pool = WorkerPool(num_workers=3)
    try:
        def slow(i):
            time.sleep(0.01 * (5 - i))
            return i * i
        assert pool.map_ordered(slow, range(6)) == [0, 1, 4, 9, 16, 25]
        assert pool.map_ordered(slow, []) == []
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# The micro-batching scheduler.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def translators(paths):
    return (tt.Translator(paths["translator"], device="cpu"),
            ct.Translator(paths["translator"], device="cpu"))


def test_buffered_wrapper_gives_the_batch_results(translators):
    port, ref = translators
    srcs = sources(7, seed=3)
    prefixes = [None, ["tok7"], None, ["tok9", "tok3"], None, None, ["tok4"]]
    expected = port.translate_batch(srcs, prefixes, max_decoding_length=8)
    outs = {}
    for module, tr in ((tt, port), (ct, ref)):
        w = module.BufferedTranslationWrapper(tr, max_batch_size=4,
                                              batch_timeout_in_micros=20000)
        try:
            fs = [w.translate_async(s, p, max_decoding_length=8)
                  for s, p in zip(srcs, prefixes)]
            # Another option set runs as a group of its own.
            beam = w.translate_async(srcs[0], beam_size=1, max_decoding_length=5)
            outs[module.__name__] = ([f.result(timeout=120).hypotheses for f in fs],
                                     beam.result(timeout=120).hypotheses)
            assert w.num_queued == 0
        finally:
            w.close()
    got, short = outs["ctranslate2_tpu_torch"]
    assert got == [r.hypotheses for r in expected]
    assert outs["ctranslate2_tpu"] == outs["ctranslate2_tpu_torch"]
    assert len(short[0]) <= 5


def test_schedulers_give_the_batch_results(paths, translators):
    port = translators[0]
    srcs = sources(6, seed=4)
    sched = tt.translation_scheduler(port, max_batch_size=4, batch_timeout_ms=10)
    try:
        fs = [sched.submit(s, max_decoding_length=6) for s in srcs]
        fp = sched.submit(srcs[0], target_prefix=[["tok3"]], max_decoding_length=6)
        assert [f.result(timeout=120).hypotheses for f in fs] == [
            r.hypotheses for r in port.translate_batch(srcs, max_decoding_length=6)]
        assert fp.result(timeout=120).hypotheses[0][0] == "tok3"
    finally:
        sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(srcs[0])

    gen = tt.Generator(paths["generator"], device="cpu")
    gsched = tt.generation_scheduler(gen, max_batch_size=3)
    try:
        fs = [gsched.submit(s, max_length=6, include_prompt_in_result=False) for s in srcs]
        assert [f.result(timeout=120).sequences_ids for f in fs] == [
            r.sequences_ids for r in gen.generate_batch(
                srcs, max_length=6, include_prompt_in_result=False)]
        assert gsched.num_active_batches == 0
    finally:
        gsched.close()


def test_scheduler_takes_list_options_and_rejects_unhashable_ones():
    """Lists (a target prefix) group by value; in the JAX package a list
    ends the scheduler thread (ROADMAP queue 3)."""
    sched = tt.ServingScheduler(lambda ex, opts: [(e, opts["p"]) for e in ex],
                                max_batch_size=8, batch_timeout_ms=20)
    try:
        a = sched.submit(1, p=[["x"]])
        b = sched.submit(2, p=[["x"]])
        assert a.result(timeout=30) == (1, [["x"]]) and b.result(timeout=30) == (2, [["x"]])
        with pytest.raises(TypeError):
            sched.submit(3, p={1, 2})
    finally:
        sched.close()


def test_scheduler_fails_a_batch_and_goes_on():
    calls = []

    def run(examples, options):
        calls.append(list(examples))
        if options.get("fail"):
            raise ValueError("batch failed")
        return [e * 2 for e in examples]

    sched = tt.ServingScheduler(run, max_batch_size=8, batch_timeout_ms=20)
    try:
        bad = sched.submit(1, fail=True)
        good = [sched.submit(i) for i in range(3)]
        with pytest.raises(ValueError, match="batch failed"):
            bad.result(timeout=30)
        assert [f.result(timeout=30) for f in good] == [0, 2, 4]
    finally:
        sched.close()


def test_py_queue_bounds_and_close():
    q = _PyQueue(max_size=2)
    q.put(1)
    q.put(2)
    done = threading.Event()

    def third():
        q.put(3)
        done.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not done.is_set() and q.size() == 2  # full: put blocks
    assert q.collect(1, 10) == [1]
    assert done.wait(5) and q.size() == 2
    start = time.monotonic()
    assert q.collect(8, 20, min_items=5) == [2, 3]  # timed out short of 5
    assert time.monotonic() - start >= 0.015
    q.close()
    assert q.collect(8, 5000) == []  # closed: returns at once


# ---------------------------------------------------------------------------
# Serving parts left for later, and speculation since it came.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,error,match", [
    (dict(beam_size=2, speculation_k=4), NotImplementedError, "beam serving"),
    (dict(speculation_k=4), None, None),
    (dict(speculation_k=4, draft_model="draft"), FileNotFoundError, "model.bin"),
    (dict(draft_model="draft"), ValueError, "draft_model requires speculation_k > 1"),
], ids=["kwargs0-beam serving", "kwargs1-speculation", "kwargs2-speculation",
        "kwargs3-draft-model"])
def test_unported_serving_parts_raise(paths, kwargs, error, match):
    """Beam serving takes no speculation and still raises. Speculation runs
    since it was ported (tests/test_torch_speculation.py holds it against
    the JAX package); the draft cases raise the JAX package's errors: a
    path that holds no model fails to load, and a draft needs
    speculation_k > 1."""
    gen = tt.Generator(paths["generator"], device="cpu")
    if error is None:
        cb = tt.ContinuousBatcher(gen, capacity=64, **kwargs)
        try:
            out = cb.submit(["tok3", "tok4"], max_length=4).result(timeout=120)
        finally:
            cb.close()
        assert 0 < len(out.sequences_ids[0]) <= 4
        assert cb.stats()["spec_draft"] == "prompt-lookup"
        return
    with pytest.raises(error, match=match):
        tt.ContinuousBatcher(gen, **kwargs)


def test_multi_host_serving_raises(paths, monkeypatch):
    gen = tt.Generator(paths["generator"], device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="tensor_parallel=True"):
        tt.ContinuousBatcher(gen)
