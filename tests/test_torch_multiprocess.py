"""Multi-process continuous serving of the port against the JAX package,
on the CPU.

Two ranks over gloo (``parallel/launch.py``; the ranks never import JAX)
load the same models with ``tensor_parallel=True`` and serve mixed traffic
through ``ContinuousBatcher`` (greedy blocks with per-request penalties
and stop sequences, prompt-lookup speculation, beam search, streaming
callbacks with an early stop), ``ContinuousTranslator`` and
``ContinuousWhisper``: rank 0 leads, rank 1 replays its control records.
This test process serves the same traffic through the JAX package's
engines, unsharded, and through the port's in one process without tensor
parallelism. The leader's tokens equal the JAX package's, and the
one-process port's, with scores within ``SCORE_TOL``; the follower reaches
every phase's close. A draft model under more than one process raises, on
every rank. A leader whose scheduler fails sends its error in a last
record, which the follower raises from ``join`` at once; where the
replayed admit fails on every rank, each rank raises its own. One job runs
for the module (``served`` fixture), as ``tools/run_multiprocess.py
--continuous`` does for the JAX package.

Where requests carry options (the greedy, speculation and translator
phases), every run suppresses the vocabulary's last id for every request:
the JAX package's batchers turn their tables' -1 padding into that id
(ROADMAP queue 3 item 6; its ``ContinuousTranslator`` admit marks it as
seen, so a repetition penalty moves its score), which the global
suppression makes moot, as in ``test_torch_continuous.py``. The JAX
``ContinuousWhisper`` skips the initial-timestamp rule (queue 3 item 9),
so the timestamped Whisper request is held to the one-process port only.
"""

import importlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-4
LLAMA = dict(vocab_size=64, num_layers=2, num_heads=8, num_heads_kv=4, d_model=64,
             d_ff=128, rotary_dim=0, glu=True, rms_norm=True, activation="swish")
PROMPTS = [["tok1", "tok2"], ["tok3"], ["tok4", "tok1", "tok5"]]
TRAFFIC = [
    (["tok1", "tok2"], {"max_length": 10}),
    (["tok3"], {"max_length": 6}),
    (["tok4", "tok1", "tok5"], {"max_length": 12, "repetition_penalty": 1.3}),
    (["tok2", "tok4"], {"max_length": 8, "no_repeat_ngram_size": 2}),
    (["tok1"], {"max_length": 10, "stop_sequences": [[5, 25]]}),
    (["tok5", "tok3"], {"max_length": 7}),
]
PHASES = ["greedy", "spec", "beam", "translator", "streaming", "whisper"]
FAILURES = ["admit", "prefill"]
WHISPER_PROMPTS = [
    ["<|startoftranscript|>", "<|en|>", "<|transcribe|>", "<|notimestamps|>"],
    ["<|startoftranscript|>", "<|en|>", "<|transcribe|>"],
    ["<|startoftranscript|>", "<|en|>", "<|transcribe|>", "<|notimestamps|>"],
]


def _results(futures):
    results = [f.result(timeout=600) for f in futures]
    return {"seqs": [r.sequences_ids for r in results],
            "scores": [list(r.scores) for r in results]}


def serve(dirs, tensor_parallel: bool, package: str = "ctranslate2_tpu_torch"):
    """Every phase's results (rank 0, or one process of the port or of the
    JAX package, ``package``), or on a follower the phases it replayed to
    their close."""
    tt = importlib.import_module(package)
    kw = (dict(device="cpu", tensor_parallel=tensor_parallel)
          if package == "ctranslate2_tpu_torch" else {})
    g = tt.Generator(dirs["llama"], **kw)
    # Where requests carry options, the vocabulary's last id is suppressed
    # for every request (see the module's docstring).
    last = dict(suppress_tokens=[f"tok{LLAMA['vocab_size'] - 4}"])
    follower = tensor_parallel and g.model.grid.rank != 0
    out = {}

    def run(name, batcher, submit):
        if follower:
            batcher.join(timeout=600)
            if batcher._thread.is_alive():
                raise RuntimeError(f"the follower of phase {name!r} did not reach its close")
            out[name] = "replayed"
            return
        try:
            out[name] = submit(batcher)
        finally:
            batcher.close()

    phases = [("greedy", dict(last, steps_per_sync=4), TRAFFIC),
              ("spec", dict(last, speculation_k=3), TRAFFIC[:3]),
              ("beam", {"beam_size": 2}, [(["tok1", "tok2"], {"max_length": 10}),
                                          (["tok3"], {"max_length": 8, "num_hypotheses": 2})])]
    for name, bkw, traffic in phases:
        run(name, tt.ContinuousBatcher(g, num_slots=2, capacity=64, **bkw),
            lambda cb, traffic=traffic: _results([cb.submit(p, **s) for p, s in traffic]))

    t = tt.Translator(dirs["s2s"], **kw)
    sources = [(["tok1", "tok2", "tok3"], {}),
               (["tok4"], {"target_prefix": ["tok5", "tok6"]}),
               (["tok2", "tok5"], {"repetition_penalty": 1.3})]
    run("translator", tt.ContinuousTranslator(t, num_slots=2, capacity=64, max_source_len=16,
                                              **last),
        lambda ct: _results([ct.submit(s, max_length=12, **k) for s, k in sources]))

    def streaming(cb):
        streamed = [[], []]

        def keep(sr):
            streamed[0].append(sr.token_id)
            return False

        def stop_after_3(sr):
            streamed[1].append(sr.token_id)
            return len(streamed[1]) >= 3

        res = _results([cb.submit(PROMPTS[0], max_length=10, callback=keep),
                        cb.submit(PROMPTS[2], max_length=12, callback=stop_after_3)])
        res["streamed"] = streamed
        return res

    run("streaming", tt.ContinuousBatcher(g, num_slots=2, capacity=64, steps_per_sync=4),
        streaming)

    w = tt.Whisper(dirs["whisper"], **kw)
    feats = [np.random.default_rng(0).standard_normal((24, 64)).astype(np.float32)
             for _ in range(3)]
    run("whisper", tt.ContinuousWhisper(w, num_slots=2, capacity=64),
        lambda cw: _results([cw.submit(f, p, max_length=16)
                             for f, p in zip(feats, WHISPER_PROMPTS)]))

    if tensor_parallel:
        try:
            tt.ContinuousBatcher(g, num_slots=2, capacity=64, speculation_k=3, draft_model=g)
            out["draft"] = "served"
        except NotImplementedError as e:
            out["draft"] = str(e)
        for where in FAILURES:  # the last: a record may be left untaken
            out[f"fails_{where}"] = fail(g, failing_batcher(tt, where))
    return out


def failing_batcher(tt, where):
    """A batcher whose next admit raises: on the leader alone before its
    control record goes out (``where`` "admit"), or on every rank, the
    replayed admit too ("prefill")."""
    class Failing(tt.ContinuousBatcher):
        def _collect_admits(self):
            if where == "admit" and self._leader and not self._queue.empty():
                raise RuntimeError("injected admit failure")
            return super()._collect_admits()

        def _prefill_into_slot(self, slot, req):
            if where == "prefill":
                raise RuntimeError("injected prefill failure")
            return super()._prefill_into_slot(slot, req)
    return Failing


def fail(g, cls):
    """This rank's error (the leader's request's, a follower's ``join``'s),
    whether its scheduler thread still runs, and the seconds it took."""
    t0 = time.monotonic()
    cb = cls(g, num_slots=2, capacity=64)
    error = None
    try:
        if cb.model.grid.rank == 0:
            cb.submit(PROMPTS[0], max_length=4).result(timeout=120)
        else:
            cb.join(timeout=120)
    except Exception as e:  # noqa: BLE001
        error = f"{type(e).__name__}: {e}"
    cb._thread.join(timeout=120)
    return {"error": error, "alive": cb._thread.is_alive(),
            "seconds": time.monotonic() - t0}


def worker(dirs_path, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    out = serve(json.load(open(dirs_path)), tensor_parallel=True)
    rank = int(os.environ["RANK"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print(f"MP_OK rank={rank} {'leader' if rank == 0 else 'follower'} "
          f"phases={sorted(out)}", flush=True)


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
    sys.exit(0)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from ctranslate2_tpu_torch.converters import builder as tb

    def mk(name):
        return str(tmp_path_factory.mktemp(name))

    d = {"llama": mk("llama"), "s2s": mk("s2s"), "whisper": mk("whisper")}
    tb.build_decoder_only_model(d["llama"], **LLAMA)
    tb.build_seq2seq_model(d["s2s"], vocab_size=64, num_layers=2, num_heads=8,
                           d_model=64, d_ff=128)
    tb.build_whisper_model(d["whisper"])
    return d


@pytest.fixture(scope="module")
def served(dirs, tmp_path_factory):
    """(the port's results in one process, [each rank's], the JAX
    package's) of the same traffic."""
    from ctranslate2_tpu_torch.parallel.launch import launch

    spec = str(tmp_path_factory.mktemp("spec") / "dirs.json")
    json.dump(dirs, open(spec, "w"))
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rc, logs = launch([os.path.abspath(__file__), "--worker", spec, out_dir], 2,
                      timeout=600, env=env, log_dir=out_dir)
    assert rc == 0, "\n".join(log[-3000:] for log in logs)
    assert "MP_OK rank=0 leader" in logs[0] and "MP_OK rank=1 follower" in logs[1]
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    return (serve(dirs, tensor_parallel=False), ranks,
            serve(dirs, tensor_parallel=False, package="ctranslate2_tpu"))


def _same_phase(got, want, phase, rows=None):
    if rows is not None:
        got, want = ({k: [v[i] for i in rows] for k, v in r.items()} for r in (got, want))
    assert got["seqs"] == want["seqs"]
    np.testing.assert_allclose(np.concatenate(got["scores"]),
                               np.concatenate(want["scores"]), atol=SCORE_TOL, rtol=0)
    if phase == "streaming":
        assert got["streamed"] == want["streamed"]
        assert got["seqs"][1][0] == got["streamed"][1]  # stopped after 3 tokens
        assert len(got["streamed"][1]) == 3


@pytest.mark.parametrize("phase", PHASES)
def test_leader_equals_jax(served, phase):
    # The JAX ContinuousWhisper skips the initial-timestamp rule (ROADMAP
    # queue 3 item 9): its timestamped request is held to the port alone.
    rows = ([i for i, p in enumerate(WHISPER_PROMPTS) if p[-1] == "<|notimestamps|>"]
            if phase == "whisper" else None)
    _same_phase(served[1][0][phase], served[2][phase], phase, rows)


@pytest.mark.parametrize("phase", PHASES)
def test_leader_equals_one_process(served, phase):
    _same_phase(served[1][0][phase], served[0][phase], phase)


def test_follower_replays_every_phase(served):
    assert {p: served[1][1][p] for p in PHASES} == {p: "replayed" for p in PHASES}


def test_draft_model_raises_on_every_rank(served):
    for rank in served[1]:
        assert "draft-model speculation is not supported" in rank["draft"]


@pytest.mark.parametrize("where", FAILURES)
def test_failed_scheduler_ends_every_rank(served, where):
    leader, follower = (rank[f"fails_{where}"] for rank in served[1])
    assert leader["error"] == f"RuntimeError: injected {where} failure"
    assert not leader["alive"] and not follower["alive"]
    assert follower["seconds"] < 60  # not the process group's 30-minute timeout
    assert follower["error"] == ("RuntimeError: the leader's scheduler failed: "
                                 "RuntimeError: injected admit failure"
                                 if where == "admit" else leader["error"])
