"""The continuous engines' slots on the data axis, on the CPU.

Ranks over gloo (``parallel/launch.py``; they never import JAX) load the
models with ``tensor_parallel=True`` and a data axis of 2
(``device_index=[0, 1]``): world 4 (data 2 x model 2) and world 2 (data 2
x model 1). They serve the traffic of ``test_torch_multiprocess.py``
(greedy blocks with per-request penalties and stop sequences,
prompt-lookup speculation, beam search, ``ContinuousTranslator``,
streaming with an early stop, ``ContinuousWhisper``) and a sampled phase,
each at 2 slots: data group d holds slot d alone. The leader's tokens
equal the JAX package's batchers' (with the row exclusions that file
documents) and the one-process port's, with scores within ``SCORE_TOL``;
sampled tokens are held to the one-process port only, since the JAX
package draws other noise. Each rank's slot cache is half of one
process's (at the rank's share of the heads), and 3 slots (which the axis does not divide) fall back to
every slot on every rank with the same tokens. An admit whose prefill
fails in the group that owns the slot, the leader's group or the other,
ends every rank within 60 s. Both jobs run once for the module
(``served`` fixture), side by side. In one process, a failed admit fails
every request its admit round took from the queue.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_multiprocess import (LLAMA, PHASES, PROMPTS, ROOT, TRAFFIC, WHISPER_PROMPTS,
                                     _results, _same_phase, dirs)  # noqa: F401 - a fixture
from test_torch_multiprocess import serve as serve_jax

WORLDS = [4, 2]
SAMPLED = [(["tok1", "tok2"], {"max_length": 10, "sampling_topk": 8, "seed": 3}),
           (["tok3"], {"max_length": 8, "sampling_topk": 0, "sampling_topp": 0.9,
                       "sampling_temperature": 0.8, "seed": 5}),
           (["tok4", "tok1", "tok5"], {"max_length": 9, "sampling_topk": 4, "seed": 7}),
           (["tok2"], {"max_length": 6})]
ALL_PHASES = PHASES + ["sampled", "odd"]
OWNERS = [0, 1]  # the data group whose prefill fails


def serve(dirs, data_axis: bool):
    """Every phase's results and (local slots, slot-cache bytes) on rank 0
    of a job with a data axis of 2, or in one process; on a follower the
    phases it replayed to their close."""
    import ctranslate2_tpu_torch as tt

    kw = dict(device="cpu")
    if data_axis:
        kw.update(tensor_parallel=True, device_index=[0, 1])
    g = tt.Generator(dirs["llama"], **kw)
    last = dict(suppress_tokens=[f"tok{LLAMA['vocab_size'] - 4}"])
    follower = data_axis and g.model.grid.rank != 0
    out = {}

    def run(name, batcher, submit):
        stats = batcher.stats()
        out[f"{name}_slots"] = (stats["local_slots"], stats["slot_cache_bytes"])
        if follower:
            batcher.join(timeout=300)
            if batcher._thread.is_alive():
                raise RuntimeError(f"the follower of phase {name!r} did not reach its close")
            out[name] = "replayed"
            return
        try:
            out[name] = submit(batcher)
        finally:
            batcher.close()

    def traffic(items):
        return lambda cb: _results([cb.submit(p, **s) for p, s in items])

    phases = [("greedy", 2, dict(last, steps_per_sync=4), TRAFFIC),
              ("spec", 2, dict(last, speculation_k=3), TRAFFIC[:3]),
              ("beam", 2, {"beam_size": 2}, [(["tok1", "tok2"], {"max_length": 10}),
                                             (["tok3"], {"max_length": 8,
                                                         "num_hypotheses": 2})]),
              ("sampled", 2, {"steps_per_sync": 4}, SAMPLED),
              ("odd", 3, dict(last, steps_per_sync=4), TRAFFIC)]
    for name, slots, bkw, items in phases:
        run(name, tt.ContinuousBatcher(g, num_slots=slots, capacity=64, **bkw), traffic(items))

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

    if data_axis:
        for owner in OWNERS:
            out[f"fails_{owner}"] = fail_owner(g, tt, owner)
    return out


def fail_owner(g, tt, owner):
    """Two requests into a batcher whose prefill raises in data group
    ``owner`` (which owns slot ``owner``): this rank's error (the leader's
    requests', a follower's ``join``'s), whether its scheduler thread still
    runs, and the seconds it took."""
    class Failing(tt.ContinuousBatcher):
        def _prefill_logits(self, ids):
            if self._lo == owner * self._ns:
                raise RuntimeError("injected owner prefill failure")
            return super()._prefill_logits(ids)

    t0 = time.monotonic()
    cb = Failing(g, num_slots=2, capacity=64)
    errors = []
    try:
        if cb.model.grid.rank == 0:
            # The first request decodes until the second has its slot (1).
            futures = [cb.submit(PROMPTS[0], max_length=40, min_length=39),
                       cb.submit(PROMPTS[1], max_length=4)]
            for f in futures:
                try:
                    f.result(timeout=120)
                except Exception as e:  # noqa: BLE001
                    errors.append(f"{type(e).__name__}: {e}")
        else:
            cb.join(timeout=120)
    except Exception as e:  # noqa: BLE001
        errors.append(f"{type(e).__name__}: {e}")
    cb._thread.join(timeout=120)
    return {"errors": errors, "alive": cb._thread.is_alive(),
            "seconds": time.monotonic() - t0, "data_rank": cb.model.grid.data.rank}


def worker(dirs_path, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    out = serve(json.load(open(dirs_path)), data_axis=True)
    rank = int(os.environ["RANK"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    print(f"MP_OK rank={rank} {'leader' if rank == 0 else 'follower'}", flush=True)


if __name__ == "__main__" and len(sys.argv) == 4 and sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
    sys.exit(0)


@pytest.fixture(scope="module")
def served(dirs, tmp_path_factory):
    """(the port's results in one process, {world: [each rank's]}, the JAX
    package's) of the same traffic. Both jobs run side by side, each rank
    launch bounded by its own timeout."""
    from ctranslate2_tpu_torch.parallel.launch import launch

    spec = str(tmp_path_factory.mktemp("spec") / "dirs.json")
    json.dump(dirs, open(spec, "w"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    jobs = {}

    def job(world):
        out_dir = str(tmp_path_factory.mktemp(f"world{world}"))
        jobs[world] = out_dir, launch([os.path.abspath(__file__), "--worker", spec, out_dir],
                                      world, timeout=300, env=env, log_dir=out_dir)

    threads = [threading.Thread(target=job, args=(w,)) for w in WORLDS]
    for t in threads:
        t.start()
    one = serve(dirs, data_axis=False)
    jax_out = serve_jax(dirs, tensor_parallel=False, package="ctranslate2_tpu")
    for t in threads:
        t.join()
    ranks = {}
    for world, (out_dir, (rc, logs)) in jobs.items():
        assert rc == 0, "\n".join(log[-3000:] for log in logs)
        ranks[world] = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                        for r in range(world)]
    return one, ranks, jax_out


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("world", WORLDS)
def test_data_axis_equals_jax(served, world, phase):
    # The JAX ContinuousWhisper skips the initial-timestamp rule (ROADMAP
    # queue 3 item 9): its timestamped request is held to the port alone.
    rows = ([i for i, p in enumerate(WHISPER_PROMPTS) if p[-1] == "<|notimestamps|>"]
            if phase == "whisper" else None)
    _same_phase(served[1][world][0][phase], served[2][phase], phase, rows)


@pytest.mark.parametrize("phase", ALL_PHASES)
@pytest.mark.parametrize("world", WORLDS)
def test_data_axis_equals_one_process(served, world, phase):
    _same_phase(served[1][world][0][phase], served[0][phase], phase)


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_share_of_the_slots(served, world):
    # A model axis of M (world 4) also splits every slot's KV and memory
    # heads M ways; the data axis of 2 halves what remains.
    one, model_axis = served[0], world // 2
    for rank in served[1][world]:
        for phase in ALL_PHASES:
            (slots, size), (one_slots, one_size) = rank[f"{phase}_slots"], one[f"{phase}_slots"]
            if phase == "odd":  # 3 slots: every slot on every rank
                assert (slots, size * model_axis) == (3, one_size) and one_slots == 3
            else:
                assert slots == 1 and one_slots == 2 and size > 0
                assert 2 * size * model_axis == one_size, phase


@pytest.mark.parametrize("world", WORLDS)
def test_followers_replay_every_phase(served, world):
    for rank in served[1][world][1:]:
        assert {p: rank[p] for p in ALL_PHASES} == {p: "replayed" for p in ALL_PHASES}


@pytest.mark.parametrize("owner", OWNERS)
@pytest.mark.parametrize("world", WORLDS)
def test_failed_owner_prefill_ends_every_rank(served, world, owner):
    injected = "RuntimeError: injected owner prefill failure"
    for r, rank in enumerate(served[1][world]):
        got = rank[f"fails_{owner}"]
        assert not got["alive"] and got["seconds"] < 60
        mine = injected if got["data_rank"] == owner else (
            f"RuntimeError: data rank {owner} failed: {injected}")
        if r == 0:  # the leader's requests: at least the failed admit's
            assert got["errors"] and set(got["errors"]) == {mine}
        else:
            assert got["errors"] == [mine]


def test_failed_admit_fails_every_request_of_its_round(dirs):
    """One process: an admit round's failure reaches every request the
    round took from the queue, not only the one being admitted."""
    import ctranslate2_tpu_torch as tt

    gate = threading.Event()

    class Failing(tt.ContinuousBatcher):
        def _collect_admits(self):
            gate.wait(30)  # both requests queued: one round takes both
            return super()._collect_admits()

        def _prefill_into_slot(self, slot, req):
            raise RuntimeError("injected admit failure")

    cb = Failing(tt.Generator(dirs["llama"], device="cpu"), num_slots=2, capacity=64)
    futures = [cb.submit(p, max_length=4) for p in PROMPTS[:2]]
    gate.set()
    for f in futures:
        with pytest.raises(RuntimeError, match="injected admit failure"):
            f.result(timeout=30)
    cb.close()
