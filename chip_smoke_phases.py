#!/usr/bin/env python3
"""Runs a few phases of ``chip_smoke.py`` alone on one card, to try a
phase out or to time a phase against another tree's form of it.

    python3 chip_smoke_phases.py probe
    python3 chip_smoke_phases.py cuts PARENT_DIR

``probe`` runs, at cut depths, the phases that the data-axis serving slots
and the converters added or changed: ``convert_and_run``,
``continuous_translator``, ``host_core_replicas``,
``serving_generator_beam`` and ``parallel_two_ranks`` on a 2-layer Llama
(every check of theirs runs; about four minutes with the build).

``cuts`` times the phases whose depth was cut for the run's time limit,
in the form they have in ``PARENT_DIR/chip_smoke.py`` (a tree unpacked with
``git archive``, whose phases take the full-depth model) and in this
tree's, one after the other in this process on this tree's package, and
``convert_and_run``: ``host_core_replicas`` (6 + 6 against 3 + 3 layers),
``continuous_translator`` and ``serving_generator_beam`` (their profiled
blocks at full depth against the half-depth Translator and the 4-layer
Llama subset). Each phase's seconds go into one ``cuts`` line.

Run from the repository root; prints one JSON line a phase, as
``chip_smoke.py`` does, and exits non-zero when a check fails.
"""

import atexit
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

import chip_smoke as C


def _setup():
    """The card's line, the kernels built, the work directory, the int8
    Transformer-base at full and half depth, its vocabulary's batches."""
    from ctranslate2_tpu_torch.converters.builder import build_seq2seq_model
    from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary
    from ctranslate2_tpu_torch.kernels import build

    C.emit({"phase": "card", "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()})
    C.emit({"phase": "build", "seconds": build.build()})
    work = tempfile.mkdtemp(prefix="phases_", dir=build.build_dir())
    atexit.register(shutil.rmtree, work, True)
    int8_dir = build_seq2seq_model(os.path.join(work, "int8"), quantization="int8", **C.MODEL)
    half_dir = build_seq2seq_model(os.path.join(work, "int8_half"), quantization="int8",
                                   **dict(C.MODEL, num_layers=C.HALF_LAYERS))
    vocab = Vocabulary.load(int8_dir, "shared_vocabulary")
    return work, int8_dir, half_dir, [C.make_batch(vocab, i) for i in range(1 + C.ITERS)]


def _timed(seconds, key, call):
    C.free_card()
    t0 = time.perf_counter()
    call()
    C.free_card()
    seconds[key] = time.perf_counter() - t0
    C.emit({"phase": key, "seconds": seconds[key]})


def probe(tt, checks):
    work, int8_dir, half_dir, batches = _setup()
    seconds = {}
    _timed(seconds, "convert_and_run",
           lambda: C.convert_and_run(tt, C.start_conversion(), checks, {}))
    _timed(seconds, "continuous_translator",
           lambda: C.continuous_translator(tt, int8_dir, batches, checks, {}, half_dir))
    _timed(seconds, "host_core_replicas",
           lambda: C.host_core_replicas(tt, half_dir, batches, checks, {}))
    llama = C.build_llama_modelfile(2)
    vocab = C.family_vocab(C.LLAMA["vocab"])
    llama.save(os.path.join(work, "llama_int8"))  # parallel_two_ranks reads it
    with C.environ(CT2TPU_KV_CACHE="int8"):
        gen = C.make_generator(tt, llama, vocab, compute_type="int8")
    _timed(seconds, "serving_generator_beam",
           lambda: C.serving_generator_beam(tt, gen, checks, {}, gen))
    del gen
    _timed(seconds, "parallel_two_ranks",
           lambda: C.parallel_two_ranks(tt, int8_dir, llama, vocab,
                                        batches[1][:C.PAR_SENTENCES], work, checks, {}))
    return seconds


def cuts(tt, checks, parent_dir):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_parent", os.path.join(parent_dir, "chip_smoke.py"))
    P = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(P)
    work, int8_dir, half_dir, batches = _setup()
    seconds = {}
    _timed(seconds, "convert_and_run",
           lambda: C.convert_and_run(tt, C.start_conversion(), checks, {}))
    _timed(seconds, "replicas_parent",
           lambda: P.host_core_replicas(tt, int8_dir, batches, checks, {}))
    _timed(seconds, "replicas_this",
           lambda: C.host_core_replicas(tt, half_dir, batches, checks, {}))
    _timed(seconds, "ct_parent",
           lambda: P.continuous_translator(tt, int8_dir, batches, checks, {}))
    _timed(seconds, "ct_this",
           lambda: C.continuous_translator(tt, int8_dir, batches, checks, {}, half_dir))
    llama = C.build_llama_modelfile(C.MAIN_LAYERS)
    vocab = C.family_vocab(C.LLAMA["vocab"])
    with C.environ(CT2TPU_KV_CACHE="int8"):
        gen = C.make_generator(tt, llama, vocab, compute_type="int8")
        side = C.make_generator(tt, C.llama_subset(llama, C.SIDE_LAYERS), vocab,
                                compute_type="int8")
    _timed(seconds, "beam_parent", lambda: P.serving_generator_beam(tt, gen, checks, {}))
    _timed(seconds, "beam_this",
           lambda: C.serving_generator_beam(tt, gen, checks, {}, side))
    return seconds


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_phases: CUDA is not available", file=sys.stderr)
        return 2
    import ctranslate2_tpu_torch as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = C.Checks()
    mode = sys.argv[1:2]
    if mode == ["probe"]:
        seconds = probe(tt, checks)
    elif mode == ["cuts"] and len(sys.argv) == 3:
        seconds = cuts(tt, checks, sys.argv[2])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    C.emit({"phase": mode[0], "seconds": seconds, "checks_failed": checks.failed})
    return 1 if checks.failed else 0


if __name__ == "__main__":
    sys.exit(main())
