#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ctranslate2_tpu_torch``) on one card.

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON object per line:

1. card: the card's name and power limit, the torch/CUDA versions, and the
   seconds to build the six CUDA sources from ``ctranslate2_tpu_torch/csrc``;
   before it a ``ptxas`` line with the registers, spills and static shared
   memory of every kernel of the two wgmma sources and the W4 source
   (``PTXAS_REPORT``).
2. Translator main path: the full-width Transformer-base model (6+6 layers,
   d_model 512, ffn 2048, 8 heads, 32,000 words; random weights from seed
   7), ``Translator(..., compute_type="int8").translate_batch`` on batches
   of 64 sentences of 20-30 tokens, beam 2, exactly 32 target tokens; then
   one call with ``CT2TPU_BEAM_CHAIN=0`` (the fused-gather beam reorder).
3. Generator main path: the Llama-3-8B geometry (``LLAMA``: 32 layers,
   d_model 4096, 32 query / 8 KV heads of 128, ffn 14336, 128,256 words,
   rotary base 500000, RMSNorm, SwiGLU) fabricated as int8 payloads from
   seeds, ``Generator(..., compute_type="int8").generate_batch`` on 4
   prompts of 2,049 tokens, ``include_prompt_in_result=False``, greedy,
   exactly 64 new tokens, with ``CT2TPU_KV_CACHE=int8``: the prefill of
   2,048 takes the flash kernel, every decode step the int8-KV decode
   kernel, every RMSNorm the norm kernel, every linear W8A8. One more call
   with the float16 KV cache. Then the flash kernel against
   ``CT2TPU_FLASH=0`` and the decode kernel against
   ``CT2TPU_DECODE_KERNEL=0`` at full depth (a prefill and one step): a
   random-weight model of this depth amplifies any rounding difference under
   W8A8, so the switch-off run is fed the kernel run's int8 activations at
   every linear. Each layer's attention then gets the kernel run's inputs,
   and its output is compared where the output projection quantizes it: at
   most one int8 step apart, on at most ``FED_STEP_SHARE`` of the entries.
4. AWQ Generator main path: the same geometry in AutoAWQ's GEMM layout
   (group 128, zero points; float16 embeddings and projection), fabricated
   in memory; ``Generator(...).generate_batch`` with the card's defaults
   (float16 activations, packed W4) and ``CT2TPU_KV_CACHE=int8``, the same
   prompts and lengths: every layer linear goes through ``matmul_w4p``; then
   one call with ``CT2TPU_W4_PACKED=0`` (``matmul_w4a16``). The launch
   counts are checked against the expected ones, and no W4 plain version may
   run on the card.
   On every main path the launch counters are zeroed just before and read
   just after; each kernel of the path must have launched, and the shapes
   it was called with are logged over the same calls.
5. kernels: each of the nine kernels at every shape a main path gave it
   (the two folded W4 forms, which ``linear()`` never dispatches, at their
   counterpart's shapes), against its plain PyTorch version on the same
   inputs, with its time, the plain version's, the one library call's
   where there is one and the bound (W8A8 and the two dispatched W4 forms
   also with their plan from ``w8a8_plan`` / ``w4_plan`` and the time of
   the path the plan did not pick; causal flash also with its query tiles in
   launch order); then small shapes for every feature the paths do not use
   (flash at head dims 32, 80 and 96, zero-padded to the kernel's 64 / 128;
   the norm at widths off a multiple of 8). Tolerances: W8A8 bit-equal, gather equal,
   ``FLASH_TOL``, ``DECODE_TOL``, ``NORM_F32_TOL`` / one ulp of the half
   type, ``w4_error_bound`` for the W4 products.
6. float16 Translator run, float32 chain/chain-off pair, Translator card
   against CPU (as before).
7. Generator A/B at the same widths and 2 layers, no activation
   quantization: flash against ``CT2TPU_FLASH=0`` and the int8-KV decode
   kernel against ``CT2TPU_DECODE_KERNEL=0``. In float32 the first-step
   log-probs must agree within ``LOGPROB_TOL``; in float16 within
   ``OWN_ERROR_FACTOR`` times float16's own error on the same path (its
   plain run against the float32 plain run); the first 8 tokens must be the
   same on every row in both. Then the card against the port on the CPU
   (float32, prompts of 513 with ``flash_attention=True``): within
   ``LOGPROB_TOL`` with the float KV cache; with the int8 KV cache (a cached
   vector at a rounding tie may land one step apart) within
   ``INT8_KV_LOGPROB_TOL``.
8. AWQ checks at 2 layers of the same AWQ weights: the card in float32 (the
   W4 kernels' FMA path) against the port on the CPU (the plain versions),
   packed and unpacked, within ``LOGPROB_TOL``; the card in float16 (the
   ``mma`` path), each W4 kernel against its plain version patched in its
   place, within ``OWN_ERROR_FACTOR`` times float16's own error and with
   the same first 8 tokens.

The line before the last is ``{"kernels": [...]}`` (times are sums over
the ``launches`` counted on the main paths), the last
``{"ok": true, "device": {...}}``. The script exits non-zero, without
those lines, if CUDA is unavailable, any call raises or any check fails.
"""

import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_HALF_FLOPS = 989e12  # H100 SXM dense f16/bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
BATCH = 64
BEAM = 2
MAX_DEC = 32
ITERS = 3
# The sources whose registers, shared memory and spills the card phase
# reports (nvcc -Xptxas -v).
PTXAS_REPORT = ("w8a8_gemm", "flash_attention", "w4_gemm")
OPTS = dict(beam_size=BEAM, max_decoding_length=MAX_DEC,
            min_decoding_length=MAX_DEC, return_scores=True)
# Chain-off vs chain run: the share of identical hypotheses, and the largest
# difference of their normalized scores. In float16 the two attentions'
# other summation orders can part a near-tied beam (60/64 identical on the
# H100); float32 and int8 must be identical.
CHAIN_SAME_SHARE = {"int8": 1.0, "float16": 0.9, "float32": 1.0}
SCORE_TOL = 0.05
# Card against CPU, first decode step's log-probs, both sides summing floats
# in their own orders on the same inputs (int8: the same int8 activations).
LOGPROB_TOL = 1e-3
# Fed the same int8 activations upstream, a linear's input still differs
# between the card and the CPU by float32 rounding, which moves an entry at a
# half-step tie by one int8 step (2 in 65,536 at the worst linear on the
# H100 when the runs are left free).
QUANT_DIFF_SHARE = 1e-3
# Card against CPU with the int8 KV cache (float32, 2 layers): a cached
# vector at a rounding tie lands one int8 step apart (7.6e-3 on the H100;
# the int8 cache's own effect on these log-probs is 0.26).
INT8_KV_LOGPROB_TOL = 5e-2
# A float16 attention kernel against the plain float16 path on the same
# inputs, read after int8 quantization at the output projection: the share
# of one linear's entries that may land one step apart (on the H100 0.023
# for the flash kernel and 0.039 for the decode kernel at the worst layer).
FED_STEP_SHARE = 0.08
MODEL = dict(vocab_size=32000, num_layers=6, num_heads=8, d_model=512,
             d_ff=2048, seed=7)
# The Generator's model: Llama-3-8B's geometry at full width and depth.
LLAMA = dict(layers=32, d_model=4096, heads=32, heads_kv=8, d_ff=14336,
             vocab=128256, rotary_base=500000.0)
GEN_BATCH = 4
GEN_PROMPT = 2049  # the prefill is 2,048 long: the flash kernel's threshold
GEN_NEW = 64
AB_NEW = 8
AB_LAYERS = 2
CPU_PROMPT = 513
# Kernel against plain version on the card. float32: the sums run in another
# order. Half types: the plain version is computed in float32 from the same
# half inputs; the kernel rounds P to the half type before P.V and its
# output once more (bfloat16 has 8 bits of mantissa).
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
             "float16": dict(atol=2e-3, rtol=0.0),
             "bfloat16": dict(atol=1.6e-2, rtol=0.0)}
DECODE_TOL = dict(atol=1e-4, rtol=1e-4)
NORM_F32_TOL = dict(atol=1e-5, rtol=1e-5)
# Two correct runs that each carry a rounding error independently part by
# up to about 1.4 times that error (sqrt(2) for two independent errors of
# one size). Where a switch changes the summation order upstream of a
# rounding step (float16 activations), the two runs are held to this
# multiple of the rounding's own error, measured in the same run on the same
# inputs.
OWN_ERROR_FACTOR = 1.5
# The AWQ model: AutoAWQ's GEMM layout, group 128, the same geometry.
AWQ_GROUP = 128
AWQ_CPU_PROMPT = 129
# Expected launches of one AWQ generate_batch call (4 prompts of 2,049, 64
# new tokens): 5 W4 linears in each of 32 layers, for the prefill and each
# of the 64 steps; 64 x 32 decode-kernel launches; 65 norms a forward pass.
AWQ_LAUNCHES_PER_CALL = {"w4": 32 * 5 * (1 + GEN_NEW), "flash_attention": 32,
                         "decode_attention_int8": GEN_NEW * 32,
                         "fused_norm": 65 * (1 + GEN_NEW), "matmul_w8a8": 0}


STARTED = time.perf_counter()


def emit(obj):
    """Prints one JSON line; phase lines carry the script's elapsed seconds."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - STARTED, 1))
    print(json.dumps(obj), flush=True)


def free_card():
    """Frees what the last phase left: cyclic garbage first (a loaded model
    can sit in a reference cycle), then the allocator's cached blocks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        if not ok:
            self.failed.append(what)
            emit({"check_failed": what})
        return ok


@contextlib.contextmanager
def patched(module, name, wrap):
    """Replaces ``module.name`` by ``wrap(original)`` for one block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def chain_off():
    """Turns chain-mask beam attention off: the beam reorders its caches
    through the gather kernel."""
    os.environ["CT2TPU_BEAM_CHAIN"] = "0"
    try:
        yield
    finally:
        os.environ.pop("CT2TPU_BEAM_CHAIN")


def shape_log(counts, key):
    """A ``patched`` wrapper that counts the calls per ``key(*args)``."""
    def wrap(orig):
        def wrapped(*args, **kwargs):
            k = key(*args, **kwargs)
            counts[k] = counts.get(k, 0) + 1
            return orig(*args, **kwargs)
        return wrapped
    return wrap


def _dt(t):
    return str(t.dtype).split(".")[1]


# What identifies a call shape of each kernel's wrapper.
SHAPE_KEYS = {
    "matmul_w8a8": lambda q, wq, a, w: (q.shape[0], q.shape[1], wq.shape[0]),
    "gather_rows_fused": lambda arrays, rows: (
        tuple((tuple(a.shape), str(a.dtype)) for a in arrays), rows.shape[0]),
    "flash_attention": lambda q, k, v, **kw: (
        tuple(q.shape), k.shape[1], k.shape[2], _dt(q), bool(kw.get("causal")),
        kw.get("lengths") is not None, kw.get("window", 0)),
    "decode_attention_int8": lambda q, k8, ks, v8, vs, lengths, **kw: (
        tuple(q.shape), k8.shape[1], k8.shape[2], _dt(q),
        kw.get("k_new8") is not None, kw.get("window", 0)),
    "fused_norm": lambda x, gamma, beta=None, **kw: (
        x.numel() // x.shape[-1], x.shape[-1], _dt(x), beta is not None),
    "matmul_w4p": lambda x, w4p, gs, zs: (x.shape[0], x.shape[1], w4p.shape[1], _dt(x)),
    "matmul_w4a16": lambda x, w4, gs: (x.shape[0], x.shape[1], w4.shape[1], _dt(x)),
}


@contextlib.contextmanager
def kernel_shape_logs(logs):
    """Logs, per kernel, the call shapes its wrapper is given (where the
    model code looks the wrapper up) into ``logs[name][shape] += 1``."""
    import ctranslate2_tpu_torch.models.transformer as T
    import ctranslate2_tpu_torch.ops.linear as L
    import ctranslate2_tpu_torch.ops.norms as N

    homes = {"matmul_w8a8": L, "gather_rows_fused": T, "flash_attention": T,
             "decode_attention_int8": T, "fused_norm": N, "matmul_w4p": L,
             "matmul_w4a16": L}
    with contextlib.ExitStack() as stack:
        for name, module in homes.items():
            stack.enter_context(patched(
                module, name, shape_log(logs.setdefault(name, {}), SHAPE_KEYS[name])))
        yield logs


def check_logs_cover(counts, logs, logs_before, label, checks):
    """The shape logs must account for every counted launch."""
    for name, n in counts.items():
        logged = sum(logs.get(name, {}).values()) - logs_before.get(name, 0)
        checks(logged == n,
               f"{label}: the shape log of {name} covers every counted launch "
               f"({logged} logged, {n} counted)")


_CAPTURE_STREAM = None


def cuda_time_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up.

    The calls are captured in a CUDA graph and the graph is timed with CUDA
    events: timing eager calls would measure the host's launch rate, which
    for kernels of tens of microseconds is slower than the card."""
    import torch

    global _CAPTURE_STREAM
    if _CAPTURE_STREAM is None:
        _CAPTURE_STREAM = torch.cuda.Stream()
    stream = _CAPTURE_STREAM
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # the warm-up runs on the capture stream: per-stream state
        # (the W4 split-K counters) is then made outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_summary(log):
    """Per kernel entry of an ``-Xptxas -v`` log: its registers, spill
    stores and loads, and static shared memory, as one short string."""
    out = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_\d+_\w+?_cu_\w{8}\d+", "", m.group(1))
            out[entry] = ""
        elif entry and ("registers" in line or "spill" in line):
            out[entry] += line.split(":", 1)[-1].strip() + "; "
    return out


def make_batch(vocab, seed):
    import numpy as np

    r = np.random.default_rng(1000 + seed)
    return [[vocab.to_token(int(t)) for t in r.integers(3, 31990, int(r.integers(20, 31)))]
            for _ in range(BATCH)]


def translate_run(translator, batches):
    """Timed translate_batch calls; returns (results, seconds, tokens)."""
    import torch

    results = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for b in batches:
        results.append(translator.translate_batch(b, **OPTS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    tokens = sum(len(r.hypotheses[0]) for res in results for r in res)
    return results, seconds, tokens


def compare_chain(chain, off):
    """Chain-mask results against chain-off results of the same batch: the
    identical hypotheses, the score differences among them (the summation
    order's own noise) and those of the sentences whose hypotheses parted."""
    same = [a.hypotheses == b.hypotheses for a, b in zip(chain, off)]
    diffs = [abs(a.scores[0] - b.scores[0]) for a, b in zip(chain, off)]
    return {"identical": sum(same), "sentences": len(same),
            "best_score_max_abs_diff": max(diffs),
            "identical_best_score_max_abs_diff": max(
                (d for d, s in zip(diffs, same) if s), default=None),
            "parted_best_score_abs_diff": [d for d, s in zip(diffs, same) if not s]}


def check_chain(cmp, label, checks):
    checks(cmp["identical"] >= CHAIN_SAME_SHARE[label] * cmp["sentences"]
           and cmp["best_score_max_abs_diff"] <= SCORE_TOL,
           f"{label}: chain-off hypotheses match the chain run's "
           f"({cmp['identical']}/{cmp['sentences']} identical, "
           f"best-score diff {cmp['best_score_max_abs_diff']})")


def profile_call(call, label):
    """One call of the entry point under torch.profiler: the device's busy
    time (sum of kernel times) against the call's wall time, and the
    kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit({"phase": f"profile_{label}", "wall_ms_profiled": wall_ms,
          "device_busy_ms": device_ms,
          "device_busy_share": device_ms / wall_ms,
          "kernel_launches_profiled": sum(r[1] for r in rows),
          "top_device_ms": [[name[:60], ms, n] for ms, n, name in rows[:8]]})


def main_path(tt, model_dir, compute_type, batches, checks, label, logs):
    """Timed chain-on calls plus one chain-off call, with the launch
    counters zeroed before and read after, and each kernel's call shapes
    logged over the same calls."""
    import torch

    translator = tt.Translator(model_dir, compute_type=compute_type)
    translator.translate_batch(batches[0], **OPTS)  # warm-up, both paths
    with chain_off():
        translator.translate_batch(batches[0], **OPTS)

    logged_before = {name: sum(d.values()) for name, d in logs.items()}
    with kernel_shape_logs(logs):
        torch.cuda.reset_peak_memory_stats()
        tt.reset_launches()
        results, seconds, tokens = translate_run(translator, batches[1:1 + ITERS])
        chain_counts = tt.launch_counts()
        with chain_off():
            off, off_seconds, _ = translate_run(translator, batches[1:2])
        counts = tt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    profile_call(lambda: translator.translate_batch(batches[1], **OPTS), label)
    # The same call with the plain norm functions (the port's state before
    # the norm kernel), for its launch count beside the above.
    with environ(CT2TPU_PALLAS_NORMS="0"):
        profile_call(lambda: translator.translate_batch(batches[1], **OPTS),
                     f"{label}_plain_norms")

    cmp = compare_chain(results[0], off[0])
    lengths_ok = all(len(r.hypotheses[0]) == MAX_DEC for res in results for r in res)
    checks(lengths_ok, f"{label}: every hypothesis has {MAX_DEC} tokens")
    checks(counts["gather_rows_fused"] > chain_counts["gather_rows_fused"],
           f"{label}: the chain-off call launched the gather kernel")
    check_logs_cover(counts, logs, logged_before, label, checks)
    check_chain(cmp, label, checks)
    steps = (ITERS + 1) * MAX_DEC
    emit({"phase": f"main_{label}", "compute_type": translator.compute_type,
          "calls": ITERS, "sentences_per_call": BATCH, "beam": BEAM,
          "target_tokens": tokens, "seconds": seconds,
          "target_tokens_per_s": tokens / seconds,
          "chain_off_call_seconds": off_seconds,
          "launches_chain_calls": chain_counts,
          "launches_total": counts,
          "w8a8_launches_per_call": chain_counts["matmul_w8a8"] / ITERS,
          "fused_norm_launches_per_call": chain_counts["fused_norm"] / ITERS,
          "fused_norm_launches_per_decode_step": (
              counts["fused_norm"] - (ITERS + 1) * 13) / steps,
          "gather_launches_chain_off_call": counts["gather_rows_fused"]
          - chain_counts["gather_rows_fused"],
          "chain_off_vs_chain": cmp,
          "peak_memory_bytes": peak})
    return counts


def chain_float32(tt, model_dir, batch, checks):
    """The chain/chain-off pair in float32 on the card at full width: a
    second witness that the two beam paths agree where float16's rounding
    cannot part near-tied beams."""
    translator = tt.Translator(model_dir, compute_type="float32")
    chain = translator.translate_batch(batch, **OPTS)
    with chain_off():
        off = translator.translate_batch(batch, **OPTS)
    cmp = compare_chain(chain, off)
    check_chain(cmp, "float32", checks)
    emit({"phase": "chain_float32", "chain_off_vs_chain": cmp})


def w8a8_other_plan(qm, M, K, N):
    """The plan of the path ``w8a8_plan`` does not pick for (M, K, N), where
    the other path takes the shape (None where it does not)."""
    chosen = qm.w8a8_plan(M, N, K)
    saved = qm.WGMMA_MIN_M
    qm.WGMMA_MIN_M = 1 << 40 if chosen.path == "wgmma" else 1
    try:
        other = qm.w8a8_plan(M, N, K)
    finally:
        qm.WGMMA_MIN_M = saved
    return other if other.path != chosen.path else None


def bench_w8a8(shapes, checks):
    """Kernel vs plain vs library at each (M, K, N), weighted by its
    launches on the main path; returns the sums over those launches. Each
    line also carries the plan (path, split count, tile) and the time of
    the path the plan did not pick, the evidence for the crossover."""
    import torch
    from ctranslate2_tpu_torch.kernels import quant_matmul as qm
    from ctranslate2_tpu_torch.kernels.quant_matmul import (
        matmul_w8a8, matmul_w8a8_plain)

    g = torch.Generator(device="cuda").manual_seed(0)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    library_ok = True
    max_err = 0.0
    for (M, K, N), n in sorted(shapes.items()):
        q = torch.randint(-128, 128, (M, K), generator=g, device="cuda",
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                           dtype=torch.int8)
        a_s = torch.rand(M, generator=g, device="cuda") * 5 + 0.5
        w_s = torch.rand(N, generator=g, device="cuda") * 5 + 0.5
        plan = qm.w8a8_plan(M, N, K)
        other = w8a8_other_plan(qm, M, K, N)
        out = matmul_w8a8(q, wq, a_s, w_s)
        ref = matmul_w8a8_plain(q, wq, a_s, w_s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)
        checks(torch.equal(out, ref), f"w8a8 bit-equal to plain at {(M, K, N)} ({plan.path})")
        if other is not None:
            checks(torch.equal(qm._w8a8_launch(q, wq, a_s, w_s, other), ref),
                   f"w8a8 {other.path} path bit-equal to plain at {(M, K, N)}")
        iters = 50 if M * N * K < 2**32 else 10
        ms = cuda_time_ms(lambda: matmul_w8a8(q, wq, a_s, w_s), iters)
        other_ms = (None if other is None else cuda_time_ms(
            lambda: qm._w8a8_launch(q, wq, a_s, w_s, other), iters))
        plain_ms = cuda_time_ms(lambda: matmul_w8a8_plain(q, wq, a_s, w_s), iters)
        try:
            wt = wq.t()
            # torch._int_mm wants more than 16 rows: the decode shapes are
            # padded to 32 rows of zeros for it (timed only).
            ql = q if M >= 32 else torch.cat([q, q.new_zeros((32 - M, K))])
            lib_ms = cuda_time_ms(
                lambda: torch._int_mm(ql, wt)[:M].float() / (a_s[:, None] * w_s[None, :]),
                iters)
        except RuntimeError as e:  # torch._int_mm refuses some shapes
            lib_ms, library_ok = None, False
            emit({"library_refused": [M, K, N], "error": str(e)[:200]})
        bytes_ms = (M * K + N * K + 4 * M * N + 4 * M + 4 * N) / PEAK_BYTES * 1e3
        ops_ms = 2 * M * N * K / PEAK_INT8_OPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        emit({"phase": "kernel_w8a8", "M": M, "K": K, "N": N,
              "path": plan.path, "splits": plan.splits, "tile": list(plan.tile),
              "launches": n, "max_abs_err": err, "kernel_ms": ms,
              "tops": 2 * M * N * K / ms / 1e9, "share_of_bound": bound_ms / ms,
              "other_path": None if other is None else other.path,
              "other_path_splits": None if other is None else other.splits,
              "other_path_ms": other_ms,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": bound_ms,
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["library_ms"] += n * (lib_ms or 0.0)
        tot["bytes_ms"] += n * bytes_ms
        tot["ops_ms"] += n * ops_ms
    tot["library_ms"] = tot["library_ms"] if library_ok else None
    tot["max_abs_err"] = max_err
    return tot


def bench_gather(shapes, checks):
    """Kernel vs plain (= the library's index_select loop) at each call
    shape, weighted by its launches on the main path; returns the sums."""
    import torch
    from ctranslate2_tpu_torch.kernels.gather_rows import (
        gather_rows_fused, gather_rows_plain)

    g = torch.Generator(device="cuda").manual_seed(1)
    tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0)
    max_err = 0.0
    for (specs, n_rows), n in sorted(shapes.items()):
        arrays = [torch.randn(shape, generator=g, device="cuda").to(getattr(torch, dt.split(".")[1]))
                  for shape, dt in specs]
        rows = torch.randint(0, specs[0][0][0], (n_rows,), generator=g,
                             device="cuda", dtype=torch.int32)
        out = gather_rows_fused(arrays, rows)
        ref = gather_rows_plain(arrays, rows)
        torch.cuda.synchronize()
        err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
        max_err = max(max_err, err)
        checks(all(torch.equal(o, r) for o, r in zip(out, ref)),
               f"gather equal to plain at {len(specs)} arrays x {n_rows} rows")
        ms = cuda_time_ms(lambda: gather_rows_fused(arrays, rows), 100)
        plain_ms = cuda_time_ms(lambda: gather_rows_plain(arrays, rows), 100)
        nbytes = sum(a.numel() * a.element_size() for a in arrays) \
            * n_rows // specs[0][0][0]
        bytes_ms = 2 * nbytes / PEAK_BYTES * 1e3
        emit({"phase": "kernel_gather", "arrays": [list(s) for s, _ in specs][:1],
              "num_arrays": len(specs), "dtype": specs[0][1], "rows": n_rows,
              "launches": n, "max_abs_err": err, "kernel_ms": ms,
              "plain_ms": plain_ms, "library_ms": plain_ms,
              "bytes_moved": 2 * nbytes, "bound_ms": bytes_ms, "bound_by": "bytes"})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["bytes_ms"] += n * bytes_ms
    tot["max_abs_err"] = max_err
    return tot


def _flash_inputs(g, B, Hq, Hkv, Tq, Tk, D, dtype):
    import torch

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return t(B, Hq, Tq, D), t(B, Hkv, Tk, D), t(B, Hkv, Tk, D)


def bench_flash(shapes, checks):
    """The flash kernel at every main-path shape against its plain version
    (computed in float32 from the same inputs) and, timed only,
    ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F
    from ctranslate2_tpu_torch.kernels import flash_attention as fa
    from ctranslate2_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(2)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
               max_abs_err=0.0)
    for key, n in sorted(shapes.items()):
        (B, Hq, Tq, D), Hkv, Tk, dt, causal, has_lengths, window = key
        dtype = getattr(torch, dt)
        q, k, v = _flash_inputs(g, B, Hq, Hkv, Tq, Tk, D, dtype)
        lengths = (torch.randint(Tk // 2, Tk + 1, (B,), generator=g, device="cuda",
                                 dtype=torch.int32) if has_lengths else None)
        kw = dict(scale=D ** -0.5, causal=causal, lengths=lengths, window=window)
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        checks(torch.allclose(out.float(), ref, **FLASH_TOL[dt]),
               f"flash within {FLASH_TOL[dt]} of plain at {key} (max abs err {err})")
        del ref
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw), 5)
        launch_order_ms = None
        if causal:  # the causal query tiles in launch order instead
            fa.HEAVIEST_FIRST = False
            try:
                launch_order_ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw), 5)
            finally:
                fa.HEAVIEST_FIRST = True
        plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, **kw), 3)
        lib_ms = None
        if lengths is None and not window:
            lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=D ** -0.5,
                enable_gqa=Hq != Hkv), 5)
        share = 0.5 if causal and Tq == Tk and not window else 1.0
        ops = 4.0 * B * Hq * Tq * Tk * D * share
        peak = PEAK_F32_FLOPS if dt == "float32" else PEAK_HALF_FLOPS
        ops_ms = ops / peak * 1e3
        bytes_ms = (2 * q.numel() + 2 * k.numel()) * q.element_size() / PEAK_BYTES * 1e3
        emit({"phase": "kernel_flash", "q": [B, Hq, Tq, D], "kv": [B, Hkv, Tk, D],
              "dtype": dt, "causal": causal, "lengths": has_lengths, "window": window,
              "launches": n, "max_abs_err": err, "tolerance": FLASH_TOL[dt],
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "library": "F.scaled_dot_product_attention",
              "flops": ops, "tflops": ops / ms / 1e9,
              "share_of_bound": max(ops_ms, bytes_ms) / ms,
              "heaviest_first": causal, "launch_order_ms": launch_order_ms,
              "bound_ms": max(ops_ms, bytes_ms),
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["library_ms"] = (None if lib_ms is None or tot["library_ms"] is None
                             else tot["library_ms"] + n * lib_ms)
        tot["bytes_ms"] += n * bytes_ms
        tot["ops_ms"] += n * ops_ms
    return tot


def _decode_inputs(g, B, Hq, Hkv, C, D, dtype, fresh, lengths):
    import torch
    from ctranslate2_tpu_torch.kernels.decode_attention import quantize_kv

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    k8, ks = quantize_kv(t(B, Hkv, C, D))
    v8, vs = quantize_kv(t(B, Hkv, C, D))
    kw = {}
    if fresh:
        kw["k_new8"], kw["kn_scale"] = quantize_kv(t(B, Hkv, 1, D))
        kw["v_new8"], kw["vn_scale"] = quantize_kv(t(B, Hkv, 1, D))
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (t(B, Hq, 1, D).to(dtype), k8, ks, v8, vs, lengths), kw


def bench_decode(shapes, first_length, steps, checks):
    """The int8-KV decode kernel at every main-path shape, with cache
    lengths spread over those of the run's steps. No single PyTorch call
    computes this function, so there is no library time."""
    import torch
    from ctranslate2_tpu_torch.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain)

    g = torch.Generator(device="cuda").manual_seed(3)
    tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
    for key, n in sorted(shapes.items()):
        (B, Hq, _, D), Hkv, C, dt, fresh, window = key
        # Lengths from the first step's to the last step's: their mean is
        # the mean over the run.
        lengths = [first_length + round(i * (steps - 1) / max(B - 1, 1))
                   for i in range(B)]
        args, kw = _decode_inputs(g, B, Hq, Hkv, C, D, getattr(torch, dt),
                                  fresh, lengths)
        kw.update(scale=D ** -0.5, window=window)
        out = decode_attention_int8(*args, **kw)
        ref = decode_attention_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        checks(torch.allclose(out, ref, **DECODE_TOL),
               f"decode within {DECODE_TOL} of plain at {key} (max abs err {err})")
        ms = cuda_time_ms(lambda: decode_attention_int8(*args, **kw), 50)
        plain_ms = cuda_time_ms(lambda: decode_attention_int8_plain(*args, **kw), 20)
        # The wrapper's rule: with a fresh key the window shows window - 1
        # cache keys, and none when it is 1.
        shown = window - 1 if fresh and window else window
        keys = sum(0 if fresh and window == 1 else (min(lng, shown) if shown else lng)
                   for lng in lengths)
        nbytes = keys * Hkv * (2 * D + 8) + (2 * Hkv * (D + 4) * B if fresh else 0) \
            + B * Hq * D * (args[0].element_size() + 4)
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        ops_ms = 4.0 * keys * Hq * D / PEAK_F32_FLOPS * 1e3
        emit({"phase": "kernel_decode", "q": [B, Hq, 1, D], "cache": [B, Hkv, C, D],
              "dtype": dt, "fresh": fresh, "window": window, "lengths": lengths,
              "launches": n, "max_abs_err": err, "tolerance": DECODE_TOL,
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "bytes_moved": nbytes, "gbytes_per_s": nbytes / ms / 1e6,
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["bytes_ms"] += n * bytes_ms
        tot["ops_ms"] += n * ops_ms
    return tot


def norm_close(out, ref, beta):
    """float32: ``NORM_F32_TOL``. Half types: one ulp of the output type,
    taken at the scale of the terms where beta cancels the scaled value."""
    import torch

    if out.dtype == torch.float32:
        return torch.allclose(out, ref, **NORM_F32_TOL)
    ulp = 2.0 ** (-10 if out.dtype == torch.float16 else -7)
    scale = ref.float().abs().clamp_min(2.0 ** -14)
    if beta is not None:
        scale = torch.maximum(scale, beta.abs().expand_as(scale))
    return bool(((out.float() - ref.float()).abs() <= ulp * scale).all())


def bench_norm(shapes, checks):
    """The norm kernel at every main-path shape against its plain version
    and, timed only, ``F.rms_norm`` / ``F.layer_norm``."""
    import torch
    import torch.nn.functional as F
    from ctranslate2_tpu_torch.kernels.norms import fused_norm, fused_norm_plain

    g = torch.Generator(device="cuda").manual_seed(4)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, max_abs_err=0.0)
    for key, n in sorted(shapes.items()):
        rows, D, dt, has_beta = key
        dtype = getattr(torch, dt)
        x = (torch.randn((rows, D), generator=g, device="cuda") * 2 + 0.5).to(dtype)
        gamma = torch.randn(D, generator=g, device="cuda")
        beta = torch.randn(D, generator=g, device="cuda") if has_beta else None
        out = fused_norm(x, gamma, beta, eps=1e-5)
        ref = fused_norm_plain(x, gamma, beta, eps=1e-5)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        checks(norm_close(out, ref, beta),
               f"norm within one ulp of plain at {key} (max abs err {err})")
        iters = 100 if rows * D < 2**22 else 20
        ms = cuda_time_ms(lambda: fused_norm(x, gamma, beta, eps=1e-5), iters)
        plain_ms = cuda_time_ms(lambda: fused_norm_plain(x, gamma, beta, eps=1e-5), iters)
        gx = gamma.to(dtype)
        if has_beta:
            bx = beta.to(dtype)
            lib_ms = cuda_time_ms(lambda: F.layer_norm(x, (D,), gx, bx, 1e-5), iters)
        else:
            lib_ms = cuda_time_ms(lambda: F.rms_norm(x, (D,), gx, 1e-5), iters)
        nbytes = 2 * rows * D * x.element_size() + 4 * D * (2 if has_beta else 1)
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        emit({"phase": "kernel_norm", "rows": rows, "D": D, "dtype": dt,
              "layer_norm": has_beta, "launches": n, "max_abs_err": err,
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "library": "F.layer_norm" if has_beta else "F.rms_norm",
              "bytes_moved": nbytes, "bound_ms": bytes_ms, "bound_by": "bytes"})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["library_ms"] += n * lib_ms
        tot["bytes_ms"] += n * bytes_ms
    return tot


def feature_checks(checks):
    """Small shapes on the card for every feature the main paths do not
    use: each kernel against its plain version."""
    import torch
    from ctranslate2_tpu_torch.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain)
    from ctranslate2_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from ctranslate2_tpu_torch.kernels.norms import fused_norm, fused_norm_plain

    g = torch.Generator(device="cuda").manual_seed(5)
    B, T = 2, 150

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    def slopes(h):
        return torch.tensor([0.5 ** (i + 1) for i in range(h)], device="cuda")

    def table(h):
        return torch.randn((12, h), generator=g, device="cuda")

    segments = torch.sort(torch.randint(0, 3, (B, T), generator=g, device="cuda",
                                        dtype=torch.int32), dim=1).values
    flash_cases = [
        ("non_causal_lengths", "float16", 128, 4, 2, T, T, dict(lengths=i32([37, T]))),
        ("window", "float16", 64, 4, 4, T, T, dict(causal=True, window=17)),
        ("segment_ids", "float16", 128, 4, 2, T, T, dict(causal=True, segment_ids=segments)),
        ("alibi_negative", "bfloat16", 64, 4, 2, T, T,
         dict(causal=True, alibi_slopes=slopes(4), alibi_positive=False)),
        ("alibi_positive", "float16", 64, 4, 4, T, T,
         dict(causal=True, alibi_slopes=slopes(4), alibi_positive=True)),
        ("t5_causal", "float16", 64, 4, 4, T, T,
         dict(causal=True, rel_bias_table=table(4), rel_max_distance=50,
              rel_bidirectional=False)),
        ("t5_bidirectional", "float32", 64, 4, 2, T, T,
         dict(rel_bias_table=table(4), rel_max_distance=50, rel_bidirectional=True)),
        ("q_offset", "float16", 128, 4, 2, 60, T, dict(causal=True, q_offset=5)),
        ("bf16_mqa", "bfloat16", 128, 4, 1, T, T, dict(causal=True)),
        ("f32_head_dim_128", "float32", 128, 2, 2, T, T, dict(causal=True, lengths=i32([T, 9]))),
        ("masked_rows", "float16", 64, 2, 2, T, T, dict(lengths=i32([0, T]))),
        # Head dims off 64/128 run zero-padded to the next instance.
        ("head_dim_80", "float16", 80, 4, 2, T, T, dict(causal=True, lengths=i32([T, 101]))),
        ("head_dim_96", "bfloat16", 96, 4, 2, T, T, dict(lengths=i32([37, T]))),
        ("head_dim_32_f32", "float32", 32, 4, 1, T, T, dict(causal=True)),
    ]
    worst = {}
    for name, dt, D, Hq, Hkv, Tq, Tk, kw in flash_cases:
        q, k, v = _flash_inputs(g, B, Hq, Hkv, Tq, Tk, D, getattr(torch, dt))
        out = flash_attention(q, k, v, scale=D ** -0.5, **kw)
        ref = flash_attention_plain(q.float(), k.float(), v.float(), scale=D ** -0.5, **kw)
        torch.cuda.synchronize()
        worst[f"flash_{name}"] = err = (out.float() - ref).abs().max().item()
        checks(torch.allclose(out.float(), ref, **FLASH_TOL[dt]),
               f"flash feature {name} ({dt}, D={D}) within {FLASH_TOL[dt]} (got {err})")
    try:
        flash_attention(*_flash_inputs(g, 1, 2, 2, 8, 8, 256, torch.float16))
        refused = False
    except NotImplementedError as e:
        refused = "256" in str(e)
    checks(refused, "flash refuses a head dim of 256 with a message that names it")

    decode_cases = [
        ("window_fresh", "float16", 8, 2, 300, 64, True, 9, [300, 17, 0]),
        ("window_one", "float32", 8, 2, 300, 64, True, 1, [300, 17, 0]),
        ("no_fresh", "float16", 32, 8, 2176, 128, False, 0, [2048, 2111, 1]),
        ("no_fresh_window", "bfloat16", 6, 1, 130, 32, False, 7, [130, 64, 5]),
        ("head_dim_256", "float32", 4, 2, 70, 256, True, 0, [70, 33, 2]),
    ]
    for name, dt, Hq, Hkv, C, D, fresh, window, lengths in decode_cases:
        args, kw = _decode_inputs(g, len(lengths), Hq, Hkv, C, D, getattr(torch, dt),
                                  fresh, lengths)
        kw.update(scale=D ** -0.5, window=window)
        out = decode_attention_int8(*args, **kw)
        ref = decode_attention_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        worst[f"decode_{name}"] = err = (out - ref).abs().max().item()
        checks(torch.allclose(out, ref, **DECODE_TOL),
               f"decode feature {name} within {DECODE_TOL} (got {err})")

    for name, dt, shape, has_beta in [
            ("layer_norm_beta", "float16", (3, 5, 512), True),
            ("layer_norm_f32", "float32", (7, 24), True),
            ("rms_bf16_long_row", "bfloat16", (2, 17000), False),
            # Widths off a multiple of 8 take the scalar-load instance.
            ("layer_norm_odd_width", "float16", (5, 4097), True),
            ("rms_width_100", "bfloat16", (9, 100), False),
            ("layer_norm_width_12_f32", "float32", (3, 12), True)]:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(getattr(torch, dt))
        gamma = torch.randn(shape[-1], generator=g, device="cuda")
        beta = torch.randn(shape[-1], generator=g, device="cuda") if has_beta else None
        out = fused_norm(x, gamma, beta, eps=1e-5)
        ref = fused_norm_plain(x, gamma, beta, eps=1e-5)
        torch.cuda.synchronize()
        worst[f"norm_{name}"] = (out.float() - ref.float()).abs().max().item()
        checks(norm_close(out, ref, beta), f"norm feature {name} within one ulp of plain")
    emit({"phase": "kernel_features", "max_abs_err": worst})


# ---------------------------------------------------------------------------
# Generator: the Llama-3-8B geometry.
# ---------------------------------------------------------------------------

def _llama_file(layers, **config):
    """The Llama-3-8B geometry's attributes and norms in a new in-memory
    ModelFile (``config`` added to its config), and its weight matrices as
    (scope, out_dim, in_dim, seed) jobs, embeddings and projection first."""
    import numpy as np
    from ctranslate2_tpu_torch.formats.model_file import ModelFile, make_variable

    cfg = LLAMA
    d, heads, heads_kv = cfg["d_model"], cfg["heads"], cfg["heads_kv"]
    head_dim = d // heads
    mf = ModelFile(spec_name="TransformerDecoderSpec", spec_revision=8,
                   binary_version=6)
    mf.config = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
                 "layer_norm_epsilon": 1e-5, **config}

    def add(name, value, dtype=None):
        mf.variables[name] = make_variable(name, value, dtype)

    sc = "decoder"
    add(f"{sc}/num_heads", heads, "int16")
    add(f"{sc}/pre_norm", 1, "int8")
    add(f"{sc}/activation", 2, "int8")  # swish
    add(f"{sc}/scale_embeddings", 0, "int8")
    add(f"{sc}/layer_norm/gamma", np.ones(d, np.float32))
    jobs = [(f"{sc}/embeddings", cfg["vocab"], d, 0),
            (f"{sc}/projection", cfg["vocab"], d, 1)]
    for i in range(layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        jobs.append((f"{asc}/linear_0", (heads + 2 * heads_kv) * head_dim, d, 10 + i))
        jobs.append((f"{asc}/linear_1", d, heads * head_dim, 1000 + i))
        add(f"{asc}/layer_norm/gamma", np.ones(d, np.float32))
        add(f"{asc}/num_heads_kv", heads_kv, "int32")
        add(f"{asc}/rotary_dim", 0, "int32")
        add(f"{asc}/rotary_interleave", 0, "int8")
        add(f"{asc}/rotary_base", cfg["rotary_base"], "float32")
        jobs.append((f"{ls}/ffn/linear_0", cfg["d_ff"], d, 2000 + i))
        jobs.append((f"{ls}/ffn/linear_0_noact", cfg["d_ff"], d, 3000 + i))
        jobs.append((f"{ls}/ffn/linear_1", d, cfg["d_ff"], 4000 + i))
        add(f"{ls}/ffn/layer_norm/gamma", np.ones(d, np.float32))
    return mf, jobs


def _draw_into(mf, jobs, draw):
    """Adds the variables ``draw(job)`` returns for every job, several jobs at
    a time on a thread pool (numpy releases the interpreter lock while it
    draws). ``draw`` returns (scope, {suffix: array})."""
    from concurrent.futures import ThreadPoolExecutor

    from ctranslate2_tpu_torch.formats.model_file import make_variable

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        for scope, arrays in pool.map(draw, jobs):
            for suffix, value in arrays.items():
                name = f"{scope}/{suffix}"
                mf.variables[name] = make_variable(name, value)
    return mf


def build_llama_modelfile(layers):
    """The Llama-3-8B geometry fabricated directly as int8 payloads and
    scales, in memory (no float intermediates): every linear's payload is
    drawn from its own seed."""
    import numpy as np

    mf, jobs = _llama_file(layers)

    def draw(job):
        scope, rows, cols, seed = job
        q = np.random.default_rng(seed).integers(-127, 128, (rows, cols), dtype=np.int8)
        return scope, {"weight": q,
                       "weight_scale": np.full((rows,), 127.0 / 0.05, np.float32)}

    return _draw_into(mf, jobs, draw)


def build_awq_llama_modelfile(layers):
    """The same geometry as AutoAWQ's GEMM checkpoints store it (group 128,
    zero points; ``quantization_type`` 1), fabricated in memory: each layer
    linear's ``weight`` int32 [in, out/8] of random nibbles, ``weight_scale``
    f32 [in/128, out] in [0.005, 0.0075] and ``weight_zero`` int32
    [in/128, out/8] of zero points 7 and 8, so that (q - z) * s is centred
    and about as wide as the int8 model's weights; float16 embeddings and
    projection, as the reference's converter leaves them."""
    import numpy as np
    from ctranslate2_tpu_torch.ops.awq import AWQ_GEMM, pack_awq_gemm

    G = AWQ_GROUP
    mf, jobs = _llama_file(layers, quantization_type=AWQ_GEMM,
                           quantization_bits=4, quantization_group_size=G)

    def draw(job):
        scope, out_dim, in_dim, seed = job
        rng = np.random.default_rng(seed)
        if not re.search(r"/layer_\d+/", scope):  # embeddings, projection
            w = np.empty((out_dim, in_dim), np.float16)
            for r in range(0, out_dim, 16384):
                rows = min(16384, out_dim - r)
                w[r:r + rows] = rng.random((rows, in_dim), dtype=np.float32) * 0.1 - 0.05
            return scope, {"weight": w}
        return scope, {
            "weight": rng.integers(0, 2 ** 32, (in_dim, out_dim // 8),
                                   dtype=np.uint32).view(np.int32),
            "weight_scale": rng.random((in_dim // G, out_dim), dtype=np.float32)
                            * 0.0025 + 0.005,
            "weight_zero": pack_awq_gemm(
                rng.integers(7, 9, (in_dim // G, out_dim), dtype=np.uint8))}

    return _draw_into(mf, jobs, draw)


def llama_subset(mf, layers):
    """The first ``layers`` layers of a fabricated model, sharing its arrays."""
    from ctranslate2_tpu_torch.formats.model_file import ModelFile

    sub = ModelFile(spec_name=mf.spec_name, spec_revision=mf.spec_revision,
                    binary_version=mf.binary_version)
    sub.config = dict(mf.config)
    for name, var in mf.variables.items():
        layer = re.match(r"decoder/layer_(\d+)/", name)
        if layer and int(layer.group(1)) >= layers:
            continue
        sub.variables[name] = var
    return sub


def make_generator(tt, mf, vocab, **kwargs):
    """A Generator on an in-memory model, which carries no vocabulary file:
    the vocabulary is handed to the loaded model."""
    gen = tt.Generator(mf, **kwargs)
    gen.model.target_vocabulary = vocab
    return gen


def make_prompts(vocab, length, seed):
    import numpy as np

    r = np.random.default_rng(2000 + seed)
    return [[vocab.to_token(int(t)) for t in r.integers(10, LLAMA["vocab"] - 10, length)]
            for _ in range(GEN_BATCH)]


@contextlib.contextmanager
def environ(**values):
    """Sets environment variables for one block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def generate_run(gen, prompts, new_tokens=GEN_NEW):
    """One timed generate_batch call; returns (results, seconds, prefill
    seconds). The prefill is timed with a device sync on either side."""
    import torch

    prefill = []

    def timed(orig):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            prefill.append(time.perf_counter() - start)
            return out
        return wrapped

    torch.cuda.synchronize()
    start = time.perf_counter()
    with patched(gen, "_prefill", timed):
        results = gen.generate_batch(
            prompts, include_prompt_in_result=False, beam_size=1,
            min_length=new_tokens, max_length=new_tokens, return_scores=True)
    torch.cuda.synchronize()
    return results, time.perf_counter() - start, sum(prefill)


def generator_first_step_logprobs(gen, prompts, quantize_wrap=None,
                                  on_prefilled=None):
    """Prefill all but the last prompt token, then one decode step: its
    log-probs (float32, on the CPU). With ``quantize_wrap``,
    ``ops.linear.quantize_per_row`` is patched by it over both;
    ``on_prefilled`` is called between the two."""
    import torch
    import ctranslate2_tpu_torch.ops.linear as L
    from ctranslate2_tpu_torch.models import transformer as T

    m = gen.model
    if quantize_wrap is not None:
        with patched(L, "quantize_per_row", quantize_wrap):
            return generator_first_step_logprobs(gen, prompts,
                                                 on_prefilled=on_prefilled)
    ids = [[gen._vocab.to_id(t) for t in p] for p in prompts]
    length = len(ids[0])
    capacity = (length + GEN_NEW + 64) // 64 * 64
    m.ensure_consts(capacity)
    cache = T.init_self_cache(m.arch, len(ids), capacity, dtype=m.kv_dtype,
                              device=m.device)
    gen._prefill([row[:-1] for row in ids], cache, 0)
    if on_prefilled is not None:
        on_prefilled()
    last = torch.tensor([[row[-1]] for row in ids], dtype=torch.long, device=m.device)
    logits, _ = T.decoder_forward(
        m.arch, m.params, m.consts, last, length - 1, cache,
        quantize_acts=m.policy.quantize_activations, out_dtype=m.out_dtype)
    return torch.log_softmax(logits[:, -1].float(), -1).cpu()


def same_prefix_rows(a, b, n):
    return sum(x.sequences_ids[0][:n] == y.sequences_ids[0][:n] for x, y in zip(a, b))


def generator_main_path(tt, mf, vocab, checks, logs):
    """The Generator at full width and depth, int8 weights, int8 KV cache:
    timed calls with the launch counters zeroed before and read after, the
    profiler's busy share, the flash-off and decode-kernel-off runs fed the
    kernel run's int8 activations, then the float16-KV call."""
    import torch

    t0 = time.perf_counter()
    with environ(CT2TPU_KV_CACHE="int8"):
        gen = make_generator(tt, mf, vocab, compute_type="int8")
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - t0
    prompts = [make_prompts(vocab, GEN_PROMPT, i) for i in range(2)]
    calls = 1  # one timed call: the AWQ path below takes the time of a second

    with environ(CT2TPU_KV_CACHE="int8"):
        generate_run(gen, prompts[0])  # warm-up
        logged_before = {name: sum(d.values()) for name, d in logs.items()}
        with kernel_shape_logs(logs):
            torch.cuda.reset_peak_memory_stats()
            tt.reset_launches()
            runs = [generate_run(gen, p) for p in prompts[1:1 + calls]]
            counts = tt.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_logs_cover(counts, logs, logged_before, "generator", checks)
        profile_call(lambda: generate_run(gen, prompts[1]), "generator_int8")
        layers = len(gen.model.arch.decoder.layers)
        recorded = []
        logp = generator_first_step_logprobs(gen, prompts[1],
                                             record_quantized(recorded))
        fed = {}
        for name, switch, kernel in (
                ("flash_off", "CT2TPU_FLASH", "flash_attention"),
                ("decode_kernel_off", "CT2TPU_DECODE_KERNEL", "decode_attention_int8")):
            replay = ReplayQuantized(recorded)
            # The decode kernel runs in the step only: the prefill before it
            # is the same run again and is left out of its reading.
            on_prefilled = replay.reset_stats if kernel == "decode_attention_int8" else None
            with environ(**{switch: "0"}):
                before = tt.launch_counts()[kernel]
                logp_fed = generator_first_step_logprobs(gen, prompts[1], replay,
                                                         on_prefilled)
                checks(tt.launch_counts()[kernel] == before,
                       f"generator: {switch}=0 launches no {kernel} kernel")
            fed[name] = check_fed(replay, len(recorded), logp_fed, logp, layers,
                                  f"generator int8, {name}", checks)
        del recorded, replay
    # The float16 KV cache: the same call without the int8-KV kernel.
    tt.reset_launches()
    f16_results, f16_seconds, f16_prefill = generate_run(gen, prompts[1])
    f16_counts = tt.launch_counts()

    results = [r for run in runs for r in run[0]]
    seconds = sum(run[1] for run in runs)
    prefill = sum(run[2] for run in runs)
    tokens = sum(len(r.sequences_ids[0]) for r in results)
    checks(all(len(r.sequences_ids[0]) == GEN_NEW for r in results + f16_results),
           f"generator: every hypothesis has {GEN_NEW} tokens")
    checks(all(math.isfinite(r.scores[0]) for r in results + f16_results)
           and bool(torch.isfinite(logp).all()),
           "generator: scores and log-probs are finite")
    checks(tuple(logp.shape) == (GEN_BATCH, LLAMA["vocab"]),
           "generator: first-step log-probs have the vocabulary's width")
    checks(f16_counts["decode_attention_int8"] == 0 and f16_counts["flash_attention"] > 0,
           "generator: the float16 KV cache runs flash and no int8-KV kernel")
    emit({"phase": "main_generator", "compute_type": gen.compute_type,
          "kv_cache": "int8", "model": dict(LLAMA, layers=layers),
          "load_seconds": load_seconds, "calls": calls, "prompts_per_call": GEN_BATCH,
          "prompt_tokens": GEN_PROMPT, "new_tokens_per_prompt": GEN_NEW,
          "target_tokens": tokens, "seconds": seconds,
          "target_tokens_per_s": tokens / seconds,
          "prefill_ms_per_call": prefill / calls * 1e3,
          "prefill_tokens_per_s": calls * GEN_BATCH * (GEN_PROMPT - 1) / prefill,
          "decode_ms_per_step": (seconds - prefill) / calls / GEN_NEW * 1e3,
          "launches": counts,
          "launches_per_call": {k: v / calls for k, v in counts.items()},
          "peak_memory_bytes": peak,
          "float16_kv_call": {"seconds": f16_seconds,
                              "prefill_ms": f16_prefill * 1e3,
                              "decode_ms_per_step":
                                  (f16_seconds - f16_prefill) / GEN_NEW * 1e3,
                              "launches": f16_counts},
          "fed_kernel_runs_int8_activations": fed,
          "fed_tolerances": {"max_step": 1, "worst_linear_share": FED_STEP_SHARE,
                             "first_step_logprob": LOGPROB_TOL}})
    return counts


def generator_ab(tt, mf, vocab, checks):
    """Same widths, 2 layers, no activation quantization: each attention
    kernel against the plain path it replaces, in float32 and in float16."""
    prompts = make_prompts(vocab, GEN_PROMPT, 7)
    arms = {  # environment of each arm
        "plain": dict(CT2TPU_FLASH="0"),
        "flash": {},
        "kv_plain": dict(CT2TPU_KV_CACHE="int8", CT2TPU_DECODE_KERNEL="0"),
        "kv_kernel": dict(CT2TPU_KV_CACHE="int8"),
    }
    pairs = {"flash": ("flash", "plain", "flash_attention"),
             "decode_kernel": ("kv_kernel", "kv_plain", "decode_attention_int8")}
    runs = {}
    for compute_type in ("float32", "float16"):
        gen = make_generator(tt, mf, vocab, compute_type=compute_type)
        for arm, env in arms.items():
            with environ(**env):
                tt.reset_launches()
                results = generate_run(gen, prompts, AB_NEW)[0]
                logp = generator_first_step_logprobs(gen, prompts)
                runs[compute_type, arm] = (results, logp, tt.launch_counts())
        del gen
    out = {"phase": "generator_ab", "layers": AB_LAYERS,
           "prompt_tokens": GEN_PROMPT, "own_error_factor": OWN_ERROR_FACTOR}
    for compute_type in ("float32", "float16"):
        for name, (on_arm, off_arm, kernel) in pairs.items():
            on, logp_on, counts_on = runs[compute_type, on_arm]
            off, logp_off, counts_off = runs[compute_type, off_arm]
            diff = (logp_on - logp_off).abs().max().item()
            same = same_prefix_rows(on, off, AB_NEW)
            entry = {"first_step_logprob_max_abs_diff": diff,
                     f"rows_with_same_first_{AB_NEW}_tokens": f"{same}/{GEN_BATCH}",
                     "launches_on": counts_on[kernel]}
            if compute_type == "float32":
                tol = LOGPROB_TOL
            else:
                # float16's own error on the plain path of this pair.
                own = (logp_off - runs["float32", off_arm][1]).abs().max().item()
                entry["float16_own_error"] = own
                tol = OWN_ERROR_FACTOR * own
            entry["tolerance"] = tol
            label = f"{compute_type} A/B, {name} kernel on/off"
            checks(counts_on[kernel] > 0 and counts_off[kernel] == 0,
                   f"{label}: the switch turns the kernel off "
                   f"({counts_on[kernel]} launches on, {counts_off[kernel]} off)")
            checks(diff <= tol,
                   f"{label}: first-step log-probs within {tol} (got {diff})")
            checks(same == GEN_BATCH,
                   f"{label}: the same first {AB_NEW} tokens on every row "
                   f"({same}/{GEN_BATCH})")
            out[f"{compute_type}_{name}"] = entry
    emit(out)


def generator_card_vs_cpu(tt, mf, vocab, checks):
    """The port on the card against the port on the CPU: 2 layers, same
    widths, float32, ``flash_attention=True`` so that the shorter prompts
    still take the (float32) flash kernel on the card; with the float KV
    cache and with the int8 one."""
    prompts = make_prompts(vocab, CPU_PROMPT, 9)
    card = make_generator(tt, mf, vocab, compute_type="float32", flash_attention=True)
    cpu = make_generator(tt, mf, vocab, device="cpu", compute_type="float32",
                         flash_attention=True)
    logp, counts = {}, {}
    t0 = time.perf_counter()
    for kv in ("", "int8"):
        with environ(CT2TPU_KV_CACHE=kv):
            tt.reset_launches()
            logp["card", kv] = generator_first_step_logprobs(card, prompts)
            counts[kv] = tt.launch_counts()
            logp["cpu", kv] = generator_first_step_logprobs(cpu, prompts)
    seconds = time.perf_counter() - t0
    norms = 2 * (2 * AB_LAYERS + 1)
    checks(counts[""]["flash_attention"] == AB_LAYERS
           and counts[""]["fused_norm"] == norms
           and counts["int8"]["decode_attention_int8"] == AB_LAYERS
           and counts["int8"]["flash_attention"] == AB_LAYERS,
           f"generator card vs CPU: the card ran the kernels ({counts})")
    diff = (logp["card", ""] - logp["cpu", ""]).abs().max().item()
    checks(diff <= LOGPROB_TOL,
           f"generator card vs CPU (float32, float KV, {AB_LAYERS} layers) "
           f"first-step log-probs within {LOGPROB_TOL} (got {diff})")
    diff8 = (logp["card", "int8"] - logp["cpu", "int8"]).abs().max().item()
    own8 = (logp["cpu", "int8"] - logp["cpu", ""]).abs().max().item()
    checks(diff8 <= INT8_KV_LOGPROB_TOL,
           f"generator card vs CPU (float32, int8 KV): first-step log-probs "
           f"within {INT8_KV_LOGPROB_TOL} (got {diff8})")
    emit({"phase": "generator_card_vs_cpu", "layers": AB_LAYERS,
          "compute_type": "float32", "prompt_tokens": CPU_PROMPT,
          "float_kv_first_step_logprob_max_abs_diff": diff, "tolerance": LOGPROB_TOL,
          "int8_kv_first_step_logprob_max_abs_diff": diff8,
          "int8_kv_own_error_cpu": own8,
          "int8_kv_tolerance": INT8_KV_LOGPROB_TOL,
          "card_launches": counts["int8"], "seconds": seconds})


# ---------------------------------------------------------------------------
# Generator on AWQ-W4 weights.
# ---------------------------------------------------------------------------

W4_PLAIN = ("matmul_w4a16_plain", "matmul_w4p_plain", "matmul_w4a16_fold_plain",
            "matmul_w4p_fold_plain")


@contextlib.contextmanager
def w4_plain_calls_on_card(counter):
    """Counts, in ``counter[0]``, the calls of the four W4 plain versions
    with CUDA activations; on the main path there must be none."""
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    def wrap(orig):
        def wrapped(x, *args):
            counter[0] += x.is_cuda
            return orig(x, *args)
        return wrapped

    with contextlib.ExitStack() as stack:
        for name in W4_PLAIN:
            stack.enter_context(patched(Q, name, wrap))
        yield counter


def generator_awq_main_path(tt, mf, vocab, checks, logs):
    """The Generator on the AWQ model at full width and depth: float16
    activations (the default for an AWQ model on the card), int8 KV cache,
    the packed W4 layout (the card's default). Timed calls with the launch
    counters zeroed before and read after, the profiler's busy share; then
    one call with ``CT2TPU_W4_PACKED=0`` (the unpacked layout)."""
    import torch

    prompts = [make_prompts(vocab, GEN_PROMPT, 20 + i) for i in range(3)]
    calls = 2
    on_card = [0]
    with environ(CT2TPU_KV_CACHE="int8"), w4_plain_calls_on_card(on_card):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = make_generator(tt, mf, vocab)
        torch.cuda.synchronize()
        load_seconds = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated()
        ffn = gen.model.params["decoder"]["layers"][0]["ffn"]["linear_0"]
        checks(gen.compute_type == "float16" and "w4p" in ffn,
               f"awq generator: float16 activations and packed W4 on the card "
               f"({gen.compute_type}, {sorted(ffn)})")
        generate_run(gen, prompts[0])  # warm-up
        logged_before = {name: sum(d.values()) for name, d in logs.items()}
        with kernel_shape_logs(logs):
            torch.cuda.reset_peak_memory_stats()
            tt.reset_launches()
            runs = [generate_run(gen, p) for p in prompts[1:1 + calls]]
            counts = tt.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_logs_cover(counts, logs, logged_before, "awq generator", checks)
        profile_call(lambda: generate_run(gen, prompts[1]), "generator_awq")
        del gen
        free_card()
        with environ(CT2TPU_W4_PACKED="0"):
            gen = make_generator(tt, mf, vocab)
            ffn = gen.model.params["decoder"]["layers"][0]["ffn"]["linear_0"]
            checks("w4" in ffn, f"CT2TPU_W4_PACKED=0 loads the unpacked layout ({sorted(ffn)})")
            logged_before = {name: sum(d.values()) for name, d in logs.items()}
            with kernel_shape_logs(logs):
                tt.reset_launches()
                unpacked = generate_run(gen, prompts[1])
                u_counts = tt.launch_counts()
            check_logs_cover(u_counts, logs, logged_before, "awq generator unpacked", checks)
        del gen
        free_card()

    expected = {k: v * calls for k, v in AWQ_LAUNCHES_PER_CALL.items() if k != "w4"}
    expected.update(matmul_w4p=AWQ_LAUNCHES_PER_CALL["w4"] * calls, matmul_w4a16=0)
    checks(all(counts[k] == v for k, v in expected.items()),
           f"awq generator: launches {counts}, expected {expected}")
    u_expected = {k: v for k, v in AWQ_LAUNCHES_PER_CALL.items() if k != "w4"}
    u_expected.update(matmul_w4a16=AWQ_LAUNCHES_PER_CALL["w4"], matmul_w4p=0)
    checks(all(u_counts[k] == v for k, v in u_expected.items()),
           f"awq generator unpacked: launches {u_counts}, expected {u_expected}")
    checks(on_card[0] == 0, f"awq generator: no W4 plain version ran on the card "
           f"({on_card[0]} calls)")
    results = [r for run in runs for r in run[0]] + unpacked[0]
    checks(all(len(r.sequences_ids[0]) == GEN_NEW for r in results),
           f"awq generator: every hypothesis has {GEN_NEW} tokens")
    checks(all(math.isfinite(r.scores[0]) for r in results),
           "awq generator: scores are finite")
    seconds = sum(run[1] for run in runs)
    prefill = sum(run[2] for run in runs)
    tokens = sum(len(r.sequences_ids[0]) for run in runs for r in run[0])
    emit({"phase": "main_generator_awq", "compute_type": "float16",
          "kv_cache": "int8", "w4_layout": "packed (w4p)",
          "model": dict(LLAMA, awq_group=AWQ_GROUP),
          "load_seconds": load_seconds, "load_peak_memory_bytes": load_peak,
          "calls": calls, "prompts_per_call": GEN_BATCH, "prompt_tokens": GEN_PROMPT,
          "new_tokens_per_prompt": GEN_NEW, "target_tokens": tokens,
          "seconds": seconds, "target_tokens_per_s": tokens / seconds,
          "prefill_ms_per_call": prefill / calls * 1e3,
          "prefill_tokens_per_s": calls * GEN_BATCH * (GEN_PROMPT - 1) / prefill,
          "decode_ms_per_step": (seconds - prefill) / calls / GEN_NEW * 1e3,
          "launches": counts, "launches_per_call": {k: v / calls for k, v in counts.items()},
          "peak_memory_bytes": peak,
          "unpacked_call": {"seconds": unpacked[1], "prefill_ms": unpacked[2] * 1e3,
                            "decode_ms_per_step": (unpacked[1] - unpacked[2]) / GEN_NEW * 1e3,
                            "note": "one call, no warm-up", "launches": u_counts}})
    return counts, u_counts


def w4_library(x, q, s, z, ref):
    """(name, fn) of one PyTorch call that computes ``x @ ((q - z) * s)``:
    ``torch._weight_int4pack_mm`` (bfloat16 activations, its own packed
    layout, ``w = (q - 8) * s + zero'``, so zero' = (8 - z) * s), checked
    against ``ref``; where that call is missing or refuses the shape,
    unpack + dequantize + ``torch.matmul``."""
    import torch
    from ctranslate2_tpu_torch.kernels.quant_matmul import _w4p_values

    K, N = q.shape
    G = K // s.shape[0]
    try:
        qt = q.t().contiguous().to(torch.int32)
        w = torch._convert_weight_to_int4pack((qt[:, ::2] << 4 | qt[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([s, (8 - z) * s], -1).to(torch.bfloat16).contiguous()
        xb = x.to(torch.bfloat16)
        y = torch._weight_int4pack_mm(xb, w, G, sz).float()
        rel = ((y - ref).norm() / ref.norm()).item()
        if rel < 2e-2:  # bfloat16 activations and scales
            return "torch._weight_int4pack_mm", lambda: torch._weight_int4pack_mm(xb, w, G, sz)
        emit({"library_disagrees": [x.shape[0], K, N], "relative_error": rel})
    except (AttributeError, RuntimeError, TypeError) as e:
        emit({"library_refused": [x.shape[0], K, N], "error": str(e)[:200]})
    w4p = (q[:K // 2] | (q[K // 2:] << 4)).view(torch.int8)
    s_rows, zs_rows = s.repeat_interleave(G, 0), (z * s).repeat_interleave(G, 0)
    return "unpack + dequantize + torch.matmul", lambda: torch.matmul(
        x, (_w4p_values(w4p) * s_rows - zs_rows).to(x.dtype))


def w4_other_plan(Q, args, packed):
    """The plan of the path ``w4_plan`` does not pick for these operands of
    ``matmul_w4p`` / ``matmul_w4a16`` (split-K below its M limit, the tile
    above)."""
    chosen = Q.w4_wrapper_plan(args[0], args[1], args[2], packed, False)
    saved = Q.W4_SPLITK_MAX_M
    Q.W4_SPLITK_MAX_M = 0 if chosen.path == "splitk" else 1 << 40
    try:
        other = Q.w4_wrapper_plan(args[0], args[1], args[2], packed, False)
    finally:
        Q.W4_SPLITK_MAX_M = saved
    return chosen, (other if other.path != chosen.path else None)


def bench_w4(shapes, checks):
    """The four W4 kernels at every main-path shape, against their plain
    versions within ``w4_error_bound``, with the plain version's time, the
    library call's and the bound. ``shapes`` holds the shape logs of
    ``matmul_w4p`` (packed calls) and ``matmul_w4a16`` (the unpacked call);
    the two folded forms are not on the path and run at their counterpart's
    shapes, their sums weighted by its launches. The two dispatched forms'
    lines also carry their plan (path, split count) and the time of the
    path the plan did not pick, held to the same bound: the crossover's
    evidence. Returns the sums."""
    import torch
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    kinds = {  # name: (packed, fold, the path's kernel at these shapes)
        "matmul_w4p": (True, False, "matmul_w4p"),
        "matmul_w4p_fold": (True, True, "matmul_w4p"),
        "matmul_w4a16": (False, False, "matmul_w4a16"),
        "matmul_w4a16_fold": (False, True, "matmul_w4a16"),
    }
    g = torch.Generator(device="cuda").manual_seed(6)
    G = AWQ_GROUP
    tots = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                       max_abs_err=0.0, libraries=set()) for name in kinds}
    for key in sorted(set(shapes["matmul_w4p"]) | set(shapes["matmul_w4a16"])):
        M, K, N, dt = key
        x = torch.randn((M, K), generator=g, device="cuda").to(getattr(torch, dt))
        q = torch.randint(0, 16, (K, N), generator=g, device="cuda", dtype=torch.uint8)
        s = torch.rand((K // G, N), generator=g, device="cuda") * 0.0025 + 0.005
        z = torch.randint(7, 9, (K // G, N), generator=g, device="cuda").float()
        operands = {True: (x, (q[:K // 2] | (q[K // 2:] << 4)).view(torch.int8), s, z * s),
                    False: (x, (q.to(torch.int16) - z.to(torch.int16).repeat_interleave(G, 0))
                            .to(torch.int8), s)}
        small = M * K * N < 2 ** 32
        iters, plain_iters = (50, 10) if small else (3, 2)
        library, lib_fn = w4_library(x, q, s, z, Q.matmul_w4a16_plain(*operands[False]))
        lib_ms = cuda_time_ms(lib_fn, iters)
        for name, (packed, fold, base) in kinds.items():
            n = shapes[base].get(key, 0)
            fn, plain = getattr(Q, name), getattr(Q, name + "_plain")
            args = operands[packed]
            zs = args[3] if packed else None
            out = fn(*args)
            ref = plain(*args)
            bound = Q.w4_error_bound(*args[:3], zs, fold)
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            err = diff.max().item()
            worst = (diff / bound).max().item()
            checks(bool((diff <= bound).all()),
                   f"{name} within its error bound of plain at {key} "
                   f"(max abs err {err}, worst share of the bound {worst})")
            plan, other = ((Q.w4_wrapper_plan(x, args[1], s, packed, True), None) if fold
                           else w4_other_plan(Q, args, packed))
            other_ms = None
            if other is not None:
                diff = (Q._w4_run(*args[:3], zs, packed, False, other) - ref).abs()
                checks(bool((diff <= bound).all()),
                       f"{name} {other.path} path within its error bound of plain at "
                       f"{key} (worst share of the bound {(diff / bound).max().item()})")
                other_ms = cuda_time_ms(
                    lambda: Q._w4_run(*args[:3], zs, packed, False, other), iters)
            del out, ref, diff, bound
            ms = cuda_time_ms(lambda: fn(*args), iters)
            plain_ms = cuda_time_ms(lambda: plain(*args), plain_iters)
            nbytes = ((K * N // 2 + 8 * (K // G) * N) if packed else (K * N + 4 * (K // G) * N)) \
                + M * K * x.element_size() + 4 * M * N
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            ops_ms = 2 * M * N * K / (PEAK_F32_FLOPS if dt == "float32" else PEAK_HALF_FLOPS) * 1e3
            emit({"phase": "kernel_w4", "kernel": name, "M": M, "K": K, "N": N, "dtype": dt,
                  "group": G, "launches": n if name == base else 0,
                  "weighted_by_launches_of": base, "weight": n,
                  "path": plan.path, "splits": plan.splits, "k_chunk": plan.k_chunk,
                  "other_path": None if other is None else other.path,
                  "other_path_splits": None if other is None else other.splits,
                  "other_path_ms": other_ms,
                  "max_abs_err": err, "worst_share_of_error_bound": worst,
                  "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "library": library, "bytes_moved": nbytes,
                  "tflops": 2 * M * N * K / ms / 1e9, "gbytes_per_s": nbytes / ms / 1e6,
                  "bound_ms": max(bytes_ms, ops_ms), "share_of_bound": max(bytes_ms, ops_ms) / ms,
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
            tot = tots[name]
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain_ms
            tot["library_ms"] += n * lib_ms
            tot["bytes_ms"] += n * bytes_ms
            tot["ops_ms"] += n * ops_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["libraries"].add(library)
        del x, q, operands
        free_card()
    for tot in tots.values():
        tot["libraries"] = sorted(tot["libraries"])
    return tots


def generator_awq_checks(tt, mf, vocab, checks):
    """2 layers of the AWQ model, packed and unpacked. The card in float32
    (the W4 kernels' FMA path) against the port on the CPU (their plain
    versions): first-step log-probs within ``LOGPROB_TOL``. Then the card in
    float16 (the ``mma`` path), the W4 kernel against its plain version
    patched in its place: first-step log-probs within ``OWN_ERROR_FACTOR``
    times float16's own error on the same path (its plain run against the
    float32 plain run), and the same first 8 tokens on every row."""
    import torch
    import ctranslate2_tpu_torch.ops.linear as L
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    out = {"phase": "generator_awq_checks", "layers": AB_LAYERS,
           "cpu_prompt_tokens": AWQ_CPU_PROMPT, "float16_prompt_tokens": GEN_PROMPT,
           "own_error_factor": OWN_ERROR_FACTOR}
    cpu_prompts = make_prompts(vocab, AWQ_CPU_PROMPT, 11)
    prompts = make_prompts(vocab, GEN_PROMPT, 12)
    for packed, kernel, other in (("1", "matmul_w4p", "matmul_w4a16"),
                                  ("0", "matmul_w4a16", "matmul_w4p")):
        plain = getattr(Q, kernel + "_plain")
        def as_plain():
            return patched(L, kernel, lambda orig: plain)

        with environ(CT2TPU_W4_PACKED=packed):
            card = make_generator(tt, mf, vocab, compute_type="float32", flash_attention=True)
            tt.reset_launches()
            logp_card = generator_first_step_logprobs(card, cpu_prompts)
            counts = tt.launch_counts()
            cpu = make_generator(tt, mf, vocab, device="cpu", compute_type="float32",
                                 flash_attention=True)
            logp_cpu = generator_first_step_logprobs(cpu, cpu_prompts)
            del cpu
            with as_plain():  # the float32 reference of float16's own error
                logp32 = generator_first_step_logprobs(card, prompts)
            del card
            free_card()
            gen = make_generator(tt, mf, vocab, compute_type="float16")
            runs = {}
            for arm in ("kernel", "plain"):
                with as_plain() if arm == "plain" else contextlib.nullcontext():
                    tt.reset_launches()
                    results = generate_run(gen, prompts, AB_NEW)[0]
                    logp = generator_first_step_logprobs(gen, prompts)
                    runs[arm] = (results, logp, tt.launch_counts()[kernel])
            del gen
            free_card()
        diff = (logp_card - logp_cpu).abs().max().item()
        label = f"awq card vs CPU (float32, {kernel}, {AB_LAYERS} layers)"
        checks(counts[kernel] == 2 * 5 * AB_LAYERS and counts[other] == 0,
               f"{label}: every W4 linear launched {kernel} ({counts})")
        checks(bool(torch.isfinite(logp_card).all()) and diff <= LOGPROB_TOL,
               f"{label}: first-step log-probs within {LOGPROB_TOL} (got {diff})")
        (k_res, k_logp, k_n), (p_res, p_logp, p_n) = runs["kernel"], runs["plain"]
        own = (p_logp - logp32).abs().max().item()
        diff16 = (k_logp - p_logp).abs().max().item()
        same = same_prefix_rows(k_res, p_res, AB_NEW)
        tol = OWN_ERROR_FACTOR * own
        label = f"awq float16, {kernel} against its plain version ({AB_LAYERS} layers)"
        checks(k_n > 0 and p_n == 0,
               f"{label}: the kernel run launched it, the plain run did not ({k_n}, {p_n})")
        checks(diff16 <= tol, f"{label}: first-step log-probs within {tol} (got {diff16})")
        checks(same == GEN_BATCH, f"{label}: the same first {AB_NEW} tokens on every row "
               f"({same}/{GEN_BATCH})")
        out[f"float32_card_vs_cpu_{kernel}"] = {
            "first_step_logprob_max_abs_diff": diff, "tolerance": LOGPROB_TOL,
            "launches": counts[kernel]}
        out[f"float16_kernel_vs_plain_{kernel}"] = {
            "first_step_logprob_max_abs_diff": diff16, "float16_own_error": own,
            "tolerance": tol, f"rows_with_same_first_{AB_NEW}_tokens": f"{same}/{GEN_BATCH}",
            "launches": k_n}
    emit(out)


def record_quantized(out):
    """A ``patched`` wrapper for ``quantize_per_row`` that appends every
    (q, scale) it returns to ``out``."""
    def wrap(orig):
        def wrapped(x, *args, **kwargs):
            q, scale = orig(x, *args, **kwargs)
            out.append((q, scale))
            return q, scale
        return wrapped
    return wrap


class ReplayQuantized:
    """A ``patched`` wrapper for ``quantize_per_row``: it quantizes as this
    run does, counts where that lands apart from the recorded run's int8
    activations for the same linear, and returns the recorded (q, scale),
    so that every W8A8 product gets the same int8 inputs in both runs (card
    and CPU, or a kernel and the plain path it replaces). A run that
    quantizes fewer or other activations than the recorded one leaves
    recorded pairs unused or raises."""

    def __init__(self, recorded):
        self.recorded = recorded
        self.calls = 0
        self.reset_stats()

    def reset_stats(self):
        self.entries = self.differing = self.max_step = self.calls_differing = 0
        self.worst_share = 0.0  # of one linear's entries

    def __call__(self, orig):
        def wrapped(x, *args, **kwargs):
            q, _ = orig(x, *args, **kwargs)
            q_rec, scale_rec = self.recorded[self.calls]
            self.calls += 1
            q_rec, scale_rec = q_rec.to(x.device), scale_rec.to(x.device)
            step = (q.int() - q_rec.int()).abs()
            differing = int((step > 0).sum().item())
            self.entries += step.numel()
            self.differing += differing
            self.calls_differing += differing > 0
            self.worst_share = max(self.worst_share, differing / step.numel())
            self.max_step = max(self.max_step, int(step.max().item()))
            return q_rec, scale_rec
        return wrapped


def check_fed(replay, recorded, logp_fed, logp, layers, label, checks):
    """A switch-off run fed the kernel run's int8 activations: every layer's
    attention then sees the kernel run's inputs, and its own output is read
    where the next linear (the output projection) quantizes it. No other
    linear's input can differ, the two attentions' outputs may round an
    entry at a half step one int8 step apart, and the log-probs agree."""
    diff = (logp_fed - logp).abs().max().item()
    checks(replay.calls == recorded > 0,
           f"{label}: the same {recorded} linears quantize (got {replay.calls})")
    checks(0 < replay.calls_differing <= layers,
           f"{label}: only the {layers} attention outputs differ "
           f"({replay.calls_differing} linears with differing inputs)")
    checks(replay.max_step <= 1 and replay.worst_share <= FED_STEP_SHARE,
           f"{label}: attention outputs at most one int8 step apart on at "
           f"most {FED_STEP_SHARE} of a linear's entries (max step "
           f"{replay.max_step}, worst share {replay.worst_share})")
    checks(diff <= LOGPROB_TOL,
           f"{label}: first-step log-probs within {LOGPROB_TOL} (got {diff})")
    return {"linears_with_differing_inputs": replay.calls_differing,
            "int8_max_step": replay.max_step,
            "worst_linear_share_differing": replay.worst_share,
            "entries": replay.entries, "entries_differing": replay.differing,
            "first_step_logprob_max_abs_diff": diff}


def first_step_logprobs(tr, sentences, quantize_wrap=None):
    """The first decode step's log-probs (float32, on the CPU); with
    ``quantize_wrap``, ``ops.linear.quantize_per_row`` is patched by it."""
    import torch
    import ctranslate2_tpu_torch.ops.linear as L
    from ctranslate2_tpu_torch.models import transformer as T

    m = tr.model
    ids, lengths = tr._pad_feature_ids(
        tr._ids_from_streams(tr._source_feature_streams(sentences), 1024))
    qa = m.policy.quantize_activations
    consts = m.ensure_consts(64)
    patch = (patched(L, "quantize_per_row", quantize_wrap) if quantize_wrap
             else contextlib.nullcontext())
    with torch.no_grad(), patch:
        mem = T.encoder_forward(m.arch, m.params, consts, ids, lengths,
                                quantize_acts=qa, out_dtype=m.out_dtype)
        mem_kv = T.precompute_memory(m.arch, m.params, mem, quantize_acts=qa)
        bias = T.attn_ops.length_mask_bias(lengths, mem.shape[1])
        cache = T.init_self_cache(m.arch, len(sentences), 64,
                                  dtype=m.kv_dtype, device=m.device)
        start = torch.full((len(sentences), 1), tr._decoder_start_id(),
                           dtype=torch.long, device=m.device)
        logits, _ = T.decoder_forward(m.arch, m.params, consts, start, 0,
                                      cache, mem_kv, bias, quantize_acts=qa,
                                      out_dtype=m.out_dtype)
    return torch.log_softmax(logits[:, -1].float(), -1).cpu()


def card_vs_cpu(tt, model_dir, batch, checks):
    """The port on the card against the port on the CPU, 4 sentences."""
    sentences = batch[:4]
    opts = dict(beam_size=BEAM, max_decoding_length=MAX_DEC)
    cpu_float32 = None
    for compute_type in ("float32", "int8_float32"):
        cpu = tt.Translator(model_dir, device="cpu", compute_type=compute_type)
        card = tt.Translator(model_dir, device="cuda", compute_type=compute_type)
        recorded = []
        logp_cpu = first_step_logprobs(cpu, sentences, record_quantized(recorded))
        logp_card = first_step_logprobs(card, sentences)
        hyps = [[r.hypotheses for r in tr.translate_batch(sentences, **opts)]
                for tr in (card, cpu)]
        diff = (logp_card - logp_cpu).abs().max().item()
        out = {"phase": "card_vs_cpu", "compute_type": compute_type,
               "sentences": len(sentences), "first_step_logprob_max_abs_diff": diff,
               "identical_hypotheses": f"{sum(a == b for a, b in zip(*hyps))}"
                                       f"/{len(sentences)}"}
        if not recorded:
            cpu_float32 = logp_cpu
            checks(diff <= LOGPROB_TOL, f"card vs CPU ({compute_type}) first-step "
                   f"log-probs within {LOGPROB_TOL} (got {diff})")
            out["tolerance"] = LOGPROB_TOL
            emit(out)
            continue
        # int8: the free run above is reported only; an activation at a
        # half-step tie parts the two runs by about int8's own error.
        replay = ReplayQuantized(recorded)
        logp_fed = first_step_logprobs(card, sentences, replay)
        fed_diff = (logp_fed - logp_cpu).abs().max().item()
        share = replay.differing / max(replay.entries, 1)
        checks(replay.calls == len(recorded) > 0,
               f"card vs CPU ({compute_type}): the same {len(recorded)} linears "
               f"quantize on the card (got {replay.calls})")
        checks(fed_diff <= LOGPROB_TOL,
               f"card vs CPU ({compute_type}) fed the CPU's int8 activations: "
               f"first-step log-probs within {LOGPROB_TOL} (got {fed_diff})")
        checks(replay.max_step <= 1 and share < QUANT_DIFF_SHARE,
               f"card vs CPU ({compute_type}): the card's own int8 activations are "
               f"at most one step from the CPU's on under {QUANT_DIFF_SHARE} of "
               f"the entries (max step {replay.max_step}, share {share})")
        out.update({
            "fed_cpu_int8_logprob_max_abs_diff": fed_diff, "tolerance": LOGPROB_TOL,
            "int8_linears": len(recorded), "int8_entries": replay.entries,
            "int8_entries_differing": replay.differing,
            "int8_max_step": replay.max_step,
            # int8's own error: the same int8 weights on the CPU with and
            # without quantizing activations.
            "int8_vs_float32_cpu_logprob_max_abs_diff":
                (logp_cpu - cpu_float32).abs().max().item()})
        emit(out)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import ctranslate2_tpu_torch as tt
    from ctranslate2_tpu_torch.converters.builder import build_seq2seq_model
    from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary, VocabularyInfo
    from ctranslate2_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = Checks()
    started = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    build_seconds = build.build(ptxas_report=PTXAS_REPORT)
    emit({"phase": "ptxas", "report": {
        name: ptxas_summary(build.PTXAS_LOG.get(name, "")) for name in PTXAS_REPORT}})
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi[0] if smi else None, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernels_built": list(build.KERNEL_SOURCES),
          "kernel_build_seconds": build_seconds})

    work = tempfile.mkdtemp(prefix="smoke_", dir=build.build_dir())
    try:
        t0 = time.perf_counter()
        int8_dir = build_seq2seq_model(os.path.join(work, "int8"), quantization="int8", **MODEL)
        float_dir = build_seq2seq_model(os.path.join(work, "float"), **MODEL)
        emit({"phase": "models", "config": MODEL, "seconds": time.perf_counter() - t0})

        # ---- main path 1: Translator ----
        logs = {}
        vocab = Vocabulary.load(int8_dir, "shared_vocabulary")
        batches = [make_batch(vocab, i) for i in range(1 + ITERS)]
        tr_counts = main_path(tt, int8_dir, "int8", batches, checks, "int8", logs)
        for name in ("matmul_w8a8", "gather_rows_fused", "fused_norm"):
            checks(tr_counts[name] > 0,
                   f"{name} launched on the Translator main path ({tr_counts[name]})")
        free_card()

        # ---- main path 2: Generator ----
        t0 = time.perf_counter()
        llama = build_llama_modelfile(LLAMA["layers"])
        llama_vocab = Vocabulary(
            ["<unk>", "<s>", "</s>"] + [f"t{i}" for i in range(LLAMA["vocab"] - 3)],
            VocabularyInfo(unk_token="<unk>", bos_token="<s>", eos_token="</s>"))
        emit({"phase": "llama_model", "config": LLAMA,
              "int8_weight_bytes": sum(v.array.nbytes for n, v in llama.variables.items()
                                       if n.endswith("/weight")),
              "seconds": time.perf_counter() - t0})
        gen_counts = generator_main_path(tt, llama, llama_vocab, checks, logs)
        for name in ("matmul_w8a8", "flash_attention", "decode_attention_int8",
                     "fused_norm"):
            checks(gen_counts[name] > 0,
                   f"{name} launched on the Generator main path ({gen_counts[name]})")
        small_llama = llama_subset(llama, AB_LAYERS)
        del llama
        free_card()

        # ---- main path 3: Generator on AWQ-W4 weights ----
        t0 = time.perf_counter()
        awq = build_awq_llama_modelfile(LLAMA["layers"])
        emit({"phase": "awq_model", "config": LLAMA, "group": AWQ_GROUP,
              "layout": "AutoAWQ GEMM (quantization_type 1)",
              "host_bytes": sum(v.array.nbytes for v in awq.variables.values()),
              "seconds": time.perf_counter() - t0})
        awq_logs = {}
        awq_counts, awq_unpacked_counts = generator_awq_main_path(
            tt, awq, llama_vocab, checks, awq_logs)
        for name in ("matmul_w4p", "flash_attention", "decode_attention_int8",
                     "fused_norm"):
            checks(awq_counts[name] > 0,
                   f"{name} launched on the AWQ Generator main path ({awq_counts[name]})")
        checks(awq_unpacked_counts["matmul_w4a16"] > 0,
               "matmul_w4a16 launched on the unpacked AWQ call "
               f"({awq_unpacked_counts['matmul_w4a16']})")
        small_awq = llama_subset(awq, AB_LAYERS)
        del awq
        free_card()

        # ---- every kernel against its plain version ----
        w8 = bench_w8a8(logs["matmul_w8a8"], checks)
        ga = bench_gather(logs["gather_rows_fused"], checks)
        fl = bench_flash(logs["flash_attention"], checks)
        free_card()
        de = bench_decode(logs["decode_attention_int8"], GEN_PROMPT - 1, GEN_NEW, checks)
        no = bench_norm(logs["fused_norm"], checks)
        feature_checks(checks)
        w4 = bench_w4(awq_logs, checks)
        free_card()

        # ---- the other Translator runs ----
        f16_counts = main_path(tt, float_dir, "float16", batches, checks, "float16", {})
        checks(f16_counts["matmul_w8a8"] == 0, "float16 runs no W8A8 launch")
        chain_float32(tt, float_dir, batches[1], checks)
        free_card()
        card_vs_cpu(tt, int8_dir, batches[1], checks)

        # ---- the other Generator runs ----
        generator_ab(tt, small_llama, llama_vocab, checks)
        free_card()
        generator_card_vs_cpu(tt, small_llama, llama_vocab, checks)
        free_card()
        generator_awq_checks(tt, small_awq, llama_vocab, checks)

        def entry(name, source, replaces, tot, library_ms, launches=None, **extra):
            """One kernel's line; ``launches`` defaults to the Translator and
            int8 Generator paths' counts, over which its times are summed."""
            bytes_ms, ops_ms = tot["bytes_ms"], tot.get("ops_ms", 0.0)
            if launches is None:
                launches = tr_counts[name] + gen_counts[name]
                extra = dict(launches_translator_path=tr_counts[name],
                             launches_generator_path=gen_counts[name],
                             launches_awq_generator_path_not_summed=awq_counts[name])
            return {"name": name, "route": "cuda",
                    "source": f"ctranslate2_tpu_torch/csrc/{source}",
                    "replaces": f"ctranslate2_tpu/kernels/{replaces}",
                    "launches": launches, "max_abs_err": tot["max_abs_err"],
                    "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": library_ms, "ms_summed_over": "launches", **extra}

        def w4_entry(name, replaces, launches, **extra):
            return entry(name, "w4_gemm.cu", replaces, w4[name], w4[name]["library_ms"],
                         launches, library=w4[name]["libraries"], **extra)

        kernels = [
            entry("matmul_w8a8", "w8a8_gemm.cu", "quant_matmul.py:238", w8,
                  w8["library_ms"]),
            entry("gather_rows_fused", "gather_rows.cu", "gather_rows.py:27", ga,
                  ga["plain_ms"]),
            entry("flash_attention", "flash_attention.cu", "flash_attention.py:185",
                  fl, fl["library_ms"]),
            entry("decode_attention_int8", "decode_attention_int8.cu",
                  "decode_attention.py:135", de, None),
            entry("fused_norm", "fused_norm.cu", "norms.py:37", no, no["library_ms"]),
            w4_entry("matmul_w4a16", "quant_matmul.py:77",
                     awq_unpacked_counts["matmul_w4a16"],
                     launches_awq_unpacked_call=awq_unpacked_counts["matmul_w4a16"]),
            w4_entry("matmul_w4p", "quant_matmul.py:333", awq_counts["matmul_w4p"],
                     launches_awq_generator_path=awq_counts["matmul_w4p"]),
            w4_entry("matmul_w4a16_fold", "quant_matmul.py:157", 0,
                     ms_summed_over="the launches of matmul_w4a16 at the same shapes "
                                    "(linear() never dispatches the folded form)"),
            w4_entry("matmul_w4p_fold", "quant_matmul.py:431", 0,
                     ms_summed_over="the launches of matmul_w4p at the same shapes "
                                    "(linear() never dispatches the folded form)"),
        ]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit({"phase": "done", "seconds": time.perf_counter() - started,
          "checks_failed": len(checks.failed)})
    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed: {checks.failed}",
              file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
