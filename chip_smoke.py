#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ctranslate2_tpu_torch``) on one card.

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON object per line:

1. card: the card's name and power limit, the torch/CUDA versions, and the
   seconds to build both CUDA kernels from ``ctranslate2_tpu_torch/csrc``.
2. main path: the full-width Transformer-base model (6+6 layers, d_model
   512, ffn 2048, 8 heads, 32,000 words; random weights from seed 7),
   ``Translator(..., compute_type="int8").translate_batch`` on batches of
   64 sentences of 20-30 tokens, beam 2, exactly 32 target tokens; then one
   call with ``CT2TPU_BEAM_CHAIN=0`` (the fused-gather beam reorder). The
   launch counters are zeroed just before and read just after; each
   kernel must have launched, and the shapes it was called with are
   logged over the same calls.
3. kernels: each kernel at every shape the main path gave it, against its
   plain PyTorch version on the same inputs (W8A8 must be bit-equal; the
   gather must be equal), with its time, the plain version's, the library
   call's (``torch._int_mm`` + epilogue; ``index_select``) and the bound.
4. float16: the same translation run on a float model with
   ``compute_type="float16"`` (W8A8 is not on that path; the gather is).
   In both runs the chain-off hypotheses must match the chain run's (see
   ``CHAIN_SAME_SHARE``); a float32 chain/chain-off pair on the same batch
   must match on every sentence.
5. card against CPU, 4 sentences, first decode step's log-probs: float32
   within ``LOGPROB_TOL``. ``int8_float32`` is run twice on the card: once
   free, reported only, and once fed the CPU's int8 activations at every
   linear, which must then agree within the float32 tolerance; the card's
   own quantization of each linear's input must land at most one int8
   step from the CPU's, on under ``QUANT_DIFF_SHARE`` of the entries.

The line before the last is ``{"kernels": [...]}`` (times are sums over
the ``launches`` counted on the main path), the last
``{"ok": true, "device": {...}}``. The script exits non-zero, without
those lines, if CUDA is unavailable, any call raises or any check fails.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
BATCH = 64
BEAM = 2
MAX_DEC = 32
ITERS = 3
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
MODEL = dict(vocab_size=32000, num_layers=6, num_heads=8, d_model=512,
             d_ff=2048, seed=7)


def emit(obj):
    print(json.dumps(obj), flush=True)


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
        def wrapped(*args):
            k = key(*args)
            counts[k] = counts.get(k, 0) + 1
            return orig(*args)
        return wrapped
    return wrap


def cuda_time_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up.

    The calls are captured in a CUDA graph and the graph is timed with CUDA
    events: timing eager calls would measure the host's launch rate, which
    for kernels of tens of microseconds is slower than the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def profile_call(translator, batch, label):
    """One translate_batch call under torch.profiler: the device's busy
    time (sum of kernel times) against the call's wall time, and the
    kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        translator.translate_batch(batch, **OPTS)
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
          "top_device_ms": [[name[:60], ms, n] for ms, n, name in rows[:8]]})


def main_path(tt, model_dir, compute_type, batches, checks, label):
    """Timed chain-on calls plus one chain-off call, with the launch
    counters zeroed before and read after, and each kernel's call shapes
    logged over the same calls."""
    import torch
    import ctranslate2_tpu_torch.models.transformer as T
    import ctranslate2_tpu_torch.ops.linear as L

    translator = tt.Translator(model_dir, compute_type=compute_type)
    translator.translate_batch(batches[0], **OPTS)  # warm-up, both paths
    with chain_off():
        translator.translate_batch(batches[0], **OPTS)

    w8_shapes, gather_shapes = {}, {}
    w8_key = lambda q, wq, a, w: (q.shape[0], q.shape[1], wq.shape[0])  # noqa: E731
    gather_key = lambda arrays, rows: (  # noqa: E731
        tuple((tuple(a.shape), str(a.dtype)) for a in arrays), rows.shape[0])
    with patched(L, "matmul_w8a8", shape_log(w8_shapes, w8_key)), \
            patched(T, "gather_rows_fused", shape_log(gather_shapes, gather_key)):
        torch.cuda.reset_peak_memory_stats()
        tt.reset_launches()
        results, seconds, tokens = translate_run(translator, batches[1:1 + ITERS])
        chain_counts = tt.launch_counts()
        with chain_off():
            off, off_seconds, _ = translate_run(translator, batches[1:2])
        counts = tt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    profile_call(translator, batches[1], label)

    cmp = compare_chain(results[0], off[0])
    lengths_ok = all(len(r.hypotheses[0]) == MAX_DEC for res in results for r in res)
    checks(lengths_ok, f"{label}: every hypothesis has {MAX_DEC} tokens")
    checks(counts["gather_rows_fused"] > chain_counts["gather_rows_fused"],
           f"{label}: the chain-off call launched the gather kernel")
    checks(sum(w8_shapes.values()) == counts["matmul_w8a8"]
           and sum(gather_shapes.values()) == counts["gather_rows_fused"],
           f"{label}: the shape logs cover every counted launch")
    check_chain(cmp, label, checks)
    emit({"phase": f"main_{label}", "compute_type": translator.compute_type,
          "calls": ITERS, "sentences_per_call": BATCH, "beam": BEAM,
          "target_tokens": tokens, "seconds": seconds,
          "target_tokens_per_s": tokens / seconds,
          "chain_off_call_seconds": off_seconds,
          "launches_chain_calls": chain_counts,
          "launches_total": counts,
          "w8a8_launches_per_call": chain_counts["matmul_w8a8"] / ITERS,
          "gather_launches_chain_off_call": counts["gather_rows_fused"]
          - chain_counts["gather_rows_fused"],
          "chain_off_vs_chain": cmp,
          "peak_memory_bytes": peak})
    return counts, w8_shapes, gather_shapes


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


def bench_w8a8(shapes, checks):
    """Kernel vs plain vs library at each (M, K, N), weighted by its
    launches on the main path; returns the sums over those launches."""
    import torch
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
        out = matmul_w8a8(q, wq, a_s, w_s)
        ref = matmul_w8a8_plain(q, wq, a_s, w_s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)
        checks(torch.equal(out, ref), f"w8a8 bit-equal to plain at {(M, K, N)}")
        iters = 50 if M * N * K < 2**32 else 10
        ms = cuda_time_ms(lambda: matmul_w8a8(q, wq, a_s, w_s), iters)
        plain_ms = cuda_time_ms(lambda: matmul_w8a8_plain(q, wq, a_s, w_s), iters)
        try:
            wt = wq.t()
            lib_ms = cuda_time_ms(
                lambda: torch._int_mm(q, wt).float() / (a_s[:, None] * w_s[None, :]),
                iters)
        except RuntimeError as e:  # torch._int_mm refuses some shapes
            lib_ms, library_ok = None, False
            emit({"library_refused": [M, K, N], "error": str(e)[:200]})
        bytes_ms = (M * K + N * K + 4 * M * N + 4 * M + 4 * N) / PEAK_BYTES * 1e3
        ops_ms = 2 * M * N * K / PEAK_INT8_OPS * 1e3
        emit({"phase": "kernel_w8a8", "M": M, "K": K, "N": N,
              "launches": n, "max_abs_err": err, "kernel_ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": max(bytes_ms, ops_ms),
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
    """A ``patched`` wrapper for ``quantize_per_row`` on the card: it
    quantizes as the card does, counts where that lands apart from the
    CPU's int8 activations for the same linear, and returns the CPU's
    (q, scale), so that every W8A8 product gets the same int8 inputs on
    both devices. A card path that quantizes fewer or other activations
    than the CPU's leaves recorded pairs unused or raises."""

    def __init__(self, recorded):
        self.recorded = recorded
        self.calls = self.entries = self.differing = self.max_step = 0

    def __call__(self, orig):
        def wrapped(x, *args, **kwargs):
            q, _ = orig(x, *args, **kwargs)
            q_cpu, scale_cpu = self.recorded[self.calls]
            self.calls += 1
            step = (q.cpu().int() - q_cpu.int()).abs()
            self.entries += step.numel()
            self.differing += int((step > 0).sum().item())
            self.max_step = max(self.max_step, int(step.max().item()))
            return q_cpu.to(x.device), scale_cpu.to(x.device)
        return wrapped


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
    from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary
    from ctranslate2_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = Checks()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    build_seconds = build.build()
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi[0] if smi else None, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_build_seconds": build_seconds})

    work = tempfile.mkdtemp(prefix="smoke_", dir=build.build_dir())
    try:
        t0 = time.perf_counter()
        int8_dir = build_seq2seq_model(os.path.join(work, "int8"), quantization="int8", **MODEL)
        float_dir = build_seq2seq_model(os.path.join(work, "float"), **MODEL)
        emit({"phase": "models", "config": MODEL, "seconds": time.perf_counter() - t0})

        vocab = Vocabulary.load(int8_dir, "shared_vocabulary")
        batches = [make_batch(vocab, i) for i in range(1 + ITERS)]
        counts, w8_shapes, gather_shapes = main_path(
            tt, int8_dir, "int8", batches, checks, "int8")
        for name, n in counts.items():
            checks(n > 0, f"{name} launched on the main path ({n})")
        torch.cuda.empty_cache()

        w8 = bench_w8a8(w8_shapes, checks)
        ga = bench_gather(gather_shapes, checks)

        f16_counts, _, _ = main_path(
            tt, float_dir, "float16", batches, checks, "float16")
        checks(f16_counts["matmul_w8a8"] == 0, "float16 runs no W8A8 launch")
        chain_float32(tt, float_dir, batches[1], checks)
        torch.cuda.empty_cache()

        card_vs_cpu(tt, int8_dir, batches[1], checks)

        kernels = [
            {"name": "matmul_w8a8", "route": "cuda",
             "source": "ctranslate2_tpu_torch/csrc/w8a8_gemm.cu",
             "replaces": "ctranslate2_tpu/kernels/quant_matmul.py:238",
             "launches": counts["matmul_w8a8"], "max_abs_err": w8["max_abs_err"],
             "ms": w8["ms"], "plain_ms": w8["plain_ms"],
             "bound_ms": max(w8["bytes_ms"], w8["ops_ms"]),
             "bound_by": "bytes" if w8["bytes_ms"] >= w8["ops_ms"] else "operations",
             "library_ms": w8["library_ms"], "ms_summed_over": "launches"},
            {"name": "gather_rows_fused", "route": "cuda",
             "source": "ctranslate2_tpu_torch/csrc/gather_rows.cu",
             "replaces": "ctranslate2_tpu/kernels/gather_rows.py:27",
             "launches": counts["gather_rows_fused"], "max_abs_err": ga["max_abs_err"],
             "ms": ga["ms"], "plain_ms": ga["plain_ms"], "bound_ms": ga["bytes_ms"],
             "bound_by": "bytes", "library_ms": ga["plain_ms"],
             "ms_summed_over": "launches"},
        ]
    finally:
        shutil.rmtree(work, ignore_errors=True)

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
