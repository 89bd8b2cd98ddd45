#!/usr/bin/env python3
"""Times this checkout's W8A8, flash-attention, int8-KV decode-attention,
AWQ-W4 (``matmul_w4p``, ``matmul_w4a16`` and their folded forms) and norm
kernels against another checkout's, on one card, in turns.

    python3 kernel_ab.py OTHER_TREE [SMOKE_LOG] [--w4 | --w4-prefill | --norm | --e2e]

OTHER_TREE is an unpacked ``git archive`` of an earlier commit (its
``ctranslate2_tpu_torch`` is imported from there and builds its kernels
into its own ``_build``). The shapes and their launches are read from the
``kernel_w8a8``, ``kernel_flash``, ``kernel_decode`` and ``kernel_w4`` lines
of a ``chip_smoke.py`` log when one is given (those with main-path
launches; a folded W4 form's weighted by its counterpart's launches at the
same shape, as the log does), else the Generator's main-path shapes at
Llama-3-8B's widths (M = 4 and 8,192; the AWQ path's two packed calls and
one unpacked call, the folded forms at their counterparts' shapes; the int8
Generator's 2,048 decode launches) are taken. ``--w4`` keeps only the W4
shapes, ``--w4-prefill`` only those above 64 rows (the AWQ prefill).
``--norm`` times only the norm alone (``fused_norm`` without a residual or
quantization, the one form both trees have) at every (rows, width, type,
LayerNorm) of the log's summed ``kernel_norm`` lines, whatever their form,
with their launches (else ``DEFAULT_NORM``). ``--e2e`` times instead the
two int8 main paths end to end, where the host's launch rate bounds them:
``chip_smoke.py``'s Translator (Transformer-base, 3 calls of 64 sentences,
beam 2, 32 tokens: ``translator_int8`` is their seconds) and its int8
Generator at Llama-3-8B's widths cut to ``E2E_LAYERS`` layers (int8 KV
cache, 2 calls of 4 prompts of 2,049 tokens and 64 new ones:
``generator_int8_decode_step`` and ``generator_int8_prefill``, ms). Each
tree runs in a worker process, in the order other, this, this, other; each
worker builds the sources of the kernels it times, times every shape in a
CUDA graph (this checkout's ``chip_smoke.cuda_time_ms`` for both trees) and
prints one JSON line a shape. The last line gives, per tree, the least of its two runs at each
shape and the sums over the launches.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_W8A8 = {(4, 4096, 6144): 2048, (4, 4096, 4096): 2048, (4, 4096, 14336): 4096,
                (4, 14336, 4096): 2048, (4, 4096, 128256): 64,
                (8192, 4096, 6144): 32, (8192, 4096, 4096): 32,
                (8192, 4096, 14336): 64, (8192, 14336, 4096): 32}
DEFAULT_FLASH = {((4, 32, 2048, 128), 8, 2048, "float16", True, False, 0): 32}
DEFAULT_DECODE = {((4, 32, 1, 128), 8, 2176, "float16", True, 0, (2048, 2069, 2090, 2111)):
                  2048}
W4_KN_LAUNCHES = {(4096, 6144): 1, (4096, 4096): 1, (4096, 14336): 2, (14336, 4096): 1}
DEFAULT_W4 = {(name, M, K, N, "float16"): per * calls * (32 * 64 if M == 4 else 32)
              for name, calls in (("matmul_w4p", 2), ("matmul_w4a16", 1),
                                  ("matmul_w4p_fold", 2), ("matmul_w4a16_fold", 1))
              for M in (4, 8192) for (K, N), per in W4_KN_LAUNCHES.items()}
# (rows, D, dtype, LayerNorm): launches (the int8 Generator's and the
# Translator's, float16 on the card).
DEFAULT_NORM = {(8192, 4096, "float16", False): 65, (4, 4096, "float16", False): 4160,
                (128, 512, "float16", True): 2432, (2048, 512, "float16", True): 52}
AWQ_GROUP = 128
E2E_LAYERS = 8


def shapes_from_log(path):
    w8a8, flash, decode, w4, norm = {}, {}, {}, {}, {}
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            if row.get("phase") == "kernel_w8a8":
                w8a8[(row["M"], row["K"], row["N"])] = row["launches"]
            elif row.get("phase") == "kernel_flash" and row["launches"]:
                key = (tuple(row["q"]), row["kv"][1], row["kv"][2], row["dtype"],
                       row["causal"], row["lengths"], row["window"])
                flash[key] = row["launches"]
            elif row.get("phase") == "kernel_decode" and row["launches"]:
                key = (tuple(row["q"]), row["cache"][1], row["cache"][2], row["dtype"],
                       row["fresh"], row["window"], tuple(row["lengths"]))
                decode[key] = row["launches"]
            elif row.get("phase") == "kernel_w4" and row["weight"]:
                w4[(row["kernel"], row["M"], row["K"], row["N"], row["dtype"])] = row["weight"]
            elif row.get("phase") == "kernel_norm" and row.get("summed", True):
                key = (row["rows"], row["D"], row["dtype"], row["layer_norm"])
                norm[key] = norm.get(key, 0) + row["launches"]
    return w8a8, flash, decode, w4, norm


def worker(tree, spec):
    sys.path.insert(0, tree)
    sys.path.insert(1, HERE)
    import torch
    from ctranslate2_tpu_torch.kernels import build
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q
    from ctranslate2_tpu_torch.kernels.decode_attention import (
        decode_attention_int8, quantize_kv)
    from ctranslate2_tpu_torch.kernels.flash_attention import flash_attention
    from ctranslate2_tpu_torch.kernels.quant_matmul import matmul_w8a8

    # Both trees are timed by this checkout's harness.
    smoke = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(smoke)
    smoke.loader.exec_module(here)
    cuda_time_ms = here.cuda_time_ms
    assert os.path.dirname(os.path.dirname(build.__file__)).startswith(tree)
    if spec["e2e"]:
        build.build()
        e2e(here)
        return
    build.build([source for source, key in (
        ("w8a8_gemm", "w8a8"), ("flash_attention", "flash"),
        ("decode_attention_int8", "decode"), ("w4_gemm", "w4"),
        ("fused_norm", "norm")) if spec[key]])
    g = torch.Generator(device="cuda").manual_seed(0)
    for (M, K, N), n in spec["w8a8"]:
        q = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
        a_s = torch.rand(M, generator=g, device="cuda") + 0.5
        w_s = torch.rand(N, generator=g, device="cuda") + 0.5
        ms = cuda_time_ms(lambda: matmul_w8a8(q, wq, a_s, w_s),
                          50 if M * N * K < 2**32 else 10)
        print(json.dumps({"kernel": "matmul_w8a8", "shape": [M, K, N], "launches": n,
                          "ms": ms}), flush=True)
        del q, wq
    for (qs, hkv, tk, dt, causal, has_lengths, window), n in spec["flash"]:
        B, Hq, Tq, D = qs
        dtype = getattr(torch, dt)
        q = torch.randn((B, Hq, Tq, D), generator=g, device="cuda").to(dtype)
        k = torch.randn((B, hkv, tk, D), generator=g, device="cuda").to(dtype)
        v = torch.randn((B, hkv, tk, D), generator=g, device="cuda").to(dtype)
        lengths = (torch.full((B,), tk, dtype=torch.int32, device="cuda")
                   if has_lengths else None)
        ms = cuda_time_ms(lambda: flash_attention(
            q, k, v, scale=D ** -0.5, causal=causal, lengths=lengths, window=window), 5)
        print(json.dumps({"kernel": "flash_attention",
                          "shape": [list(qs), hkv, tk, dt, causal, has_lengths, window],
                          "launches": n, "ms": ms}), flush=True)
        del q, k, v
    for (qs, hkv, C, dt, fresh, window, lengths), n in spec["decode"]:
        B, Hq, _, D = qs

        def t(*shape):
            return torch.randn(shape, generator=g, device="cuda")

        k8, ks = quantize_kv(t(B, hkv, C, D))
        v8, vs = quantize_kv(t(B, hkv, C, D))
        kw = dict(scale=D ** -0.5, window=window)
        if fresh:
            kw["k_new8"], kw["kn_scale"] = quantize_kv(t(B, hkv, 1, D))
            kw["v_new8"], kw["vn_scale"] = quantize_kv(t(B, hkv, 1, D))
        args = (t(B, Hq, 1, D).to(getattr(torch, dt)), k8, ks, v8, vs,
                torch.tensor(lengths, dtype=torch.int32, device="cuda"))
        ms = cuda_time_ms(lambda: decode_attention_int8(*args, **kw), 50)
        print(json.dumps({"kernel": "decode_attention_int8",
                          "shape": [list(qs), hkv, C, dt, fresh, window, list(lengths)],
                          "launches": n, "ms": ms}), flush=True)
        del k8, v8, args
    G = AWQ_GROUP
    for (name, M, K, N, dt), n in spec["w4"]:
        x = torch.randn((M, K), generator=g, device="cuda").to(getattr(torch, dt))
        q = torch.randint(0, 16, (K, N), generator=g, device="cuda", dtype=torch.uint8)
        s = torch.rand((K // G, N), generator=g, device="cuda") * 0.0025 + 0.005
        z = torch.randint(7, 9, (K // G, N), generator=g, device="cuda").float()
        if name.startswith("matmul_w4p"):
            args = (x, (q[:K // 2] | (q[K // 2:] << 4)).view(torch.int8), s, z * s)
        else:
            args = (x, (q.to(torch.int16) - z.to(torch.int16).repeat_interleave(G, 0))
                    .to(torch.int8), s)
        fn = getattr(Q, name)
        ms = cuda_time_ms(lambda: fn(*args), 50 if M * N * K < 2**32 else 3)
        print(json.dumps({"kernel": name, "shape": [M, K, N, dt], "launches": n,
                          "ms": ms}), flush=True)
        del x, q, args
        torch.cuda.empty_cache()
    for (rows, D, dt, layer_norm), n in spec["norm"]:
        from ctranslate2_tpu_torch.kernels.norms import fused_norm

        x = (torch.randn((rows, D), generator=g, device="cuda") * 2 + 0.5).to(getattr(torch, dt))
        gamma = torch.randn(D, generator=g, device="cuda")
        beta = torch.randn(D, generator=g, device="cuda") if layer_norm else None
        ms = cuda_time_ms(lambda: fused_norm(x, gamma, beta, eps=1e-5),
                          100 if rows * D < 2**22 else 20)
        print(json.dumps({"kernel": "fused_norm", "shape": [rows, D, dt, layer_norm],
                          "launches": n, "ms": ms}), flush=True)
        del x


def e2e(smoke):
    """The tree's int8 Translator and Generator main paths, timed with
    ``chip_smoke.py``'s helpers (from this checkout) on the tree's package."""
    import tempfile

    import ctranslate2_tpu_torch as tt
    from ctranslate2_tpu_torch.converters.builder import build_seq2seq_model
    from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary, VocabularyInfo
    from ctranslate2_tpu_torch.kernels import build

    def row(name, ms, **extra):
        print(json.dumps({"kernel": name, "shape": [], "launches": 1, "ms": ms, **extra}),
              flush=True)

    with tempfile.TemporaryDirectory(dir=build.build_dir()) as work:
        path = build_seq2seq_model(os.path.join(work, "int8"), quantization="int8",
                                   **smoke.MODEL)
        vocab = Vocabulary.load(path, "shared_vocabulary")
        batches = [smoke.make_batch(vocab, i) for i in range(1 + smoke.ITERS)]
        translator = tt.Translator(path, compute_type="int8")
        translator.translate_batch(batches[0], **smoke.OPTS)
        _, seconds, tokens = smoke.translate_run(translator, batches[1:])
        row("translator_int8", seconds * 1e3, tokens_per_s=tokens / seconds)
        del translator
    llama = smoke.build_llama_modelfile(E2E_LAYERS)
    vocab = Vocabulary(
        ["<unk>", "<s>", "</s>"] + [f"t{i}" for i in range(smoke.LLAMA["vocab"] - 3)],
        VocabularyInfo(unk_token="<unk>", bos_token="<s>", eos_token="</s>"))
    with smoke.environ(CT2TPU_KV_CACHE="int8"):
        gen = smoke.make_generator(tt, llama, vocab, compute_type="int8")
        prompts = [smoke.make_prompts(vocab, smoke.GEN_PROMPT, i) for i in range(3)]
        smoke.generate_run(gen, prompts[0])  # warm-up
        steps, prefills = [], []
        for p in prompts[1:]:
            _, seconds, prefill = smoke.generate_run(gen, p)
            steps.append((seconds - prefill) / smoke.GEN_NEW * 1e3)
            prefills.append(prefill * 1e3)
    row("generator_int8_decode_step", min(steps), runs=steps, layers=E2E_LAYERS)
    row("generator_int8_prefill", min(prefills), runs=prefills, layers=E2E_LAYERS)


def main():
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], json.loads(sys.argv[3]))
        return 0
    args = [a for a in sys.argv[1:] if a not in ("--w4", "--w4-prefill", "--norm", "--e2e")]
    other = os.path.abspath(args[0])
    w8a8, flash, decode, w4, norm = (
        shapes_from_log(args[1]) if len(args) > 1
        else (DEFAULT_W8A8, DEFAULT_FLASH, DEFAULT_DECODE, DEFAULT_W4, DEFAULT_NORM))
    if "--norm" in sys.argv or "--e2e" in sys.argv:
        w8a8, flash, decode, w4 = {}, {}, {}, {}
    if "--norm" not in sys.argv:
        norm = {}
    if "--w4" in sys.argv or "--w4-prefill" in sys.argv:
        w8a8, flash, decode = {}, {}, {}
    if "--w4-prefill" in sys.argv:
        w4 = {k: v for k, v in w4.items() if k[1] > 64}
    spec = json.dumps({"w8a8": sorted(w8a8.items()), "flash": sorted(flash.items()),
                       "decode": sorted(decode.items()), "w4": sorted(w4.items()),
                       "norm": sorted(norm.items()), "e2e": "--e2e" in sys.argv})
    best = {}
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        proc = subprocess.run([sys.executable, __file__, "--worker", tree, spec],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode:
            print(proc.stdout, proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            row = json.loads(line)
            print(json.dumps(dict(row, tree=label)), flush=True)
            key = (label, row["kernel"], json.dumps(row["shape"]))
            best[key] = min(best.get(key, float("inf")), row["ms"])
    sums = {}
    for (label, kernel, shape), ms in best.items():
        n = dict(matmul_w8a8=dict((json.dumps(list(k)), v) for k, v in w8a8.items()),
                 flash_attention=dict((json.dumps([list(k[0]), *k[1:]]), v)
                                      for k, v in flash.items()),
                 decode_attention_int8=dict(
                     (json.dumps([list(k[0]), *k[1:-1], list(k[-1])]), v)
                     for k, v in decode.items()),
                 fused_norm=dict((json.dumps(list(k)), v) for k, v in norm.items()))
        for k, v in w4.items():
            n.setdefault(k[0], {})[json.dumps(list(k[1:]))] = v
        launches = n.get(kernel, {}).get(shape)
        if launches is None:  # an end-to-end row: its best is in per_shape_ms
            continue
        sums.setdefault(label, {}).setdefault(kernel, 0.0)
        sums[label][kernel] += launches * ms
    print(json.dumps({"kernel_ab": {"other": other, "sums_ms": sums,
                                    "per_shape_ms": {f"{k[0]} {k[1]} {k[2]}": v
                                                     for k, v in sorted(best.items())}}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
