#!/usr/bin/env python3
"""Times this checkout's W8A8 and flash-attention kernels against another
checkout's, on one card, in turns.

    python3 kernel_ab.py OTHER_TREE [SMOKE_LOG]

OTHER_TREE is an unpacked ``git archive`` of an earlier commit (its
``ctranslate2_tpu_torch`` is imported from there and builds its kernels
into its own ``_build``). The shapes and their launches are read from the
``kernel_w8a8`` and ``kernel_flash`` lines of a ``chip_smoke.py`` log when
one is given, else the Generator's main-path shapes at Llama-3-8B's widths
(M = 4 and 8,192) are taken. Each tree runs in a worker process, in the order
other, this, this, other; each worker builds both sources, times every
shape in a CUDA graph (``chip_smoke.cuda_time_ms``) and prints one JSON
line a shape. The last line gives, per tree, the least of its two runs at
each shape and the sums over the launches.
"""

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


def shapes_from_log(path):
    w8a8, flash = {}, {}
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            if row.get("phase") == "kernel_w8a8":
                w8a8[(row["M"], row["K"], row["N"])] = row["launches"]
            elif row.get("phase") == "kernel_flash":
                key = (tuple(row["q"]), row["kv"][1], row["kv"][2], row["dtype"],
                       row["causal"], row["lengths"], row["window"])
                flash[key] = row["launches"]
    return w8a8, flash


def worker(tree, spec):
    sys.path.insert(0, tree)
    sys.path.insert(1, HERE)
    import torch
    from chip_smoke import cuda_time_ms
    from ctranslate2_tpu_torch.kernels import build
    from ctranslate2_tpu_torch.kernels.flash_attention import flash_attention
    from ctranslate2_tpu_torch.kernels.quant_matmul import matmul_w8a8

    assert os.path.dirname(os.path.dirname(build.__file__)).startswith(tree)
    build.build(["w8a8_gemm", "flash_attention"])
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


def main():
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], json.loads(sys.argv[3]))
        return 0
    other = os.path.abspath(sys.argv[1])
    w8a8, flash = (shapes_from_log(sys.argv[2]) if len(sys.argv) > 2
                   else (DEFAULT_W8A8, DEFAULT_FLASH))
    spec = json.dumps({"w8a8": sorted(w8a8.items()), "flash": sorted(flash.items())})
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
        n = dict(w8a8=dict((json.dumps(list(k)), v) for k, v in w8a8.items()),
                 flash=dict((json.dumps([list(k[0]), *k[1:]]), v) for k, v in flash.items()))
        launches = n["w8a8" if kernel == "matmul_w8a8" else "flash"][shape]
        sums.setdefault(label, {}).setdefault(kernel, 0.0)
        sums[label][kernel] += launches * ms
    print(json.dumps({"kernel_ab": {"other": other, "sums_ms": sums,
                                    "per_shape_ms": {f"{k[0]} {k[1]} {k[2]}": v
                                                     for k, v in sorted(best.items())}}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
