"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``lib<name>-<hash>.so`` (the hash covers the source, every
shared header ``csrc/*.cuh`` and the full nvcc command line, so an edited
source or header is rebuilt), then loaded with ``ctypes``. The
build directory is ``_build/`` inside the package unless
``CT2TPU_TORCH_BUILD_DIR`` names another. Nothing is built or imported
when this module is imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
KERNEL_SOURCES = ("w8a8_gemm", "gather_rows", "flash_attention",
                  "decode_attention_int8", "fused_norm", "w4_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# ptxas's report (registers, shared memory, spills) of each source built
# with ``ptxas_report`` naming it.
PTXAS_LOG: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> str:
    return (os.environ.get("CT2TPU_TORCH_BUILD_DIR")
            or os.path.join(PACKAGE_DIR, "_build"))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found: the CUDA kernels are built from "
        f"{CSRC_DIR} on first use (set NVCC or put nvcc on PATH)")


def _command(name: str, out: str) -> list:
    return [*NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, name + ".cu")]


def library_path(name: str) -> str:
    digest = hashlib.sha1()
    paths = [os.path.join(CSRC_DIR, name + ".cu")]
    paths += sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in paths:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update("\0".join(_command(name, "")).encode())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES,
          ptxas_report: Sequence[str] = ()) -> float:
    """Compile every missing library, one nvcc per source, all started
    together. Returns the wall seconds spent; raises with the compiler's
    output if a build fails. Sources named in ``ptxas_report`` are compiled
    with ``-Xptxas -v`` (which changes no code) and their report is kept in
    ``PTXAS_LOG``."""
    start = time.perf_counter()
    os.makedirs(build_dir(), exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *_command(name, tmp)]
        if name in ptxas_report:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if name in ptxas_report:
            PTXAS_LOG[name] = log
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
