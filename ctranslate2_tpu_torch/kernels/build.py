"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``lib<name>-<hash>.so`` (the hash covers the source, every
shared header ``csrc/*.cuh`` and the full nvcc command lines, so an edited
source or header is rebuilt), then loaded with ``ctypes``. The decode
source is compiled as ``KERNEL_UNITS`` units at once (each with
``-DCT2_UNIT=<i>``, which it requires: a q dtype's template instances) and
linked into the one library. The build directory is ``_build/`` inside the package unless
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
# The sources whose build is the longest, split into units compiled in
# parallel: the decode source, one unit a q dtype.
KERNEL_UNITS = {"decode_attention_int8": 3}

# ptxas's report (registers, shared memory, spills) of each source built
# with ``ptxas_report`` naming it.
PTXAS_LOG: Dict[str, str] = {}
# The seconds from the start of the last ``build`` until each source it
# built was done (its units compiled and linked).
BUILD_SECONDS: Dict[str, float] = {}

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


def _command(name: str, out: str, unit=None) -> list:
    source = os.path.join(CSRC_DIR, name + ".cu")
    if unit is None:
        return [*NVCC_FLAGS, "-o", out, source]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return [*flags, "-c", f"-DCT2_UNIT={unit}", "-o", out, source]


def _commands(name: str, out: str) -> list:
    """The nvcc command lines that build ``name`` into ``out``: one, or one
    a unit and the link."""
    units = KERNEL_UNITS.get(name)
    if not units:
        return [_command(name, out)]
    objects = [f"{out}.{i}.o" for i in range(units)]
    return ([_command(name, obj, i) for i, obj in enumerate(objects)]
            + [["-shared", *objects, "-o", out]])


def library_path(name: str) -> str:
    digest = hashlib.sha1()
    paths = [os.path.join(CSRC_DIR, name + ".cu")]
    paths += sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in paths:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update("\0".join(x for cmd in _commands(name, "") for x in cmd).encode())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES,
          ptxas_report: Sequence[str] = ()) -> float:
    """Compile every missing library, one nvcc a source (a unit), all
    started together. Returns the wall seconds spent; raises with the
    compiler's output if a build fails. Sources named in ``ptxas_report``
    are compiled with ``-Xptxas -v`` (which changes no code) and their
    report is kept in ``PTXAS_LOG``."""
    start = time.perf_counter()
    os.makedirs(build_dir(), exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        commands = _commands(name, tmp)
        compiles, link = ((commands[:-1], commands[-1]) if KERNEL_UNITS.get(name)
                          else (commands, None))
        procs = []
        for i, cmd in enumerate(compiles):
            cmd = [_nvcc(), *cmd]
            if name in ptxas_report:
                cmd[1:1] = ["-Xptxas", "-v"]
            log = open(f"{tmp}.{i}.log", "w+")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                           text=True), log))
        jobs.append([name, out, tmp, procs, link])
    failures = []
    while jobs:
        for job in [j for j in jobs if all(p.poll() is not None for p, _ in j[3])]:
            jobs.remove(job)
            name, out, tmp, procs, link = job
            logs = []
            for proc, log in procs:
                log.seek(0)
                logs.append(log.read())
                log.close()
                os.remove(log.name)
            bad = [(p.returncode, text) for (p, _), text in zip(procs, logs)
                   if p.returncode != 0]
            if link is not None:
                if not bad:
                    linked = subprocess.run([_nvcc(), *link], capture_output=True,
                                            text=True)
                    if linked.returncode != 0:
                        bad = [(linked.returncode, linked.stdout + linked.stderr)]
                for obj in link[1:-2]:  # the units' objects
                    if os.path.exists(obj):
                        os.remove(obj)
            if bad:
                failures.append(f"{name}: nvcc exited {bad[0][0]}\n"
                                + "\n".join(text for _, text in bad))
                continue
            if name in ptxas_report:
                PTXAS_LOG[name] = "".join(logs)
            os.replace(tmp, out)
            BUILD_SECONDS[name] = time.perf_counter() - start
        if jobs:
            time.sleep(0.1)
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
