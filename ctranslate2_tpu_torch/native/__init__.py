"""The native host core (``ct2tpu_host.cpp``), built on first use.

Exposes, from the compiled CPython extension:

- ``Vocabulary``: token <-> id hashing;
- ``RequestQueue``: the bounded MPMC queue with timeout batch collection
  behind ``ServingScheduler``;
- ``rebatch``: length-sorted descending batching (``std::stable_sort``);
- ``parse_model_index``: the model.bin header as a variable index (names,
  dtype ids, shapes, payload offsets and sizes) for zero-copy loading.

``g++ -O3 -std=c++17 -shared -fPIC`` compiles the source into the
kernels' build directory (``_build/`` inside the package unless
``CT2TPU_TORCH_BUILD_DIR`` names another), under a name that carries a
hash of the source and of the command line, the first time one of these
names is read; nothing is built when this module is imported. The
extension is loaded from that file under its package-qualified name,
``ctranslate2_tpu_torch.native.ct2tpu_host``, never by searching
``sys.path``. A failed build raises with the compiler's output: there is
no Python fallback.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from types import ModuleType

from ..kernels.build import build_dir

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ct2tpu_host.cpp")
MODULE_NAME = __name__ + ".ct2tpu_host"
EXPORTS = ("Vocabulary", "RequestQueue", "rebatch", "parse_model_index")

_module = None
_lock = threading.Lock()


def _command(out: str) -> list:
    return ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            "-I" + sysconfig.get_path("include"), SOURCE, "-o", out]


def module_path() -> str:
    """The extension's file in the build directory (built or not)."""
    digest = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update("\0".join(_command("")).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(build_dir(), f"ct2tpu_host-{digest.hexdigest()[:12]}{suffix}")


def build() -> str:
    """Compiles the extension unless its file exists; returns its path.
    Each process and thread compiles into a name of its own and renames it
    into place, so concurrent builds never see a partial file."""
    out = module_path()
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the native host core failed (g++ exited "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ModuleType:
    """The loaded extension, built first if needed."""
    global _module
    with _lock:
        if _module is None:
            path = build()
            loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, path)
            spec = importlib.util.spec_from_file_location(MODULE_NAME, path,
                                                          loader=loader)
            module = importlib.util.module_from_spec(spec)
            loader.exec_module(module)
            sys.modules[MODULE_NAME] = module
            _module = module
        return _module


def __getattr__(name: str):
    if name in EXPORTS:
        return getattr(load(), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
