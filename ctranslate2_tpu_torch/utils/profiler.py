"""Scope profiler (parity with reference: src/profiler.cc:36-164).

``profile("name")`` scopes accumulate wall time into a global table with a
thread-local parent chain; ``dump_profiling`` prints the self / cumulative
/ % table sorted by self time. A scope that ran while a CUDA card is in use
waits for the card's work at its start and at its end
(``torch.cuda.synchronize()``, as the reference synchronizes its CUDA
stream), so device time lands in the scope that queued it, not in the next
one to wait for the card (a collective that copies its input to the host). ``trace(log_dir)`` records a ``torch.profiler`` trace of
the host and the card and writes it as a Chrome trace.

The port's scopes: ``Translator.translate_batch`` / ``score_batch`` and
``Generator.generate_batch`` / ``score_batch``, one a batch a worker runs.
"""

from __future__ import annotations

import io
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Optional, TextIO

import torch

_enabled = False
_lock = threading.Lock()
_totals = defaultdict(lambda: [0.0, 0.0, 0])  # name -> [self, cumulative, count]
_tls = threading.local()
_global_start: Optional[float] = None


def init_profiling(num_threads: int = 1) -> None:
    """Starts an empty table (``num_threads`` is accepted for parity)."""
    global _enabled, _global_start
    with _lock:
        _totals.clear()
    _enabled = True
    _global_start = time.perf_counter()


def profiling_enabled() -> bool:
    return _enabled


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def profile(name: str):
    if not _enabled:
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    _synchronize()
    start = time.perf_counter()
    child_time_box = [0.0]
    stack.append(child_time_box)
    try:
        yield
    finally:
        _synchronize()
        elapsed = time.perf_counter() - start
        stack.pop()
        self_time = elapsed - child_time_box[0]
        if stack:
            stack[-1][0] += elapsed
        with _lock:
            entry = _totals[name]
            entry[0] += self_time
            entry[1] += elapsed
            entry[2] += 1


def profiling_totals() -> dict:
    """{scope: (self seconds, cumulative seconds, calls)} so far."""
    with _lock:
        return {name: tuple(v) for name, v in _totals.items()}


def dump_profiling(output: Optional[TextIO] = None) -> str:
    """Stops profiling and returns the table (also written to ``output``)."""
    global _enabled
    _enabled = False
    total_time = (time.perf_counter() - _global_start) if _global_start else 0.0

    buf = io.StringIO()
    with _lock:
        rows = sorted(_totals.items(), key=lambda kv: -kv[1][0])
        accounted = sum(v[0] for _, v in _totals.items()) or 1e-9
        buf.write(f"{'scope':<40} {'calls':>8} {'self(ms)':>10} "
                  f"{'cum(ms)':>10} {'%':>6}\n")
        for name, (self_t, cum_t, count) in rows:
            buf.write(f"{name:<40} {count:>8} {self_t * 1e3:>10.2f} "
                      f"{cum_t * 1e3:>10.2f} {100 * self_t / accounted:>5.1f}%\n")
        if total_time:
            buf.write(f"(wall time: {total_time * 1e3:.2f} ms)\n")
    text = buf.getvalue()
    if output is not None:
        output.write(text)
    return text


@contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host, and the card where
    one is in use), written to ``log_dir/trace.json`` in the Chrome trace
    format (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
