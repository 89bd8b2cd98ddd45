"""Shared task-API surface for a model on one device (read-only
attributes of the reference's pybind classes:
python/cpp/{translator,generator,whisper,encoder,wav2vec2}.cc).
Tensor parallelism and data-parallel replicas are not ported yet."""

from __future__ import annotations

import dataclasses

from .batching import rebatch_input
from .results import AsyncResult


class TaskAPIMixin:
    """Mixin for classes owning ``self.model`` (LoadedModel) and
    ``self._pool`` (WorkerPool)."""

    def _apply_flash_flag(self, kwargs) -> None:
        """Honor the reference's ``flash_attention`` constructor flag.

        The reference opts INTO FA2 with it (python/cpp/translator.cc:295);
        here the flash kernel is dispatched automatically above a length
        threshold, so True removes the threshold FOR THIS MODEL and False
        keeps automatic dispatch."""
        if kwargs.get("flash_attention"):
            self.model.arch = dataclasses.replace(
                self.model.arch, flash_min_len=0)

    def _run_batches(self, results, compute_idx, lengths, max_batch_size,
                     batch_type, run, asynchronous):
        """Runs ``run(rows)`` on the worker pool for the rows ``compute_idx``
        of a call (``lengths`` theirs), rebatched longest first; ``run``
        returns one result a row, in order. ``results`` holds one entry a
        row of the call, those outside ``compute_idx`` done already.
        Returns ``results`` filled, or one AsyncResult a row when
        ``asynchronous``."""
        async_results = [None if r is None else AsyncResult(r) for r in results]
        futures = []
        for batch in rebatch_input(lengths, max_batch_size, batch_type):
            rows = [compute_idx[j] for j in batch]
            future = self._pool.submit(run, rows)
            futures.append((rows, future))
            for pos, i in enumerate(rows):
                async_results[i] = AsyncResult(future, pos)
        if asynchronous:
            return async_results
        for rows, future in futures:
            for i, out in zip(rows, future.result()):
                results[i] = out
        return results

    @property
    def compute_type(self) -> str:
        """Resolved compute type (e.g. ``int8_float16`` on the card)."""
        p = self.model.policy
        if p.weight_dtype == "int8":
            return "int8_" + p.activation_dtype
        return p.weight_dtype

    @property
    def device(self) -> str:
        return self.model.device.type

    @property
    def num_workers(self) -> int:
        return self._pool.num_workers

    @property
    def num_queued_batches(self) -> int:
        return self._pool.num_queued_batches

    @property
    def num_active_batches(self) -> int:
        return self._pool.num_active_batches
