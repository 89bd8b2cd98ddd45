"""Shared task-API surface for a model on one device (read-only
attributes of the reference's pybind classes:
python/cpp/{translator,generator,whisper,encoder,wav2vec2}.cc) and model
residency (``unload_model`` / ``load_model``, the reference's replica pool
detaching and setting its model: replica_pool.h:110-116). Tensor
parallelism and data-parallel replicas are not ported yet: one replica,
never sharded."""

from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import make_consts
from .batching import rebatch_input
from .results import AsyncResult


def move_tree(tree, device):
    """``tree`` (nested dicts, lists and tuples of tensors) with every tensor
    on ``device``. Each storage moves once, whole, and every tensor keeps
    its offset, shape and strides in it: leaves that shared memory share it
    again, and moving back restores the layout the model was built with."""
    device = torch.device(device)
    storages = {}

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(move(v) for v in node)
        if not torch.is_tensor(node) or node.device == device:
            return node
        src = node.untyped_storage()
        key = (src.data_ptr(), src.nbytes())
        if key not in storages:
            whole = torch.empty(0, dtype=torch.uint8, device=node.device).set_(
                src, 0, (src.nbytes(),), (1,))
            storages[key] = whole.to(device).untyped_storage()
        return torch.empty(0, dtype=node.dtype, device=device).set_(
            storages[key], node.storage_offset(), node.shape, node.stride())

    return move(tree)


class ModelResidency:
    """``model_is_loaded``, ``unload_model`` and ``load_model`` for a class
    whose weights live in ``self._resident()``'s ``params`` (and, for a
    loaded model, its position tables in ``consts``), on ``device``."""

    def _resident(self):
        return self.model

    def _resident_device(self) -> torch.device:
        return self.model.device

    def _unload_extra(self, to_cpu: bool) -> None:
        """Frees the device tensors the class keeps besides the model's
        params: weights of its own, caches derived from the weights (none
        by default)."""

    def _load_extra(self, device) -> None:
        """Restores what ``_unload_extra(to_cpu=True)`` kept."""

    @property
    def model_is_loaded(self) -> bool:
        return getattr(self, "_unloaded_params", None) is None

    @property
    def num_replicas(self) -> int:
        return 1

    @property
    def tensor_parallel(self) -> bool:
        return False

    def unload_model(self, to_cpu: bool = False):
        """Frees the weights' memory on the device, keeping a host copy with
        ``to_cpu`` for a later ``load_model()``. As in the reference
        (replica_pool.h:110-116), a no-op while batches are being processed.
        The position tables and every cache derived from the weights go
        too, so the card keeps none of the model's memory."""
        if not self.model_is_loaded or self.num_active_batches > 0:
            return
        holder = self._resident()
        self._unloaded_params = (move_tree(holder.params, "cpu") if to_cpu
                                 else True)
        holder.params = None
        consts = getattr(holder, "consts", None)
        if consts is not None:
            self._unloaded_positions = consts.get("max_positions", 0)
            holder.consts = {}
        self._unload_extra(to_cpu)

    def load_model(self):
        """Moves the weights kept by ``unload_model(to_cpu=True)`` back to
        the model's device; raises when no host copy was kept."""
        if self.model_is_loaded:
            return
        if self._unloaded_params is True:
            raise RuntimeError("Model was unloaded without keeping a host copy")
        holder = self._resident()
        device = self._resident_device()
        holder.params = move_tree(self._unloaded_params, device)
        if hasattr(holder, "consts"):
            holder.consts = make_consts(holder.arch, holder.params,
                                        self._unloaded_positions, device)
        self._load_extra(device)
        self._unloaded_params = None


class TaskAPIMixin(ModelResidency):
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
