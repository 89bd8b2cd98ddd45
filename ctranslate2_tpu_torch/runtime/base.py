"""Shared task-API surface (read-only attributes of the reference's
pybind classes: python/cpp/{translator,generator,whisper,encoder,wav2vec2}.cc),
data-parallel replicas and model residency.

``device_index=[0, 1, ..]`` gives one model replica a listed device
(reference: replica_pool.h:19-300): worker ``i`` of the pool runs its jobs
on replica ``i % num_replicas``, which ``model`` and ``engine`` resolve to
in that worker's thread (replica 0 in any other thread). Replicas on one
device share one parameter tree; each has its own position tables, its
own decoding engine and, on a card, its own CUDA stream. Residency
(``unload_model`` / ``load_model``, the reference's replica pool detaching
and setting its model: replica_pool.h:110-116) covers every replica and
moves a shared tree once.

``tensor_parallel=True`` (``_load_model``) loads this rank's shard of the
model over the ``torch.distributed`` group (``parallel/sharding.py``; one
process a rank, the group initialised from the launcher's environment
where none is): a ``device_index`` list sizes the grid's data axis and
makes no replicas. Every rank runs every call, and the calls must reach
the ranks in one order, since each issues the model's collectives: one
worker thread a model (``inter_threads`` > 1 raises). A batch that the
data axis divides is split over it (``_split_over_data``). Every rank
returns the whole result.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.loader import replicate_model, resolve_devices
from ..models.transformer import make_consts
from ..utils.profiler import profile
from .batching import rebatch_input
from .pool import WorkerPool, current_worker_index, resolve_max_queued_batches
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
    whose weights live in the ``params`` (and, for a loaded model, the
    position tables in ``consts``) of each of ``self._residents()``."""

    def _resident(self):
        return self.model

    def _resident_device(self) -> torch.device:
        return self.model.device

    def _residents(self) -> list:
        """(holder, device) of each copy of the weights, replica 0 first."""
        return [(self._resident(), self._resident_device())]

    def _quiesce(self) -> None:
        """Waits for the device work that may still read the weights."""

    def _weights_loaded(self) -> None:
        """Called once the weights are back on their devices."""

    def _unload_extra(self, to_cpu: bool) -> None:
        """Frees the device tensors the class keeps besides the model's
        params: weights of its own, caches derived from the weights (none
        by default)."""

    def _load_extra(self) -> None:
        """Restores what ``_unload_extra(to_cpu=True)`` kept."""

    @property
    def model_is_loaded(self) -> bool:
        return getattr(self, "_unloaded_params", None) is None

    @property
    def num_replicas(self) -> int:
        return len(self._residents())

    @property
    def tensor_parallel(self) -> bool:
        return getattr(self, "_tensor_parallel", False)

    def unload_model(self, to_cpu: bool = False):
        """Frees the weights' memory on the device(s), keeping one host copy
        with ``to_cpu`` for a later ``load_model()``. As in the reference
        (replica_pool.h:110-116), a no-op while batches are being processed.
        The position tables and every cache derived from the weights go
        too, so the card keeps none of the model's memory."""
        if not self.model_is_loaded or self.num_active_batches > 0:
            return
        self._quiesce()
        residents = self._residents()
        self._unloaded_params = (move_tree(residents[0][0].params, "cpu")
                                 if to_cpu else True)
        self._unloaded_positions = []
        for holder, _ in residents:
            holder.params = None
            consts = getattr(holder, "consts", None)
            self._unloaded_positions.append(
                None if consts is None else consts.get("max_positions", 0))
            if consts is not None:
                holder.consts = {}
        self._unload_extra(to_cpu)

    def load_model(self):
        """Moves the weights kept by ``unload_model(to_cpu=True)`` back to
        each replica's device, once a device; raises when no host copy was
        kept."""
        if self.model_is_loaded:
            return
        if self._unloaded_params is True:
            raise RuntimeError("Model was unloaded without keeping a host copy")
        moved = {}
        for (holder, device), positions in zip(self._residents(),
                                               self._unloaded_positions):
            if device not in moved:
                moved[device] = move_tree(self._unloaded_params, device)
            holder.params = moved[device]
            if positions is not None:
                holder.consts = make_consts(holder.arch, holder.params,
                                            positions, device)
        self._load_extra()
        self._weights_loaded()
        self._unloaded_params = None


class TaskAPIMixin(ModelResidency):
    """Mixin for classes owning ``self.model`` (LoadedModel), optionally
    ``self.engine``, and ``self._pool`` (WorkerPool), with data-parallel
    replicas (``_init_replicas``)."""

    _replicas = None  # [(model, engine)] when there are two or more
    _replica_streams = None  # one CUDA stream a replica, on a card

    def _replica_index(self) -> int:
        """The replica of the calling thread: its worker's, else 0."""
        if not self._replicas:
            return 0
        i = current_worker_index()
        return 0 if i is None else i % len(self._replicas)

    @property
    def model(self):
        if self._replicas:
            return self._replicas[self._replica_index()][0]
        return self._model

    @model.setter
    def model(self, value):
        self._model = value

    @property
    def engine(self):
        if self._replicas:
            return self._replicas[self._replica_index()][1]
        return getattr(self, "_engine", None)

    @engine.setter
    def engine(self, value):
        self._engine = value

    def _load_model(self, model_path, compute_type, device, device_index,
                    kwargs):
        """The model at ``model_path`` on ``device``/``device_index``, or
        with ``tensor_parallel=True`` this rank's shard of it on the rank's
        card (its node-local rank modulo the visible cards) or the CPU."""
        from ..models.loader import load_model, resolve_device

        self._tensor_parallel = bool(kwargs.get("tensor_parallel", False))
        grid = None
        if self._tensor_parallel:
            from ..parallel.sharding import setup_tensor_parallel

            grid = setup_tensor_parallel(device or "cuda", device_index)
            dev = grid.device
        else:
            dev = resolve_device(device, device_index)
        return load_model(model_path, compute_type=compute_type,
                          files=kwargs.get("files"), device=dev, grid=grid)

    def _all_models(self) -> list:
        if self._replicas:
            return [m for m, _ in self._replicas]
        return [self._model]

    def _residents(self) -> list:
        return [(m, m.device) for m in self._all_models()]

    def _init_replicas(self, device, device_index, engine_factory=None) -> None:
        """One (model, engine) replica a device of ``device_index`` when it
        lists two or more (reference: one replica a device,
        replica_pool.h:19-300). Replica 0 is the model already loaded on
        the first device; the others are ``replicate_model`` copies, each
        with an engine from ``engine_factory``. On a card every replica
        gets a CUDA stream of its own, which first waits for the work that
        made the weights. Under tensor parallelism the list sized the data
        axis instead: no replicas."""
        if self.tensor_parallel:
            return
        devices = resolve_devices(device, device_index)
        if len(devices) < 2:
            return
        replicas = [(self._model, getattr(self, "_engine", None))]
        for dev in devices[1:]:
            m = replicate_model(self._model, dev)
            replicas.append((m, engine_factory(m) if engine_factory else None))
        self._replicas = replicas
        if devices[0].type == "cuda":
            self._replica_streams = [torch.cuda.Stream(d) for d in devices]
            self._weights_loaded()

    def _start_pool(self, inter_threads: int, max_queued_batches: int,
                    kwargs) -> None:
        """``inter_threads`` workers a replica (reference: pool size =
        devices x inter_threads, replica_pool.h:19-300); worker ``i`` runs
        on replica ``i % num_replicas``'s device and stream."""
        models = self._all_models()
        if self.tensor_parallel and inter_threads > 1:
            raise ValueError(
                "tensor_parallel=True runs one worker thread (inter_threads=1): "
                "every rank must issue the model's collectives in one order")
        self._pool = WorkerPool(
            num_workers=max(1, inter_threads) * len(models),
            max_queued_batches=resolve_max_queued_batches(kwargs,
                                                          max_queued_batches),
            device=[m.device for m in models], streams=self._replica_streams)

    def _quiesce(self) -> None:
        for stream in self._replica_streams or ():
            stream.synchronize()

    def _weights_loaded(self) -> None:
        # The replicas' streams read weights and position tables that the
        # loading thread's stream wrote.
        for stream in self._replica_streams or ():
            stream.wait_stream(torch.cuda.current_stream(stream.device))

    def _apply_flash_flag(self, kwargs) -> None:
        """Honor the reference's ``flash_attention`` constructor flag.

        The reference opts INTO FA2 with it (python/cpp/translator.cc:295);
        here the flash kernel is dispatched automatically above a length
        threshold, so True removes the threshold FOR THIS MODEL and False
        keeps automatic dispatch."""
        if kwargs.get("flash_attention"):
            self.model.arch = dataclasses.replace(
                self.model.arch, flash_min_len=0)

    def _split_over_data(self, rows: list, run, split: bool = True) -> list:
        """``run(rows)``: one result a row, in order. Under tensor
        parallelism with a data axis that divides ``rows`` (and ``split``),
        data rank d runs the d-th contiguous share of them, so that its KV
        cache holds those rows only, and the shares' results are gathered
        over the axis: every rank returns them all. A share that raises
        raises on every rank. Pass ``split=False`` where the rows depend on
        one another (draws taken over the whole batch, a per-step
        callback that sees every row)."""
        grid = getattr(self.model, "grid", None)
        n = grid.num_data if grid is not None and split else 1
        if n == 1 or len(rows) % n:
            return run(rows)
        from ..parallel.context import batch_on_data_axis

        share, d = len(rows) // n, grid.data.rank
        try:
            with batch_on_data_axis():
                mine, error = run(rows[d * share:(d + 1) * share]), None
        except Exception as e:  # noqa: BLE001 - raised on every rank below
            mine, error = None, e
        parts = grid.data.all_gather_objects(
            (mine, None if error is None else f"{type(error).__name__}: {error}"))
        if error is not None:
            raise error
        for i, (_, text) in enumerate(parts):
            if text is not None:
                raise RuntimeError(f"data rank {i} failed: {text}")
        return [r for part, _ in parts for r in part]

    def _run_batches(self, results, compute_idx, lengths, max_batch_size,
                     batch_type, run, asynchronous, scope, split: bool = True):
        """Runs ``run(rows)`` on the worker pool for the rows ``compute_idx``
        of a call (``lengths`` theirs), rebatched longest first and each
        batch split over a tensor-parallel data axis (``_split_over_data``,
        with ``split``); ``run`` returns one result a row, in order, in a
        profiler scope named ``scope``. ``results`` holds one entry a row
        of the call, those outside ``compute_idx`` done already. Returns
        ``results`` filled, or one AsyncResult a row when ``asynchronous``."""
        def job(rows):
            with profile(scope):
                return self._split_over_data(rows, run, split)

        async_results = [None if r is None else AsyncResult(r) for r in results]
        futures = []
        for batch in rebatch_input(lengths, max_batch_size, batch_type):
            rows = [compute_idx[j] for j in batch]
            future = self._pool.submit(job, rows)
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
