"""Shared task-API surface for a model on one device (read-only
attributes of the reference's pybind classes:
python/cpp/{translator,generator,whisper,encoder,wav2vec2}.cc).
Tensor parallelism and data-parallel replicas are not ported yet."""

from __future__ import annotations


class TaskAPIMixin:
    """Mixin for classes owning ``self.model`` (LoadedModel) and
    ``self._pool`` (WorkerPool)."""

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
