"""Tensor parallelism over ``torch.distributed`` (``sharding``), ring
attention over the data axis (``context``), the collectives both use
(``comm``) and a local launcher of N ranks (``launch``). Port of
``ctranslate2_tpu/parallel/``."""

from .sharding import (Grid, apply_tensor_parallel, device_info, head_layout,
                       initialize_distributed, make_grid, shard_params)

__all__ = ["Grid", "apply_tensor_parallel", "device_info", "head_layout",
           "initialize_distributed", "make_grid", "shard_params"]
