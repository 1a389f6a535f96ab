"""Data and sequence parallelism for training (counterpart of
osu_dreamer_tpu/parallel/): one rank a device over ``torch.distributed``.
Tensor parallelism (the JAX ``tp.py``) is not ported: ``parallel.tp > 1``
raises."""

from .config import ParallelArgs, Parallelism, build_parallelism
from .distributed import init_multihost, input_shard, launch
from .mesh import auto_data_parallel, rank_grid

__all__ = [
    "ParallelArgs",
    "Parallelism",
    "auto_data_parallel",
    "build_parallelism",
    "init_multihost",
    "input_shard",
    "launch",
    "rank_grid",
]
