"""Data, sequence and tensor parallelism for training (counterpart of
osu_dreamer_tpu/parallel/): one rank a device over ``torch.distributed``."""

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
