"""Data and spatial parallelism over ``torch.distributed`` (counterpart of :mod:`ssds_tpu.parallel`)."""

from ssds_tpu_torch.parallel.sharding import (
    allgather_pickled,
    all_reduce_mean,
    data_parallel_size,
    initialize_distributed,
    is_main,
    rank,
    rank_device,
    spatial_size,
    world_size,
)

__all__ = ["allgather_pickled", "all_reduce_mean", "data_parallel_size",
           "initialize_distributed", "is_main", "rank", "rank_device", "spatial_size",
           "world_size"]
