"""Data parallelism over ranks (twin of ``freqfusion_tpu/parallel``)."""

from .mesh import (Mesh, active, all_gather, all_reduce_mean, all_reduce_sum,  # noqa: F401
                   global_batch_mean, make_mesh, replicate, run_ranks, shard_batch)
