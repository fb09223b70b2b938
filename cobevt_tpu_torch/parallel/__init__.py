"""Multi-process training and serving: the rendezvous, the data-parallel
helpers and the ("data", "model") mesh.

Counterpart of ``cobevt_tpu/parallel/``.  ``distributed.py`` holds the
rendezvous (here ``torch.distributed``) with the data-parallel helpers that
stand in for the JAX package's sharded step (the gradient reduction, the
start-of-run broadcast, the per-rank share of the global batch's random
draws; ``multihost.py``'s per-host batch is the loader's per-rank shard).
``mesh.py`` holds the mesh: batch and agent-axis placements and the
tensor-parallel rules of the JAX package's ``mesh.py``, with the layers
that carry them out.
"""

from cobevt_tpu_torch.parallel.distributed import (
    ClusterSpec,
    DrawLayout,
    all_reduce_mean_,
    barrier,
    broadcast_module_,
    detect_cluster,
    draw_layout,
    is_main_process,
    maybe_initialize_distributed,
    rank,
    slurm_coordinator,
    world_size,
)
from cobevt_tpu_torch.parallel.mesh import (
    ShardedLinear,
    batch_sharding,
    cooperative_batch_sharding,
    make_mesh,
    param_sharding,
    replicated,
    shard_batch,
    tensor_parallel_spec,
)

__all__ = ["ClusterSpec", "DrawLayout", "ShardedLinear", "all_reduce_mean_",
           "barrier", "batch_sharding", "broadcast_module_",
           "cooperative_batch_sharding", "detect_cluster", "draw_layout",
           "is_main_process", "make_mesh", "maybe_initialize_distributed",
           "param_sharding", "rank", "replicated", "shard_batch",
           "slurm_coordinator", "tensor_parallel_spec", "world_size"]
