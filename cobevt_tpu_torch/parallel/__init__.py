"""Multi-process training: the rendezvous and the data-parallel helpers.

Counterpart of ``cobevt_tpu/parallel/``.  Ported: ``distributed.py`` (the
rendezvous, here ``torch.distributed``) with the data-parallel helpers that
stand in for the JAX package's sharded step (the gradient reduction and the
start-of-run broadcast; ``multihost.py``'s per-host batch is the loader's
per-rank shard).  ``mesh.py``'s tensor-parallel rules are not ported yet.
"""

from cobevt_tpu_torch.parallel.distributed import (
    ClusterSpec,
    all_reduce_mean_,
    barrier,
    broadcast_module_,
    detect_cluster,
    is_main_process,
    maybe_initialize_distributed,
    rank,
    slurm_coordinator,
    world_size,
)

__all__ = ["ClusterSpec", "all_reduce_mean_", "barrier", "broadcast_module_",
           "detect_cluster", "is_main_process",
           "maybe_initialize_distributed", "rank", "slurm_coordinator",
           "world_size"]
