"""Multi-process bring-up: the ``torch.distributed`` rendezvous.

Counterpart of ``cobevt_tpu/parallel/distributed.py`` (reference
``opv2v/opencood/tools/multi_gpu_utils.py:16-39``: env / SLURM rendezvous
and ``torch.distributed.init_process_group``).  The JAX package runs one
process per host and one sharded program over every chip; here there is
one process per GPU, each holding a whole replica, and the train step
averages the gradients over the process group (``train/step.py``).

Detection ladder (first match wins; :func:`detect_cluster`, the JAX
package's, the same result on every env mapping):

  1. Explicit env: ``COBEVT_COORDINATOR`` (or ``JAX_COORDINATOR_ADDRESS``)
     + ``JAX_NUM_PROCESSES`` + ``JAX_PROCESS_ID`` (or ``WORLD_SIZE`` /
     ``RANK``): a TCP rendezvous at the coordinator's ``host:port``.
  2. SLURM: ``SLURM_NTASKS > 1``: rank ``SLURM_PROCID``, world
     ``SLURM_NTASKS``, local GPU ``SLURM_LOCALID``; the coordinator is the
     first host of ``SLURM_STEP_NODELIST`` at a port derived from
     ``SLURM_JOB_ID``, as JAX's ``SlurmCluster`` derives it
     (:func:`slurm_coordinator`).
  3. ``COBEVT_MULTIHOST=1`` or ``TPU_WORKER_HOSTNAMES`` naming more than one
     host: torchrun's contract, ``MASTER_ADDR`` / ``MASTER_PORT`` /
     ``WORLD_SIZE`` / ``RANK`` (and ``LOCAL_RANK``); an error names what is
     missing.

Anything else is a single-process run and the bring-up does nothing.  The
train CLIs call :func:`maybe_initialize_distributed` first thing, then
load their rank's shard of each epoch (``DataLoader(num_shards=world,
shard_index=rank)``).

  # one node, 4 GPUs
  COBEVT_MULTIHOST=1 torchrun --nproc_per_node 4 \\
      -m cobevt_tpu_torch.tools.train_camera --hypes_yaml ...
  # SLURM, one task per GPU
  srun --ntasks-per-node=4 --gpus-per-node=4 \\
      python -m cobevt_tpu_torch.tools.train_camera --hypes_yaml ...
  # explicit rendezvous
  COBEVT_COORDINATOR=host0:8476 JAX_NUM_PROCESSES=8 JAX_PROCESS_ID=$i \\
      python -m cobevt_tpu_torch.tools.train_camera --hypes_yaml ...
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Mapping, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """How to initialize the process group.

    ``coordinator/num_processes/process_id`` of None: read from the
    launcher's environment (SLURM's or torchrun's)."""

    source: str                       # "env" | "slurm" | "tpu_pod"
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


def detect_cluster(env: Mapping[str, str]) -> Optional[ClusterSpec]:
    """Pure detection over an env mapping; None means single-process."""
    coord = env.get("COBEVT_COORDINATOR") or env.get(
        "JAX_COORDINATOR_ADDRESS")
    if coord:
        nproc = env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE")
        pid = env.get("JAX_PROCESS_ID") or env.get("RANK")
        if nproc is None or pid is None:
            raise ValueError(
                "COBEVT_COORDINATOR set but JAX_NUM_PROCESSES / "
                "JAX_PROCESS_ID (or WORLD_SIZE / RANK) missing — the "
                "explicit rendezvous needs all three "
                "(reference contract: multi_gpu_utils.py:16-39)")
        if int(nproc) <= 1:
            return None
        return ClusterSpec("env", coord, int(nproc), int(pid))

    ntasks = env.get("SLURM_NTASKS") or env.get("SLURM_NPROCS")
    if ntasks and int(ntasks) > 1:
        return ClusterSpec("slurm")

    hosts = env.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h.strip()]) > 1:
        return ClusterSpec("tpu_pod")
    if env.get("COBEVT_MULTIHOST") == "1":
        return ClusterSpec("tpu_pod")
    return None


def slurm_coordinator(env: Mapping[str, str]) -> str:
    """``host:port`` of a SLURM job's rendezvous, as JAX's ``SlurmCluster``
    derives it: the first host of ``SLURM_STEP_NODELIST`` ('node001',
    'node001,host2', 'node[001-015],host2', 'node[001,007-015],host2' all
    give 'node001') and a port in [61440, 65535] from ``SLURM_JOB_ID``.
    No ``scontrol`` call."""
    port = int(env["SLURM_JOB_ID"]) % 2 ** 12 + (65535 - 2 ** 12 + 1)
    nodes = env["SLURM_STEP_NODELIST"]
    ind = next((i for i, ch in enumerate(nodes) if ch in ",["), len(nodes))
    if ind == len(nodes) or nodes[ind] == ",":
        return f"{nodes[:ind]}:{port}"
    prefix, suffix = nodes[:ind], nodes[ind + 1:]
    ind2 = next((i for i, ch in enumerate(suffix) if ch in ",-"), None)
    return f"{prefix}{suffix[:ind2]}:{port}"


_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def rendezvous(spec: ClusterSpec, env: Mapping[str, str]):
    """(init_method, world size, rank, local rank) of a detected cluster."""
    if spec.source == "env":
        world, rank_ = spec.num_processes, spec.process_id
        local = int(env.get("LOCAL_RANK", rank_))
        return f"tcp://{spec.coordinator}", world, rank_, local
    if spec.source == "slurm":
        return (f"tcp://{slurm_coordinator(env)}", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]), int(env["SLURM_LOCALID"]))
    missing = [k for k in _TORCHRUN_VARS if k not in env]
    if missing:
        raise ValueError(
            f"a multi-process launch ({spec.source}: COBEVT_MULTIHOST=1 or "
            f"TPU_WORKER_HOSTNAMES) takes torchrun's rendezvous; "
            f"{', '.join(missing)} not set")
    rank_ = int(env["RANK"])
    return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), rank_, int(env.get("LOCAL_RANK", rank_)))


def maybe_initialize_distributed(env: Optional[Mapping[str, str]] = None,
                                 verbose: bool = True,
                                 backend: Optional[str] = None) -> bool:
    """Initialize the default process group iff a multi-process launch is
    detected, one process per GPU: ``backend`` "nccl" where CUDA is
    available (the process takes GPU ``local rank``), else "gloo", unless
    named.  Idempotent; a no-op returning False for a single-process run,
    so every CLI works unchanged on one device."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ if env is None else env
    spec = detect_cluster(env)
    if spec is None:
        return False
    init_method, world, rank_, local = rendezvous(spec, env)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_)
    if verbose:
        print(f"[distributed] initialized via {spec.source} ({backend}): "
              f"process {rank_}/{world}, local device {local}")
    return True


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    """Rank 0: the process that writes checkpoints, logs and reports."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if world_size() > 1:
        dist.barrier()


def min_over_ranks(n: int) -> int:
    """The least of every rank's ``n`` (``n`` itself without a group)."""
    if world_size() == 1:
        return n
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t)


# elements a bucket of the gradient reduction holds (f32: 100 MB)
BUCKET_ELEMENTS = 25 * 2 ** 20


def all_reduce_mean_(tensors, bucket_elements: int = BUCKET_ELEMENTS):
    """Average ``tensors`` (one dtype) over the default group in place: the
    tensors are packed into buckets of at most ``bucket_elements``, each
    bucket summed by one ``all_reduce`` and divided by the world size.  A
    no-op for one process."""
    world = world_size()
    if world == 1 or not tensors:
        return tensors
    buckets, current, size = [], [], 0
    for t in tensors:
        if current and size + t.numel() > bucket_elements:
            buckets.append(current)
            current, size = [], 0
        current.append(t)
        size += t.numel()
    buckets.append(current)
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(world)
        torch._foreach_copy_(
            bucket, [v.view_as(t) for v, t in zip(
                flat.split([t.numel() for t in bucket]), bucket)])
    return tensors


_loss_scope = threading.local()


@contextlib.contextmanager
def rank_mean_scope():
    """The loss of a data-parallel train step: ``train/step.py`` opens it
    around its criterion on every rank alike, and inside it
    :func:`rank_mean_denominator` averages over the ranks."""
    prev = getattr(_loss_scope, "active", False)
    _loss_scope.active = True
    try:
        yield
    finally:
        _loss_scope.active = prev


def rank_mean_denominator(den):
    """``den``, the normaliser of a per-batch weighted mean (a weight sum, a
    count of kept pixels).  Inside :func:`rank_mean_scope` under a group of
    more than one rank it becomes the mean of the ranks' normalisers, so
    that the mean of the ranks' losses, which the data-parallel step logs
    and differentiates, is the loss of the global batch, as in the JAX
    package's sharded step.  Anywhere else (one process, an evaluation, a
    loss that one rank alone computes) it is ``den`` and no collective
    runs."""
    if not getattr(_loss_scope, "active", False) or world_size() == 1:
        return den
    den = den.detach().clone()
    dist.all_reduce(den)
    return den / world_size()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the default group; its backward sums the gradients over the
    group too (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t):
    """Differentiable sum of ``t`` over the default group (a new tensor)."""
    return _AllReduceSum.apply(t)


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers (BatchNorm statistics)
    into every rank's ``module``, in place: each rank builds its weights
    from the same seed, and this makes a rank that differs agree before the
    first step instead of drifting unseen."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)
