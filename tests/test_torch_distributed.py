"""The port's multi-process bring-up and data-parallel step.

``cobevt_tpu_torch/parallel/distributed.py`` against the JAX package's
(``cobevt_tpu/parallel/distributed.py``): every case of
``tests/test_distributed_bootstrap.py`` on the port, the two packages'
``detect_cluster`` equal on a table of env mappings, the SLURM coordinator
derived as JAX's ``SlurmCluster`` derives it, and torchrun's variables
asked for by name.  Then one executed two-process gloo run on the CPU
(``tests/torch_dp_worker.py``, modelled on ``tests/mp_rendezvous_worker.py``):
each rank loads its shard of a 4-sample set through the port's
``DataLoader`` and takes one data-parallel step of the tiny CorpBEVT, which
must equal one process's step on the global batch of 4 within 1e-5
relative in the loss, every parameter and every BatchNorm statistic.
Dropout is off in that model: each rank draws its batch's masks from one
generator state, so the two runs would draw different masks.  A second
two-process run takes one epoch of ``Trainer.fit`` over shards of unequal
length (5 samples at batch 1), which must end with as many steps on each
rank, the same losses as one process on the paired batches, and one
checkpoint.  Last, a single-process BatchNorm forward and the loss's
normaliser outside a train step's scope are unchanged.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cobevt_tpu.parallel import distributed as jax_distributed
from cobevt_tpu_torch.nn.layers import BatchNorm2d
from cobevt_tpu_torch.parallel import distributed as dd
from cobevt_tpu_torch.parallel.distributed import (
    ClusterSpec,
    detect_cluster,
    maybe_initialize_distributed,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")


# --- the cases of tests/test_distributed_bootstrap.py, on the port ---------

def test_empty_env_is_single_process():
    assert detect_cluster({}) is None


def test_explicit_env_rendezvous():
    spec = detect_cluster({
        "COBEVT_COORDINATOR": "host0:8476",
        "JAX_NUM_PROCESSES": "4",
        "JAX_PROCESS_ID": "2",
    })
    assert spec.source == "env"
    assert spec.coordinator == "host0:8476"
    assert spec.num_processes == 4
    assert spec.process_id == 2


def test_jax_standard_env_names():
    spec = detect_cluster({
        "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234",
        "WORLD_SIZE": "2",
        "RANK": "1",
    })
    assert spec.source == "env"
    assert (spec.num_processes, spec.process_id) == (2, 1)


def test_explicit_env_missing_rank_is_loud():
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        detect_cluster({"COBEVT_COORDINATOR": "host0:8476"})


def test_world_size_one_is_single_process():
    assert detect_cluster({
        "COBEVT_COORDINATOR": "host0:8476",
        "WORLD_SIZE": "1", "RANK": "0"}) is None


def test_slurm_autodetect():
    spec = detect_cluster({"SLURM_NTASKS": "8"})
    assert spec.source == "slurm"
    assert spec.coordinator is None     # derived from the SLURM env
    assert detect_cluster({"SLURM_NTASKS": "1"}) is None


def test_tpu_pod_hostnames():
    spec = detect_cluster({"TPU_WORKER_HOSTNAMES": "t-0,t-1,t-2,t-3"})
    assert spec.source == "tpu_pod"
    assert detect_cluster({"TPU_WORKER_HOSTNAMES": "t-0"}) is None
    assert detect_cluster({"COBEVT_MULTIHOST": "1"}).source == "tpu_pod"


def test_single_process_noop():
    """With no launch detected the bring-up does nothing and returns False;
    the process stays a world of one."""
    assert maybe_initialize_distributed(env={}) is False
    assert not torch.distributed.is_initialized()
    assert dd.world_size() == 1 and dd.rank() == 0
    assert dd.is_main_process()


# --- the port against the JAX package ----------------------------------------

ENV_TABLE = [
    {},
    {"COBEVT_COORDINATOR": "h:1", "JAX_NUM_PROCESSES": "3",
     "JAX_PROCESS_ID": "0"},
    {"COBEVT_COORDINATOR": "h:1", "WORLD_SIZE": "2", "RANK": "1"},
    {"JAX_COORDINATOR_ADDRESS": "h:2", "JAX_NUM_PROCESSES": "1",
     "JAX_PROCESS_ID": "0"},
    {"COBEVT_COORDINATOR": "h:1", "JAX_NUM_PROCESSES": "2",
     "RANK": "1", "SLURM_NTASKS": "4"},
    {"SLURM_NTASKS": "2"}, {"SLURM_NPROCS": "5"}, {"SLURM_NTASKS": "1"},
    {"SLURM_NTASKS": "1", "COBEVT_MULTIHOST": "1"},
    {"TPU_WORKER_HOSTNAMES": "a,b"}, {"TPU_WORKER_HOSTNAMES": "a, ,"},
    {"COBEVT_MULTIHOST": "0"}, {"COBEVT_MULTIHOST": "1", "WORLD_SIZE": "4"},
    {"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "2",
     "RANK": "0"},
]


@pytest.mark.parametrize("env", ENV_TABLE, ids=range(len(ENV_TABLE)))
def test_detect_cluster_equals_the_jax_package(env):
    got, want = detect_cluster(env), jax_distributed.detect_cluster(env)
    if want is None:
        assert got is None
    else:
        assert got == ClusterSpec(want.source, want.coordinator,
                                  want.num_processes, want.process_id)


def test_detect_cluster_raises_where_the_jax_package_does():
    env = {"JAX_COORDINATOR_ADDRESS": "h:2", "WORLD_SIZE": "2"}
    for fn in (detect_cluster, jax_distributed.detect_cluster):
        with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
            fn(env)


NODE_LISTS = ["node001", "node001,host2", "node[001-0015],host2",
              "node[001,007-015],host2", "gpu-a[7-9]", "x[12]"]


@pytest.mark.parametrize("nodes", NODE_LISTS)
def test_slurm_coordinator_is_jaxs(nodes, monkeypatch):
    from jax._src.clusters.slurm_cluster import SlurmCluster

    env = {"SLURM_JOB_ID": "123457", "SLURM_STEP_NODELIST": nodes}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dd.slurm_coordinator(env) == \
        SlurmCluster.get_coordinator_address(None, None)


def test_slurm_rendezvous_takes_rank_world_and_local_device():
    env = {"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
           "SLURM_JOB_ID": "4096", "SLURM_STEP_NODELIST": "n[3-4]"}
    spec = detect_cluster(env)
    assert dd.rendezvous(spec, env) == ("tcp://n3:61440", 8, 5, 1)


def test_explicit_rendezvous_is_tcp_at_the_coordinator():
    env = {"COBEVT_COORDINATOR": "h0:8476", "JAX_NUM_PROCESSES": "4",
           "JAX_PROCESS_ID": "3", "LOCAL_RANK": "1"}
    assert dd.rendezvous(detect_cluster(env), env) == (
        "tcp://h0:8476", 4, 3, 1)


@pytest.mark.parametrize("env, missing", [
    ({"COBEVT_MULTIHOST": "1"}, "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK"),
    ({"TPU_WORKER_HOSTNAMES": "a,b", "MASTER_ADDR": "h", "RANK": "0"},
     "MASTER_PORT, WORLD_SIZE"),
])
def test_multihost_without_torchrun_variables_raises(env, missing):
    with pytest.raises(ValueError, match=missing):
        maybe_initialize_distributed(env=env, verbose=False)
    assert not torch.distributed.is_initialized()


def test_multihost_takes_torchruns_variables():
    env = {"COBEVT_MULTIHOST": "1", "MASTER_ADDR": "h", "MASTER_PORT": "29500",
           "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "0"}
    assert dd.rendezvous(detect_cluster(env), env) == (
        "tcp://h:29500", 4, 2, 0)


# --- the executed two-process data-parallel step --------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, mode, *args):
    """Start two workers in ``mode`` with the explicit-env rendezvous, wait
    for both (a hung pair fails at the time limit) and return their
    ``.npz`` results in rank order."""
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        env = os.environ.copy()
        env.update(COBEVT_COORDINATOR=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   OMP_NUM_THREADS="1")
        outs.append(tmp_path / f"{mode}_rank{pid}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, mode, str(outs[-1]), *args], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for pid, p in enumerate(procs):
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(f"--- rank {pid} (rc={p.returncode}) ---\n{stdout}")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(o)) for o in outs]


def _worker():
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_dp_worker
    return torch_dp_worker


def test_two_process_step_equals_one_process_on_the_global_batch(tmp_path):
    """The model runs in f64 on both sides (its K1 plain path in f32):
    f32 through the whole graph leaves gradients that are rounding noise
    around zero (a key-projection bias, a conv bias before BatchNorm), and
    AdamW moves such an element by +-lr whatever its size, so the f32 runs
    would part by 2 lr there.  Held to 1e-5 relative: the loss, every
    BatchNorm statistic, every gradient the update reads (of its tensor's
    largest, with a floor of 1e-6 of the model's largest gradient), and
    every updated parameter element whose gradient passes that floor (of
    its tensor's largest); the other elements within twice the step's lr.
    The two ranks must hold bit-equal parameters and statistics, and rank
    1, built from other weights, must have taken rank 0's.  Both sides
    compute on an f64 twin of the masters, the branch a bf16 run takes."""
    worker = _worker()
    ranks = run_ranks(tmp_path, "step")

    # one process, the global batch of 4, the weights of seed 0
    _, state, step = worker.train_state(seed=0)
    want = worker.results(state, step(state, worker.to_tensors(
        worker.global_batch())))
    lr = state.schedule(0)

    assert set(ranks[0]) - {"rank"} == set(want)
    for key in want:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                      err_msg=key)
    got = ranks[0]
    floor = 1e-6 * max(np.abs(v).max() for k, v in want.items()
                       if k.startswith("grad/"))
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    checked = 0
    for key, w in want.items():
        d = np.abs(got[key] - w)
        if key.startswith("grad/"):
            assert d.max() <= 1e-5 * max(np.abs(w).max(), floor), key
        elif "running" in key:
            assert d.max() <= 1e-5 * np.abs(w).max(), key
        elif f"grad/{key}" in want:
            clear = np.abs(want[f"grad/{key}"]) > floor
            assert (d[clear] <= 1e-5 * np.abs(w).max()).all(), key
            assert d.max() <= 2 * lr, key
            checked += int(clear.sum())
    assert checked > 0.95 * sum(w.size for k, w in want.items()
                                if k.startswith("grad/"))


def test_two_process_fit_takes_as_many_steps_on_unequal_shards(tmp_path):
    """One epoch of ``Trainer.fit`` on two ranks whose shards differ in
    length (2 and 3 batches: the loader gives the last shard the
    remainder).  Both ranks take 2 steps, so every step's collectives pair
    with the same step's on the other rank (a third step on rank 1 would
    wait forever for a partner), then meet at the checkpoint barrier.  The
    logged losses equal one process's steps on the paired global batches
    (samples 0 + 2, then 1 + 3) within 1e-5 relative, the ranks end with
    bit-equal parameters and statistics, and rank 0 wrote one
    checkpoint."""
    worker = _worker()
    ckpt = tmp_path / "ckpt"
    ranks = run_ranks(tmp_path, "fit", str(ckpt))
    assert [int(r["loader_len"]) for r in ranks] == [2, 3]
    assert [int(r["steps"]) for r in ranks] == [2, 2]
    for key in ranks[0]:
        if key not in ("rank", "loader_len"):
            np.testing.assert_array_equal(ranks[0][key], ranks[1][key],
                                          err_msg=key)
    assert sorted(os.listdir(ckpt)) == ["net_epoch1.pth",
                                       "train_state_epoch1.pt"]

    batch = worker.global_batch(worker.FIT_SAMPLES)
    _, state, step = worker.train_state(seed=0)
    want = [float(step(state, worker.to_tensors(
        {k: v[list(pair)] for k, v in batch.items()}))["loss"])
        for pair in ((0, 2), (1, 3))]
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)


def test_loss_normaliser_is_local_outside_a_train_step(monkeypatch):
    """The seg losses average their normalisers over the ranks only inside
    the train step's ``rank_mean_scope``: a loss computed elsewhere (a
    diagnostic, an evaluation, one rank alone) runs no collective."""
    reduced = []
    monkeypatch.setattr(dd, "world_size", lambda: 2)
    monkeypatch.setattr(dd.dist, "all_reduce",
                        lambda t, *a, **k: reduced.append(t.clone()))
    den = torch.tensor(3.0)
    assert dd.rank_mean_denominator(den) is den and not reduced
    with dd.rank_mean_scope():
        got = dd.rank_mean_denominator(den)
    assert float(got) == 1.5 and len(reduced) == 1
    assert dd.rank_mean_denominator(den) is den and len(reduced) == 1


def test_single_process_batch_norm_is_unchanged():
    """Without a process group the train-mode BatchNorm is the one it was:
    PyTorch's kernel at momentum 1 into zeroed buffers, the running
    variance moved toward the biased batch variance."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, 5, 7, generator=gen)
    bn = BatchNorm2d(8).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.5, 0.5, generator=gen)
    mean, var = torch.zeros(8), torch.zeros(8)
    want = torch.nn.functional.batch_norm(x, mean, var, bn.weight, bn.bias,
                                          True, 1.0, bn.eps)
    n = x.numel() // 8
    want_rm = torch.zeros(8).lerp_(mean, 0.1)
    want_rv = torch.ones(8).lerp_(var * ((n - 1) / n), 0.1)
    got = bn(x)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, want_rm)
    assert torch.equal(bn.running_var, want_rv)
