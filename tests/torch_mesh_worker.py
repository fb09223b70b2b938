"""One rank of the port's 2 x 2 ("data", "model") mesh (not a test module).

Used by ``tests/test_torch_mesh.py``, which starts four of these with the
explicit-env rendezvous (``tests/test_torch_distributed.py:start_ranks``)
and runs the same cases in one process.  A rank joins the gloo group,
builds ``parallel/mesh.py:make_mesh(2, 2, "cpu")`` and runs, all in f64 on
an f64 compute twin (``tests/torch_dp_worker.py:state_of``), from the
weights the test wrote:

  * ``tp_nodrop``: one tensor-parallel step, every dropout off (its loss);
  * ``tp``: one tensor-parallel step with the dropouts at 0.1, masks from
    a generator seeded ``DROPOUT_SEED``, then the eval step on the placed
    state over the whole batch;
  * ``agent``: the same step with the batch's agents over "model"
    (``cooperative_batch_sharding``) and tensor-parallel weights;
  * ``moments_cut``: ``place_state`` of a state with AdamW moments cuts
    each moment like its parameter;
  * ``serve``: ``StagedBucketedRunner`` over the mesh on the serving
    weights (f32, max_cav 3, 2 live agents).

  python tests/torch_mesh_worker.py mesh <out.npz> <weights.pt> <serve.pt>

writes each train case's loss, whole state_dict after the step and whole
gradients the update read (``<case>/...``), the eval outputs, the served
outputs, and the count of sharded parameters.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dp_worker as dp  # noqa: E402

N_DATA, N_MODEL = 2, 2
SERVE_CAV, SERVE_LIVE = 3, 2


def serve_batch():
    """The serving case's batch: the global batch at max_cav 3 with 2 live
    agents (the JAX serving test's case)."""
    rng = np.random.RandomState(1)
    b = dp.global_batch()
    L = SERVE_CAV
    B = b["inputs"].shape[0]
    out = {
        "inputs": rng.rand(B, L, dp.M, dp.IMG, dp.IMG, 3).astype(np.float32),
        "intrinsic": np.concatenate([b["intrinsic"], b["intrinsic"][:, :1]],
                                    1),
        "extrinsic": np.concatenate([b["extrinsic"], b["extrinsic"][:, :1]],
                                    1),
        "transformation_matrix": np.concatenate(
            [b["transformation_matrix"], b["transformation_matrix"][:, :1]],
            1),
        "agent_mask": np.zeros((B, L), np.float32),
    }
    out["agent_mask"][:, :SERVE_LIVE] = 1
    return out


def model_from(path, dropout, max_cav=dp.L):
    import torch

    from cobevt_tpu_torch.models.corpbevt import CorpBEVT

    model = CorpBEVT(dp.tiny_config(dropout, max_cav))
    model.load_state_dict(torch.load(path, weights_only=True))
    return model


def train_case(mesh, weights, dropout, place_batch, use_tp=True):
    """One step of a placed f64 state on this rank's part of the global
    batch: (loss, whole state_dict, whole gradients, placed state)."""
    import torch

    from cobevt_tpu_torch.parallel import mesh as tp
    from cobevt_tpu_torch.train import (
        full_state_dict,
        make_train_step,
        place_state,
    )

    state = place_state(dp.state_of(model_from(weights, dropout).double()),
                        mesh, use_tp)
    names = {id(p): n for n, p in state.model.named_parameters()}
    grads = {}
    state.optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: grads.update(
            {names[id(p)]: p.grad.detach().clone()
             for g in opt.param_groups for p in g["params"]}))
    step = make_train_step(state.model, dp.criterion, mesh)
    batch = place_batch(mesh, dp.to_tensors(dp.global_batch()))
    gen = torch.Generator().manual_seed(dp.DROPOUT_SEED)
    logs = step(state, batch, gen)
    owners = dict(state.model.named_modules())
    whole = {}
    for name, g in grads.items():
        owner = owners[name.rpartition(".")[0]]
        if isinstance(owner, tp.ShardedLinear) and name.endswith("weight"):
            g = tp.gather_plain(g, owner.dim, owner.axis)
        whole[name] = g
    return float(logs["loss"]), full_state_dict(state), whole, state


def main():
    mode, out_path, weights, serve_weights = sys.argv[1:5]
    assert mode == "mesh"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import torch

    torch.set_num_threads(1)      # see tests/torch_dp_worker.py:main
    from cobevt_tpu_torch.parallel import (
        maybe_initialize_distributed,
        rank,
        world_size,
    )
    from cobevt_tpu_torch.parallel import mesh as tp
    from cobevt_tpu_torch.train import make_eval_step, place_state
    from cobevt_tpu_torch.utils.serving import StagedBucketedRunner

    assert maybe_initialize_distributed(backend="gloo") is True
    assert world_size() == N_DATA * N_MODEL
    out = {"rank": rank()}
    mesh = tp.make_mesh(N_DATA, N_MODEL, "cpu")

    loss, *_ = train_case(mesh, weights, 0.0, tp.shard_batch)
    out["tp_nodrop/loss"] = loss

    cases = {"tp": tp.shard_batch, "agent": tp.cooperative_batch_sharding}
    for case, place in cases.items():
        loss, params, grads, state = train_case(mesh, weights, dp.DROPOUT,
                                                place)
        out[f"{case}/loss"] = loss
        out.update({f"{case}/{k}": v.numpy() for k, v in params.items()})
        out.update({f"{case}/grad/{k}": v.numpy() for k, v in grads.items()})
        out[f"{case}/sharded"] = len(tp.sharded_parameter_ids(state.model))
        if case == "tp":
            seg, _ = make_eval_step(state.model)(
                state, dp.to_tensors(dp.global_batch()))
            out["eval/dynamic_seg"] = seg["dynamic_seg"].numpy()

    # place_state of a state with AdamW moments: each moment cut like its
    # parameter
    state = dp.state_of(model_from(weights, 0.0).double())
    gen = torch.Generator().manual_seed(0)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen, dtype=p.dtype)
    state.optimizer.step()
    specs = tp.param_sharding(mesh, state.model)
    placed = place_state(state, mesh)
    old = dict(state.model.named_parameters())
    out["moments_cut"] = all(
        torch.equal(placed.optimizer.state[p][k], tp.local_part(
            state.optimizer.state[old[name]][k], mesh, specs[name]))
        for name, p in placed.model.named_parameters()
        for k in ("exp_avg", "exp_avg_sq"))

    runner = StagedBucketedRunner(model_from(serve_weights, 0.0, SERVE_CAV),
                                  SERVE_CAV, mesh)
    out["serve/dynamic_seg"] = runner(serve_batch())["dynamic_seg"].numpy()
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
