"""The port's ("data", "model") mesh against the JAX package's.

``cobevt_tpu_torch/parallel/mesh.py`` beside ``cobevt_tpu/parallel/
mesh.py``, on the tiny CorpBEVT of ``tests/test_train_multichip.py``
(ResNet-18, 64^2 images, 2 agents x 1 camera, BEV 32^2, FAX dim 32):

  * the rules, in this process: the port's ``tensor_parallel_spec`` shards
    the same 46 of 311 tensors as the JAX package's, each on the transposed
    axis (a flax kernel is (in, out), an ``nn.Linear`` weight (out, in));
    at 3 "model" ranks ``param_sharding`` replicates exactly where the JAX
    package's does on its 8 virtual CPU devices; and
    ``cooperative_batch_sharding`` splits the agents of the same keys for 2,
    3 and 4 agents over 2 "model" ranks;
  * one executed run of four gloo processes on the CPU, mesh 2 x 2
    (``tests/torch_mesh_worker.py``): a tensor-parallel step and an
    agent-axis step (agents over "model", tensor-parallel weights), both
    with the self-attention and fusion dropouts at 0.1, each equal to one
    process's step on the global batch of 4 from the same generator seed
    (1e-5 relative, in f64: ``tests/test_torch_distributed.py:
    assert_step_equal``) with the four ranks' whole states bit-equal; the
    eval step on the placed state equal to one process's eval of its state
    after the step; ``StagedBucketedRunner`` over the mesh at max_cav 3 with
    2 live agents equal to the padded single-process forward within the JAX
    serving test's ``atol=2e-4, rtol=1e-3``; ``place_state`` of a state
    with AdamW moments cutting each like its parameter; and the
    tensor-parallel step's
    loss with every dropout off within ``rtol=1e-4`` (the JAX test's own
    tolerance) of the JAX package's single-device ``make_train_step`` on
    the same weights and batch, which this process runs while the workers
    do.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT
from cobevt_tpu.parallel import mesh as jmesh
from cobevt_tpu.train import TrainState as JaxTrainState
from cobevt_tpu.train import make_train_step as jax_make_train_step
from cobevt_tpu.train.optim import cosine_warmup_schedule as jax_schedule
from cobevt_tpu.train.optim import make_optimizer as jax_make_optimizer
from cobevt_tpu_torch.models.corpbevt import CorpBEVT
from cobevt_tpu_torch.parallel import mesh as tp
from cobevt_tpu_torch.train import make_eval_step, make_train_step
from cobevt_tpu_torch.utils.weights import (
    jax_tree_to_state_dict,
    load_jax_variables,
    seeded_init_,
)
from tests import torch_dp_worker as dp
from tests import torch_mesh_worker as mw
from tests.test_torch_distributed import (
    REPO,
    assert_step_equal,
    start_ranks,
    wait_ranks,
)
from tests.test_train_multichip import make_criterion, tiny_batch
from tests.test_train_multichip import tiny_config as jax_tiny_config
from tests.torch_parity import jax_variables

MESH_WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")


def _jax_specs(params, mesh=None):
    """{flax path: PartitionSpec} of the JAX rules (``param_sharding`` on
    ``mesh``, else ``tensor_parallel_spec``)."""
    if mesh is None:
        tree = jax.tree_util.tree_map_with_path(jmesh.tensor_parallel_spec,
                                                params)
    else:
        tree = jax.tree.map(lambda s: s.spec,
                            jmesh.param_sharding(mesh, params))
    return {jax.tree_util.keystr(path): spec for path, spec in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _port_names(port, params):
    """{flax path: port state_dict name}, through the weight bridge: every
    leaf replaced by an array of its own index."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(leaf), i) for i, (_, leaf) in
                  enumerate(leaves)])
    paths = [jax.tree_util.keystr(path) for path, _ in leaves]
    return {paths[int(np.asarray(v).flat[0])]: name for name, v in
            jax_tree_to_state_dict(port, {"params": ids}).items()}


# the port's placement of a flax spec: the kernel is the torch weight's
# transpose, so its split axis is the other one
_TRANSPOSED = {P(): tp.Replicate(), P(None, "model"): tp.Shard(0),
               P("model", None): tp.Shard(1)}


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its numpy variables, the port model holding them)."""
    model = JaxCorpBEVT(jax_tiny_config())
    batch = tiny_batch(B=2)
    variables = jax_variables(model, batch, False, seed=3)
    port = CorpBEVT(dp.tiny_config())
    load_jax_variables(port, variables)
    return model, variables, port


def test_tensor_parallel_rules_shard_the_jax_tensors(tiny):
    _, variables, port = tiny
    want = _jax_specs(variables["params"])
    names = _port_names(port, variables["params"])
    params = dict(port.named_parameters())
    assert len(want) == len(params) == 311
    got = {path: tp.tensor_parallel_spec(names[path], params[names[path]])
           for path in want}
    assert got == {path: _TRANSPOSED[spec] for path, spec in want.items()}
    assert sum(spec != P() for spec in want.values()) == 46


def test_param_sharding_replicates_where_jax_does(tiny):
    """3 "model" ranks: the FAX and fusion widths (32, 64) do not divide,
    the packed to_qkv (96) and the MLPs' hidden 64 partly do."""
    _, variables, port = tiny
    want = _jax_specs(variables["params"], jmesh.make_mesh(n_data=2,
                                                           n_model=3))
    names = _port_names(port, variables["params"])
    got = tp.shard_specs(port, 3)
    assert {path: got[names[path]] for path in want} == \
        {path: _TRANSPOSED[spec] for path, spec in want.items()}
    sharded = sum(spec != P() for spec in want.values())
    assert 0 < sharded < 46


@pytest.mark.parametrize("agents", [2, 3, 4])
def test_cooperative_batch_sharding_is_jaxs(agents):
    batch = tiny_batch(B=2, L=agents)
    placed = jmesh.cooperative_batch_sharding(
        jmesh.make_mesh(n_data=2, n_model=2), batch)
    got = tp.cooperative_placements({k: np.asarray(v)
                                     for k, v in batch.items()}, 2)
    for key, value in placed.items():
        split = value.sharding.spec == P("data", "model")
        assert got[key] == (tp.Shard(0), tp.Shard(1) if split
                            else tp.Replicate()), key
    assert isinstance(got["inputs"][1], tp.Shard) == (agents % 2 == 0)


def _jax_loss(model, variables, batch):
    """The loss of the JAX package's single-device train step (every
    dropout off) on ``variables`` and ``batch``."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jax_make_optimizer(jax_schedule(2e-4, 2e-5, 10, 100),
                            weight_decay=1e-2, eps=1e-10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx)
    step = jax_make_train_step(model, make_criterion(), donate=False)
    _, logs = step(state, jbatch, jax.random.PRNGKey(1))
    return float(logs["loss"])


def test_mesh_2x2_equals_one_process(tiny, tmp_path):
    model, variables, port = tiny
    weights = tmp_path / "weights.pt"
    torch.save(port.state_dict(), weights)
    serving = CorpBEVT(dp.tiny_config(0.0, mw.SERVE_CAV))
    seeded_init_(serving, 1)
    serve_weights = tmp_path / "serve.pt"
    torch.save(serving.state_dict(), serve_weights)
    procs = start_ranks(tmp_path, "mesh", str(weights), str(serve_weights),
                        world=4, worker=MESH_WORKER)

    # while the workers run: the JAX step, one process's step with the
    # dropouts on from the same seed, its eval after it, the padded forward
    batch = dp.global_batch()
    jax_loss = _jax_loss(model, variables, batch)
    state = dp.state_of(mw.model_from(weights, dp.DROPOUT).double())
    step = make_train_step(state.model, dp.criterion)
    gen = torch.Generator().manual_seed(dp.DROPOUT_SEED)
    want = dp.results(state, step(state, dp.to_tensors(batch), gen))
    want_eval, _ = make_eval_step(state.model)(state, dp.to_tensors(batch))
    with torch.no_grad():
        want_serve = serving.eval()(
            {k: torch.from_numpy(v) for k, v in mw.serve_batch().items()})

    ranks = wait_ranks(*procs)
    for r in ranks[1:]:
        for key in ranks[0]:
            if key != "rank":
                np.testing.assert_array_equal(ranks[0][key], r[key],
                                              err_msg=key)
    got = ranks[0]
    lr = state.schedule(0)
    assert bool(got["moments_cut"])
    for case in ("tp", "agent"):
        assert int(got[f"{case}/sharded"]) == 46
        assert_step_equal({k: got[f"{case}/{k}"] for k in want}, want, lr)
    np.testing.assert_allclose(got["eval/dynamic_seg"],
                               want_eval["dynamic_seg"].numpy(),
                               rtol=1e-5, atol=1e-5 * np.abs(
                                   got["eval/dynamic_seg"]).max())
    np.testing.assert_allclose(got["serve/dynamic_seg"],
                               want_serve["dynamic_seg"].numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["tp_nodrop/loss"], jax_loss, rtol=1e-4)
