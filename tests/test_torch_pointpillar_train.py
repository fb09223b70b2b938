"""One and two train steps of the cooperative LiDAR model, port vs JAX.

The small PointPillar + FuseBEVT configuration of
``tests/test_torch_pointpillar.py`` (fused width 128, a 32 x 32 pillar grid,
2 agents, every dropout 0), B 1, f32 on the CPU.  The same numpy weights,
BatchNorm statistics, pillars (some share a cell, a fifth are masked, the
second agent is rotated) and anchor labels go through
``cobevt_tpu.train.make_train_step`` with ``PointPillarLoss`` and through the
port's step with its own.  Compared after each step: loss and its parts, the
global gradient norm, every gradient, every updated parameter and the
running statistics of the PFN, backbone and shrink-conv BatchNorms.

The JAX step runs in f64 (``jax.enable_x64``) and the port in f32, for the
reason given in ``tests/test_torch_train_step.py``.  Both window attentions of
the port (4 windows of 128 tokens, head dim 32, with the communication mask)
pass K5's gate and take K5's plain version in the backward.

Tolerances, those of ``tests/test_torch_train_step.py``.  Step 1: loss 1e-5
rel, gradient norm 1e-4 rel; gradients 5e-4 of the tensor's largest value plus
1e-3 rel, with a floor of 1e-6 of the model's largest gradient; running
statistics 1e-5; updated parameters 1e-6 where the gradient is clear of noise
(above 1e-3 of its tensor's largest and 1e-6 of the model's largest) and
within twice the learning rate elsewhere (AdamW divides a gradient by its own
magnitude).  Step 2 starts from parameters that differ by those elements:
loss 1e-4, gradient norm 2e-3, gradients 1e-1 of the tensor's largest, clear
updated parameters 2e-5 on 99.5% of the elements (the tensors here are small:
three elements of a conv's 2,268 are 0.13%).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.losses.detection_loss import PointPillarLoss as JaxLoss
from cobevt_tpu.models.lidar import point_pillar_models as jm
from cobevt_tpu.train import TrainState as JaxTrainState
from cobevt_tpu.train import make_train_step as jax_make_train_step
from cobevt_tpu.train.optim import make_optimizer as jax_make_optimizer
from cobevt_tpu_torch.models.lidar import point_pillar_models as pm
from cobevt_tpu_torch.ops import window_attention as pwa
from cobevt_tpu_torch.tools import benchmark, validate_kernels
from cobevt_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)
from cobevt_tpu_torch.train.optim import constant_schedule
from cobevt_tpu_torch.utils.weights import (
    jax_tree_to_state_dict,
    load_jax_variables,
)
from tests.test_torch_pointpillar import SMALL, _batch
from tests.torch_parity import jax_variables

LR = 2e-4
LABELS = ("pos_equal_one", "neg_equal_one", "targets")


def make_batch():
    """The tool's synthetic batch and labels as numpy arrays."""
    cfg = pm.PointPillarConfig(**SMALL)
    batch = _batch(cfg)
    # in every agent two live pillars share a cell and one more is masked
    batch["voxel_coords"][0, :, 1] = batch["voxel_coords"][0, :, 0]
    batch["voxel_mask"][0, :, :2] = 1.0
    batch["voxel_mask"][0, :, 2] = 0.0
    model = pm.PointPillarFuseBEVT(cfg)
    _, train_batch = benchmark.make_criterion("pointpillar", model, batch)
    return cfg, {k: v.numpy() for k, v in train_batch.items()}


def _jax_criterion():
    loss = JaxLoss()

    def criterion(out, b):
        return loss(out, {k: b[k] for k in LABELS})
    return criterion


def _jax_steps(model, variables, batch):
    jbatch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                             else None) for k, v in batch.items()}
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
    criterion = _jax_criterion()
    import optax
    tx = jax_make_optimizer(optax.constant_schedule(LR), weight_decay=1e-2,
                            eps=1e-10)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx)
    step = jax_make_train_step(model, criterion, mesh=None, donate=False)

    @jax.jit
    def grads_of(state):
        def loss_fn(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": state.batch_stats}, jbatch,
                True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            return criterion(out, jbatch)[0]
        return jax.grad(loss_fn)(state.params)

    steps = []
    for _ in range(2):
        grads = grads_of(state)
        state, logs = step(state, jbatch, jax.random.PRNGKey(0))
        steps.append({
            "logs": {k: float(v) for k, v in logs.items()},
            "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    return steps


@pytest.fixture(scope="module")
def jax_run():
    cfg, batch = make_batch()
    model = jm.PointPillarFuseBEVT(jm.PointPillarConfig(**SMALL))
    inputs = {k: jnp.asarray(v) for k, v in batch.items() if k not in LABELS}
    variables = jax_variables(model, inputs, False, seed=5)
    with jax.enable_x64(True):
        steps = _jax_steps(model, variables, batch)
    return cfg, variables, batch, steps


@pytest.fixture(scope="module")
def port_run(jax_run):
    cfg, variables, batch, _ = jax_run
    model = pm.PointPillarFuseBEVT(cfg)
    load_jax_variables(model, variables)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    criterion, _ = benchmark.make_criterion("pointpillar", model, tbatch)
    schedule = constant_schedule(LR)
    state = create_train_state(
        model, make_optimizer(model.parameters(), schedule,
                              weight_decay=1e-2, eps=1e-10), schedule)
    step = make_train_step(model, criterion)
    taken = {"K5 plain version": 0, "composite": 0}
    real = (pwa.packed_backward_reference, pwa.packed_backward_composite)

    def spy(name, fn):
        def wrapped(*a, **kw):
            taken[name] += 1
            return fn(*a, **kw)
        return wrapped

    pwa.packed_backward_reference = spy("K5 plain version", real[0])
    pwa.packed_backward_composite = spy("composite", real[1])
    steps = []
    try:
        for _ in range(2):
            saved = {k: v.clone() for k, v in model.state_dict().items()}
            model.train()
            loss, _ = criterion(model(tbatch), tbatch)
            loss.backward()
            grads = {k: torch.zeros_like(p) if p.grad is None
                     else p.grad.clone()
                     for k, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            model.load_state_dict(saved)      # undo the BN statistics update
            before = dict(taken)
            logs = step(state, tbatch)
            steps.append({
                "logs": {k: float(v) for k, v in logs.items()},
                "grads": grads,
                "state": {k: v.clone() for k, v in
                          model.state_dict().items()},
                "taken": {k: taken[k] - before[k] for k in taken}})
    finally:
        pwa.packed_backward_reference, pwa.packed_backward_composite = real
    return model, state, steps


STEP_TOL = [dict(loss=1e-5, gnorm=1e-4, grad=5e-4, param=1e-6),
            dict(loss=1e-4, gnorm=2e-3, grad=1e-1, param=2e-5)]


def _jax_grads(jax_run, model, i):
    grads = jax_tree_to_state_dict(model, {"params": jax_run[3][i]["grads"]})
    return grads, max(float(np.abs(g).max()) for g in grads.values())


def test_batch_has_colliding_and_masked_pillars(jax_run):
    cfg, _, batch, _ = jax_run
    nx = cfg.grid_size[0]
    for agent in range(2):
        c = batch["voxel_coords"][0, agent]
        live = batch["voxel_mask"][0, agent] > 0
        cells = (c[:, 2] * nx + c[:, 3])[live]
        assert len(np.unique(cells)) < len(cells)       # live pillars collide
        assert 0 < (~live).sum() < len(live)            # and some are masked
    assert batch["pos_equal_one"].sum() > 0
    assert batch["targets"].shape == (1, 16, 16, 14)


@pytest.mark.parametrize("i", [0, 1])
def test_loss_and_grad_norm_match(jax_run, port_run, i):
    want, got = jax_run[3][i]["logs"], port_run[2][i]["logs"]
    assert set(got) == set(want)
    assert {"cls_loss", "reg_loss", "loss", "grad_norm"} <= set(got)
    for k in want:
        rtol = STEP_TOL[i]["gnorm" if k == "grad_norm" else "loss"]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)
    assert port_run[1].step == 2


@pytest.mark.parametrize("i", [0, 1])
def test_every_gradient_matches(jax_run, port_run, i):
    model = port_run[0]
    want, largest = _jax_grads(jax_run, model, i)
    got = port_run[2][i]["grads"]
    assert set(got) == set(want) == {k for k, _ in model.named_parameters()}
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(
            got[k].numpy(), want[k], rtol=1e-3, err_msg=k,
            atol=STEP_TOL[i]["grad"] * scale + 1e-6 * largest)


@pytest.mark.parametrize("i", [0, 1])
def test_updated_parameters_and_running_statistics_match(jax_run, port_run,
                                                         i):
    model = port_run[0]
    lr_sum = LR * (i + 1)
    want = jax_tree_to_state_dict(
        model, {"params": jax_run[3][i]["params"],
                "batch_stats": jax_run[3][i]["batch_stats"]})
    got = port_run[2][i]["state"]
    names = {k for k, _ in model.named_parameters()}
    assert set(want) == {k for k in got if "num_batches_tracked" not in k}
    stats = [k for k in want if k not in names]
    assert len(stats) == 2 * 9           # PFN 1, backbone 4 + 2, shrink 2
    so_far = [_jax_grads(jax_run, model, s) for s in range(i + 1)]
    for k in want:
        g = got[k].numpy()
        if k not in names:                       # running_mean, running_var
            np.testing.assert_allclose(g, want[k], atol=1e-5, rtol=1e-5,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(g, want[k], atol=2 * lr_sum * 1.01,
                                   rtol=0, err_msg=k)
        clear = np.ones(want[k].shape, bool)
        for grads, largest in so_far:
            a = np.abs(grads[k])
            clear &= (a > 1e-3 * a.max()) & (a > 1e-6 * largest)
        close = np.isclose(g[clear], want[k][clear],
                           atol=STEP_TOL[i]["param"], rtol=1e-6)
        assert close.sum() >= (1.0 if i == 0 else 0.995) * close.size, k
    tracked = [v for k, v in got.items() if "num_batches_tracked" in k]
    assert tracked and all(int(v) == i + 1 for v in tracked)


def test_both_attentions_take_k5_in_the_backward(port_run):
    for s in port_run[2]:
        assert s["taken"] == {"K5 plain version": 2, "composite": 0}


def test_masked_pillars_get_no_gradient():
    """The scatter's backward is a gather: a masked pillar's features get a
    zero gradient, colliding pillars each the gradient of their cell."""
    from cobevt_tpu_torch.models.lidar.pillar_encoder import pillar_scatter
    feats = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    feats.requires_grad_(True)
    coords = torch.tensor([[0, 0, 1, 1], [0, 0, 1, 1], [0, 0, 0, 2],
                           [0, 0, 1, 0]])
    mask = torch.tensor([True, True, True, False])
    canvas = pillar_scatter(feats, coords, 1, (3, 2, 1), mask)
    assert torch.equal(canvas[0, 1, 1], feats[0].detach() + feats[1].detach())
    g = torch.arange(18, dtype=torch.float32).reshape(1, 2, 3, 3)
    canvas.backward(g)
    assert torch.equal(feats.grad[0], g[0, 1, 1])
    assert torch.equal(feats.grad[1], g[0, 1, 1])
    assert torch.equal(feats.grad[2], g[0, 0, 2])
    assert torch.equal(feats.grad[3], torch.zeros(3))


def test_measure_train_on_the_cpu_reports_no_device_time():
    cfg = pm.PointPillarConfig(**dict(SMALL, fusion_dropout=0.1))
    model, batch, key = benchmark.build_pointpillar(config=cfg)
    assert key == "voxel_features"
    opt = benchmark.parse_args(["--train", "--model", "pointpillar",
                                "--iters", "3", "--warmup", "1", "--fp32"])
    row = benchmark.measure_train(model, "pointpillar", batch, opt,
                                  torch.device("cpu"))
    assert row["model"] == "pointpillar" and row["mode"] == "train"
    assert row["device"] == "cpu" and row["clock"] == "host"
    assert "ms_per_step" not in row and "peak_memory_gb" not in row
    assert row["host_ms_per_step"] > 0 and row["steps"] == 4
    # CPU tensors run the plain versions: no launch is counted
    assert row["k1_launches_per_step"] == row["k5_launches_per_step"] == 0
    assert row["launches_per_step"] == {}
    assert np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
    assert row["fused_xattn_train"] is False


def test_training_lowers_the_loss():
    """Ten AdamW steps at 1e-3 on one batch: the detection loss falls."""
    cfg = pm.PointPillarConfig(**SMALL)
    model, batch, _ = benchmark.build_pointpillar(config=cfg)
    criterion, train_batch = benchmark.make_criterion("pointpillar", model,
                                                      batch)
    schedule = constant_schedule(1e-3)
    state = create_train_state(
        model, make_optimizer(model.parameters(), schedule), schedule)
    step = make_train_step(model, criterion)
    losses = [float(step(state, train_batch)["loss"]) for _ in range(10)]
    assert losses[-1] < 0.8 * losses[0]


def test_criterion_labels_are_the_jax_tools_draws():
    """``make_criterion`` draws pos at 2%, neg at 90% of the rest and normal
    targets from RandomState(1), in the JAX tool's order."""
    cfg = pm.PointPillarConfig(**SMALL)
    model, batch, _ = benchmark.build_pointpillar(config=cfg)
    _, train_batch = benchmark.make_criterion("pointpillar", model, batch)
    assert benchmark.pointpillar_output_shapes(cfg, 1) == (
        (1, 16, 16, 2), (1, 16, 16, 14))
    with torch.no_grad():
        out = model.eval()(batch)
    assert tuple(out["cls_preds"].shape) == (1, 16, 16, 2)
    assert tuple(out["reg_preds"].shape) == (1, 16, 16, 14)
    rng = np.random.RandomState(1)
    pos = (rng.rand(1, 16, 16, 2) < 0.02).astype(np.float32)
    neg = ((1.0 - pos) * (rng.rand(1, 16, 16, 2) < 0.9)).astype(np.float32)
    targets = rng.randn(1, 16, 16, 14).astype(np.float32)
    np.testing.assert_array_equal(train_batch["pos_equal_one"].numpy(), pos)
    np.testing.assert_array_equal(train_batch["neg_equal_one"].numpy(), neg)
    np.testing.assert_array_equal(train_batch["targets"].numpy(), targets)
    full = pm.PointPillarConfig(
        point_cloud_range=benchmark.POINTPILLAR_RANGE)
    assert benchmark.pointpillar_output_shapes(full, 1) == (
        (1, 96, 176, 2), (1, 96, 176, 14))


def test_gradient_gate_and_truth_check_at_a_small_config_on_the_cpu():
    cfg = pm.PointPillarConfig(**validate_kernels.TRUTH_CONFIG)
    report = validate_kernels.validate_train(
        torch.device("cpu"), bf16=False, config=cfg,
        model_name="pointpillar")
    assert report["ok"] and report["precision"] == "fp32"
    assert report["component"] == "pointpillar_train_step_flash_bwd"
    # in f32 the three backward paths are the same arithmetic
    assert report["loss"]["rel"] < 1e-6
    assert report["grad_norm"]["rel"] < 1e-4
    assert set(report["launches"].values()) == {0}
    assert report["budgets"]["scalar"] == \
        validate_kernels.TRAIN_BUDGETS["pointpillar"][0]
    truth = validate_kernels.gradient_truth(torch.device("cpu"))
    assert truth["ok"] and truth["budget"] == validate_kernels.BUDGET_TRUTH
    # bf16 against f32: a real distance, far below the bound
    for path in ("flash", "stock"):
        assert 1e-4 < truth[path]["grad_rel_l2"] < truth["budget"]
    # and the check trips when the bound is taken away
    assert not validate_kernels.gradient_truth(torch.device("cpu"),
                                               budget=1e-6)["ok"]


def test_fused_xattn_train_flag_needs_train(capsys):
    assert benchmark.main(["--fused_xattn_train", "--device", "cpu"]) == 2
    assert "--train" in capsys.readouterr().err
