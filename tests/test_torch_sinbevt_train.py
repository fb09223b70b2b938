"""One SinBEVT-nuScenes train step of the port against the JAX step, and
the train step's entry points at a small config on the CPU.

The small config of tests/test_nuscenes_model.py (EfficientNet-b0, 2
cameras of 64 x 128, dims 16/32/64, BEV 40^2, no remat) with the vehicle
experiment's criterion (visibility-masked focal loss on the folded vehicle
labels + 0.1 x the masked center loss), B 2, f32 on the CPU, no mesh.  The
recipe is the experiment's: AdamW with wd 1e-7 and eps 1e-8 on the
one-cycle schedule (lr 5e-3 over 50,001 steps), and a global-norm clip of
1e-6, which binds: it scales the gradients down to the size of eps, so the
update of an element depends on the scale and a missing or wrong clip
shows.  The same numpy weights, images and labels (12 binary label
channels, centerness, visibility 0-4) go through
``cobevt_tpu.train.make_train_step`` and the port's.  Both sides keep every
drop-connect gate (``jax.random.bernoulli`` of the JAX module and the port's
``drop_gate`` patched to "keep"), so they draw the same gates.  Which
backward each window attention takes: all six (windows of 25 queries over
64 keys) pass the port's K5 gate and take K5's plain version; JAX on the CPU
takes its XLA branch.

As in tests/test_torch_train_step.py, the JAX step runs in f64
(``jax.enable_x64``) and the port in f32: XLA's CPU reductions add f32
values one after another, which leaves a BatchNorm backward's f32
gradients ~1e-2 of their scale from the f64 result.  Tolerances: loss and
each part 1e-5 rel, gradient norm 1e-4 rel; gradients 5e-4 of the tensor's
largest value plus 1e-3 rel, with a floor of 1e-6 of the model's largest
gradient; BatchNorm running statistics 1e-5; updated parameters within 2
learning rates everywhere (AdamW's step is +-lr where an element's clipped
gradient exceeds eps: a noise element may step either way) and 1e-6 where
the gradient exceeds 1e-3 of its tensor's largest and 1e-6 of the model's
largest.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.configs import nuscenes_experiments as jexp
from cobevt_tpu.models import sinbevt_nuscenes as jsn
from cobevt_tpu.nn import efficientnet as jeff
from cobevt_tpu.train import TrainState as JaxTrainState
from cobevt_tpu.train import make_train_step as jax_make_train_step
from cobevt_tpu.train.optim import make_optimizer as jax_make_optimizer
from cobevt_tpu.train.optim import onecycle_schedule as jax_onecycle
from cobevt_tpu_torch.configs import nuscenes_experiments as pexp
from cobevt_tpu_torch.nn.efficientnet import MBConvBlock
from cobevt_tpu_torch.ops import window_attention as pwa
from cobevt_tpu_torch.tools import benchmark, validate_kernels
from cobevt_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
    onecycle_schedule,
)
from cobevt_tpu_torch.utils.weights import (
    jax_tree_to_state_dict,
    load_jax_variables,
)
from tests.test_nuscenes_model import small_cfg
from tests.test_torch_sinbevt_nuscenes import (
    OUTPUTS,
    make_batch,
    small_experiment,
)
from tests.torch_parity import jax_variables, jnp_tree

VEHICLE = "cvt_pyramid_axial_nuscenes_vehicle"
CLIP = 1e-6
B = 2


def vehicle_experiment():
    """The small config with the vehicle experiment's losses and recipe."""
    flagship = pexp.nuscenes_experiment(VEHICLE)
    return dataclasses.replace(small_experiment(), losses=flagship.losses,
                               label_indices=flagship.label_indices)


def train_batch():
    """Images and poses of the forward tests, and labels in the layout of
    the nuScenes generator (benchmark.nuscenes_labels) at BEV 40^2."""
    batch = make_batch(B=B)
    batch.update(benchmark.nuscenes_labels(B, 40, 40, seed=3))
    return batch


def _keep_every_gate(monkeypatch):
    """Both sides keep every drop-connect gate: the JAX module's Bernoulli
    draws ones, the port's gate is 1 / keep where it would draw."""
    monkeypatch.setattr(jeff.jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    real = MBConvBlock.drop_gate

    def keep(self, x, generator=None):
        gate = real(self, x, generator)
        return None if gate is None else torch.full_like(
            gate, 1.0 / (1.0 - self.spec.drop_rate))

    monkeypatch.setattr(MBConvBlock, "drop_gate", keep)


@pytest.fixture(scope="module")
def run():
    """One step on each side from the same seeded numpy variables: the JAX
    step in f64, the port's in f32.  Returns (port model, JAX variables,
    JAX logs, grads, params and batch_stats after, port logs, grads and
    state_dict after, which backward each attention took)."""
    mp = pytest.MonkeyPatch()
    try:
        _keep_every_gate(mp)
        return _run()
    finally:
        mp.undo()


def _run():
    exp = vehicle_experiment()
    jcfg = small_cfg()
    jm = jsn.CrossViewTransformer(jcfg, decoder_blocks=(64, 64, 32),
                                  dim_last=32, outputs=OUTPUTS)
    batch = train_batch()
    variables = jax_variables(jm, jnp_tree(make_batch(B=B)), False, seed=5)

    # JAX, f64
    jcrit = jexp.build_criterion(jexp.nuscenes_experiment(VEHICLE))
    with jax.enable_x64(True):
        jbatch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                                 else None) for k, v in batch.items()}
        jvars = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             variables)
        tx = jax_make_optimizer(jax_onecycle(exp.lr, exp.steps),
                                weight_decay=exp.weight_decay, eps=1e-8,
                                grad_clip=CLIP)
        params = jvars["params"]
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jvars["batch_stats"],
                              opt_state=tx.init(params), tx=tx)

        def loss_fn(p):
            out, _ = jm.apply({"params": p,
                               "batch_stats": state.batch_stats}, jbatch,
                              True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
            return jcrit(out, jbatch)[0]

        jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params))
        step = jax_make_train_step(jm, jcrit, mesh=None, donate=False)
        new, jlogs = step(state, jbatch, jax.random.PRNGKey(0))
        jax_out = ({k: float(v) for k, v in jlogs.items()}, jgrads,
                   jax.tree.map(np.asarray, new.params),
                   jax.tree.map(np.asarray, new.batch_stats))

    # the port, f32
    model = pexp.build_model(exp)
    load_jax_variables(model, variables)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    crit = pexp.build_criterion(exp)
    schedule = onecycle_schedule(exp.lr, exp.steps)
    opt = make_optimizer(model.parameters(), schedule,
                         weight_decay=exp.weight_decay, eps=1e-8)
    pstate = create_train_state(model, opt, schedule, grad_clip=CLIP)
    taken = {"K5 plain version": 0, "composite": 0}
    real = (pwa.packed_backward_reference, pwa.packed_backward_composite)

    def spy(name, fn):
        def wrapped(*a, **kw):
            taken[name] += 1
            return fn(*a, **kw)
        return wrapped

    pwa.packed_backward_reference = spy("K5 plain version", real[0])
    pwa.packed_backward_composite = spy("composite", real[1])
    try:
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        model.train()
        loss, _ = crit(model(tbatch), tbatch)
        loss.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        model.load_state_dict(saved)      # undo the BN statistics update
        before = dict(taken)
        logs = make_train_step(model, crit)(pstate, tbatch)
        taken = {k: taken[k] - before[k] for k in taken}
    finally:
        pwa.packed_backward_reference, pwa.packed_backward_composite = real
    port_out = ({k: float(v) for k, v in logs.items()}, grads,
                {k: v.clone() for k, v in model.state_dict().items()}, taken)
    return model, variables, jax_out, port_out, pstate


def _jax_grads(model, jax_out):
    grads = jax_tree_to_state_dict(model, {"params": jax_out[1]})
    return grads, max(float(np.abs(g).max()) for g in grads.values())


def test_loss_parts_and_grad_norm_match(run):
    want, got = run[2][0], run[3][0]
    assert set(got) == set(want) == {"visible", "center", "loss",
                                     "grad_norm"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, atol=1e-7,
                                   rtol=1e-4 if k == "grad_norm" else 1e-5)
    # the clip binds: the norm before clipping is far above it
    assert got["grad_norm"] > 100 * CLIP
    assert run[4].step == 1


def test_every_gradient_matches(run):
    model = run[0]
    want, largest = _jax_grads(model, run[2])
    got = run[3][1]
    assert set(got) == set(want) == {k for k, _ in model.named_parameters()}
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=5e-4 * scale + 1e-6 * largest,
                                   err_msg=k)


def test_batch_stats_and_clipped_update_match(run):
    model = run[0]
    exp = vehicle_experiment()
    lr = onecycle_schedule(exp.lr, exp.steps)(0)
    want = jax_tree_to_state_dict(model, {"params": run[2][2],
                                          "batch_stats": run[2][3]})
    got = run[3][2]
    names = {k for k, _ in model.named_parameters()}
    assert set(want) == {k for k in got if "num_batches_tracked" not in k}
    grads, largest = _jax_grads(model, run[2])
    stepped = 0
    for k in want:
        g = got[k].numpy()
        if k not in names:                       # running_mean, running_var
            np.testing.assert_allclose(g, want[k], atol=1e-5, rtol=1e-5,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(g, want[k], atol=2 * lr * 1.01, rtol=0,
                                   err_msg=k)
        a = np.abs(grads[k])
        clear = (a > 1e-3 * a.max()) & (a > 1e-6 * largest)
        np.testing.assert_allclose(g[clear], want[k][clear], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        stepped += int(clear.sum())
    assert stepped > 0
    tracked = [v for k, v in got.items() if "num_batches_tracked" in k]
    assert tracked and all(int(v) == 1 for v in tracked)


def test_the_clip_sets_the_update(run):
    """With the clip, a parameter's step is lr * x / (|x| + eps) of its
    clipped gradient x: far below lr where x is below eps.  Without it every
    clear element would step a full lr."""
    model = run[0]
    exp = vehicle_experiment()
    lr = onecycle_schedule(exp.lr, exp.steps)(0)
    start = jax_tree_to_state_dict(model, {"params": run[1]["params"]})
    got = run[3][2]
    grads = run[3][1]
    norm = run[3][0]["grad_norm"]
    for k, g0 in start.items():
        g = grads[k].numpy().astype(np.float64)
        x = g * CLIP / norm
        # AdamW's first step: m / (sqrt(v) + eps) = x / (|x| + eps); the
        # decoupled decay lr * wd * p is below 1e-9 here
        want = g0 - lr * x / (np.abs(x) + 1e-8) \
            - lr * exp.weight_decay * g0
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-7,
                                   rtol=1e-5, err_msg=k)


def test_which_backward_each_attention_took(run):
    assert run[3][3] == {"K5 plain version": 6, "composite": 0}


def test_drop_gate_keeps_at_its_rate_and_scales_by_the_inverse():
    """The port's drop-connect gate: per sample Bernoulli(1 - drop_rate)
    over 1 - drop_rate, drawn from the generator it is given (so the
    rematerialised forward and a second step with a reseeded generator see
    the same gates), None where the block has no skip or is in eval."""
    exp = vehicle_experiment()
    model = pexp.build_model(exp).train()
    blocks = [m for m in model.modules() if isinstance(m, MBConvBlock)]
    gated = [b for b in blocks if b.spec.drop_rate > 0 and b.spec.stride == 1
             and b.spec.in_ch == b.spec.out_ch]
    assert gated and len(gated) < len(blocks)
    block = gated[-1]
    keep = 1.0 - block.spec.drop_rate
    x = torch.zeros(20000, 1, 1, 1)
    gate = block.drop_gate(x, torch.Generator().manual_seed(0))
    assert gate.shape == (20000, 1, 1, 1)
    kept = gate > 0
    assert torch.all(gate[~kept] == 0.0)
    assert torch.allclose(gate[kept], torch.tensor(1.0 / keep))
    rate = float((gate > 0).float().mean())
    # binomial standard deviation of the rate at 20,000 draws: < 0.0035
    assert abs(rate - keep) < 0.015
    again = block.drop_gate(x, torch.Generator().manual_seed(0))
    assert torch.equal(gate, again)
    for b in blocks:
        if b not in gated:
            assert b.drop_gate(x[:4]) is None
    block.eval()
    assert block.drop_gate(x[:4]) is None


def test_benchmark_train_step_at_a_small_config_on_the_cpu():
    """``tools/benchmark.py --train --model sinbevt`` as its main runs it,
    at the small config: the experiment's recipe (one-cycle lr, clip 5.0,
    eps 1e-8, wd 1e-7), labels in the generator's layout, finite loss and
    its two parts, no kernel launched on the CPU; the nuScenes row's batch
    defaults to the experiment's 8."""
    exp = vehicle_experiment()
    opt = benchmark.parse_args(["--train", "--model", "sinbevt", "--iters",
                                "1", "--warmup", "1", "--device", "cpu"])
    assert opt.batch == 8
    opt.batch = 2
    model, batch, key = benchmark.build_sinbevt(config=exp)
    assert tuple(batch["bev"].shape) == (1, 40, 40, 12)
    assert tuple(batch["center"].shape) == (1, 40, 40, 1)
    assert tuple(batch["visibility"].shape) == (1, 40, 40)
    assert set(torch.unique(batch["visibility"]).tolist()) <= set(range(5))
    assert 0.15 < float(batch["bev"].mean()) < 0.25
    row = benchmark.measure_train(model, "sinbevt", batch, opt,
                                  torch.device("cpu"), exp)
    assert row["steps"] == 2 and row["batch"] == 2
    assert row["grad_clip"] == 5.0 and row["clock"] == "host"
    assert row["lr_last"] == pytest.approx(
        onecycle_schedule(5e-3, 50001)(1))
    assert set(row["loss_parts"]) == {"visible", "center"}
    assert np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
    assert "ms_per_step" not in row
    assert not any(row["launches_per_step"].values())
    schedule, wd, eps, clip = benchmark.train_recipe("sinbevt")
    assert (wd, eps, clip) == (1e-7, 1e-8, 5.0)
    assert benchmark.train_recipe("sinbevt_opv2v")[1:] == (1e-2, 1e-10,
                                                           None)
    assert benchmark.parse_args(["--model", "sinbevt"]).batch == 1
    assert benchmark.parse_args(["--train", "--model",
                                 "sinbevt_opv2v"]).batch == 1


def test_gradient_gate_at_a_small_config_on_the_cpu():
    """The SinBEVT gradient gate at the small config: on the CPU the default
    step runs K5's plain version, so against the plain-backward step it
    reads 0 exactly; against the f32 step it reads bf16's drift (at this
    narrow width and random weights up to ~1.3 of a gradient norm, so the
    truth budgets are the small config's own here); no kernel launched."""
    loose = {"truth": {"scalar": 0.2, "param": 3.0}}
    report = validate_kernels.validate_sinbevt_train(
        torch.device("cpu"), seeds=(0,), config=vehicle_experiment(),
        budgets=loose)
    seed = report["per_seed"][0]
    assert report["ok"], report
    assert seed["plain"]["max_rel"] == 0.0
    assert seed["plain"]["max_scalar"] == 0.0
    assert 0.0 < seed["truth"]["max_scalar"] < 0.2
    assert not any(seed["launches"].values())


def test_gradient_gate_trips_on_its_planted_k5_faults():
    """Each planted fault reaches the step's first K5 call (stage 2's grid
    branch, 25 queries here) and moves the plain-backward comparison far
    past its budget: a dropped dq head on stage 2's query projection, the
    rows past Tq on its key and value projections."""
    loose = {"truth": {"scalar": 0.2, "param": 3.0}}
    planted = validate_kernels.validate_sinbevt_train_faults(
        torch.device("cpu"), config=vehicle_experiment(), budgets=loose)
    assert set(planted["faults"]) == set(validate_kernels.SINBEVT_K5_FAULTS)
    assert planted["ok"]
    for name, r in planted["faults"].items():
        assert r["tripped"], name
        hit = {p["name"] for p in r["worst_material_params"]["plain"]}
        want = ("to_q",) if "dq" in name else ("to_k", "to_v")
        assert any("cross_views.2.cross_win_attend_2" in h and
                   any(w in h for w in want) for h in hit), (name, hit)
        assert r["max_max_rel"]["plain"] > 3 * \
            validate_kernels.SINBEVT_TRAIN_BUDGETS["plain"]["param"]


def test_nuscenes_batch_holds_distinct_samples():
    """``build_sinbevt(batch_size=B)`` draws B distinct samples (images and
    labels), the first image the B 1 batch's; ``tile_batch`` leaves a batch
    of B as it is and refuses one of another size."""
    exp = vehicle_experiment()
    _, one, _ = benchmark.build_sinbevt(config=exp)
    _, three, _ = benchmark.build_sinbevt(config=exp, batch_size=3)
    assert all(v.shape[0] == 3 for v in three.values())
    assert torch.equal(three["image"][0], one["image"][0])
    for key in ("image", "bev", "center", "visibility"):
        for i in range(3):
            for j in range(i):
                assert not torch.equal(three[key][i], three[key][j]), key
    assert benchmark.tile_batch(three, 3) is three
    assert benchmark.tile_batch(one, 3)["image"].shape[0] == 3
    with pytest.raises(ValueError):
        benchmark.tile_batch(three, 2)


def test_fused_xattn_gate_at_a_small_config_on_the_cpu():
    """The COBEVT_FUSED_XATTN_TRAIN=1 gate at the small config in f32 (K2's
    plain version on the CPU): the switched step reads f32 rounding against
    the default step, far inside the budgets; a K2 head dropped in stage
    2's local branch moves the train forward's outputs (relative L2) past
    the output budget and trips the gate.  No kernel launched."""
    cpu = torch.device("cpu")
    sound = validate_kernels.validate_sinbevt_xattn_train(
        cpu, seeds=(0,), config=vehicle_experiment(), batch=2, bf16=False)
    seed = sound["per_seed"][0]
    assert sound["ok"], sound
    assert seed["max_output_drift"] < 1e-3
    assert seed["max_scalar"] < 1e-3
    # the default step against a second run of itself: the CPU repeats it
    assert seed["control"] == {"max_scalar": 0.0, "max_material_rel": 0.0,
                               "max_output_drift": 0.0}
    assert not any(seed["launches"].values())
    planted = validate_kernels.validate_sinbevt_xattn_train(
        cpu, seeds=(0,), config=vehicle_experiment(), batch=2, bf16=False,
        fault=True)
    assert not planted["ok"] and planted["fault"] == "k2_dropped_head"
    # 0.47 here in f32, against the sound run's < 1e-3
    assert planted["max_output_drift"] > \
        validate_kernels.SINBEVT_XATTN_TRAIN_BUDGET["output"]
