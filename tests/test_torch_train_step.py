"""One and two CorpBEVT train steps of the port against the JAX step.

The dry-run config of ``__graft_entry__.py:dryrun_multichip`` (ResNet-18,
64^2 images, 2 agents x 1 camera, BEV 32^2, FAX dim 32 with head dim 16,
fusion head dim 8, all dropouts 0), B 2, f32 on the CPU, no mesh.  The
same numpy weights, BatchNorm statistics, images and labels go through
``cobevt_tpu.train.make_train_step`` and the port's.  Compared after each
step: loss, global gradient norm, every gradient, every updated parameter
and the BatchNorm statistics.

Which backward each attention takes at this config (asserted below): the
FAX self-attention (16 queries and keys, head dim 16) passes the port's K5
gate and takes K5's plain version; the six cross-view attentions (4 keys:
not a multiple of 8) and the two fusion attentions (head dim 8) take the
composite backward.  JAX on the CPU takes its XLA branch for all nine; in
f32 the formulations agree to rounding.

The JAX step runs in f64 (``jax.enable_x64``), the port in f32: XLA's CPU
reductions add f32 values one after another, and over the 10^3..10^5
elements of a BatchNorm backward that leaves its f32 gradients ~1e-2 of
their scale from the f64 result, where the port's are ~1e-4 from it.  So
the f64 run is the oracle that can tell a wrong backward from rounding.

Tolerances.  Step 1: loss 1e-5 rel, gradient norm 1e-4 rel; gradients 5e-4
of the tensor's largest value plus 1e-3 rel (f32 against f64 through
ResNet-18 and nine attentions), with a floor of 1e-6 of the largest
gradient of the model for tensors that are rounding noise around zero (a
key-projection bias, a conv bias before BatchNorm); BatchNorm statistics
1e-5.  AdamW divides a gradient by its own magnitude, so an element whose
gradient is noise may step +lr on one side and -lr on the other: updated
parameters agree to 1e-6 where every gradient so far exceeds 1e-3 of its
tensor's largest and 1e-6 of the model's largest, and to twice the summed
learning rates elsewhere.  Step 2 starts from parameters that differ by
those +-lr elements, and the gradients answer to that: loss 1e-4 rel,
gradient norm 2e-3 rel, gradients 1e-1 of the tensor's largest, updated
parameters 2e-5 (half of step 2's learning rate) on 99.9% of the clear
elements (a gradient that moved by a tenth of its tensor's largest can
change sign).  Step 1 is the sharp check.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.losses import VanillaSegLoss as JaxSegLoss
from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT
from cobevt_tpu.models.corpbevt import CorpBEVTConfig as JaxCorpBEVTConfig
from cobevt_tpu.models.fax import FAXConfig as JaxFAXConfig
from cobevt_tpu.train import TrainState as JaxTrainState
from cobevt_tpu.train import make_train_step as jax_make_train_step
from cobevt_tpu.train.optim import cosine_warmup_schedule as jax_schedule
from cobevt_tpu.train.optim import make_optimizer as jax_make_optimizer
from cobevt_tpu_torch.losses import VanillaSegLoss
from cobevt_tpu_torch.models.corpbevt import CorpBEVT, CorpBEVTConfig
from cobevt_tpu_torch.models.fax import FAXConfig
from cobevt_tpu_torch.ops import window_attention as pwa
from cobevt_tpu_torch.tools import benchmark
from cobevt_tpu_torch.train import (
    cosine_warmup_schedule,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from cobevt_tpu_torch.utils.weights import (
    jax_tree_to_state_dict,
    load_jax_variables,
)
from tests.torch_parity import jax_variables

SCHEDULE = (2e-4, 2e-5, 10, 100)
B, L, M, IMG, BEV = 2, 2, 1, 64, 32


def dryrun_config():
    fax = JaxFAXConfig(
        dim=(32, 32, 32), middle=(1, 1, 1), image_height=64, image_width=64,
        heads=(2, 2, 2), dim_head=(16, 16, 16),
        q_win_size=((4, 4), (4, 4), (4, 4)),
        feat_win_size=((2, 2), (2, 2), (2, 2)),
        bev_embedding_flag=(True, False, False), bev_height=32, bev_width=32,
        upsample_scales=(2, 4, 8), self_attn_dim_head=16,
        self_attn_dropout=0.0, self_attn_window=4)
    return JaxCorpBEVTConfig(
        max_cav=2, target="dynamic", encoder_num_layers=18,
        encoder_id_pick=(1, 2, 3), image_height=64, image_width=64, fax=fax,
        sttf_resolution=0.8, sttf_downsample_rate=4, use_roi_mask=True,
        fusion_mlp_dim=32, fusion_window_size=2, fusion_dim_head=8,
        fusion_dropout=0.0, fusion_depth=1, fusion_mask=True,
        decoder_num_layer=3, decoder_num_ch=(16, 24, 32), seg_head_dim=16,
        output_class=2)


def port_config(jcfg) -> CorpBEVTConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "fax"
              and f.name in {g.name for g in
                             dataclasses.fields(CorpBEVTConfig)}}
    return CorpBEVTConfig(**fields,
                          fax=FAXConfig(**dataclasses.asdict(jcfg.fax)))


def make_batch():
    rng = np.random.RandomState(0)
    intr = np.zeros((B, L, M, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = IMG * 0.9
    intr[..., 0, 2] = intr[..., 1, 2] = IMG / 2
    intr[..., 2, 2] = 1.0
    tmat = np.tile(np.eye(4, dtype=np.float32), (B, L, 1, 1))
    tmat[:, 1, :2, 3] = [1.5, -2.0]              # the second agent is shifted
    return {
        "inputs": rng.rand(B, L, M, IMG, IMG, 3).astype(np.float32),
        "intrinsic": intr,
        "extrinsic": np.tile(np.eye(4, dtype=np.float32), (B, L, M, 1, 1)),
        "transformation_matrix": tmat,
        "agent_mask": np.ones((B, L), np.float32),
        "gt_dynamic": rng.randint(0, 2, (B, 1, BEV, BEV)),
    }


def _jax_steps(model, variables, batch, float_dtype):
    jbatch = {k: jnp.asarray(v, float_dtype if v.dtype == np.float32
                             else None) for k, v in batch.items()}
    variables = jax.tree.map(lambda a: jnp.asarray(a, float_dtype),
                             variables)
    seg = JaxSegLoss(target="dynamic", d_weights=75.0, d_coe=2.0)

    def criterion(out, b):
        return seg(out, {"gt_dynamic": b["gt_dynamic"],
                         "gt_static": b["gt_dynamic"]})

    tx = jax_make_optimizer(jax_schedule(*SCHEDULE), weight_decay=1e-2,
                            eps=1e-10)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx)
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
    """Two steps of the JAX train step from seeded numpy variables, run in
    f64 (``enable_x64``): the variables, and per step the logs, gradients,
    new params and batch_stats, all as numpy."""
    jcfg = dryrun_config()
    model = JaxCorpBEVT(jcfg)
    batch = make_batch()
    variables = jax_variables(
        model, {k: jnp.asarray(v) for k, v in batch.items()}, False, seed=3)
    with jax.enable_x64(True):
        steps = _jax_steps(model, variables, batch, jnp.float64)
    return jcfg, variables, batch, steps


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The same two steps in the port; per step the logs, the gradients
    (from a copy of the state before the step), the state_dict after, and
    which backward each attention took."""
    jcfg, variables, batch, _ = jax_run
    model = CorpBEVT(port_config(jcfg))
    load_jax_variables(model, variables)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    seg = VanillaSegLoss(target="dynamic", d_weights=75.0, d_coe=2.0)

    def criterion(out, b):
        return seg(out, {"gt_dynamic": b["gt_dynamic"],
                         "gt_static": b["gt_dynamic"]})

    schedule = cosine_warmup_schedule(*SCHEDULE)
    state = create_train_state(
        model, make_optimizer(model.parameters(), schedule), schedule)
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
            # a parameter the loss does not reach: zero, as in JAX
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
    return model, state, tbatch, criterion, steps


# per step: loss rtol, grad-norm rtol, gradient atol (share of the tensor's
# largest), updated-parameter atol on clear elements
STEP_TOL = [dict(loss=1e-5, gnorm=1e-4, grad=5e-4, param=1e-6),
            dict(loss=1e-4, gnorm=2e-3, grad=1e-1, param=2e-5)]


def _jax_grads(jax_run, model, i):
    """Step i's JAX gradients keyed like the port's, and their largest."""
    grads = jax_tree_to_state_dict(model, {"params": jax_run[3][i]["grads"]})
    return grads, max(float(np.abs(g).max()) for g in grads.values())


@pytest.mark.parametrize("i", [0, 1])
def test_loss_and_grad_norm_match(jax_run, port_run, i):
    want, got = jax_run[3][i]["logs"], port_run[4][i]["logs"]
    assert set(got) == set(want)
    for k in want:
        rtol = STEP_TOL[i]["gnorm" if k == "grad_norm" else "loss"]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)
    assert port_run[1].step == 2


@pytest.mark.parametrize("i", [0, 1])
def test_every_gradient_matches(jax_run, port_run, i):
    model = port_run[0]
    want, largest = _jax_grads(jax_run, model, i)
    got = port_run[4][i]["grads"]
    assert set(got) == set(want) == {k for k, _ in model.named_parameters()}
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(
            got[k].numpy(), want[k], rtol=1e-3, err_msg=k,
            atol=STEP_TOL[i]["grad"] * scale + 1e-6 * largest)


@pytest.mark.parametrize("i", [0, 1])
def test_updated_parameters_and_batch_stats_match(jax_run, port_run, i):
    model = port_run[0]
    schedule = cosine_warmup_schedule(*SCHEDULE)
    lr_sum = sum(schedule(s) for s in range(i + 1))
    want = jax_tree_to_state_dict(
        model, {"params": jax_run[3][i]["params"],
                "batch_stats": jax_run[3][i]["batch_stats"]})
    got = port_run[4][i]["state"]
    names = {k for k, _ in model.named_parameters()}
    assert set(want) == {k for k in got if "num_batches_tracked" not in k}
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
        assert close.sum() >= (1.0 if i == 0 else 0.999) * close.size, k
    tracked = [v for k, v in got.items() if "num_batches_tracked" in k]
    assert tracked and all(int(v) == i + 1 for v in tracked)


def test_which_backward_each_attention_took(port_run):
    for s in port_run[4]:
        assert s["taken"] == {"K5 plain version": 1, "composite": 8}


def test_eval_step_and_synthetic_criterion(jax_run, port_run):
    model, state, tbatch, criterion, _ = port_run
    out, parts = make_eval_step(model, criterion)(state, tbatch)
    assert not model.training
    assert tuple(out["dynamic_seg"].shape) == (B, 1, BEV, BEV, 2)
    assert np.isfinite(float(parts["loss"]))
    assert not out["dynamic_seg"].requires_grad
    # the benchmark tool's label shape is the model's output shape
    assert benchmark.output_hw(model.config) == (BEV, BEV)
    crit, train_batch = benchmark.make_criterion(
        "corpbevt", model, {k: v[:1] for k, v in tbatch.items()
                            if k != "gt_dynamic"})
    assert tuple(train_batch["gt_dynamic"].shape) == (1, 1, BEV, BEV)
    tiled = benchmark.tile_batch(train_batch, B)
    loss, _ = crit(out, tiled)
    assert np.isfinite(float(loss))
