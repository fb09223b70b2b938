"""``COBEVT_FUSED_XATTN_TRAIN=1``: K2 in the training forward of the port.

The dry-run CorpBEVT config of ``test_torch_train_step.py`` with two cameras
per agent (2 x 2 x 2 = 8 keys a window, which K2's gate takes), B 1, f32 on
the CPU.  With the switch on, the JAX package's training forward takes
``fused_cross_view_attention`` (on the CPU its XLA composite, differentiated
by ``_cva_bwd``) and the port's takes K2's wrapper (on the CPU its plain
version; backward = autograd of the plain composite through K1's and K5's
plain versions).  The same numpy weights and batch go through both; JAX runs
in f64, as in ``test_torch_train_step.py``.

Tolerances: loss 1e-5 rel; gradients 5e-3 of the tensor's largest value plus
1e-3 rel, floor 1e-6 of the model's largest gradient.  That is f32 against
f64 at B 1: the decoder's BatchNorms take their statistics over one map, and
every gradient behind them, the decoder's own included, is 3-4e-3 of its
scale from the f64 one, by the same amount with the switch on or off (the
ratio to the f64 gradient scatters around 1.000 with no offset).  The sharp
check is the port against itself: with the switch on and off its gradients
agree to 5e-4 of the tensor's largest value, the step-1 budget of
``test_torch_train_step.py``: the fused region is the same function.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.losses import VanillaSegLoss as JaxSegLoss
from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.losses import VanillaSegLoss
from cobevt_tpu_torch.models import fax as port_fax
from cobevt_tpu_torch.models.corpbevt import CorpBEVT
from cobevt_tpu_torch.ops.dispatch import env_switches
from cobevt_tpu_torch.ops.fused_cross_attention import (
    cross_view_attention_reference,
    fused_cross_view_attention,
)
from cobevt_tpu_torch.utils.weights import (
    jax_tree_to_state_dict,
    load_jax_variables,
)
from tests.test_torch_train_step import dryrun_config, port_config
from tests.torch_parity import jax_variables

B, L, M, IMG, BEV = 1, 2, 2, 64, 32
SWITCH = "COBEVT_FUSED_XATTN_TRAIN"


def make_batch():
    rng = np.random.RandomState(0)
    intr = np.zeros((B, L, M, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = IMG * 0.9
    intr[..., 0, 2] = intr[..., 1, 2] = IMG / 2
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (B, L, M, 1, 1))
    extr[:, :, 1, 0, 3] = 0.5                    # the second camera is offset
    tmat = np.tile(np.eye(4, dtype=np.float32), (B, L, 1, 1))
    tmat[:, 1, :2, 3] = [1.5, -2.0]
    return {
        "inputs": rng.rand(B, L, M, IMG, IMG, 3).astype(np.float32),
        "intrinsic": intr, "extrinsic": extr, "transformation_matrix": tmat,
        "agent_mask": np.ones((B, L), np.float32),
        "gt_dynamic": rng.randint(0, 2, (B, 1, BEV, BEV)),
    }


@pytest.fixture(scope="module")
def jax_run():
    """Loss and gradients of the JAX training forward with the switch on,
    in f64."""
    jcfg = dryrun_config()
    model = JaxCorpBEVT(jcfg)
    batch = make_batch()
    variables = jax_variables(
        model, {k: jnp.asarray(v) for k, v in batch.items()}, False, seed=3)
    seg = JaxSegLoss(target="dynamic", d_weights=75.0, d_coe=2.0)
    with env_switches(**{SWITCH: "1"}), jax.enable_x64(True):
        jbatch = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                                 else None) for k, v in batch.items()}
        var64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss_fn(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": var64["batch_stats"]}, jbatch,
                True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            return seg(out, {"gt_dynamic": jbatch["gt_dynamic"],
                             "gt_static": jbatch["gt_dynamic"]})[0]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(var64["params"])
        loss, grads = float(loss), jax.tree.map(np.asarray, grads)
    return jcfg, variables, batch, loss, grads


def _port_loss_and_grads(model, tbatch, switch):
    seg = VanillaSegLoss(target="dynamic", d_weights=75.0, d_coe=2.0)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    calls = []
    real = port_fax.fused_cross_view_attention

    def spy(*a, **kw):
        calls.append(kw.get("grid_keys", False))
        return real(*a, **kw)

    port_fax.fused_cross_view_attention = spy
    try:
        with env_switches(**{SWITCH: switch}):
            model.train()
            ops.reset_launch_counts()
            out = model(tbatch)
            loss, _ = seg(out, {"gt_dynamic": tbatch["gt_dynamic"],
                                "gt_static": tbatch["gt_dynamic"]})
            loss.backward()
    finally:
        port_fax.fused_cross_view_attention = real
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.load_state_dict(saved)             # undo the BN statistics update
    return float(loss.detach()), grads, calls


@pytest.fixture(scope="module")
def port_run(jax_run):
    jcfg, variables, batch, _, _ = jax_run
    model = CorpBEVT(port_config(jcfg))
    load_jax_variables(model, variables)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return model, {s: _port_loss_and_grads(model, tbatch, s)
                   for s in ("1", None, "0")}


def test_switch_on_takes_k2_in_training_and_only_then(port_run):
    _, runs = port_run
    # three stages, a local and a grid branch each
    assert runs["1"][2] == [False, True] * 3
    assert runs[None][2] == [] and runs["0"][2] == []
    assert os.environ.get(SWITCH) is None
    # CPU tensors run the plain versions: no launch is counted
    assert ops.launch_counts()["fused_cross_view_attention"] == 0


def test_loss_and_gradients_match_jax_with_the_switch_on(jax_run, port_run):
    model, runs = port_run
    loss, got, _ = runs["1"]
    np.testing.assert_allclose(loss, jax_run[3], rtol=1e-5)
    want = jax_tree_to_state_dict(model, {"params": jax_run[4]})
    largest = max(float(np.abs(g).max()) for g in want.values())
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=5e-3 * scale + 1e-6 * largest,
                                   err_msg=k)


def test_switch_unset_changes_nothing(port_run):
    _, runs = port_run
    assert runs[None][0] == runs["0"][0]
    for k, g in runs[None][1].items():
        assert torch.equal(g, runs["0"][1][k]), k
    # on or off the same function: the step-1 budget between the two
    np.testing.assert_allclose(runs["1"][0], runs["0"][0], rtol=1e-5)
    largest = max(float(g.abs().max()) for g in runs["0"][1].values())
    for k, g in runs["0"][1].items():
        np.testing.assert_allclose(
            runs["1"][1][k].numpy(), g.numpy(), rtol=1e-3, err_msg=k,
            atol=5e-4 * float(g.abs().max()) + 1e-6 * largest)


def _branch_operands(grid_keys, seed=0):
    rng = np.random.RandomState(seed)
    Bb, n, H, W, D, C, hid = 2, 2, 8, 8, 32, 32, 64

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32))

    params = {"ln_q": (t(D) + 1, t(D, scale=0.1)),
              "ln_k": (t(D) + 1, t(D, scale=0.1)),
              "ln_v": (t(D) + 1, t(D, scale=0.1)),
              "wq": t(D, C, scale=0.2), "bq": t(C, scale=0.1),
              "wk": t(D, C, scale=0.2), "bk": t(C, scale=0.1),
              "wv": t(D, C, scale=0.2), "bv": t(C, scale=0.1),
              "wo": t(C, D, scale=0.2), "bo": t(D, scale=0.1)}
    mlp = {"ln": (t(D) + 1, t(D, scale=0.1)), "w1": t(D, hid, scale=0.2),
           "b1": t(hid, scale=0.1), "w2": t(hid, D, scale=0.2),
           "b2": t(D, scale=0.1)}
    post_ln = (t(D) + 1, t(D, scale=0.1)) if grid_keys else None
    x, key, val = t(Bb, H, W, D), t(Bb, n, 4, 4, D), t(Bb, n, 4, 4, D)
    embeds = (None, None) if grid_keys else (t(H, W, D), t(Bb, n, D))
    return x, embeds, key, val, params, mlp, post_ln


@pytest.mark.parametrize("grid_keys", [False, True])
def test_wrapper_gradients_equal_autograd_of_the_plain_version(grid_keys):
    """The autograd function's backward (composite through the packed
    attention's own backward) against stock autograd through the plain
    version, every operand and parameter: 1e-4 (f32, two formulations of the
    softmax backward, gradients of order 1)."""
    from torch.utils._pytree import tree_flatten
    x, (w_embed, c_embed), key, val, params, mlp, post_ln = \
        _branch_operands(grid_keys)
    leaves = [t for t in tree_flatten(
        ((x, w_embed, c_embed, key, val), params, mlp, post_ln))[0]
        if t is not None]
    for leaf in leaves:
        leaf.requires_grad_(True)
    kw = dict(q_win=(4, 4), k_win=(2, 2), n_heads=2, scale=0.25,
              grid_keys=grid_keys)
    g = torch.from_numpy(np.random.RandomState(1).randn(*x.shape)
                         .astype(np.float32))
    out = fused_cross_view_attention(x, w_embed, c_embed, key, val, params,
                                     mlp=mlp, post_ln=post_ln, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    ref = cross_view_attention_reference(x, w_embed, c_embed, key, val,
                                         params, mlp=mlp, post_ln=post_ln,
                                         **kw)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    want = torch.autograd.grad(ref, leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        assert fused_cross_view_attention(
            x, w_embed, c_embed, key, val, params, mlp=mlp, post_ln=post_ln,
            **kw).grad_fn is None
