"""The port's schedule and AdamW against optax, on numpy parameters.

The schedule is compared value for value (1e-6 rel, plus 1e-6 of the base
lr where optax's f32 cosine cancels near its end: the same closed form in
f64).  Three AdamW steps with the schedule, weight decay
1e-2 and eps 1e-10 match ``optax.adamw`` to 1e-6: both decay decoupled and
put eps outside the root; the first update uses ``schedule(0)``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import optax
import torch

from cobevt_tpu.train import optim as jo
from cobevt_tpu_torch.train import optim as po
from cobevt_tpu_torch.train.state import create_train_state
from cobevt_tpu_torch.train.step import global_norm, make_train_step


@pytest.mark.parametrize("args", [
    (2e-4, 2e-5, 10, 100, 0.0),       # the dry-run recipe
    (2e-4, 2e-5, 10, 100, 5e-6),      # corpbevt.yaml has lr_min
    (1e-3, 0.0, 0, 20, 0.0),          # no warmup
])
def test_cosine_warmup_schedule_matches_optax(args):
    want = jo.cosine_warmup_schedule(*args)
    got = po.cosine_warmup_schedule(*args)
    for step in list(range(0, 25)) + [50, 99, 100, 101, 500]:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-6 * args[0], err_msg=str(step))


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.ps = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays])

    def forward(self, batch, generator=None):
        return self.ps


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_three_adamw_steps_match_optax(grad_clip):
    rng = np.random.RandomState(0)
    arrays = [rng.randn(4, 3).astype(np.float32),
              rng.randn(5).astype(np.float32) * 10,
              rng.randn(2, 2, 2).astype(np.float32) * 1e-3]
    targets = [rng.randn(*a.shape).astype(np.float32) for a in arrays]
    sched_args = (2e-2, 2e-3, 2, 10)

    # optax side
    tx = jo.make_optimizer(jo.cosine_warmup_schedule(*sched_args),
                           weight_decay=1e-2, eps=1e-10, grad_clip=grad_clip)
    params = [jnp.asarray(a) for a in arrays]
    opt_state = tx.init(params)
    want_norms = []
    for _ in range(3):
        grads = [2 * (p - jnp.asarray(t)) for p, t in zip(params, targets)]
        want_norms.append(float(optax.global_norm(grads)))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    # port side, through the train step
    model = _Params(arrays)
    schedule = po.cosine_warmup_schedule(*sched_args)
    state = create_train_state(
        model, po.make_optimizer(model.parameters(), schedule), schedule,
        grad_clip=grad_clip)

    def criterion(ps, batch):
        loss = sum(((p - torch.from_numpy(t)) ** 2).sum()
                   for p, t in zip(ps, targets))
        return loss, {}

    step = make_train_step(model, criterion)
    for i in range(3):
        logs = step(state, None)
        np.testing.assert_allclose(float(logs["grad_norm"]), want_norms[i],
                                   rtol=1e-5)
    assert state.step == 3
    assert state.optimizer.param_groups[0]["lr"] == schedule(2)
    for got, want in zip(model.ps, params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def test_global_norm_and_optimizer_constants():
    ts = [torch.full((3,), 2.0), torch.full((2, 2), -1.0)]
    assert float(global_norm(ts)) == pytest.approx(4.0)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = po.make_optimizer([p], po.constant_schedule(2e-4))
    g = opt.param_groups[0]
    assert (g["lr"], g["eps"], g["weight_decay"], g["betas"]) == (
        2e-4, 1e-10, 1e-2, (0.9, 0.999))
