"""Optimizer and LR schedule of the OPV2V recipe.

Counterpart of ``cobevt_tpu/train/optim.py``: AdamW(lr 2e-4, eps 1e-10,
wd 1e-2) with a cosine anneal after a linear warmup (reference
``train_utils.py:174-258``, ``corpbevt.yaml:125-137``).  A schedule is a
plain function step -> lr, counted from 0 as optax counts: the first
update uses ``schedule(0)``.  The train step sets the optimizer's ``lr``
from it before every update.  The nuScenes one-cycle schedule comes with
its slice.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def cosine_warmup_schedule(base_lr: float, warmup_lr: float,
                           warmup_steps: int, total_steps: int,
                           lr_min: float = 0.0) -> Callable[[int], float]:
    """Linear warmup from warmup_lr to base_lr over ``warmup_steps``, then
    a cosine to lr_min over the remaining steps, constant after (the
    values of ``optax.join_schedules([linear, cosine_decay],
    [warmup_steps])``)."""
    ramp = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)
    alpha = lr_min / base_lr if base_lr > 0 else 0.0

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = min(step, ramp) / ramp
            return warmup_lr + (base_lr - warmup_lr) * frac
        count = min(step - warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   schedule: Callable[[int], float],
                   weight_decay: float = 1e-2,
                   eps: float = 1e-10) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with the recipe's constants.  Like
    ``optax.adamw`` it decays decoupled and adds eps outside the root of the
    bias-corrected second moment, so the two take the same steps.  On the
    card the update of all parameters is PyTorch's one fused launch.  The
    optional global-norm clip of the JAX ``make_optimizer`` is the train
    state's ``grad_clip``."""
    params = list(params)
    return torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                             eps=eps, weight_decay=weight_decay,
                             fused=all(p.is_cuda for p in params))
