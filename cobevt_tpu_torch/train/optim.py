"""Optimizers and LR schedules of the two recipes.

Counterpart of ``cobevt_tpu/train/optim.py``:

  * OPV2V: AdamW(lr 2e-4, eps 1e-10, wd 1e-2) with a cosine anneal after a
    linear warmup (reference ``train_utils.py:174-258``,
    ``corpbevt.yaml:125-137``);
  * nuScenes: AdamW(lr 5e-3, eps 1e-8, wd 1e-7), a one-cycle schedule and a
    global-norm clip of 5.0 (reference ``model_module.py:85-94``,
    ``config.yaml:20-31``; the clip is the train state's ``grad_clip``).

A schedule is a plain function step -> lr, counted from 0 as optax counts:
the first update uses ``schedule(0)``.  The train step sets the
optimizer's ``lr`` from it before every update.
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


def onecycle_schedule(max_lr: float, total_steps: int,
                      pct_start: float = 0.3, div_factor: float = 10.0,
                      final_div_factor: float = 10.0
                      ) -> Callable[[int], float]:
    """The values of ``optax.cosine_onecycle_schedule(total_steps, max_lr,
    pct_start, div_factor, final_div_factor)``: a cosine from max_lr /
    div_factor up to max_lr over the first ``int(pct_start * total_steps)``
    steps, then a cosine down to max_lr / (div_factor * final_div_factor)
    at ``total_steps``, constant after.  Not ``torch.optim.lr_scheduler.
    OneCycleLR``, whose phases end one step earlier (at ``pct_start *
    total_steps - 1`` and ``total_steps - 1``) and whose final value is
    the initial one over ``final_div_factor`` of its own."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    init = max_lr / div_factor
    values = (init, init * div_factor,
              init * div_factor / (div_factor * final_div_factor))

    def schedule(step: int) -> float:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= step < hi:
                start, end = values[i], values[i + 1]
                pct = (step - lo) / (hi - lo)
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1.0)
        # before the first boundary the sum of optax's indicators is 0 (a
        # negative step); at and past the last one the final value
        return values[2] if step >= bounds[2] else 0.0

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
