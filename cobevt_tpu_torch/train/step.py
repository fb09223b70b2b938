"""Train and eval steps.

Counterpart of ``cobevt_tpu/train/step.py``: forward, loss, backward and
the optimizer update of one batch.  The JAX step is one jitted program over
a device mesh, with sharded inputs and a donated state; here the step runs
eagerly and updates the state in place.  Data parallelism is one process
a GPU (``parallel/distributed.py``), each on its shard of the global
batch: where the process group has more than one rank the step broadcasts
rank 0's weights and BatchNorm statistics before its first update, takes
the batch statistics over every rank (``nn/layers.py:BatchNorm2d``) and
the loss's normalisers too (its criterion runs inside
``parallel/distributed.py:rank_mean_scope``), averages the f32 gradients
over the ranks before the global-norm clip, and logs the mean of the
ranks' losses: the step of one process on the global batch, as the JAX
sharded step is.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cobevt_tpu_torch.parallel.distributed import (
    all_reduce_mean_,
    broadcast_module_,
    rank_mean_scope,
    world_size,
)
from cobevt_tpu_torch.train.state import TrainState


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (the JAX
    ``optax_global_norm``), in f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(model, criterion: Callable, log_grad_norm: bool = True):
    """Build ``step(state, batch, generator=None) -> logs`` for the state
    whose master module is ``model``.

    ``criterion(output, batch) -> (loss, parts_dict)``.  The step runs the
    state's compute module in train mode (``generator`` draws its
    attention-dropout mask), takes the gradients in f32, clips them by
    global norm when the state asks for it (``optax.clip_by_global_norm``:
    scaled by clip/norm when the norm exceeds the clip), sets the lr of
    update ``state.step`` and applies AdamW to the f32 master parameters.
    A parameter the loss does not reach has a zero gradient and still
    decays, as in optax.  ``logs`` holds ``loss``, the loss parts and, with
    ``log_grad_norm``, ``grad_norm`` (before clipping), as 0-d tensors.
    Under a process group of several ranks the gradients, the logged loss
    and its parts are the means over the ranks (module docstring)."""
    synced = []

    def step(state: TrainState, batch,
             generator: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("this step was made for another model")
        world = world_size()
        if world > 1 and not synced:
            broadcast_module_(state.model)
            state.refresh_compute_model()
            synced.append(True)
        compute = state.compute_model
        compute.train()
        out = compute(batch, generator=generator)
        with rank_mean_scope():
            loss, parts = criterion(out, batch)
        loss.backward()

        masters = state.params
        with torch.no_grad():
            twin_grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                          for t in state.compute_params]
            if compute is model:
                grads = twin_grads
            else:
                # one fused cast of the twin's gradients to f32
                grads = [torch.empty_like(p) for p in masters]
                torch._foreach_copy_(grads, twin_grads)
                compute.zero_grad(set_to_none=True)
            # the global batch's gradient: the mean of the ranks' f32
            # gradients, before the clip reads its norm
            all_reduce_mean_(grads)
            for p, g in zip(masters, grads):
                p.grad = g
            norm = None
            if log_grad_norm or state.grad_clip is not None:
                norm = global_norm(grads)
            if state.grad_clip is not None:
                scale = torch.where(norm < state.grad_clip,
                                    torch.ones_like(norm),
                                    state.grad_clip / norm)
                torch._foreach_mul_(grads, scale)
            lr = state.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.refresh_compute_model()
            state.step += 1
        logs = {k: v.detach() for k, v in parts.items()}
        logs["loss"] = loss.detach()
        if world > 1:
            keys = list(logs)
            means = all_reduce_mean_([torch.stack(
                [logs[k].float().reshape(()) for k in keys])])[0]
            logs = dict(zip(keys, means.unbind()))
        if log_grad_norm:
            logs["grad_norm"] = norm
        return logs

    return step


def make_eval_step(model, criterion: Optional[Callable] = None):
    """Build ``step(state, batch) -> (outputs, loss_parts | None)``: the
    compute module in eval mode under ``torch.no_grad()``."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        if state.model is not model:
            raise ValueError("this step was made for another model")
        compute = state.compute_model
        compute.eval()
        out = compute(batch)
        if criterion is None:
            return out, None
        loss, parts = criterion(out, batch)
        parts = dict(parts)
        parts["loss"] = loss
        return out, parts

    return step
