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
sharded step is.  Its random draws (dropout, drop-connect) take each rank's
part of the global batch's (``parallel/distributed.py:draw_layout``).

On a ("data", "model") mesh (``parallel/mesh.py``) the state is placed first
(:func:`place_state`: tensor-parallel weights hold a rank's block), the
batch is a rank's part (``shard_batch`` or ``cooperative_batch_sharding``),
and the step sums a replicated gradient over every rank and a sharded one
over "data", both divided by the world (``parallel/mesh.py`` says why).
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Callable, Optional

import torch

from cobevt_tpu_torch.parallel import mesh as tp
from cobevt_tpu_torch.parallel.distributed import (
    DrawLayout,
    all_reduce_mean_,
    broadcast_module_,
    draw_layout,
    rank,
    rank_mean_scope,
    world_size,
)
from cobevt_tpu_torch.train.state import TrainState, _share_norm_statistics


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (the JAX
    ``optax_global_norm``), in f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _placed_optimizer(optimizer, old: torch.nn.Module, new: torch.nn.Module,
                      mesh, specs: dict):
    """An optimizer of ``optimizer``'s class and hyperparameters over
    ``new``'s parameters (``old``'s, placed), its moments cut to each
    parameter's block, all fresh tensors."""
    named = list(old.named_parameters())
    index = {id(p): i for i, (_, p) in enumerate(named)}
    params = list(new.parameters())
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [params[index[id(p)]] for p in g["params"]]}
              for g in optimizer.param_groups]
    accepted = inspect.signature(type(optimizer)).parameters
    placed = type(optimizer)(groups, **{k: v for k, v in
                                        optimizer.defaults.items()
                                        if k in accepted})
    saved = optimizer.state_dict()
    order = [index[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    state = {}
    for key, moments in saved["state"].items():
        name, param = named[order[key]]
        state[key] = {}
        for k, v in moments.items():
            if torch.is_tensor(v):
                v = (tp.local_part(v, mesh, specs[name])
                     if v.shape == param.shape else v).clone()
            state[key][k] = v
    placed.load_state_dict({"state": state,
                            "param_groups": saved["param_groups"]})
    return placed


def place_state(state: TrainState, mesh, use_tp: bool = True) -> TrainState:
    """The state on ``mesh``: a new state whose master parameters, AdamW
    moments and compute twin follow ``parallel/mesh.py:param_sharding``
    (each tensor-parallel weight this rank's block of it, in a
    ``ShardedLinear``) and whose BatchNorm statistics and step stay whole;
    every tensor fresh (the JAX package's ``place_state``, whose
    ``_fresh_put`` never aliases).  Every rank takes rank 0's parameters
    and statistics first, so all place one state.  A collective: every
    rank calls it."""
    model = copy.deepcopy(state.model)
    broadcast_module_(model)
    specs = tp.param_sharding(mesh, model, use_tp)
    tp.parallelize_(model, specs, mesh)
    optimizer = _placed_optimizer(state.optimizer, state.model, model, mesh,
                                  specs)
    compute = model
    if state.compute_model is not state.model:
        dtype = next(state.compute_model.parameters()).dtype
        compute = copy.deepcopy(model).to(dtype)
        _share_norm_statistics(model, compute)
    return dataclasses.replace(state, model=model, optimizer=optimizer,
                               compute_model=compute, mesh=mesh)


def full_state_dict(state: TrainState) -> dict:
    """The master module's whole state_dict (every sharded weight gathered:
    a collective), as the unplaced state holds it: what reading a sharded
    JAX array gives, and what a checkpoint writes."""
    return tp.full_state_dict(state.model)


def _mesh_layout(mesh, batch) -> DrawLayout:
    data, model = mesh.get_coordinate()
    return DrawLayout(tp.axis_size(mesh, "data"), data,
                      tp.axis_size(mesh, "model"), model,
                      tp.agents_split(batch))


def _agent_axis_forward(compute, batch, generator, mesh):
    """The forward of a batch whose agent axis is split over "model":
    ``stage="encode"`` on this rank's agents (with whole weights, since the
    "model" ranks hold different agents), their BEV maps gathered over
    "model", and ``stage="fuse"`` on every agent on each "model" rank."""
    axis = tp.mesh_axis(mesh, "model")
    with tp.whole_weights():
        bev = compute(batch, stage="encode", generator=generator)
    tail = {k: tp.gather(batch[k], 1, axis)
            if isinstance(batch.placements[k][1], tp.Shard) else batch[k]
            for k in ("transformation_matrix", "agent_mask")}
    return compute(tail, stage="fuse", agent_bev=tp.gather(bev, 1, axis),
                   generator=generator)


def _reduce_mesh_gradients(grads, sharded, mesh):
    """The global batch's gradients (module docstring of
    ``parallel/mesh.py``) and their global norm: the squares of the
    sharded blocks summed over "model" once, never over "data"."""
    world = world_size()
    rep = [g for g, s in zip(grads, sharded) if not s]
    blocks = [g for g, s in zip(grads, sharded) if s]
    all_reduce_mean_(rep)
    all_reduce_mean_(blocks, group=mesh.get_group("data"), divisor=world)
    squares = global_norm(rep) ** 2
    if blocks:
        block_squares = global_norm(blocks) ** 2
        torch.distributed.all_reduce(block_squares,
                                     group=mesh.get_group("model"))
        squares = squares + block_squares
    return torch.sqrt(squares)


def make_train_step(model, criterion: Callable, mesh=None,
                    log_grad_norm: bool = True):
    """Build ``step(state, batch, generator=None) -> logs`` for the state
    whose master module is ``model`` (with a ``mesh``, the placed state's:
    :func:`place_state`).

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
    and its parts are the means over the ranks (module docstring).  On a
    mesh ``batch`` is this rank's part of the global batch, and a
    ``cooperative_batch_sharding`` whose agents are split runs the agent
    axis (:func:`_agent_axis_forward`)."""
    synced = []

    def step(state: TrainState, batch,
             generator: Optional[torch.Generator] = None):
        if state.model is not model:
            raise ValueError("this step was made for another model")
        if state.mesh is not mesh:
            raise ValueError("the state is not placed on this step's mesh "
                             "(train/step.py:place_state)")
        world = world_size()
        if world > 1 and mesh is None and not synced:
            broadcast_module_(state.model)
            state.refresh_compute_model()
            synced.append(True)
        layout = None
        if mesh is not None:
            layout = _mesh_layout(mesh, batch)
        elif world > 1:
            layout = DrawLayout(world, rank())
        compute = state.compute_model
        compute.train()
        with draw_layout(layout):
            if layout is not None and layout.agents_split:
                out = _agent_axis_forward(compute, batch, generator, mesh)
            else:
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
            norm = None
            if mesh is not None:
                ids = tp.sharded_parameter_ids(state.model)
                norm = _reduce_mesh_gradients(
                    grads, [id(p) in ids for p in masters], mesh)
            else:
                all_reduce_mean_(grads)
            for p, g in zip(masters, grads):
                p.grad = g
            if norm is None and (log_grad_norm
                                 or state.grad_clip is not None):
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
    compute module in eval mode under ``torch.no_grad()``.  On a placed
    state it runs a copy of the compute module with every sharded weight
    gathered whole (a collective: every rank calls it; the eval kernels
    pack whole weights), on the whole ``batch``, and returns what the
    unplaced state returns."""
    whole = {}

    @torch.no_grad()
    def step(state: TrainState, batch):
        if state.model is not model:
            raise ValueError("this step was made for another model")
        compute = state.compute_model
        if tp.sharded_parameter_ids(compute):
            if whole.get("source") is not compute:
                whole.update(source=compute,
                             module=tp.unsharded_copy(compute))
            whole["module"].load_state_dict(tp.full_state_dict(compute))
            compute = whole["module"]
        compute.eval()
        out = compute(batch)
        if criterion is None:
            return out, None
        loss, parts = criterion(out, batch)
        parts = dict(parts)
        parts["loss"] = loss
        return out, parts

    return step
