"""Device mesh: data parallel x tensor parallel over ("data", "model").

Counterpart of ``cobevt_tpu/parallel/mesh.py``.  The JAX package places
the train state and the batch on a 2D ``jax.sharding.Mesh`` and XLA
inserts every collective.  Here one process holds one device of a
``torch.distributed.device_mesh.DeviceMesh`` with the same two axes (rank
``r`` at ``(r // n_model, r % n_model)``, the JAX package's device order),
and the collectives are explicit:

  * the global batch is split over "data" (:func:`shard_batch`), or over
    "data" and its agent axis over "model" (:func:`cooperative_batch_sharding`,
    where the agent count divides);
  * the projections named in ``_COL_SHARDED`` / ``_ROW_SHARDED`` keep one
    block of their weight a "model" rank (:func:`param_sharding`, Megatron's
    paired column / row splits, with the JAX package's fallback to
    replication where an axis does not divide): :class:`ShardedLinear`.  A
    column-parallel layer whose owner says its output may stay split
    (``tp_local_columns``: the heads of a cross-view attention, the hidden
    features of an MLP) computes its own output columns, and its row-parallel
    partner adds its partial product over "model" in one all-reduce; every
    other column-parallel layer (the packed ``to_qkv``, whose split does not
    fall on head boundaries) gathers its weight first, as XLA reshards it.

How the gradients come out right.  Every collective here is a sum whose
backward is its adjoint (a gather's is a sum over the group, an all-reduce's
an all-reduce), so one rank's backward gives its share of the gradient of
the sum of every rank's loss.  The "model" ranks of a data shard compute the
same loss (the tail after the row layers, and the cooperative tail on the
agent axis, is replicated), so ``train/step.py`` sums a replicated
parameter's gradient over every rank, a sharded one over "data", and divides
both by the world: the gradient of one process on the global batch.

BatchNorm takes its statistics over every rank (``nn/layers.py``), as under
the JAX package's sharded step: on the agent axis over data x model, and
elsewhere over copies that are equal across "model".  Collectives are built
from ``all_reduce`` alone (gloo takes it for CUDA tensors), half types
summed in f32.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

try:
    from torch.distributed.tensor import Replicate, Shard
except ImportError:                                     # torch < 2.5
    from torch.distributed._tensor import Replicate, Shard

from cobevt_tpu_torch.parallel.distributed import all_reduce_sum
from cobevt_tpu_torch.utils.weights import _default_rename

# Dense kernels sharded column-wise (output features) over "model", by
# their flax names (a port state_dict path renamed as the weight bridge
# renames it: ``to_q.1`` is ``to_q_1``)
_COL_SHARDED = ("to_qkv", "to_q_1", "to_k_1", "to_v_1", "net_0", "mlp_1_0",
                "mlp_2_0")
# Dense kernels sharded row-wise (input features): the paired projection
_ROW_SHARDED = ("proj", "to_out_0", "net_3", "mlp_1_2", "mlp_2_2")

# arrays in a cooperative batch that carry the agent axis at dim 1
_AGENT_AXIS_KEYS = ("inputs", "intrinsic", "extrinsic",
                    "transformation_matrix", "agent_mask",
                    "voxel_features", "voxel_num_points", "voxel_coords",
                    "voxel_mask")

AXES = ("data", "model")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: Optional[str] = None):
    """A ("data", "model") ``DeviceMesh`` over the default group's ranks
    (``n_data`` defaults to the world over ``n_model``).  On the card
    unless ``device_type`` names "cpu"; without a card "cuda" raises."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(parallel/distributed.py:"
                           "maybe_initialize_distributed)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh over {world} ranks")
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (device_type='cpu' "
                           "builds a mesh of CPU processes)")
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=AXES)


class MeshAxis:
    """One axis of a mesh as this rank sees it: the group of ranks along
    it, this rank's ``index`` there and the axis ``size``.  Shared, never
    copied, by a ``copy.deepcopy`` of a module that holds it."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size

    def __deepcopy__(self, memo):
        return self


def axis_size(mesh, name: str) -> int:
    return int(mesh.mesh.shape[AXES.index(name)])


def mesh_axis(mesh, name: str) -> MeshAxis:
    return MeshAxis(mesh.get_group(name), mesh.get_local_rank(name),
                    axis_size(mesh, name))


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# --- placements -------------------------------------------------------------

def batch_sharding(mesh):
    """The placement of a batch array: its leading axis over "data", the
    same on each "model" rank (one placement per mesh axis)."""
    return (Shard(0), Replicate())


def replicated(mesh):
    return (Replicate(), Replicate())


def local_part(value, mesh, placements) -> torch.Tensor:
    """This rank's block of a whole tensor under ``placements``."""
    value = torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value)
    for axis, place in zip(AXES, placements):
        if isinstance(place, Shard):
            n = value.shape[place.dim] // axis_size(mesh, axis)
            value = value.narrow(place.dim, mesh.get_local_rank(axis) * n, n)
    return value


class LocalBatch(dict):
    """A rank's part of a global batch, with the ``placements`` of each
    key (what a sharded JAX array carries)."""

    def __init__(self, values, placements):
        super().__init__(values)
        self.placements = placements


def _place_batch(mesh, batch, placements) -> LocalBatch:
    device = mesh_device(mesh)
    return LocalBatch({k: local_part(v, mesh, placements[k]).to(device)
                       for k, v in batch.items()}, placements)


def shard_batch(mesh, batch) -> LocalBatch:
    """This rank's rows of a global batch (dict of arrays), split over
    "data", on the mesh's device."""
    return _place_batch(mesh, batch,
                        {k: batch_sharding(mesh) for k in batch})


def cooperative_placements(batch, n_model: int) -> dict:
    """The JAX package's rule of :func:`cooperative_batch_sharding`: dim 1
    of an agent-axis key over "model" where it divides, else the batch
    over "data" alone."""
    out = {}
    for key, value in batch.items():
        shape = np.shape(value)
        if (key in _AGENT_AXIS_KEYS and len(shape) >= 2
                and shape[1] % n_model == 0):
            out[key] = (Shard(0), Shard(1))
        else:
            out[key] = (Shard(0), Replicate())
    return out


def cooperative_batch_sharding(mesh, batch) -> LocalBatch:
    """A cooperative batch (B, L, ...) over ("data", "model"): the batch
    over "data" and the agent axis over "model", so each rank encodes its
    own agents; the train step gathers their BEV maps at the fusion
    boundary (``train/step.py``).  Keys without an agent axis replicate
    over "model"."""
    return _place_batch(mesh, batch, cooperative_placements(
        batch, axis_size(mesh, "model")))


def agents_split(batch) -> bool:
    """Whether a :class:`LocalBatch` holds its ranks' own agents."""
    placements = getattr(batch, "placements", {})
    return isinstance(placements.get("inputs", (None, None))[1], Shard)


def tensor_parallel_spec(name: str, param) -> object:
    """The "model" placement of one parameter by its state_dict name:
    ``Shard(0)`` (the output rows of an ``nn.Linear`` weight: flax
    ``P(None, "model")``) for the layers of ``_COL_SHARDED``, ``Shard(1)``
    (its input columns: ``P("model", None)``) for ``_ROW_SHARDED``, and
    ``Replicate()`` for every bias and every other tensor."""
    parts = name.split(".")
    if getattr(param, "ndim", 0) == 2 and parts[-1] == "weight":
        owner = _default_rename(parts[:-1])
        parent = owner[-1] if owner else ""
        if parent in _COL_SHARDED:
            return Shard(0)
        if parent in _ROW_SHARDED:
            return Shard(1)
    return Replicate()


def shard_specs(model: nn.Module, n_model: int, use_tp: bool = True) -> dict:
    """{parameter name: "model" placement} at ``n_model``: the rules of
    :func:`tensor_parallel_spec`, replicated where the split axis does not
    divide (the JAX package's fallback) or without ``use_tp``."""
    out = {}
    for name, p in model.named_parameters():
        spec = Replicate()
        if use_tp and n_model > 1:
            spec = tensor_parallel_spec(name, p)
            if isinstance(spec, Shard) and p.shape[spec.dim] % n_model:
                spec = Replicate()
        out[name] = spec
    return out


def param_sharding(mesh, model: nn.Module, use_tp: bool = True) -> dict:
    """{parameter name: placements over ("data", "model")}: replicated over
    "data", the tensor-parallel rules over "model"."""
    return {name: (Replicate(), spec) for name, spec in
            shard_specs(model, axis_size(mesh, "model"), use_tp).items()}


# --- collectives built from all_reduce ---------------------------------------

def _sum_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``; half types are summed in
    f32."""
    if t.dtype in (torch.float16, torch.bfloat16):
        wide = t.float()
        dist.all_reduce(wide, group=group)
        return t.copy_(wide)
    dist.all_reduce(t, group=group)
    return t


def gather_plain(t: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """The blocks of ``t`` along ``dim`` of every rank of ``axis``, in
    rank order (each rank's block placed in zeros and summed: exact)."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * axis.size
    whole = t.new_zeros(shape)
    whole.narrow(dim, axis.index * n, n).copy_(t)
    return _sum_(whole, axis.group)


class _Gather(torch.autograd.Function):
    """:func:`gather_plain` whose backward sums the gradient over the axis
    and returns this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim, axis):
        ctx.dim, ctx.axis, ctx.n = dim, axis, t.shape[dim]
        return gather_plain(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        g = _sum_(g.clone(memory_format=torch.contiguous_format),
                  ctx.axis.group)
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def gather(t: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """Differentiable :func:`gather_plain`."""
    return _Gather.apply(t, dim, axis)


# --- tensor-parallel layers ------------------------------------------------

_scope = threading.local()


@contextlib.contextmanager
def whole_weights():
    """Inside the block every :class:`ShardedLinear` gathers its whole
    weight and computes the whole layer: the per-agent stages on the agent
    axis, where the "model" ranks hold different agents."""
    prev = getattr(_scope, "whole", False)
    _scope.whole = True
    try:
        yield
    finally:
        _scope.whole = prev


def _whole() -> bool:
    return getattr(_scope, "whole", False)


class ShardedLinear(nn.Linear):
    """An ``nn.Linear`` of which this rank holds one block of the weight
    over "model": ``dim`` 0, its output rows (column-parallel), or 1, its
    input columns (row-parallel).  The bias stays whole; ``in_features``,
    ``out_features`` and the state_dict names are the whole layer's.

    Column-parallel with ``local_out``: the rank's own output columns (its
    bias block added).  Otherwise the gathered weight and the whole output.
    Row-parallel: the partial product of the rank's input columns (cut from
    a whole input, or given), summed over "model", then the bias."""

    def __init__(self, linear: nn.Linear, dim: int, axis: MeshAxis,
                 local_out: bool = False):
        nn.Module.__init__(self)
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.dim, self.axis, self.local_out = dim, axis, local_out
        w = linear.weight.detach()
        n = w.shape[dim] // axis.size
        self.weight = nn.Parameter(w.narrow(dim, axis.index * n, n).clone(),
                                   requires_grad=linear.weight.requires_grad)
        if linear.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(linear.bias.detach().clone(),
                                     requires_grad=linear.bias.requires_grad)

    def full_weight(self) -> torch.Tensor:
        return gather(self.weight, self.dim, self.axis)

    def forward(self, x):
        if _whole() or (self.dim == 0 and not self.local_out):
            return F.linear(x, self.full_weight(), self.bias)
        n = self.weight.shape[self.dim]
        if self.dim == 0:
            bias = None if self.bias is None else self.bias.narrow(
                0, self.axis.index * n, n)
            return F.linear(x, self.weight, bias)
        if x.shape[-1] != n:
            x = x.narrow(-1, self.axis.index * n, n)
        y = all_reduce_sum(F.linear(x, self.weight), self.axis.group)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f"{super().extra_repr()}, sharded dim {self.dim} of "
                f"{self.axis.size}, local_out={self.local_out}")


def full_weight(linear: nn.Linear) -> torch.Tensor:
    """The whole weight of a layer, gathered where it is sharded: for a
    kernel that takes a layer's whole weights (K2 in training)."""
    if isinstance(linear, ShardedLinear):
        return linear.full_weight()
    return linear.weight


def _local_column_units(model: nn.Module) -> dict:
    """{Linear path: unit} of the column-parallel layers whose owners
    declare (``tp_local_columns``) that a rank may keep its own output
    columns, in whole units of the named attribute (None: 1)."""
    out = {}
    for path, module in model.named_modules():
        for rel, unit in getattr(module, "tp_local_columns", {}).items():
            out[f"{path}.{rel}" if path else rel] = \
                1 if unit is None else getattr(module, unit)
    return out


def parallelize_(model: nn.Module, specs: dict, mesh) -> nn.Module:
    """Replace, in place, each ``nn.Linear`` whose weight ``specs`` shards
    over "model" by a :class:`ShardedLinear` holding this rank's block (a
    fresh tensor)."""
    axis = mesh_axis(mesh, "model")
    units = _local_column_units(model)
    for path, module in list(model.named_modules()):
        if not isinstance(module, nn.Linear) or isinstance(
                module, ShardedLinear):
            continue
        place = specs.get(f"{path}.weight", (Replicate(), Replicate()))[1]
        if not isinstance(place, Shard):
            continue
        unit = units.get(path)
        local = (place.dim == 0 and unit is not None
                 and (module.out_features // axis.size) % unit == 0)
        parent, _, child = path.rpartition(".")
        setattr(model.get_submodule(parent), child,
                ShardedLinear(module, place.dim, axis, local))
    return model


def sharded_parameter_ids(model: nn.Module) -> set:
    """ids of the parameters that hold one block over "model"."""
    return {id(m.weight) for m in model.modules()
            if isinstance(m, ShardedLinear)}


@torch.no_grad()
def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every sharded weight gathered whole (a
    collective over "model"): the state_dict of the unplaced module, in
    the reference's ``.pth`` layout."""
    out = {}
    for name, t in model.state_dict().items():
        owner = model.get_submodule(name.rpartition(".")[0])
        if isinstance(owner, ShardedLinear) and name.endswith(".weight"):
            t = gather_plain(t, owner.dim, owner.axis)
        out[name] = t
    return out


def unsharded_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with each :class:`ShardedLinear` an
    ``nn.Linear`` of the whole layer, its weight not yet filled: load a
    :func:`full_state_dict` into it."""
    import copy

    copy_ = copy.deepcopy(model)
    for path, module in list(copy_.named_modules()):
        if isinstance(module, ShardedLinear):
            w = module.weight
            whole = torch.nn.utils.skip_init(
                nn.Linear, module.in_features, module.out_features,
                bias=module.bias is not None, device=w.device, dtype=w.dtype)
            parent, _, child = path.rpartition(".")
            setattr(copy_.get_submodule(parent), child, whole)
    return copy_
