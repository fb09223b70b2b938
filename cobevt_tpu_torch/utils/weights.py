"""Weights: the JAX -> port bridge, and seeded random weights.

:func:`load_jax_variables` fills a port module from the JAX package's
variables (``{"params", "batch_stats"}`` as nested dicts of numpy
arrays).  It walks the port's own ``state_dict`` keys and maps each one
forward to its flax path with the same renaming the JAX package's
``torch_port._default_rename`` applies (torch Sequential / ModuleList
digits fold into the parent segment); flax names are never inverted,
since ``mlp_1_0`` could come from ``mlp_1.0`` or ``mlp.1_0``.  The reverse
direction is ``cobevt_tpu.utils.torch_port.torch_to_flax``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

_NORMS = (nn.BatchNorm2d, nn.LayerNorm)


def _default_rename(path):
    """``layers.0.0.conv1`` -> ``layers_0_0 / conv1`` (a copy of
    ``cobevt_tpu/utils/torch_port.py:_default_rename``)."""
    out = []
    for seg in path:
        if seg.isdigit() and out:
            out[-1] = f"{out[-1]}_{seg}"
        else:
            out.append(seg)
    return out


def _flat(tree: dict, path=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out[path + (k,)] = np.asarray(v)
    return out


def _flax_leaf(module: nn.Module, leaf: str):
    """(collection, flax leaf name, converter to torch layout) of one
    port state_dict entry, or None for a leaf with no JAX counterpart."""
    if leaf == "num_batches_tracked":
        return None
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", leaf[len("running_"):], lambda a: a
    if leaf == "bias":
        return "params", "bias", lambda a: a
    if leaf == "weight":
        if isinstance(module, _NORMS):
            return "params", "scale", lambda a: a
        if isinstance(module, nn.Embedding):
            return "params", "embedding", lambda a: a
        if isinstance(module, nn.Conv2d):
            # HWIO -> OIHW; a flax Dense standing in for a 1x1 conv is
            # (I, O) and reshapes to (1, 1, I, O) first
            return "params", "kernel", lambda a: (
                a.reshape(1, 1, *a.shape) if a.ndim == 2 else a
            ).transpose(3, 2, 0, 1)
        if isinstance(module, nn.Linear):
            return "params", "kernel", lambda a: a.reshape(
                -1, a.shape[-1]).T
        raise TypeError(f"no weight rule for {type(module).__name__}")
    # any other leaf (learned positional tensors) keeps its name and layout
    return "params", leaf, lambda a: a


def jax_tree_to_state_dict(module: nn.Module,
                           variables: dict) -> Dict[str, np.ndarray]:
    """JAX trees, given by collection (``{"params": ..., "batch_stats":
    ...}``, nested dicts of numpy arrays), as a dict keyed and laid out like
    ``module.state_dict()``.  Anything shaped like the parameters goes
    through the same way: gradients, optimizer moments, updated
    parameters, the ``batch_stats`` after a step.  A collection that is
    absent is skipped, so ``{"params": grads}`` gives the entries of the
    parameters alone.  Raises on a shape mismatch, on a port entry of a
    given collection with no JAX leaf and on a JAX leaf left over."""
    flax = {}
    for collection, tree in variables.items():
        for path, value in _flat(tree).items():
            flax[(collection,) + path] = value
    used = set()
    out = {}
    for key, cur in module.state_dict().items():
        parts = key.split(".")
        owner = module.get_submodule(".".join(parts[:-1]))
        rule = _flax_leaf(owner, parts[-1])
        if rule is None or rule[0] not in variables:
            continue
        collection, leaf, convert = rule
        fkey = (collection, *_default_rename(parts[:-1]), leaf)
        if fkey not in flax:
            raise KeyError(f"{key}: no JAX leaf {'/'.join(fkey)}")
        value = convert(flax[fkey])
        if tuple(value.shape) != tuple(cur.shape):
            raise ValueError(f"{key}: port shape {tuple(cur.shape)} vs JAX "
                             f"{'/'.join(fkey)} {value.shape}")
        out[key] = value
        used.add(fkey)
    left = sorted("/".join(k) for k in set(flax) - used)
    if left:
        raise KeyError(f"JAX leaves with no port counterpart: {left}")
    return out


def load_jax_variables(module: nn.Module, variables: dict) -> None:
    """Fill ``module`` in place from JAX variables.  Raises on a shape
    mismatch and on any leaf left over on either side."""
    state = module.state_dict()
    new_state = {k: torch.tensor(v, dtype=state[k].dtype) for k, v in
                 jax_tree_to_state_dict(module, variables).items()}
    for key, cur in state.items():
        if key.endswith("num_batches_tracked"):
            new_state[key] = cur
    module.load_state_dict(new_state, strict=True)


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> None:
    """Random weights from one seeded ``torch.Generator``, drawn on the CPU
    so the values do not depend on the device: lecun-normal convs and
    linears (the flax default), N(0, 0.02) embeddings, N(0, 1) learned
    tensors, affine norms near identity, and non-trivial BatchNorm running
    statistics so eval-mode BN is not a pass-through."""
    g = torch.Generator().manual_seed(seed)

    def draw(shape, kind):
        if kind == "normal":
            return torch.randn(shape, generator=g)
        return torch.rand(shape, generator=g)

    for m in module.modules():
        params = dict(m.named_parameters(recurse=False))
        buffers = dict(m.named_buffers(recurse=False))
        new = {}
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = params["weight"]
            fan_in = w[0].numel()
            new["weight"] = draw(w.shape, "normal") / fan_in ** 0.5
            if "bias" in params:
                new["bias"] = draw(params["bias"].shape, "normal") * 0.02
        elif isinstance(m, nn.Embedding):
            new["weight"] = draw(params["weight"].shape, "normal") * 0.02
        elif isinstance(m, _NORMS):
            shape = params["weight"].shape
            new["weight"] = 1.0 + 0.1 * draw(shape, "normal")
            new["bias"] = 0.1 * draw(shape, "normal")
            if isinstance(m, nn.BatchNorm2d):
                new["running_mean"] = 0.1 * draw(shape, "normal")
                new["running_var"] = 0.5 + draw(shape, "uniform")
        else:
            for name, p in params.items():
                new[name] = draw(p.shape, "normal")
        for name, value in new.items():
            target = params.get(name, buffers.get(name))
            target.copy_(value.to(target.dtype))
