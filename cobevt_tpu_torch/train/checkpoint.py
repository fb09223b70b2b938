"""Checkpoints in the reference's format, with epoch-scan resume.

Counterpart of ``cobevt_tpu/train/checkpoint.py``, with the reference's
files in place of orbax's step directories:

  * ``net_epoch{N}.pth`` holds the f32 master model's ``state_dict()``
    alone, BatchNorm buffers included, under the reference's attribute
    names, so the reference model (``load_saved_model``,
    ``train_utils.py:24-65``) and the JAX package
    (``train/checkpoint.py:restore_from_torch``) read it;
  * ``train_state_epoch{N}.pt`` beside it holds the rest of the train
    state: ``optimizer.state_dict()``, the update count ``step``, the epoch,
    the state of the trainer's dropout generator and the compute dtype.  Its
    name does not match the reference's ``*epoch*.pth`` scan.

Every tensor is saved from the CPU and loaded with ``weights_only=True``;
a restore is strict (``load_state_dict(strict=True)``) and refreshes the
bf16 compute twin, whose BatchNorm buffers stay the master's own tensors.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

_NET_RE = re.compile(r"net_epoch(\d+)\.pth")


def checkpoint_paths(ckpt_dir: str, epoch: int) -> Tuple[str, str]:
    """(model file, train-state file) of ``epoch``."""
    return (os.path.join(ckpt_dir, f"net_epoch{epoch}.pth"),
            os.path.join(ckpt_dir, f"train_state_epoch{epoch}.pt"))


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _save(obj, path: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write the two files of ``epoch``; returns the model file's path.
    The train-state file is written first, so a model file found by
    :func:`latest_checkpoint` always has its companion."""
    os.makedirs(ckpt_dir, exist_ok=True)
    net, extra = checkpoint_paths(ckpt_dir, epoch)
    compute = next(state.compute_model.parameters()).dtype
    _save({"optimizer": _cpu(state.optimizer.state_dict()),
           "step": int(state.step), "epoch": int(epoch),
           "generator": None if generator is None else generator.get_state(),
           "compute_dtype": str(compute).replace("torch.", "")}, extra)
    _save(_cpu(state.model.state_dict()), net)
    return net


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """The largest N of the ``net_epoch{N}.pth`` files in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_NET_RE.fullmatch,
                                           os.listdir(ckpt_dir)) if m]
    return max(epochs) if epochs else None


def load_model_weights(ckpt_dir: str, model: torch.nn.Module,
                       epoch: Optional[int] = None) -> int:
    """Fill ``model`` from ``net_epoch{epoch}.pth`` (the latest by
    default), strictly; returns the epoch."""
    epoch = epoch if epoch is not None else latest_checkpoint(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no net_epoch*.pth under {ckpt_dir}")
    net, _ = checkpoint_paths(ckpt_dir, epoch)
    model.load_state_dict(torch.load(net, map_location="cpu",
                                     weights_only=True), strict=True)
    return epoch


def read_train_state(ckpt_dir: str, epoch: int) -> dict:
    """The train-state file of ``epoch`` as saved."""
    return torch.load(checkpoint_paths(ckpt_dir, epoch)[1],
                      map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, state, epoch: Optional[int] = None,
                       generator: Optional[torch.Generator] = None):
    """Restore the model, the optimizer, ``step`` and (given) the dropout
    generator of ``epoch`` (the latest by default) into ``state`` in place.
    Returns (state, epoch), or (state, None) when there is nothing to
    restore."""
    epoch = epoch if epoch is not None else latest_checkpoint(ckpt_dir)
    if epoch is None:
        return state, None
    load_model_weights(ckpt_dir, state.model, epoch)
    extra = read_train_state(ckpt_dir, epoch)
    state.optimizer.load_state_dict(extra["optimizer"])
    state.step = int(extra["step"])
    state.refresh_compute_model()
    if generator is not None and extra.get("generator") is not None:
        generator.set_state(extra["generator"])
    return state, epoch
