"""Checkpoints in the reference's format, with epoch-scan and step-scan
resume.

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
    name does not match the reference's ``*epoch*.pth`` scan;
  * a run counted in steps (the nuScenes trainer, whose JAX CLI saves at
    steps) writes the same two files as ``net_step{N}.pth`` and
    ``train_state_step{N}.pt`` (the train-state file without an epoch):
    ``save_step_checkpoint``, ``latest_step``, ``restore_step_checkpoint``.

Every tensor is saved from the CPU and loaded with ``weights_only=True``;
a restore is strict (``load_state_dict(strict=True)``) and refreshes the
bf16 compute twin, whose BatchNorm buffers stay the master's own tensors.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

_NET_RE = {unit: re.compile(rf"net_{unit}(\d+)\.pth")
           for unit in ("epoch", "step")}


def _paths(ckpt_dir: str, unit: str, n: int) -> Tuple[str, str]:
    return (os.path.join(ckpt_dir, f"net_{unit}{n}.pth"),
            os.path.join(ckpt_dir, f"train_state_{unit}{n}.pt"))


def checkpoint_paths(ckpt_dir: str, epoch: int) -> Tuple[str, str]:
    """(model file, train-state file) of ``epoch``."""
    return _paths(ckpt_dir, "epoch", epoch)


def step_checkpoint_paths(ckpt_dir: str, step: int) -> Tuple[str, str]:
    """(model file, train-state file) of ``step``."""
    return _paths(ckpt_dir, "step", step)


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


def _save_files(ckpt_dir: str, unit: str, n: int, state, extra: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    net, train_state = _paths(ckpt_dir, unit, n)
    compute = next(state.compute_model.parameters()).dtype
    _save({"optimizer": _cpu(state.optimizer.state_dict()),
           "step": int(state.step), **extra,
           "compute_dtype": str(compute).replace("torch.", "")}, train_state)
    _save(_cpu(state.model.state_dict()), net)
    return net


def save_checkpoint(ckpt_dir: str, state, epoch: int,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write the two files of ``epoch``; returns the model file's path.
    The train-state file is written first, so a model file found by
    :func:`latest_checkpoint` always has its companion."""
    return _save_files(ckpt_dir, "epoch", epoch, state, {
        "epoch": int(epoch),
        "generator": None if generator is None else generator.get_state()})


def save_step_checkpoint(ckpt_dir: str, state, step: int) -> str:
    """Write the two files of ``step`` (``net_step{step}.pth`` and its
    train-state file, first); returns the model file's path."""
    return _save_files(ckpt_dir, "step", step, state, {})


def _latest(ckpt_dir: str, unit: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    found = [int(m.group(1)) for m in map(_NET_RE[unit].fullmatch,
                                          os.listdir(ckpt_dir)) if m]
    return max(found) if found else None


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """The largest N of the ``net_epoch{N}.pth`` files in ``ckpt_dir``."""
    return _latest(ckpt_dir, "epoch")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest N of the ``net_step{N}.pth`` files in ``ckpt_dir``."""
    return _latest(ckpt_dir, "step")


def _restore_files(state, net: str, train_state: str) -> dict:
    state.model.load_state_dict(torch.load(net, map_location="cpu",
                                           weights_only=True), strict=True)
    extra = torch.load(train_state, map_location="cpu", weights_only=True)
    state.optimizer.load_state_dict(extra["optimizer"])
    state.step = int(extra["step"])
    state.refresh_compute_model()
    return extra


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
    extra = _restore_files(state, *checkpoint_paths(ckpt_dir, epoch))
    if generator is not None and extra.get("generator") is not None:
        generator.set_state(extra["generator"])
    return state, epoch


def restore_step_checkpoint(ckpt_dir: str, state,
                            step: Optional[int] = None):
    """Restore the model, the optimizer and ``step`` of the ``step``
    checkpoint (the latest by default) into ``state`` in place.  Returns
    (state, step), or (state, None) when there is nothing to restore."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return state, None
    _restore_files(state, *step_checkpoint_paths(ckpt_dir, step))
    return state, step
