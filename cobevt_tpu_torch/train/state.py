"""Train state: model, optimizer, schedule and step count.

Counterpart of ``cobevt_tpu/train/state.py``.  flax's ``dtype=bf16`` keeps
f32 parameters and f32 gradients and computes in bf16; the port's modules
compute in the dtype of their parameters.  So for bf16 training the state
holds two modules: ``model`` with the f32 master parameters, which the
optimizer updates with f32 moments, and ``compute_model``, a bf16 twin that
runs forward and backward and is refreshed from the master after every
update (one fused copy).  The twin's gradients are cast to f32 before the
update.  BatchNorm running statistics exist once, in f32: the twin's
buffers are the master's own tensors.  In f32 training the twin is the
model itself.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module                      # f32 master parameters
    optimizer: torch.optim.Optimizer      # over model.parameters()
    schedule: Callable[[int], float]      # step -> lr, from 0
    compute_model: nn.Module              # runs forward and backward
    step: int = 0
    grad_clip: Optional[float] = None     # global-norm clip, or None
    mesh: Optional[object] = None         # the DeviceMesh of place_state

    @property
    def params(self) -> List[nn.Parameter]:
        return list(self.model.parameters())

    @property
    def compute_params(self) -> List[nn.Parameter]:
        return list(self.compute_model.parameters())

    @torch.no_grad()
    def refresh_compute_model(self) -> None:
        """Copy the master parameters into the compute twin."""
        if self.compute_model is not self.model:
            torch._foreach_copy_(self.compute_params, self.params)


def _share_norm_statistics(master: nn.Module, twin: nn.Module) -> None:
    for m, t in zip(master.modules(), twin.modules()):
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            t.running_mean = m.running_mean
            t.running_var = m.running_var
            t.num_batches_tracked = m.num_batches_tracked


def compute_twin(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` computing in ``dtype`` whose BatchNorm running
    statistics are the f32 master's own tensors (``model`` itself for
    f32).  Training, evaluation and serving build their bf16 module this
    one way, so a checkpoint gives the same outputs in each."""
    if dtype is None or dtype == torch.float32:
        return model
    twin = copy.deepcopy(model).to(dtype)
    _share_norm_statistics(model, twin)
    return twin


def create_train_state(model: nn.Module, optimizer, schedule,
                       compute_dtype: Optional[torch.dtype] = None,
                       grad_clip: Optional[float] = None) -> TrainState:
    """``model`` holds f32 parameters on its device and ``optimizer`` was
    made over them (``make_optimizer``).  ``compute_dtype=torch.bfloat16``
    adds the bf16 compute twin."""
    compute = compute_twin(model, compute_dtype)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      compute_model=compute, grad_clip=grad_clip)
