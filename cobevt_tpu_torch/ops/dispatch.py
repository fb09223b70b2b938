"""Which implementation a kernel wrapper runs, and what a kernel accepts.

Every kernel of the port has two implementations: the hand-written CUDA
kernel and its plain PyTorch version.  A wrapper called with ``impl=None``
takes the plain version for a CPU tensor and the kernel for a CUDA tensor;
``impl="kernel"`` on a CPU tensor raises.  Nothing falls back silently.

:func:`forced_impl` sets the choice for every wrapper reached inside a
``with`` block, so a whole model forward can run on the plain versions on
the card (the reference run of ``chip_smoke.py``).  :func:`env_switches`
sets the environment switches that pick a path (``COBEVT_INT8``, ...) for a
block and restores the caller's values.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

IMPLS = ("kernel", "torch")

_state = threading.local()


@contextlib.contextmanager
def forced_impl(impl: str):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    prev = getattr(_state, "impl", None)
    _state.impl = impl
    try:
        yield
    finally:
        _state.impl = prev


@contextlib.contextmanager
def env_switches(**values):
    """Set the package's environment switches (``COBEVT_*``; None unsets one)
    inside the block and put back what the caller had, set or unset."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def resolve_impl(impl, tensor) -> str:
    """The implementation to run for ``tensor``."""
    if impl is None:
        impl = getattr(_state, "impl", None)
    if impl is None:
        return "kernel" if tensor.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and not tensor.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; got a tensor on "
                         f"{tensor.device}")
    return impl


def check_operand(name, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: a kernel reads raw pointers and takes nothing else."""
    if t.device != device or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}{'' if t.is_contiguous() else ' (not contiguous)'}")


def check_aligned(name, t, bytes_: int = 16) -> None:
    """Raise unless ``t`` starts on a ``bytes_`` boundary: the row kernels
    move rows as 16-byte vectors, and TMA takes 16-byte-aligned bases."""
    if t.data_ptr() % bytes_:
        raise ValueError(f"{name} must start on a {bytes_}-byte boundary")


class PackCache:
    """A module's kernel operands (weights transposed, cast and stacked),
    built once and reused while the tensors they come from are unchanged:
    the key holds each tensor's storage, version counter, dtype and device,
    so an in-place update (``load_state_dict``), a ``.to()`` or a new
    compute dtype rebuilds the entry.  Entries are built without autograd:
    the fused kernels are inference-only."""

    def __init__(self):
        self._entries = {}

    def get(self, name, tensors, build, *extra):
        key = (extra, tuple((t.data_ptr(), t._version, t.dtype, t.device)
                            for t in tensors))
        hit = self._entries.get(name)
        if hit is not None and hit[0] == key:
            return hit[1]
        # plain tensors even under inference_mode, so a later eval call
        # with autograd on can still read them
        with torch.inference_mode(False), torch.no_grad():
            value = build()
        self._entries[name] = (key, value)
        return value
