"""Which implementation a kernel wrapper runs, and what a kernel accepts.

Every kernel of the port has two implementations: the hand-written CUDA
kernel and its plain PyTorch version.  A wrapper called with ``impl=None``
takes the plain version for a CPU tensor and the kernel for a CUDA tensor;
``impl="kernel"`` on a CPU tensor raises.  Nothing falls back silently.

The eval kernels are ``torch.library`` custom ops in the ``cobevt``
namespace (:class:`KernelOp`): the op's CUDA implementation is the hand
kernel, which counts its launches when it runs, its CPU implementation is
the plain version, and its fake implementation gives the output's shape,
dtype and device and launches nothing, so ``torch.export`` traces a model
through them (``tools/export_serving.py``).  A wrapper calls the op
wherever no gradient is needed, on either device (:func:`route`); the plain
version asked for by name (``impl="torch"``, :func:`forced_impl`) runs
inline.

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


def _named_impl(impl):
    return impl if impl is not None else getattr(_state, "impl", None)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors (None
    skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def route(impl, tensor, grad: bool = False) -> str:
    """"plain": run the plain version inline (asked for by name, or a CPU
    tensor whose call needs a gradient, ``grad``: the op has no backward);
    "op": call the kernel's custom op, which dispatches on the tensor's
    device.  Raises as :func:`resolve_impl` does."""
    if resolve_impl(impl, tensor) == "torch" and (
            _named_impl(impl) is not None or grad):
        return "plain"
    return "op"


class KernelOp:
    """A kernel registered as the custom op ``cobevt::<name>``: ``plain``
    (the plain version) for CPU tensors, ``launch`` (the hand kernel; it
    raises on a build or launch failure and counts its launches) for CUDA
    tensors, ``fake`` for tracing.  ``schema`` is the op's schema without
    its name; every operand is a tensor, a list of tensors or a scalar.
    Arguments written in place are named in ``mutates_args`` and marked
    ``(a!)`` in the schema.  Calling the object calls the op.

    ``work(*args)`` gives (operations, bytes) of a call from its operands'
    shapes (``utils/flops.py``); ``products`` says what its operations are:
    "float" or "int8" products, which the flop formula registered on the op
    (``register_flop_formula``) counts for ``FlopCounterMode``, or None (no
    products: the formula counts 0)."""

    def __init__(self, name, schema, plain, launch, fake, work,
                 products="float", mutates_args=()):
        from torch.utils.flop_counter import register_flop_formula
        self.name = name
        self.launch = launch
        self.work = work
        self.products = products
        op = torch.library.custom_op(
            f"cobevt::{name}", plain, mutates_args=mutates_args,
            device_types="cpu", schema=schema)
        op.register_kernel("cuda", launch)
        op.register_fake(fake)
        self.custom_op = op
        packet = getattr(torch.ops.cobevt, name)
        self.overload = packet.default

        def formula(*args, out_val=None, **kwargs):
            return work(*args, **kwargs)[0] if products else 0

        register_flop_formula(packet, get_raw=True)(formula)

    def __call__(self, *args):
        return self.overload(*args)


def tracing(tensors=()) -> bool:
    """Whether the code runs under a trace (the fake tensors of
    ``torch.export`` or of the compiler) rather than on data: ``tensors``
    are fake, or a fake mode is active."""
    from torch._guards import detect_fake_mode
    return (detect_fake_mode(list(tensors)) is not None
            or torch.compiler.is_compiling())


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
    the fused kernels are inference-only.  Under tracing the entry is built
    and returned without being kept: fake tensors have no storage to key
    on, and a traced program then packs inside its graph at every call, as
    the JAX package's exported program refolds inside its forward."""

    def __init__(self):
        self._entries = {}

    def get(self, name, tensors, build, *extra):
        if tracing(tensors):
            with torch.no_grad():
                return build()
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
