"""BatchNorm-statistics reductions (K9, K10): a CUDA kernel, and Triton for
the shapes it does not take.

Counterpart of the two Pallas sweeps of
``cobevt_tpu/tools/micro_bn_stats.py``: the f32 per-channel sums that
BatchNorm's forward and backward take over bf16 activations flattened to
(R, C), each with the tool's ``max(., s)`` perturbation in front:

  * K9 ``bn_stats_fwd(x, s)``      -> (sum xb, sum xb^2),  xb = f32(max(x, s))
  * K10 ``bn_stats_bwd(dy, x, s)`` -> (sum dyb, sum dyb * f32(x)),
    dyb = f32(max(dy, s))

with ``s`` cast to the activations' dtype first, as the Pallas bodies read
it.  Outputs are f32 of shape (C,).

What bounds them on the H100: no product and no reuse, so the bytes of x
(and dy) read once from device memory.  Two routes, chosen by shape before
the launch (:func:`kernel_path`):

  * "cuda" (``csrc/bn_stats.cu``): rows of a whole number of 16-byte
    vectors (C * elt % 16 == 0, at most 512 vectors) on 16-byte-aligned
    bases, which holds at every shape of the JAX tool.  A persistent grid
    copies tiles of whole rows with 1-D bulk copies into a shared-memory
    ring, sums them in registers, one 16-byte column vector a thread, and
    writes one partial row a block; a second launch adds the partial rows
    in a fixed order (:func:`cuda_plan`).  Both launches are programmatic
    (each may start while the kernel before it finishes, and waits for it
    before touching device memory).  One C call, one output allocation,
    the threshold passed by value (a number, rounded to the activations'
    dtype here) or by device pointer (a tensor).
  * "triton": every other shape.  Programs own a contiguous run of
    rows and a 128-column block (masked at the edge), add 16-row tiles into
    f32 register accumulators and write one partial row each; a second small
    launch adds the partial rows in a fixed order (:func:`_plan`).

No atomics on either route, so two runs give the same bits.  ``triton`` is
imported, and ``csrc/bn_stats.cu`` built, when a kernel is first launched,
never when this module is imported: CPU-only hosts run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import check_operand, resolve_impl

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# the Triton route
_BLOCK_R, _BLOCK_C, _BLOCK_P, _NUM_WARPS = 16, 128, 32, 4
# row programs: a few per SM of the 132, so the tail is short
_ROW_PROGRAMS = 132 * 4
# the CUDA route (csrc/bn_stats.cu): one 16-byte vector a consumer thread,
# at most 512 consumers beside the copying warp; a ring of 4 stages of up
# to 32 KB (both inputs of K10 together), one block an SM
_VEC = 16
_CONSUMERS = 512
_STAGE_BYTES = 32 * 1024
_STAGES = 4
_SMS = 132
_SMEM_LIMIT = 232448
_ELT = {torch.float32: 4, torch.bfloat16: 2}


def bn_stats_fwd_reference(x, s):
    """Plain PyTorch version of K9 (the JAX tool's ``xla_fwd``)."""
    xf = torch.maximum(x, _threshold(s, x)).float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def bn_stats_bwd_reference(dy, x, s):
    """Plain PyTorch version of K10 (the JAX tool's ``xla_bwd``)."""
    dyf = torch.maximum(dy, _threshold(s, dy)).float()
    return dyf.sum(dim=0), (dyf * x.float()).sum(dim=0)


def kernel_path(C: int, dtype, aligned: bool = True) -> str:
    """The route of a CUDA call on (R, C) activations of ``dtype``: "cuda"
    when a row is a whole number of 16-byte vectors, at most one a consumer
    thread, and every base is 16-byte aligned; "triton" otherwise (the
    rows do not matter)."""
    row = C * _ELT.get(dtype, 0)
    if aligned and row and row % _VEC == 0 and row <= _VEC * _CONSUMERS:
        return "cuda"
    return "triton"


def route(*tensors) -> str:
    """:func:`kernel_path` of the wrapper's operands (x, or dy and x)."""
    first = tensors[0]
    return kernel_path(first.shape[-1], first.dtype,
                       all(t.data_ptr() % _VEC == 0 for t in tensors))


class CudaPlan(NamedTuple):
    """The CUDA route's launch: ``consumers`` threads (``lanes`` rows of
    ``vectors`` 16-byte column vectors at a time) beside one copying warp,
    tiles of ``tile_rows`` whole rows (``tiles`` of them, the last one maybe
    shorter), ``blocks`` persistent blocks each owning a contiguous run of
    whole tiles (the counts differ by at most one), a ring of ``stages``
    stages of ``stage_bytes`` (every input's tile) and ``smem`` bytes of
    shared memory in all (the ring, or the lanes' fold where larger, and two
    barriers a stage)."""
    vectors: int
    lanes: int
    consumers: int
    tile_rows: int
    tiles: int
    blocks: int
    stages: int
    stage_bytes: int
    smem: int


@functools.lru_cache(maxsize=256)
def cuda_plan(R: int, C: int, dtype, inputs: int = 1,
              sms: int = _SMS) -> CudaPlan:
    """The plan of ``csrc/bn_stats.cu`` for (R, C) activations of ``dtype``
    and ``inputs`` operands (1: K9, 2: K10) on a card of ``sms`` SMs: the
    rows of a tile are a multiple of the lanes, as many as fit a stage of
    ``_STAGE_BYTES``; the ring keeps ``_STAGES`` stages where they fit the
    shared memory of one block an SM."""
    if kernel_path(C, dtype) != "cuda" or R < 1 or inputs not in (1, 2):
        raise ValueError(f"the CUDA route does not take R={R}, C={C}, "
                         f"{dtype}, {inputs} inputs")
    row = C * _ELT[dtype]
    vectors = row // _VEC
    lanes = max(1, _CONSUMERS // vectors)
    groups = max(1, _STAGE_BYTES // (inputs * lanes * row))
    tile_rows = min(lanes * groups, R)
    tiles = -(-R // tile_rows)
    blocks = min(sms, tiles)
    stage = inputs * tile_rows * row
    fold = lanes * 2 * C * 4
    # the SM's shared memory less 1 KB that the card reserves for a block
    budget = _SMEM_LIMIT - 1024
    stages = max(2, min(_STAGES, (budget - 16 * _STAGES) // stage))
    smem = max(stages * stage, fold) + 16 * stages
    return CudaPlan(vectors, lanes, lanes * vectors, tile_rows, tiles,
                    blocks, stages, stage, smem)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("bn_stats").cobevt_bn_stats
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, ctypes.c_float, P, P, ctypes.c_longlong, I, I,
                   I, I, I, I, I, I, P]
    fn.restype = I
    return fn


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _rounded(s: float, dtype) -> float:
    """The number ``s`` rounded to ``dtype``, as ``_threshold`` rounds it."""
    return torch.full((1,), s, dtype=dtype).item()


def _launch_cuda(tensors, s):
    """``csrc/bn_stats.cu`` on ``tensors`` (x, or dy and x); returns the two
    (C,) f32 sums, views of one buffer that also holds the partial rows."""
    first = tensors[0]
    R, C = first.shape
    dev = first.device
    plan = cuda_plan(R, C, first.dtype, len(tensors), sms=_sms(dev))
    buf = torch.empty((plan.blocks + 1) * 2 * C, dtype=torch.float32,
                      device=dev)
    out = buf[:2 * C]
    if torch.is_tensor(s):
        s = s.to(device=dev, dtype=first.dtype).reshape(1)
        s_ptr, s_val = s.data_ptr(), 0.0
    else:
        s_ptr, s_val = None, _rounded(float(s), first.dtype)
    err = _entry()(
        first.data_ptr(), tensors[1].data_ptr() if len(tensors) == 2 else None,
        s_ptr, s_val, out.data_ptr(), buf[2 * C:].data_ptr(), R, C,
        int(first.dtype == torch.bfloat16), plan.blocks, plan.consumers,
        plan.tile_rows, plan.stages, plan.smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bn_stats")
    route_launches["cuda"] += 1
    return out[:C], out[C:]


def _threshold(s, like):
    """``s`` as a one-element tensor of ``like``'s dtype on its device."""
    if torch.is_tensor(s):
        return s.to(device=like.device, dtype=like.dtype).reshape(1)
    return torch.full((1,), s, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The three ``@triton.jit`` kernels, compiled at their first launch."""
    global triton, tl       # the kernels' bodies look these names up here
    import triton
    import triton.language as tl

    @triton.jit
    def fwd_partial(x_ptr, s_ptr, part_ptr, R, C, rows_per_program, P,
                    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid_r = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        col_ok = cols < C
        s = tl.load(s_ptr)
        row0 = pid_r * rows_per_program
        row_end = tl.minimum(row0 + rows_per_program, R)
        acc = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        acc_sq = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        for r in range(0, rows_per_program, BLOCK_R):
            rows = row0 + r + tl.arange(0, BLOCK_R)
            ok = (rows < row_end)[:, None] & col_ok[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=ok, other=0.0)
            xf = tl.where(ok, tl.maximum(x, s).to(tl.float32), 0.0)
            acc += xf
            acc_sq += xf * xf
        out = pid_r * C + cols
        tl.store(part_ptr + out, tl.sum(acc, axis=0), mask=col_ok)
        tl.store(part_ptr + P * C + out, tl.sum(acc_sq, axis=0), mask=col_ok)

    @triton.jit
    def bwd_partial(dy_ptr, x_ptr, s_ptr, part_ptr, R, C, rows_per_program,
                    P, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        pid_r = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        col_ok = cols < C
        s = tl.load(s_ptr)
        row0 = pid_r * rows_per_program
        row_end = tl.minimum(row0 + rows_per_program, R)
        acc = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        acc_x = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        for r in range(0, rows_per_program, BLOCK_R):
            rows = row0 + r + tl.arange(0, BLOCK_R)
            ok = (rows < row_end)[:, None] & col_ok[None, :]
            offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
            dy = tl.load(dy_ptr + offs, mask=ok, other=0.0)
            x = tl.load(x_ptr + offs, mask=ok, other=0.0)
            dyf = tl.where(ok, tl.maximum(dy, s).to(tl.float32), 0.0)
            acc += dyf
            acc_x += dyf * x.to(tl.float32)
        out = pid_r * C + cols
        tl.store(part_ptr + out, tl.sum(acc, axis=0), mask=col_ok)
        tl.store(part_ptr + P * C + out, tl.sum(acc_x, axis=0), mask=col_ok)

    @triton.jit
    def add_partials(part_ptr, out_ptr, P, C, BLOCK_P: tl.constexpr,
                     BLOCK_C: tl.constexpr):
        # grid (column blocks, 2): the P partial rows of one of the two sums
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        col_ok = cols < C
        base = tl.program_id(1) * P * C
        acc = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
        for p in range(0, P, BLOCK_P):
            rows = p + tl.arange(0, BLOCK_P)
            ok = (rows < P)[:, None] & col_ok[None, :]
            acc += tl.load(part_ptr + base + rows[:, None] * C
                           + cols[None, :], mask=ok, other=0.0)
        tl.store(out_ptr + tl.program_id(1) * C + cols, tl.sum(acc, axis=0),
                 mask=col_ok)

    return fwd_partial, bwd_partial, add_partials


def _plan(R: int):
    """(row programs P, rows per program): a multiple of the row tile."""
    rows = -(-R // _ROW_PROGRAMS)
    rows = -(-rows // _BLOCK_R) * _BLOCK_R
    return -(-R // rows), rows


def _check(name, t, like=None):
    if t.dim() != 2 or t.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name} must be (R, C) in {_KERNEL_DTYPES}; got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")
    ref = t if like is None else like
    check_operand(name, t, tuple(ref.shape), ref.dtype, ref.device)


def _launch_triton(which: int, tensors, s):
    """The Triton route: partial sums of ``tensors`` (x, or dy and x), then
    their addition; returns the two (C,) f32 sums."""
    import triton
    partial = _kernels()[which]
    add_partials = _kernels()[2]
    first = tensors[0]
    R, C = first.shape
    P, rows = _plan(R)
    part = torch.empty((2, P, C), dtype=torch.float32, device=first.device)
    out = torch.empty((2, C), dtype=torch.float32, device=first.device)
    col_blocks = triton.cdiv(C, _BLOCK_C)
    with torch.cuda.device(first.device):
        partial[(P, col_blocks)](*tensors, _threshold(s, first), part, R, C,
                                 rows, P, BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C,
                                 num_warps=_NUM_WARPS)
        add_partials[(col_blocks, 2)](part, out, P, C, BLOCK_P=_BLOCK_P,
                                      BLOCK_C=_BLOCK_C, num_warps=4)
    route_launches["triton"] += 1
    return out[0], out[1]


def _launch(tensors, s):
    """The route :func:`route` picks for ``tensors``, launched."""
    if route(*tensors) == "cuda":
        return _launch_cuda(tensors, s)
    return _launch_triton(len(tensors) - 1, tensors, s)


def bn_stats_fwd(x, s, impl=None):
    """K9: per-channel (sum, sum of squares) of ``f32(max(x, s))`` over the
    rows of x (R, C) -> two f32 (C,).  ``s``: a number or a one-element
    tensor, cast to x's dtype.  ``impl``: None (kernel for CUDA tensors,
    plain version for CPU tensors), "kernel" or "torch"."""
    if resolve_impl(impl, x) == "torch":
        return bn_stats_fwd_reference(x, s)
    _check("x", x)
    sums = _launch((x,), s)
    bn_stats_fwd.launches += 1
    return sums


def bn_stats_bwd(dy, x, s, impl=None):
    """K10: per-channel (sum dyb, sum dyb * f32(x)) with
    ``dyb = f32(max(dy, s))`` over the rows of dy, x (R, C) -> two f32 (C,).
    ``impl`` as for :func:`bn_stats_fwd`."""
    if resolve_impl(impl, dy) == "torch":
        return bn_stats_bwd_reference(dy, x, s)
    _check("dy", dy)
    _check("x", x, like=dy)
    sums = _launch((dy, x), s)
    bn_stats_bwd.launches += 1
    return sums


# calls that launched the kernels since the last reset (a call is two
# launches on either route, counted once; plain-version calls do not count)
bn_stats_fwd.launches = 0
bn_stats_bwd.launches = 0
# calls of either wrapper by the route that ran, never reset: a caller
# reads the difference over its own span to see which kernels it launched
route_launches = {"cuda": 0, "triton": 0}
