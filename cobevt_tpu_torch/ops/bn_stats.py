"""BatchNorm-statistics reductions (K9, K10) as Triton kernels.

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
(and dy) read once from device memory.  The TPU bodies carry the sums in a
resident output block across a sequential grid; blocks of a GPU grid run in
no order, so each kernel is two launches: programs own a contiguous run of
rows and a 128-column block (masked at the edge: C is 128, 144, 192, 336, the
tensor is never padded), add 16-row tiles into f32 register accumulators
and write one partial row each; a second small launch adds the partial rows
in a fixed order.  No atomics, so two runs give the same bits.  (The first
version's 32 x 64 tiles read slower on an H100 than these 16 x 128 ones;
``PERF.md`` keeps both times.)

``triton`` is imported when a kernel is first launched, never when this
module is imported: CPU-only hosts run the plain versions.
"""

from __future__ import annotations

import functools

import torch

from cobevt_tpu_torch.ops.dispatch import check_operand, resolve_impl

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK_R, _BLOCK_C, _BLOCK_P, _NUM_WARPS = 16, 128, 32, 4
# row programs: a few per SM of the 132, so the tail is short
_ROW_PROGRAMS = 132 * 4


def bn_stats_fwd_reference(x, s):
    """Plain PyTorch version of K9 (the JAX tool's ``xla_fwd``)."""
    xf = torch.maximum(x, _threshold(s, x)).float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def bn_stats_bwd_reference(dy, x, s):
    """Plain PyTorch version of K10 (the JAX tool's ``xla_bwd``)."""
    dyf = torch.maximum(dy, _threshold(s, dy)).float()
    return dyf.sum(dim=0), (dyf * x.float()).sum(dim=0)


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


def _launch(which: int, tensors, s):
    """Partial sums of ``tensors`` (x, or dy and x), then their addition;
    returns the two (C,) f32 sums."""
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
    return out[0], out[1]


def bn_stats_fwd(x, s, impl=None):
    """K9: per-channel (sum, sum of squares) of ``f32(max(x, s))`` over the
    rows of x (R, C) -> two f32 (C,).  ``s``: a number or a one-element
    tensor, cast to x's dtype.  ``impl``: None (kernel for CUDA tensors,
    plain version for CPU tensors), "kernel" or "torch"."""
    if resolve_impl(impl, x) == "torch":
        return bn_stats_fwd_reference(x, s)
    _check("x", x)
    sums = _launch(0, (x,), s)
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
    sums = _launch(1, (dy, x), s)
    bn_stats_bwd.launches += 1
    return sums


# calls that launched the kernels since the last reset (a call is two
# launches, counted once; plain-version calls do not count)
bn_stats_fwd.launches = 0
bn_stats_bwd.launches = 0
