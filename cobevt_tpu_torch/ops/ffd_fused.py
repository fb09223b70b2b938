"""Fused PreNorm feed-forward sublayer (K11) and its recompute backward (K12).

Counterpart of the Pallas pair of ``cobevt_tpu/tools/micro_ffd_fused.py``
(``_pallas_fwd``, ``_pallas_bwd``, bound by ``jax.custom_vjp`` as
``fused_ffd``): over tokens x (N, D) with w1 (D, M) and w2 (M, D) in x's
dtype (the compute dtype) and gamma, beta, b2 (D), b1 (M) in f32,

    out = x + gelu((LN(x) * gamma + beta) @ w1 + b1) @ w2 + b2

with the LayerNorm in f32 (eps 1e-5, biased variance), a cast to the compute
dtype in front of each product, f32 accumulation, and GELU by the TPU body's
own 5-term erf polynomial.  The backward saves the six inputs it needs and
recomputes everything else; the parameter gradients are f32 sums, cast to the
parameters' dtypes at the end.

On CUDA tensors the two are the hand-written kernels of
``csrc/ffd_fused.cu`` on one of two routes, chosen by shape before the
launch (:func:`kernel_path`, :func:`ffd_plan`): "wgmma" (bf16 at D 128 or
256, M a multiple of 128: persistent blocks of two warpgroups on ``wgmma`` +
TMA; K12's row launch stores t, a and dh in bf16 for a split-K weight launch)
or "rows" (f32, and bf16 at the other widths: 16-row f32 tiles on
``mma.sync``).  K12 is four launches behind one C entry on both (row-local
gradients, weight gradients, and two fixed-order additions of partial sums;
no atomics, so a repeat gives the same bits).  On CPU tensors they are the
plain versions below, which follow the TPU bodies step by step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import (
    check_aligned,
    check_operand,
    resolve_impl,
)

EPS = 1e-5
INV_SQRT_2PI = 0.3989422804014327
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_SMEM_LIMIT = 232448          # an H100 block's shared-memory maximum
_ROWS, _ROWS_W, _SLICE = 16, 32, 32     # the row kernels' tile plan
_MAX_D = 256
_SMS = 132
# the wgmma route (csrc/ffd_fused.cu, namespace wg): 64-row tiles, two
# warpgroups a block, 16 KB weight boxes of 64 x 64 atoms (48 KB stages in
# the weight launch), at most 8 ring stages
_TILE, _GROUPS, _ATOM, _MAX_STAGES = 64, 2, 64 * 128, 8
_WG_WIDTHS = (128, 256)
_WEIGHT_TILE = 128            # the weight launch's output tile rows


def _tile_width(ncols: int) -> int:
    """The weight launch's output tile width: 256 columns where they divide
    the matrix, else 128."""
    return 256 if ncols % 256 == 0 else 128


def erf_poly(x):
    """erf by the Abramowitz-Stegun 5-term polynomial (|error| <= 1.5e-7),
    ``_erf_f32`` of the JAX tool."""
    sign = torch.sign(x)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def gelu_poly(h):
    return 0.5 * h * (1.0 + erf_poly(h * (2.0 ** -0.5)))


def dgelu_poly(h):
    phi = torch.exp(-0.5 * h * h) * INV_SQRT_2PI
    return 0.5 * (1.0 + erf_poly(h * (2.0 ** -0.5))) + h * phi


def _ln_parts(x):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + EPS)
    return (xf - mu) * r, r


def _recompute(x, gamma, beta, w1, b1):
    """xhat, r, t, h, a of the forward; t and a rounded to x's dtype."""
    cd = x.dtype
    xhat, r = _ln_parts(x)
    t = (xhat * gamma.float() + beta.float()).to(cd)
    h = t.float() @ w1.float() + b1.float()
    a = gelu_poly(h).to(cd)
    return xhat, r, t, h, a


def ffd_reference(x, gamma, beta, w1, b1, w2, b2):
    """Plain PyTorch version of K11: ``_fwd_kernel`` of the JAX tool on whole
    tensors, with its casts and its erf polynomial."""
    _, _, _, _, a = _recompute(x, gamma, beta, w1, b1)
    y = a.float() @ w2.float() + b2.float()
    return (x.float() + y).to(x.dtype)


def ffd_backward_reference(x, dy, gamma, beta, w1, b1, w2):
    """Plain PyTorch version of K12: ``_bwd_kernel`` of the JAX tool on whole
    tensors.  Returns (dx, dgamma, dbeta, dw1, db1, dw2, db2): dx in x's
    dtype, the others in f32."""
    cd = x.dtype
    xhat, r, t, h, a = _recompute(x, gamma, beta, w1, b1)
    g_out = dy.float()
    gc = g_out.to(cd).float()
    da = gc @ w2.float().t()
    dh = (da * dgelu_poly(h)).to(cd).float()
    dt = dh @ w1.float().t()
    dgamma = (dt * xhat).sum(dim=0)
    dbeta = dt.sum(dim=0)
    dxhat = dt * gamma.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (g_out + r * (dxhat - m1 - xhat * m2)).to(cd)
    dw2 = a.float().t() @ gc
    db2 = g_out.sum(dim=0)
    dw1 = t.float().t() @ dh
    db1 = dh.sum(dim=0)
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


def ffd_kernel_accepts(N: int, D: int, M: int, dtype) -> bool:
    """Whether the CUDA kernels take the shape: widths multiples of 64 (the
    row product's column split), D at most 256 (one warp per 32 columns in
    the weight-gradient kernel), tiles within a block's shared memory, f32
    or bf16.  N is free: the tail rows are masked."""
    if dtype not in _KERNEL_DTYPES or N < 1 or D < 64 or M < 64:
        return False
    if D % 64 or M % 64 or D > _MAX_D:
        return False
    rows = (_ROWS * 2 * (D + 8 + M + 8) + 3 * D + M) * 4
    weights = _ROWS_W * 2 * (D + 8 + _SLICE + 8) * 4
    return max(rows, weights) <= _SMEM_LIMIT


def kernel_path(N: int, D: int, M: int, dtype) -> str:
    """The route a shape the kernels take runs on: "wgmma" for bf16 at D 128
    or 256 with M a multiple of 128 (the weight launch's 128-row output
    tiles), "rows" for every other shape :func:`ffd_kernel_accepts` takes
    (f32, and bf16 at D 64 or 192 or M an odd multiple of 64)."""
    if (dtype == torch.bfloat16 and D in _WG_WIDTHS
            and M % _WEIGHT_TILE == 0 and N < 2 ** 31):
        return "wgmma"
    return "rows"


def _stages(fixed: int, stage: int, cap: int) -> int:
    """The most ring stages of ``stage`` bytes, up to ``cap``, that fit a
    block's shared memory beside ``fixed`` bytes (1 KB of alignment and the
    barriers included)."""
    return min(cap, (_SMEM_LIMIT - fixed) // stage)


class RowsPlan(NamedTuple):
    """K12's plan on the row kernels: ``blocks`` persistent 16-row blocks,
    one partial row each, and the weight kernel's ``splits``, 32 hidden
    columns a block, split s walking the 32-row blocks s, s + S, ...  (K11
    there is one 16-row block a tile and needs no plan.)"""
    route = "rows"
    blocks: int
    splits: int

    @property
    def vec_rows(self) -> int:
        """The vector partial rows: one per block."""
        return self.blocks


class WgmmaPlan(NamedTuple):
    """What the launches of the wgmma route take: K11's and the row launch's
    ``blocks`` (persistent, two 64-row tiles a step), each launch's ring
    stages and shared-memory bytes (the C entries refuse bytes that differ
    from their own layout's), and the weight launch's ``splits`` of the
    token rows, ``split_steps`` 64-row steps each: ``split_rows`` holds
    [start, stop) of each, in order, covering [0, N) once."""
    route = "wgmma"
    tile_rows = _TILE
    blocks: int
    fwd_stages: int
    fwd_smem: int
    rows_stages: int
    rows_smem: int
    splits: int
    split_steps: int
    split_rows: tuple
    weight_stages: int
    weight_smem: int

    @property
    def vec_rows(self) -> int:
        """The vector partial rows: one per warpgroup (its tiles' dgamma and
        dbeta)."""
        return self.blocks * _GROUPS

    def bwd_ints(self):
        """The plan ints of ``cobevt_ffd_bwd_wgmma``."""
        return (self.blocks, self.rows_stages, self.splits, self.split_steps,
                self.weight_stages, self.rows_smem, self.weight_smem)


def weight_tiles(D: int, M: int) -> int:
    """The wgmma weight launch's output tiles: 128 rows by
    :func:`_tile_width` columns of dW1 (D, M) and of dW2 (M, D)."""
    return ((D // _WEIGHT_TILE) * (M // _tile_width(M))
            + (M // _WEIGHT_TILE) * (D // _tile_width(D)))


def ffd_plan(N: int, D: int, M: int, dtype=torch.bfloat16):
    """The launch plan of :func:`kernel_path`'s route for a shape
    :func:`ffd_kernel_accepts` takes: a :class:`RowsPlan` or a
    :class:`WgmmaPlan`.

    wgmma: 660 pairs of 64-row tiles at the LiDAR shape, five a block on
    132 SMs; the weight ring both warpgroups read takes the shared memory
    their tiles leave: K11's two (t, a) tile sets leave 8 stages, the row
    launch's four tiles a warpgroup (t, g, a, dh: 160 KB at D 256) leave
    4; the weight launch's 8 output tiles of 128 x 256 (D 256, M 512)
    times 16 splits are 128 blocks, one wave, each walking 83 contiguous
    64-row steps through 4 stages of 48 KB."""
    if kernel_path(N, D, M, dtype) == "rows":
        return RowsPlan(
            min(-(-N // _ROWS), 2 * _SMS),
            max(1, min(-(-N // _ROWS_W), 2 * _SMS // (M // _SLICE))))
    pairs = -(-(-(-N // _TILE)) // _GROUPS)
    bars = (2 * _MAX_STAGES + _GROUPS) * 8
    box = 2 * _ATOM
    fwd_fixed = 1024 + _GROUPS * (_TILE * D * 2 + _ATOM) + bars
    rows_fixed = 1024 + _GROUPS * (2 * _TILE * D * 2 + 2 * _ATOM) + bars
    fwd_stages = _stages(fwd_fixed, box, _MAX_STAGES)
    rows_stages = _stages(rows_fixed, box, _MAX_STAGES)
    steps = -(-N // _TILE)
    splits = max(1, min(steps, _SMS // weight_tiles(D, M)))
    per = -(-steps // splits)
    splits = -(-steps // per)          # no split without rows
    ranges = tuple((s * per * _TILE, min((s + 1) * per * _TILE, N))
                   for s in range(splits))
    w_fixed = 1024 + 2 * _MAX_STAGES * 8
    w_stages = _stages(w_fixed, 6 * _ATOM, 6)
    return WgmmaPlan(
        min(pairs, _SMS), fwd_stages, fwd_fixed + fwd_stages * box,
        rows_stages, rows_fixed + rows_stages * box, splits, per, ranges,
        w_stages, w_fixed + w_stages * 6 * _ATOM)


@functools.lru_cache(maxsize=None)
def _entries():
    """The C entries {(route, "fwd" or "bwd"): function}."""
    lib = _build.load("ffd_fused")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    IP = ctypes.POINTER(ctypes.c_int)
    fns = {("rows", "fwd"): (lib.cobevt_ffd_fwd, [P] * 8 + [L, I, I, I, I, P]),
           ("rows", "bwd"): (lib.cobevt_ffd_bwd,
                             [P] * 13 + [L, I, I, I, I, I, I, P]),
           ("wgmma", "fwd"): (lib.cobevt_ffd_fwd_wgmma,
                              [P] * 8 + [L, I, I, I, I, I, I, P]),
           ("wgmma", "bwd"): (lib.cobevt_ffd_bwd_wgmma,
                              [P] * 15 + [L, I, I, IP, I, P])}
    for fn, argtypes in fns.values():
        fn.argtypes = argtypes
        fn.restype = I
    return {k: fn for k, (fn, _) in fns.items()}


def _check(x, gamma, beta, w1, b1, w2, b2=None, dy=None):
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D); got {tuple(x.shape)}")
    N, D = x.shape
    M = w1.shape[-1]
    if not ffd_kernel_accepts(N, D, M, x.dtype):
        raise ValueError(f"K11/K12 do not take N={N}, D={D}, M={M}, "
                         f"{x.dtype}: widths are multiples of 64, D <= "
                         f"{_MAX_D}, f32 or bf16")
    dev = x.device
    check_operand("x", x, (N, D), x.dtype, dev)
    check_aligned("x", x)
    check_operand("w1", w1, (D, M), x.dtype, dev)
    check_operand("w2", w2, (M, D), x.dtype, dev)
    vectors = [("gamma", gamma, D), ("beta", beta, D), ("b1", b1, M)]
    if b2 is not None:
        vectors.append(("b2", b2, D))
    for name, t, n in vectors:
        check_operand(name, t, (n,), torch.float32, dev)
    if dy is not None:
        check_operand("dy", dy, (N, D), x.dtype, dev)
        check_aligned("dy", dy)
    return N, D, M


def _check_wgmma_bases(**operands):
    """The wgmma route reads the weights through TMA and the vectors two
    values at a time: every base on a 16-byte boundary."""
    for name, t in operands.items():
        check_aligned(name, t)


def _launch_fwd(x, gamma, beta, w1, b1, w2, b2):
    N, D, M = _check(x, gamma, beta, w1, b1, w2, b2)
    dev = x.device
    plan = ffd_plan(N, D, M, x.dtype)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "wgmma":
        # the weights in their own layouts, read through TMA
        _check_wgmma_bases(w1=w1, w2=w2, gamma=gamma, beta=beta, b1=b1,
                           b2=b2)
        err = _entries()["wgmma", "fwd"](
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), N,
            D, M, plan.blocks, plan.fwd_stages, plan.fwd_smem, dev.index,
            stream)
    else:
        # nn.Linear's (out, in) layout, which the row product reads
        w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
        err = _entries()["rows", "fwd"](
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1t.data_ptr(),
            b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), out.data_ptr(), N,
            D, M, int(x.dtype == torch.bfloat16), dev.index, stream)
    _build.check(err, "fused_ffd")
    fused_ffd.launches += 1
    return out


def _launch_bwd(x, dy, gamma, beta, w1, b1, w2):
    N, D, M = _check(x, gamma, beta, w1, b1, w2, dy=dy)
    dev = x.device
    plan = ffd_plan(N, D, M, x.dtype)
    if plan.route == "wgmma":
        _check_wgmma_bases(w1=w1, w2=w2, gamma=gamma, beta=beta, b1=b1)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    # wgmma: [dgamma | dbeta] from the row launch, [dw1 | dw2 | db1 | db2]
    # from the weight launch; rows: [dgamma | dbeta | db2 | db1], [dw1 | dw2]
    wg = plan.route == "wgmma"
    vec, wide = (2 * D, 2 * D * M + M + D) if wg else (3 * D + M, 2 * D * M)
    dvec = torch.empty(vec, **f32)
    dw = torch.empty(wide, **f32)
    pvec = torch.empty((plan.vec_rows, vec), **f32)
    pw = torch.empty((plan.splits, wide), **f32)
    out_ptrs = [dx.data_ptr(), dvec.data_ptr(), dw.data_ptr(),
                pvec.data_ptr(), pw.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan.route == "wgmma":
        # the weights in their own layouts; t, a and dh in bf16 for the
        # weight launch (216 MB at the LiDAR shape)
        t_buf = torch.empty_like(x)
        a_buf = torch.empty((N, M), dtype=x.dtype, device=dev)
        h_buf = torch.empty((N, M), dtype=x.dtype, device=dev)
        ints = (ctypes.c_int * 7)(*plan.bwd_ints())
        err = _entries()["wgmma", "bwd"](
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), b1.data_ptr(), *out_ptrs,
            t_buf.data_ptr(), a_buf.data_ptr(), h_buf.data_ptr(), N, D, M,
            ints, dev.index, stream)
    else:
        w1t = w1.t().contiguous()
        err = _entries()["rows", "bwd"](
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            w1t.data_ptr(), w1.data_ptr(), w2.data_ptr(), b1.data_ptr(),
            *out_ptrs, N, D, M, plan.blocks, plan.splits,
            int(x.dtype == torch.bfloat16), dev.index, stream)
    _build.check(err, "fused_ffd_bwd")
    fused_ffd_bwd.launches += 1
    if wg:
        dgamma, dbeta = dvec.split([D, D])
        dw1, dw2, db1, db2 = dw.split([D * M, D * M, M, D])
    else:
        dgamma, dbeta, db2, db1 = dvec.split([D, D, D, M])
        dw1, dw2 = dw.split([D * M, D * M])
    return dx, dgamma, dbeta, dw1.view(D, M), db1, dw2.view(M, D), db2


def fused_ffd_bwd(x, dy, gamma, beta, w1, b1, w2, impl=None):
    """K12: the gradients of :func:`fused_ffd` from its inputs and the
    output's gradient dy (N, D) alone.  Returns (dx, dgamma, dbeta, dw1, db1,
    dw2, db2): dx in x's dtype, the parameter gradients in f32.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU tensors),
    "kernel" or "torch".  One call is four kernel launches behind one C
    entry point on either route (:func:`kernel_path`) and counts once."""
    if resolve_impl(impl, x) == "torch":
        return ffd_backward_reference(x, dy, gamma, beta, w1, b1, w2)
    return _launch_bwd(x.contiguous(), dy.to(x.dtype).contiguous(),
                       gamma.float().contiguous(), beta.float().contiguous(),
                       w1.contiguous(), b1.float().contiguous(),
                       w2.contiguous())


class _FusedFFD(torch.autograd.Function):
    """K11 forward, K12 backward; saves the six inputs the backward reads."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, impl):
        if impl == "torch":
            out = ffd_reference(x, gamma, beta, w1, b1, w2, b2)
        else:
            out = _launch_fwd(
                x.contiguous(), gamma.float().contiguous(),
                beta.float().contiguous(), w1.contiguous(),
                b1.float().contiguous(), w2.contiguous(),
                b2.float().contiguous())
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2)
        ctx.impl, ctx.b2_dtype = impl, b2.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, b1, w2 = ctx.saved_tensors
        dx, dgamma, dbeta, dw1, db1, dw2, db2 = fused_ffd_bwd(
            x, dy, gamma, beta, w1, b1, w2, impl=ctx.impl)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None)


def fused_ffd(x, gamma, beta, w1, b1, w2, b2, impl=None):
    """K11: the PreNorm feed-forward sublayer with its residual, x (N, D) ->
    (N, D) in x's dtype; w1 (D, M) and w2 (M, D) in x's dtype, gamma, beta,
    b2 (D) and b1 (M) in f32.  Differentiable in all seven operands through
    K12.

    ``impl``: None (kernels for CUDA tensors, plain versions for CPU
    tensors), "kernel" or "torch".  The kernels raise on a shape they do
    not take (:func:`ffd_kernel_accepts`)."""
    return _FusedFFD.apply(x, gamma, beta, w1, b1, w2, b2,
                           resolve_impl(impl, x))


# kernel calls since the last reset (plain-version calls do not count)
fused_ffd.launches = 0
fused_ffd_bwd.launches = 0
