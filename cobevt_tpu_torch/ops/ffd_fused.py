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
``csrc/ffd_fused.cu`` (K12 is four launches behind one C entry: row-local
gradients, weight gradients per 32-column slice, and two fixed-order
additions of partial sums; no atomics, so a repeat gives the same bits).  On
CPU tensors they are the plain versions below, which follow the TPU bodies
step by step.
"""

from __future__ import annotations

import ctypes
import functools

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
_ROWS, _ROWS_W, _SLICE = 16, 32, 32     # csrc/ffd_fused.cu's tile plan
_MAX_D = 256
_SMS = 132


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


def bwd_plan(N: int, M: int):
    """(row-kernel blocks, row splits of the weight-gradient grid): two
    16-row blocks to an SM walk the row blocks, and M / 32 slices times the
    splits put two weight-gradient blocks on an SM."""
    row_blocks = min(-(-N // _ROWS), 2 * _SMS)
    splits = max(1, min(-(-N // _ROWS_W), 2 * _SMS // (M // _SLICE)))
    return row_blocks, splits


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("ffd_fused")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fwd, bwd = lib.cobevt_ffd_fwd, lib.cobevt_ffd_bwd
    fwd.argtypes = [P] * 8 + [L, I, I, I, I, P]
    bwd.argtypes = [P] * 13 + [L, I, I, I, I, I, I, P]
    fwd.restype = bwd.restype = I
    return fwd, bwd


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


def _launch_fwd(x, gamma, beta, w1, b1, w2, b2):
    N, D, M = _check(x, gamma, beta, w1, b1, w2, b2)
    dev = x.device
    # nn.Linear's (out, in) layout, which the row product reads
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    out = torch.empty_like(x)
    err = _entries()[0](
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1t.data_ptr(),
        b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(), out.data_ptr(), N, D, M,
        int(x.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_ffd")
    fused_ffd.launches += 1
    return out


def _launch_bwd(x, dy, gamma, beta, w1, b1, w2):
    N, D, M = _check(x, gamma, beta, w1, b1, w2, dy=dy)
    dev = x.device
    w1t = w1.t().contiguous()
    PA, S = bwd_plan(N, M)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dvec = torch.empty(3 * D + M, **f32)
    dw = torch.empty(2 * D * M, **f32)
    pvec = torch.empty((PA, 3 * D + M), **f32)
    pw = torch.empty((S, 2 * D * M), **f32)
    err = _entries()[1](
        x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w1t.data_ptr(), w1.data_ptr(), w2.data_ptr(), b1.data_ptr(),
        dx.data_ptr(), dvec.data_ptr(), dw.data_ptr(), pvec.data_ptr(),
        pw.data_ptr(), N, D, M, PA, S, int(x.dtype == torch.bfloat16),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_ffd_bwd")
    fused_ffd_bwd.launches += 1
    dgamma, dbeta, db2, db1 = dvec.split([D, D, D, M])
    dw1, dw2 = dw[:D * M].view(D, M), dw[D * M:].view(M, D)
    return dx, dgamma, dbeta, dw1, db1, dw2, db2


def fused_ffd_bwd(x, dy, gamma, beta, w1, b1, w2, impl=None):
    """K12: the gradients of :func:`fused_ffd` from its inputs and the
    output's gradient dy (N, D) alone.  Returns (dx, dgamma, dbeta, dw1, db1,
    dw2, db2): dx in x's dtype, the parameter gradients in f32.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU tensors),
    "kernel" or "torch".  One call is four kernel launches behind one C
    entry point and counts once."""
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
