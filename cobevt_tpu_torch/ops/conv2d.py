"""Fused 3x3 convolution for inference (K3, and K7 with int8 products), and
BatchNorm folding.

Counterpart of ``cobevt_tpu/ops/conv2d.py``: ``fused_conv3x3`` computes
``relu(conv3x3(x, w) + shift [+ residual])`` for a stride-1 SAME conv on
NHWC activations, with the BatchNorm scale folded into ``w`` by
:func:`fold_bn`.  The CUDA kernel is ``csrc/conv3x3.cu``.  Used by
``nn/layers.py:BasicBlock`` in eval mode.

``fused_conv3x3_int8`` is its post-training-quantized twin (the lossy
``COBEVT_INT8=1`` serving mode): the folded weight quantized per output
channel (:func:`quantize_weight`), the activations per tensor with a dynamic
scale (:func:`act_scale`, one max-reduce) and quantized inside the kernel
(``csrc/conv3x3_int8.cu``), s8 x s8 -> s32 products, f32 epilogue.  Weight
quantization and the max-reduce are plain PyTorch outside the kernel, as they
are XLA outside the Pallas body.  f32 and bf16 activations take the same
kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import (
    check_aligned,
    check_operand,
    resolve_impl,
)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def fold_bn(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Fold inference BatchNorm into (scaled kernel, shift), in f32.

    bn(conv(x)) = conv(x) * s + t with s = scale / sqrt(var + eps) and
    t = bias - mean * s.  ``kernel`` is HWIO (3, 3, C, O)."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    t = bias.float() - mean.float() * s
    return kernel.float() * s, t


def conv3x3_reference(x, w, shift, residual=None, relu: bool = True):
    """Plain PyTorch version of K3 (the JAX ``_xla_reference``): the conv
    of x with w cast to x's dtype, accumulated and finished in f32, output
    in x's dtype."""
    w_oihw = w.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w_oihw, padding=1)
    y = y.permute(0, 2, 3, 1) + shift.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _lib():
    lib = _build.load("conv3x3")
    scalar, wg = lib.cobevt_conv3x3, lib.cobevt_conv3x3_wgmma
    scalar.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    wg.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    scalar.restype = wg.restype = ctypes.c_int
    return scalar, wg


# the wgmma kernel's tile: 128 output pixels of one image by 128 channels
_WGMMA_PIXELS = 128


def conv_tile_plan(H: int, W: int):
    """The spatial box of one output tile of the wgmma kernel: (bh, bw,
    tiles_y, tiles_x).  bw is W rounded up to a power of two, at most 128,
    and bh = 128 / bw, so a tile is 128 pixel slots of one image (2 x 64 at
    W 64, 4 x 32 at W 32, 8 x 16 at W 16); slots past the image's edge are
    zero-filled by TMA and not stored."""
    bw = min(_WGMMA_PIXELS, 1 << max(W - 1, 0).bit_length())
    bh = _WGMMA_PIXELS // bw
    return bh, bw, -(-H // bh), -(-W // bw)


@dataclasses.dataclass(frozen=True)
class Conv3x3Weight:
    """A folded conv weight prepared once for K3: ``w`` (3, 3, C, O) in the
    compute dtype (the plain version and the scalar kernel), ``wt`` = w as
    (O, 9*C) with K contiguous, tap-major and channel-minor (the wgmma
    kernel's operand; None in f32), ``shift`` (O,) f32."""
    w: torch.Tensor
    wt: torch.Tensor
    shift: torch.Tensor


def pack_conv3x3_weight(w, shift, dtype) -> Conv3x3Weight:
    """Cast and transpose a folded f32 weight once for activations of
    ``dtype``; a module keeps the result in a ``PackCache``
    (``ops/dispatch.py``) keyed on its parameters."""
    w = w.to(dtype).contiguous()
    C, O = w.shape[2:]
    wt = None
    if dtype == torch.bfloat16:
        wt = w.reshape(9 * C, O).t().contiguous()
    return Conv3x3Weight(w, wt, shift.float().contiguous())


def _kernel_path(x, C, O) -> str:
    """bf16 with C % 32 == 0 and O % 8 == 0 (every trunk block) runs the
    wgmma kernel; everything else the scalar-FMA kernel."""
    if x.dtype == torch.bfloat16 and C % 32 == 0 and O % 8 == 0:
        return "wgmma"
    return "scalar"


def _launch_kernel(x, packed: Conv3x3Weight, residual, relu):
    w = packed.w
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"K3 takes x (N, H, W, C) and w (3, 3, C, O); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, H, W, C = x.shape
    O = w.shape[-1]
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"K3 takes {_KERNEL_DTYPES}, got {x.dtype}")
    if w.shape[2] != C:
        raise ValueError(f"w has {w.shape[2]} input channels, x has {C}")
    if C % 16 or O % 4:
        raise ValueError(f"K3 takes C % 16 == 0 and O % 4 == 0; got C={C}, "
                         f"O={O}")
    check_operand("x", x, (N, H, W, C), x.dtype, x.device)
    check_operand("w", w, (3, 3, C, O), x.dtype, x.device)
    check_operand("shift", packed.shift, (O,), torch.float32, x.device)
    if residual is not None:
        check_operand("residual", residual, (N, H, W, O), x.dtype, x.device)
    out = torch.empty((N, H, W, O), dtype=x.dtype, device=x.device)
    scalar, wg = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = _kernel_path(x, C, O)
    if path == "scalar":
        err = scalar(x.data_ptr(), w.data_ptr(), packed.shift.data_ptr(),
                     None if residual is None else residual.data_ptr(),
                     out.data_ptr(), N, H, W, C, O, int(relu),
                     int(x.dtype == torch.bfloat16), x.device.index, stream)
    else:
        check_operand("wt", packed.wt, (O, 9 * C), x.dtype, x.device)
        # TMA reads and writes these from 16-byte-aligned bases
        for name, t in (("x", x), ("wt", packed.wt), ("residual", residual)):
            if t is not None:
                check_aligned(name, t)
        bh, bw, _, _ = conv_tile_plan(H, W)
        err = wg(x.data_ptr(), packed.wt.data_ptr(), packed.shift.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), N, H, W, C, O, int(relu), bh, bw,
                 x.device.index, stream)
    _build.check(err, "conv3x3")
    fused_conv3x3.launches += 1
    return out


def fused_conv3x3(x, w, shift, residual=None, relu: bool = True, impl=None,
                  packed: Conv3x3Weight = None):
    """Stride-1 SAME 3x3 conv + shift (+ residual) (+ ReLU), fused.

    x: (N, H, W, C); w: (3, 3, C, O) with any BatchNorm scale folded in;
    shift: (O,) (the folded BN bias, applied in f32); residual:
    (N, H, W, O) or None, added before the ReLU.  Returns (N, H, W, O) in
    x's dtype.  ``packed``: the weight already prepared by
    :func:`pack_conv3x3_weight` for x's dtype (``w`` and ``shift`` are then
    not read), so a call launches the kernel and nothing else.  ``impl``:
    None (kernel for CUDA tensors, plain version for CPU tensors), "kernel"
    or "torch".

    On the card, bf16 with C % 32 == 0 and O % 8 == 0 runs the wgmma
    kernel, the rest (f32 included) the scalar kernel: a choice by shape,
    the same function and roundings on both paths.  The kernel raises for
    an x, residual or packed weight that does not start on a 16-byte
    boundary (TMA's rule) rather than copy it.

    Inference only: the kernel has no backward, its result carries no
    ``grad_fn``, and an eval forward under autograd gives no gradient
    through it.  Training runs the unfused block (``self.training``
    gates the dispatch)."""
    if packed is None:
        packed = pack_conv3x3_weight(w, shift, x.dtype)
    if resolve_impl(impl, x) == "torch":
        return conv3x3_reference(x, packed.w, packed.shift, residual, relu)
    return _launch_kernel(x, packed, residual, relu)


# kernel launches since the last reset (plain-version calls do not count)
fused_conv3x3.launches = 0


# ---------------------------------------------------------------------------
# K7: the int8 twin
# ---------------------------------------------------------------------------

# K7's tile plan (csrc/conv3x3_int8.cu): 128 pixel slots and 64-byte K slices
# per block, the s8 halo tile and two weight stages in shared memory
_INT8_SLOTS, _INT8_K, _INT8_SMEM = 128, 64, 232448


def quantize_weight(w):
    """Per-out-channel symmetric int8 quantization of a folded (3, 3, C, O)
    kernel -> (w_q int8, s_w f32 (O,)); ``_quantize_weight`` of the JAX
    package: the scale is ``max|w| / 127`` clamped from below at 1e-12."""
    wf = w.float()
    s_w = wf.abs().amax(dim=(0, 1, 2)) / 127.0
    s_w = torch.clamp_min(s_w, 1e-12)
    w_q = torch.clamp(torch.round(wf / s_w), -127, 127).to(torch.int8)
    return w_q, s_w


def act_scale(x):
    """Dynamic per-tensor activation scale, a 0-d f32 tensor (no host
    sync): ``_act_scale`` of the JAX package.  The maximum is taken in x's
    dtype and cast afterwards, which gives the same value as the JAX order
    (cast, then maximum) without an f32 copy of x."""
    s_a = x.abs().amax().float() / 127.0
    return torch.clamp_min(s_a, 1e-12)


@contextlib.contextmanager
def _full_f32_matmul():
    """TF32 off for the products inside: they must be exact."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def conv3x3_s32(x_q, w_q):
    """Exact stride-1 SAME 3x3 convolution of int8 activations (N, H, W, C)
    with an int8 kernel (3, 3, C, O) -> int32 (N, H, W, O), on any device.

    PyTorch has no integer convolution on CUDA, so each tap is one f32
    matrix product of integer-valued operands (TF32 off): every partial sum
    is an integer below ``C * 127**2 < 2**24`` and so exact in f32 in any
    order of summation; the nine taps are then added as int32."""
    N, H, W, C = x_q.shape
    O = w_q.shape[-1]
    if C * 127 ** 2 >= 2 ** 24:
        raise ValueError(f"conv3x3_s32 is exact for C * 127**2 < 2**24; got "
                         f"C={C}")
    xp = torch.nn.functional.pad(x_q.float(), (0, 0, 1, 1, 1, 1))
    wf = w_q.float()
    acc = torch.zeros((N * H * W, O), dtype=torch.int32, device=x_q.device)
    with _full_f32_matmul():
        for dy in range(3):
            for dx in range(3):
                tap = xp[:, dy:dy + H, dx:dx + W, :].reshape(N * H * W, C)
                acc += (tap @ wf[dy, dx]).to(torch.int32)
    return acc.reshape(N, H, W, O)


def conv3x3_int8_reference(x, w_q, s_w, s_a, shift, residual=None,
                           relu: bool = True):
    """Plain PyTorch version of K7 (the JAX ``_xla_reference_int8``), integer
    exact: the activations quantized as ``clip(round(f32(x) * (1 / s_a)))``
    (a multiply by the reciprocal, round half to even), the s32 conv, then
    ``f32(acc) * (s_a * s_w) + shift (+ f32(residual))``, ReLU, cast to x's
    dtype."""
    inv = 1.0 / s_a
    x_q = torch.clamp(torch.round(x.float() * inv), -127.0, 127.0).to(
        torch.int8)
    y = conv3x3_s32(x_q, w_q).float() * (s_a * s_w) + shift.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Int8Weight:
    """A folded conv weight quantized for K7: ``w_q`` (3, 3, C, O) int8,
    ``s_w`` (O,) f32, ``wt`` = w_q as (O, 9*C) with K contiguous (the
    kernel's operand), ``shift`` (O,) f32."""
    w_q: torch.Tensor
    s_w: torch.Tensor
    wt: torch.Tensor
    shift: torch.Tensor


def pack_int8_weight(w, shift) -> Int8Weight:
    """Quantize a folded f32 weight once; a module keeps the result in a
    ``PackCache`` (``ops/dispatch.py``) keyed on its parameters."""
    w_q, s_w = quantize_weight(w)
    C, O = w_q.shape[2:]
    return Int8Weight(w_q, s_w, w_q.reshape(9 * C, O).t().contiguous(),
                      shift.float().contiguous())


def int8_kernel_accepts(shape, O: int, dtype, dtypes=_KERNEL_DTYPES):
    """None when K7 takes x of ``shape`` (N, H, W, C) and ``dtype`` (one of
    ``dtypes``: the chain's entry takes int8) with O output channels, else
    the reason it does not.  Looks at nothing of the device."""
    if len(shape) != 4:
        return f"x must be (N, H, W, C), got {tuple(shape)}"
    _, H, W, C = shape
    if dtype not in dtypes:
        return f"K7 takes {dtypes}, got {dtype}"
    if C % _INT8_K or O % 8:
        return f"K7 takes C % {_INT8_K} == 0 and O % 8 == 0; got C={C}, O={O}"
    if W > _INT8_SLOTS:
        return f"K7 takes W <= {_INT8_SLOTS}, got {W}"
    rows = min(H, max(1, _INT8_SLOTS // W))
    smem = (rows + 2) * (W + 2) * (C + 16) + 2 * (64 if O <= 64 else 128) * 80
    if smem > _INT8_SMEM:
        return (f"K7's halo tile of {rows + 2} x {W + 2} x {C} needs {smem} "
                f"bytes of shared memory, more than {_INT8_SMEM}")
    return None


def _int8_lib():
    fn = _build.load("conv3x3_int8").cobevt_conv3x3_int8
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_int8(x, packed: Int8Weight, scale, inv, residual, relu):
    """Launch K7 with the scalars prepared: ``scale`` (O,) = s_a * s_w and
    ``inv`` (1,) = 1 / s_a, f32 on x's device."""
    O, K = packed.wt.shape
    why = int8_kernel_accepts(x.shape, O, x.dtype)
    if why is not None:
        raise ValueError(why)
    N, H, W, C = x.shape
    if K != 9 * C:
        raise ValueError(f"the weight has {K // 9} input channels, x has {C}")
    check_operand("x", x, (N, H, W, C), x.dtype, x.device)
    check_operand("wt", packed.wt, (O, 9 * C), torch.int8, x.device)
    check_operand("scale", scale, (O,), torch.float32, x.device)
    check_operand("shift", packed.shift, (O,), torch.float32, x.device)
    check_operand("inv", inv, (1,), torch.float32, x.device)
    if residual is not None:
        check_operand("residual", residual, (N, H, W, O), x.dtype, x.device)
    out = torch.empty((N, H, W, O), dtype=x.dtype, device=x.device)
    err = _int8_lib()(
        x.data_ptr(), packed.wt.data_ptr(), scale.data_ptr(),
        packed.shift.data_ptr(), inv.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        N, H, W, C, O, int(relu), int(x.dtype == torch.bfloat16),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_int8")
    fused_conv3x3_int8.launches += 1
    return out


def fused_conv3x3_int8(x, w, shift, residual=None, relu: bool = True,
                       impl=None, packed: Int8Weight = None):
    """int8 post-training-quantized twin of :func:`fused_conv3x3`, same
    contract (folded-BN f32 ``w`` and ``shift``): the weight quantized per
    output channel, the activations per tensor with the dynamic scale of this
    call.  ``packed``: the weight already quantized by
    :func:`pack_int8_weight` (``w`` and ``shift`` are then not read).
    ``impl``: None (kernel for CUDA tensors, plain version for CPU tensors),
    "kernel" or "torch".  Inference only, as K3."""
    if packed is None:
        packed = pack_int8_weight(w, shift)
    s_a = act_scale(x)
    if resolve_impl(impl, x) == "torch":
        return conv3x3_int8_reference(x, packed.w_q, packed.s_w, s_a,
                                      packed.shift, residual, relu)
    return _launch_int8(x, packed, s_a * packed.s_w, (1.0 / s_a).reshape(1),
                        residual, relu)


fused_conv3x3_int8.launches = 0
