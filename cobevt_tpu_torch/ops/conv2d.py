"""Fused 3x3 convolution (K3) for inference, and BatchNorm folding.

Counterpart of ``cobevt_tpu/ops/conv2d.py``: ``fused_conv3x3`` computes
``relu(conv3x3(x, w) + shift [+ residual])`` for a stride-1 SAME conv on
NHWC activations, with the BatchNorm scale folded into ``w`` by
:func:`fold_bn`.  The CUDA kernel is ``csrc/conv3x3.cu``.  Used by
``nn/layers.py:BasicBlock`` in eval mode.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import check_operand, resolve_impl

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
    scalar, tc = lib.cobevt_conv3x3, lib.cobevt_conv3x3_tc
    scalar.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    tc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    scalar.restype = tc.restype = ctypes.c_int
    return scalar, tc


def _tensor_core_path(x, C, O) -> bool:
    """bf16 with C % 32 == 0 and O % 8 == 0 (every trunk block) runs the
    mma.sync kernel; everything else the scalar-FMA kernel."""
    return x.dtype == torch.bfloat16 and C % 32 == 0 and O % 8 == 0


def _launch_kernel(x, w, shift, residual, relu):
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
    check_operand("shift", shift, (O,), torch.float32, x.device)
    if residual is not None:
        check_operand("residual", residual, (N, H, W, O), x.dtype, x.device)
    out = torch.empty((N, H, W, O), dtype=x.dtype, device=x.device)
    scalar, tc = _lib()
    res_ptr = None if residual is None else residual.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if _tensor_core_path(x, C, O):
        wt = w.reshape(9 * C, O).t().contiguous()   # (O, 9C): K contiguous
        err = tc(x.data_ptr(), wt.data_ptr(), shift.data_ptr(), res_ptr,
                 out.data_ptr(), N, H, W, C, O, int(relu), x.device.index,
                 stream)
    else:
        err = scalar(x.data_ptr(), w.data_ptr(), shift.data_ptr(), res_ptr,
                     out.data_ptr(), N, H, W, C, O, int(relu),
                     int(x.dtype == torch.bfloat16), x.device.index, stream)
    _build.check(err, "conv3x3")
    fused_conv3x3.launches += 1
    return out


def fused_conv3x3(x, w, shift, residual=None, relu: bool = True, impl=None):
    """Stride-1 SAME 3x3 conv + shift (+ residual) (+ ReLU), fused.

    x: (N, H, W, C); w: (3, 3, C, O) with any BatchNorm scale folded in;
    shift: (O,) (the folded BN bias, applied in f32); residual:
    (N, H, W, O) or None, added before the ReLU.  Returns (N, H, W, O) in
    x's dtype.  Inference only.  ``impl``: None (kernel for CUDA tensors,
    plain version for CPU tensors), "kernel" or "torch"."""
    if resolve_impl(impl, x) == "torch":
        return conv3x3_reference(x, w, shift, residual, relu)
    w = w.to(x.dtype).contiguous()
    shift = shift.float().contiguous()
    return _launch_kernel(x, w, shift, residual, relu)


# kernel launches since the last reset (plain-version calls do not count)
fused_conv3x3.launches = 0
