"""int8-resident conv chains for the narrow trunk stage (serving).

Counterpart of ``cobevt_tpu/ops/int8_chain.py``.  K7 (``ops/conv2d.py``,
gated to C >= 256) still reads bf16 activations from device memory; this
path keeps a whole stage's activations RESIDENT as int8: quantize once at
region entry (dynamic per-tensor scale), run every conv as s8 x s8 -> s32
with rescale + ReLU + requantize in the epilogue, and dequantize once at
region exit, in the last conv's epilogue.  It is the lossy
``COBEVT_INT8=1`` serving mode; ``tools/validate_kernels.py`` gates its
accuracy.

Scale scheme, the JAX package's: one dynamic scale ``s0`` from the region
input; a block's intermediate uses its input scale times
``INTERMEDIATE_HEADROOM``, a block's output its input scale times
``BLOCK_GROWTH``; values outside the range saturate.

The JAX module leaves the int8 convolution to XLA.  PyTorch has no integer
convolution on CUDA, so on the card :func:`conv3x3_s8` launches the second
entry of K7's source (``csrc/conv3x3_int8.cu:cobevt_conv3x3_s8``), and the
activations between the convs are ``torch.int8`` tensors in device memory:
one int8 read and one int8 (or exit) write per conv.  At C = O = 64 and W <=
128 (layer1, every conv of the chain) it runs the strip kernel
(:func:`s8_plan`): persistent blocks over strips of image rows, the 36 KB
weight resident in shared memory, halo and residual rows streamed through
rings by TMA, products on ``wgmma`` s8, and the requantization, the exit cast
and the count of clipped values in its epilogue; other shapes run K7's
``mma.sync`` implicit GEMM with the s8 activations copied into its halo tile
as they are.  Its plain
version (:func:`conv3x3_s8_reference`, CPU tensors and reference runs) takes
the s32 conv from :func:`cobevt_tpu_torch.ops.conv2d.conv3x3_s32`.  Both give
the JAX module's integers exactly.  Note the two quantizers here ADD 1e-12 to
the scale and DIVIDE by it, where K7's clamp the scale and multiply by its
reciprocal.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.conv2d import (
    Int8Weight,
    conv3x3_s32,
    int8_kernel_accepts,
)
from cobevt_tpu_torch.ops.dispatch import KernelOp, check_operand, route
from cobevt_tpu_torch.utils import flops

INTERMEDIATE_HEADROOM = 2.0
BLOCK_GROWTH = 1.5


def quantize_dynamic(x):
    """Symmetric per-tensor int8 quantization with a dynamic scale.

    Returns (x_q int8, s 0-d f32 tensor) with x ~= x_q * s; no host sync."""
    xf = x.float()
    s = xf.abs().amax() / 127.0 + 1e-12
    xq = torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8)
    return xq, s


def quantize_kernel_per_out(w):
    """Per-out-channel symmetric int8 quantization of a folded (kh, kw, I,
    O) f32 kernel -> (w_q int8, s_w f32 (O,))."""
    sw = w.abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
    wq = torch.clamp(torch.round(w / sw), -127.0, 127.0).to(torch.int8)
    return wq, sw


def pack_s8_weight(w, t) -> Int8Weight:
    """A folded f32 kernel and shift quantized once for the chain, with the
    kernel's (O, 9*C) operand; a module keeps it in a ``PackCache``."""
    wq, sw = quantize_kernel_per_out(w.float())
    C, O = wq.shape[2:]
    return Int8Weight(wq, sw, wq.reshape(9 * C, O).t().contiguous(),
                      t.float().contiguous())


def conv3x3_s8_reference(xq, sx, wq, sw, t, *, relu: bool = True,
                         out_scale=None, residual_q=None,
                         residual_scale=None, out_dtype=torch.bfloat16,
                         with_sat: bool = False):
    """Plain PyTorch version of :func:`conv3x3_s8`: the JAX function, with
    its f32 operations in its order."""
    f = conv3x3_s32(xq, wq).float() * (sx * sw) + t
    if residual_q is not None:
        f = f + residual_q.float() * residual_scale
    if relu:
        f = torch.relu(f)
    if out_scale is None:
        out = f.to(out_dtype)
        if with_sat:
            return out, torch.zeros((), dtype=torch.float32, device=f.device)
        return out
    ticks = torch.round(f / out_scale)
    out = torch.clamp(ticks, -127.0, 127.0).to(torch.int8)
    if with_sat:
        return out, (ticks.abs() > 127.0).float().mean()
    return out


_OUT_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}

# the strip kernel (csrc/conv3x3_int8.cu, namespace strip): its channels, its
# widest row, the blocks it keeps on an SM, its ring depths and buffers
S8_CHANNELS, S8_MAX_W, S8_BLOCKS_PER_SM = 64, 128, 2
S8_HALO_STAGES, S8_RES_STAGES = 5, 2
S8_HALO_BYTES = -(-(S8_MAX_W + 2) * S8_CHANNELS // 512) * 512
S8_WEIGHT_BYTES = 9 * S8_CHANNELS * S8_CHANNELS
S8_SMEM_BYTES = (1024 + S8_WEIGHT_BYTES + S8_HALO_STAGES * S8_HALO_BYTES
                 + S8_RES_STAGES * S8_MAX_W * S8_CHANNELS
                 + 2 * 64 * S8_CHANNELS + 2 * S8_CHANNELS * 4
                 + (1 + 2 * S8_HALO_STAGES + 2 * S8_RES_STAGES) * 8 + 16)
# what one block may take for two to share an SM (228 KB less 1 KB each)
_TWO_BLOCKS = 114 * 1024 - 1024


class S8Plan(NamedTuple):
    """The chain conv's launch plan (``csrc/conv3x3_int8.cu``)."""

    path: str     # "strip" (C = O = 64, W <= 128) or "mma" (K7's mma.sync)
    rows: int     # output rows a strip (0 on "mma")
    strips: int   # N * ceil(H / rows)
    blocks: int   # persistent blocks, each walking strips b, b + blocks, ..
    smem: int     # shared memory a block takes


def s8_plan(N: int, H: int, W: int, C: int, O: int, sms: int) -> S8Plan:
    """The strip kernel's plan on a card of ``sms`` SMs: the shortest strip
    that still gives every block at most one strip (each image cut into
    floor(2 sms / N) strips or fewer), so one wave of two blocks an SM
    covers the tensor and each halo row is read (rows + 2) / rows times;
    the blocks walk further strips where N exceeds 2 sms.  Other shapes take
    K7's mma.sync kernel."""
    if C != S8_CHANNELS or O != S8_CHANNELS or W > S8_MAX_W:
        return S8Plan("mma", 0, 0, 0, 0)
    slots = S8_BLOCKS_PER_SM * sms
    rows = -(-H // max(1, slots // N))
    strips = N * -(-H // rows)
    return S8Plan("strip", rows, strips, min(strips, slots), S8_SMEM_BYTES)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    fn = _build.load("conv3x3_int8").cobevt_conv3x3_s8
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scalar(value, device):
    """``value`` (a number or a 0-d tensor) as one f32 on ``device``."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(value), dtype=torch.float32, device=device)


def _launch(xq, sx, sw, t, wt, relu, out_scale, residual_q, residual_scale,
            out_dtype, with_sat):
    O, K = wt.shape
    why = int8_kernel_accepts(xq.shape, O, xq.dtype, (torch.int8,))
    if why is not None:
        raise ValueError(why)
    N, H, W, C = xq.shape
    if K != 9 * C:
        raise ValueError(f"the weight has {K // 9} input channels, x has {C}")
    out_dtype = torch.int8 if out_scale is not None else out_dtype
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"the chain's exit casts to f32 or bf16, not "
                         f"{out_dtype}")
    dev = xq.device
    scale = (sx * sw).float().contiguous()
    shift = t.float().contiguous()
    check_operand("xq", xq, (N, H, W, C), torch.int8, dev)
    check_operand("wt", wt, (O, 9 * C), torch.int8, dev)
    check_operand("scale", scale, (O,), torch.float32, dev)
    check_operand("shift", shift, (O,), torch.float32, dev)
    res_scale = None
    if residual_q is not None:
        check_operand("residual_q", residual_q, (N, H, W, O), torch.int8, dev)
        res_scale = _scalar(residual_scale, dev)
    requantize = out_scale is not None
    out_s = _scalar(out_scale, dev) if requantize else None
    clipped = torch.zeros(1, dtype=torch.int32, device=dev) \
        if requantize and with_sat else None
    out = torch.empty((N, H, W, O), dtype=out_dtype, device=dev)

    def ptr(tensor):
        return None if tensor is None else tensor.data_ptr()

    plan = s8_plan(N, H, W, C, O, _sms(dev.index))
    err = _lib()(
        xq.data_ptr(), wt.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        ptr(residual_q), ptr(res_scale), out.data_ptr(), ptr(out_s),
        ptr(clipped), N, H, W, C, O, int(relu), _OUT_KINDS[out_dtype],
        plan.rows, plan.blocks, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "conv3x3_s8")
    conv3x3_s8.launches += 1
    if not with_sat:
        return out
    if clipped is None:
        return out, torch.zeros((), dtype=torch.float32, device=dev)
    return out, clipped[0].float() / out.numel()


def _with_sat(out, device):
    """An implementation's result as the op's (out, clipped share)."""
    if isinstance(out, tuple):
        return out
    return out, torch.zeros((), dtype=torch.float32, device=device)


def _s8_plain(xq, sx, wt, sw, t, relu, out_scale, residual_q,
              residual_scale, out_dtype, with_sat):
    C, O = xq.shape[-1], wt.shape[0]
    return _with_sat(conv3x3_s8_reference(
        xq, sx, wt.t().reshape(3, 3, C, O), sw, t, relu=relu,
        out_scale=out_scale, residual_q=residual_q,
        residual_scale=residual_scale, out_dtype=out_dtype,
        with_sat=with_sat), xq.device)


def _s8_launch(xq, sx, wt, sw, t, relu, out_scale, residual_q,
               residual_scale, out_dtype, with_sat):
    return _with_sat(_launch(xq, sx, sw, t, wt, relu, out_scale, residual_q,
                             residual_scale, out_dtype, with_sat), xq.device)


def _s8_fake(xq, sx, wt, sw, t, relu, out_scale, residual_q, residual_scale,
             out_dtype, with_sat):
    dtype = torch.int8 if out_scale is not None else out_dtype
    return (xq.new_empty((*xq.shape[:3], wt.shape[0]), dtype=dtype),
            xq.new_empty((), dtype=torch.float32))


def _s8_work(xq, sx, wt, sw, t, relu, out_scale, residual_q,
             residual_scale, out_dtype, with_sat):
    out_itemsize = 1 if out_scale is not None else out_dtype.itemsize
    return flops.s8_work(xq, wt, sw, t, residual_q, out_itemsize)


# the chain's conv as the custom op cobevt::conv3x3_s8: (out, the clipped
# share, 0 unless with_sat); scales are 0-d tensors
_S8 = KernelOp(
    "conv3x3_s8",
    "(Tensor xq, Tensor sx, Tensor wt, Tensor sw, Tensor t, bool relu, "
    "Tensor? out_scale, Tensor? residual_q, Tensor? residual_scale, "
    "ScalarType out_dtype, bool with_sat) -> (Tensor, Tensor)",
    _s8_plain, _s8_launch, _s8_fake, _s8_work, products="int8")


def _scale_tensor(value, device):
    """A scale as the op takes it: a tensor as it is, a number as a 0-d f32
    tensor (the same f32 value the plain version's arithmetic uses)."""
    if value is None or torch.is_tensor(value):
        return value
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def conv3x3_s8(xq, sx, wq, sw, t, *, relu: bool = True, out_scale=None,
               residual_q=None, residual_scale=None,
               out_dtype=torch.bfloat16, with_sat: bool = False, impl=None,
               wt=None):
    """One 3x3 stride-1 SAME conv on int8-resident activations.

    ``acc = conv(x_q, w_q)`` in int32; the f32 epilogue applies the rescale
    ``sx * sw``, the folded-BN shift ``t``, the optional residual (int8 at
    its own scale) and ReLU, then either requantizes to int8 at
    ``out_scale`` (region interior) or casts to ``out_dtype`` (region exit,
    ``out_scale`` None).  ``with_sat`` also returns the share of values the
    requantization clipped (0 at the exit), a 0-d f32 tensor.  Scales are
    numbers or 0-d tensors; nothing syncs with the host.

    ``impl``: None (kernel for CUDA tensors, plain version for CPU tensors),
    "kernel" or "torch"; the call is the op ``cobevt::conv3x3_s8`` unless
    "torch" is asked for by name.  ``wt``: the kernel's weight operand from
    :func:`pack_s8_weight`, built from ``wq`` when None."""
    if route(impl, xq) == "plain":
        return conv3x3_s8_reference(
            xq, sx, wq, sw, t, relu=relu, out_scale=out_scale,
            residual_q=residual_q, residual_scale=residual_scale,
            out_dtype=out_dtype, with_sat=with_sat)
    if wt is None:
        C, O = wq.shape[2:]
        wt = wq.reshape(9 * C, O).t().contiguous()
    dev = xq.device
    out, sat = _S8(xq, _scale_tensor(sx, dev), wt, sw, t, relu,
                   _scale_tensor(out_scale, dev), residual_q,
                   _scale_tensor(residual_scale, dev), out_dtype, with_sat)
    return (out, sat) if with_sat else out


# kernel launches since the last reset (plain-version calls do not count)
conv3x3_s8.launches = 0
