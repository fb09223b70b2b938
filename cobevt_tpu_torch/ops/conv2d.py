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
scale (:func:`act_scale`) and quantized inside the kernel
(``csrc/conv3x3_int8.cu``), s8 x s8 -> s32 products, f32 epilogue.  f32 and
bf16 activations take the same kernel.  Weight quantization is plain
PyTorch outside the kernel, as it is XLA outside the Pallas body.  The
activation scale is folded into the kernels: a K7 reads the |max| of its
input from a device slot (:func:`fold_amax_`) and computes s_a, 1 / s_a and
s_a * s_w in its prologue with :func:`act_scale`'s rounded operations; the
slot is written by the epilogue of the K7 that produced the input, or by
one :func:`int8_absmax` launch where the producer is something else.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import (
    KernelOp,
    check_aligned,
    check_operand,
    needs_grad,
    route,
)
from cobevt_tpu_torch.utils import flops

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


def _nhwo(x, O):
    """A fake output: x's batch and map with O channels."""
    return x.new_empty((*x.shape[:3], O))


# K3 as the custom op cobevt::conv3x3 (``wt``: None in f32)
_K3 = KernelOp(
    "conv3x3",
    "(Tensor x, Tensor w, Tensor? wt, Tensor shift, Tensor? residual, "
    "bool relu) -> Tensor",
    lambda x, w, wt, shift, residual, relu: conv3x3_reference(
        x, w, shift, residual, relu),
    lambda x, w, wt, shift, residual, relu: _launch_kernel(
        x, Conv3x3Weight(w, wt, shift), residual, relu),
    lambda x, w, wt, shift, residual, relu: _nhwo(x, w.shape[-1]),
    lambda x, w, wt, shift, residual, relu: flops.k3_work(x, w, shift,
                                                          residual))


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

    The call is the op ``cobevt::conv3x3`` on either device, unless
    "torch" is asked for by name or a CPU operand needs a gradient (the
    plain version then runs inline).  Inference only: the op has no
    backward, so an eval forward under autograd on the card raises if a
    gradient is asked through it.  Training runs the unfused block
    (``self.training`` gates the dispatch)."""
    if packed is None:
        packed = pack_conv3x3_weight(w, shift, x.dtype)
    if route(impl, x, needs_grad(x, packed.w, packed.shift,
                                 residual)) == "plain":
        return conv3x3_reference(x, packed.w, packed.shift, residual, relu)
    return _K3(x, packed.w, packed.wt, packed.shift, residual, relu)


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


# K7's scale fold.  A device slot is an int32 (1,) tensor holding the bits
# of f32(max |t|) of the tensor t it belongs to; non-negative floats order
# as their bits, so a maximum over parts is an integer maximum (the kernels'
# atomicMax), exact in any order.  A slot starts at 0 (+0.0).

def new_amax_slots(n: int, device) -> torch.Tensor:
    """``n`` zeroed slots (one memset)."""
    return torch.zeros(n, dtype=torch.int32, device=device)


def fold_amax_(slot, t):
    """Plain version of the slot update of K7's epilogue and of
    :func:`int8_absmax`: slot = max(slot, bits(f32(max |t|)))."""
    m = t.abs().amax().float().reshape(1).view(torch.int32)
    slot.copy_(torch.maximum(slot, m))
    return slot


def scale_from_amax(slot):
    """s_a of a tensor from its slot, with the rounded operations of
    :func:`act_scale` (so the same bits): max(f32(m) / 127, 1e-12)."""
    return torch.clamp_min(slot.view(torch.float32).reshape(()) / 127.0,
                           1e-12)


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


class Int8TilePlan(NamedTuple):
    """K7's launch plan (``csrc/conv3x3_int8.cu``)."""

    path: str         # "wgmma" (C % 128 == 0) or "mma" (mma.sync)
    rows: int         # whole image rows a block: 128 pixel slots / W
    stages: int       # the wgmma kernel's weight ring (0 on "mma")
    smem: int         # shared memory a block takes
    blocks_per_sm: int


# the wgmma kernel's ring boxes (128 channels of one tap x 128 outputs, s8),
# its deepest ring, and what two blocks may take on one SM (228 KB less 1 KB
# each for the system)
_INT8_BOX, _INT8_MAX_STAGES, _INT8_TWO_BLOCKS = 128 * 128, 4, 114 * 1024 \
    - 1024


def int8_tile_plan(H: int, W: int, C: int) -> Int8TilePlan:
    """The tile of both K7 kernels is 128 pixel slots of whole image rows;
    C a multiple of 128 and of its channel group (256 channels, or C when
    smaller) runs the wgmma kernel, whose halo tile holds one channel group
    at a time, with as deep a weight ring (2 to 4 boxes) as keeps two
    blocks on an SM, or else four boxes and one block (the same bytes as
    ``wg::smem_bytes``)."""
    rows = min(H, max(1, _INT8_SLOTS // W))
    group = min(C, 256)
    if C % 128 or C % group:
        halo = (rows + 2) * (W + 2) * (C + 16)
        return Int8TilePlan("mma", rows, 0, halo + 2 * 128 * 80, 1)
    halo = (rows + 2) * (W + 2) * (group + 16)

    def smem(stages):
        return 1024 + stages * _INT8_BOX + (-(-halo // 1024) * 1024) + \
            2 * 128 * 4 + 2 * _INT8_MAX_STAGES * 8

    for stages in range(_INT8_MAX_STAGES, 1, -1):
        if smem(stages) <= _INT8_TWO_BLOCKS:
            return Int8TilePlan("wgmma", rows, stages, smem(stages), 2)
    return Int8TilePlan("wgmma", rows, _INT8_MAX_STAGES,
                        smem(_INT8_MAX_STAGES), 1)


def _int8_lib():
    lib = _build.load("conv3x3_int8")
    fn = lib.cobevt_conv3x3_int8
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    am = lib.cobevt_int8_absmax
    am.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    am.restype = ctypes.c_int
    return fn, am


def _check_slot(name, slot, device):
    check_operand(name, slot, (1,), torch.int32, device)


def int8_absmax(x, slot, impl=None):
    """Fold max |x| into ``slot`` (see :func:`fold_amax_`): the input scale
    of a K7 whose producer is not a K7.  One kernel launch on CUDA tensors
    (``csrc/conv3x3_int8.cu``: absmax_kernel), the plain version on CPU
    tensors, both through the op ``cobevt::int8_absmax`` (the slot written
    in place) unless "torch" is asked for by name.  The slot must hold 0 or
    a smaller maximum.  Returns ``slot``."""
    if route(impl, x) == "plain":
        return fold_amax_(slot, x)
    _A7(x, slot)
    return slot


def _launch_absmax(x, slot):
    if x.dtype not in _KERNEL_DTYPES or x.numel() % 8:
        raise ValueError(f"int8_absmax takes {_KERNEL_DTYPES} with a "
                         f"multiple of 8 values; got {x.dtype}, "
                         f"{x.numel()} values")
    check_operand("x", x, tuple(x.shape), x.dtype, x.device)
    check_aligned("x", x)
    _check_slot("slot", slot, x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(4 * sms, -(-x.numel() // (8 * 256))))
    err = _int8_lib()[1](
        x.data_ptr(), x.numel(), slot.data_ptr(),
        int(x.dtype == torch.bfloat16), blocks, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_absmax")
    int8_absmax.launches += 1


def _absmax_plain(x, slot):
    fold_amax_(slot, x)


# the absmax as the custom op cobevt::int8_absmax (slot written)
_A7 = KernelOp(
    "int8_absmax", "(Tensor x, Tensor(a!) slot) -> ()", _absmax_plain,
    _launch_absmax, lambda x, slot: None, flops.a7_work, products=None,
    mutates_args=("slot",))

int8_absmax.launches = 0


def _launch_int8(x, packed: Int8Weight, amax, residual, relu, out_amax=None):
    """Launch K7 on the input's |max| slot ``amax`` (int32 (1,)); with
    ``out_amax`` (a zeroed slot) the kernel also folds the |max| of its
    stored output into it."""
    O, K = packed.wt.shape
    why = int8_kernel_accepts(x.shape, O, x.dtype)
    if why is not None:
        raise ValueError(why)
    N, H, W, C = x.shape
    if K != 9 * C:
        raise ValueError(f"the weight has {K // 9} input channels, x has {C}")
    check_operand("x", x, (N, H, W, C), x.dtype, x.device)
    check_operand("wt", packed.wt, (O, 9 * C), torch.int8, x.device)
    check_operand("s_w", packed.s_w, (O,), torch.float32, x.device)
    check_operand("shift", packed.shift, (O,), torch.float32, x.device)
    _check_slot("amax", amax, x.device)
    if out_amax is not None:
        _check_slot("out_amax", out_amax, x.device)
    if residual is not None:
        check_operand("residual", residual, (N, H, W, O), x.dtype, x.device)
    plan = int8_tile_plan(H, W, C)
    if plan.path == "wgmma":
        check_aligned("wt", packed.wt)   # TMA's 16-byte rule
    out = torch.empty((N, H, W, O), dtype=x.dtype, device=x.device)
    err = _int8_lib()[0](
        x.data_ptr(), packed.wt.data_ptr(), packed.s_w.data_ptr(),
        packed.shift.data_ptr(), amax.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        None if out_amax is None else out_amax.data_ptr(),
        N, H, W, C, O, int(relu), int(x.dtype == torch.bfloat16), plan.rows,
        plan.stages, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3x3_int8")
    fused_conv3x3_int8.launches += 1
    return out


def _k7_plain(x, wt, s_w, shift, amax, residual, relu, out_amax):
    C, O = x.shape[-1], wt.shape[0]
    w_q = wt.t().reshape(3, 3, C, O)
    out = conv3x3_int8_reference(x, w_q, s_w, scale_from_amax(amax), shift,
                                 residual, relu)
    if out_amax is not None:
        fold_amax_(out_amax, out)
    return out


# K7 as the custom op cobevt::conv3x3_int8 (``out_amax`` written)
_K7 = KernelOp(
    "conv3x3_int8",
    "(Tensor x, Tensor wt, Tensor s_w, Tensor shift, Tensor amax, "
    "Tensor? residual, bool relu, Tensor(a!)? out_amax) -> Tensor",
    _k7_plain,
    lambda x, wt, s_w, shift, amax, residual, relu, out_amax: _launch_int8(
        x, Int8Weight(None, s_w, wt, shift), amax, residual, relu, out_amax),
    lambda x, wt, s_w, shift, amax, residual, relu, out_amax: _nhwo(
        x, wt.shape[0]),
    lambda x, wt, s_w, shift, amax, residual, relu, out_amax: flops.k7_work(
        x, wt, s_w, shift, residual),
    products="int8", mutates_args=("out_amax",))


def fused_conv3x3_int8(x, w, shift, residual=None, relu: bool = True,
                       impl=None, packed: Int8Weight = None, amax=None,
                       out_amax=None):
    """int8 post-training-quantized twin of :func:`fused_conv3x3`, same
    contract (folded-BN f32 ``w`` and ``shift``): the weight quantized per
    output channel, the activations per tensor with the dynamic scale of this
    call.  ``packed``: the weight already quantized by
    :func:`pack_int8_weight` (``w`` and ``shift`` are then not read).
    ``amax``: x's |max| slot (int32 (1,), :func:`fold_amax_`), written by the
    K7 that produced x; without it the call fills a new slot with one
    :func:`int8_absmax`.  ``out_amax``: a zeroed slot that receives the
    output's |max| for the next K7 (the kernel's epilogue folds it in).  The
    scale is :func:`act_scale`'s, bit for bit, either way.  ``impl``: None
    (kernel for CUDA tensors, plain version for CPU tensors), "kernel" or
    "torch".  The call is the op ``cobevt::conv3x3_int8`` (``out_amax``
    written in place) as K3's is.  Inference only, as K3."""
    if packed is None:
        packed = pack_int8_weight(w, shift)
    if route(impl, x, needs_grad(x, packed.s_w, packed.shift,
                                 residual)) == "plain":
        s_a = act_scale(x) if amax is None else scale_from_amax(amax)
        out = conv3x3_int8_reference(x, packed.w_q, packed.s_w, s_a,
                                     packed.shift, residual, relu)
        if out_amax is not None:
            fold_amax_(out_amax, out)
        return out
    if amax is None:
        amax = int8_absmax(x, new_amax_slots(1, x.device), impl)
    return _K7(x, packed.wt, packed.s_w, packed.shift, amax, residual, relu,
               out_amax)


fused_conv3x3_int8.launches = 0
