"""Common layers, with the numerics the JAX package pins.

Counterpart of ``cobevt_tpu/nn/layers.py``:

  * BatchNorm: eps 1e-5, momentum 0.1 (flax momentum 0.9); the running
    variance stores the biased batch variance, as flax does
  * LayerNorm: eps 1e-5
  * GELU: exact (erf) form

Activations are NHWC, as in the JAX package.  An NHWC-contiguous
tensor's ``permute(0, 3, 1, 2)`` is a ``channels_last`` NCHW tensor, so a
convolution or BatchNorm that stays in PyTorch runs on it without a copy
(:func:`conv_nhwc`, :func:`bn_nhwc`).  Module attribute names are the
reference's torch attribute paths, which the flax tree mirrors.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from cobevt_tpu_torch.ops.conv2d import (
    fold_bn,
    fused_conv3x3,
    fused_conv3x3_int8,
    int8_absmax,
    new_amax_slots,
    pack_conv3x3_weight,
    pack_int8_weight,
)
from cobevt_tpu_torch.ops.dispatch import PackCache
from cobevt_tpu_torch.ops.int8_chain import (
    INTERMEDIATE_HEADROOM,
    conv3x3_s8,
    pack_s8_weight,
)


def gelu(x):
    """Exact GELU (torch nn.GELU default)."""
    return F.gelu(x)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def images_from_uint8(x, normalize: bool = True):
    """uint8 images -> f32 in [0, 1], then ImageNet mean/std when
    ``normalize``; any other dtype passes through untouched (the
    host-normalized contract)."""
    if x.dtype != torch.uint8:
        return x
    x = x.float() / 255.0
    return normalize_image(x) if normalize else x


def normalize_image(x):
    """ImageNet mean/std normalization of channels-last images in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def torch_conv(in_features: int, features: int, kernel_size: int = 3,
               stride: int = 1, padding: int = 0,
               use_bias: bool = True) -> nn.Conv2d:
    """2D conv with torch-style integer padding; apply with
    :func:`conv_nhwc`."""
    return nn.Conv2d(in_features, features, kernel_size, stride, padding,
                     bias=use_bias)


def conv_nhwc(conv: nn.Conv2d, x):
    """Apply an NCHW ``nn.Conv2d`` to an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


_bn_state = threading.local()


@contextlib.contextmanager
def frozen_bn_statistics():
    """No running-statistics update inside the block: the second forward of
    a rematerialised block (``torch.utils.checkpoint``) must not count its
    batch twice."""
    prev = getattr(_bn_state, "frozen", False)
    _bn_state.frozen = True
    try:
        yield
    finally:
        _bn_state.frozen = prev


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update stores what flax's
    ``nn.BatchNorm`` stores: ``running_var`` moves towards the *biased*
    batch variance (PyTorch's own update uses the unbiased one, a factor
    n/(n-1) apart), so a model trained here has the JAX package's
    ``batch_stats``.  The state_dict names are PyTorch's.

    The running statistics may be kept in f32 under bf16 parameters (the
    train state does); scale and shift are then cast to f32 at use, the
    mixed-precision form PyTorch's kernels take.

    In train mode with a process group of more than one rank
    (``parallel/distributed.py``) the statistics are those of the global
    batch, as under the JAX package's sharded step (sync-BN,
    ``cobevt_tpu/parallel/mesh.py:17-20``): :meth:`_global_forward`."""

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.dtype != self.running_mean.dtype:
            w, b = w.to(self.running_mean.dtype), b.to(self.running_mean.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, w, b,
                                False, 0.0, self.eps)
        if _process_group_size() > 1:
            return self._global_forward(x, w, b)
        # momentum 1 into zeroed buffers: the batch mean and the unbiased
        # batch variance, with no second pass over x
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, w, b, True, 1.0, self.eps)
        if not getattr(_bn_state, "frozen", False):
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
                self.num_batches_tracked += 1
        return y


    def _global_forward(self, x, w, b):
        """Train-mode BatchNorm over every rank's batch: the per-channel
        count and sum are summed over the group, then the sum of squared
        deviations from the global mean (two passes, as precise as one
        process's), both through a differentiable ``all_reduce``, so the
        backward sums the statistics' gradients over the ranks too.  f32
        arithmetic (f64 for f64 inputs); the running statistics move toward
        the global batch's mean and biased variance (flax's update)."""
        from cobevt_tpu_torch.parallel.distributed import all_reduce_sum

        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = x.numel() // x.shape[1]
        local = torch.cat([xf.sum(dims), xf.new_full((1,), float(n))])
        total = all_reduce_sum(local)
        count = total[-1]
        mean = total[:-1] / count
        centered = xf - mean.reshape(shape)
        var = all_reduce_sum((centered * centered).sum(dims)) / count
        y = centered * torch.rsqrt(var + self.eps).reshape(shape)
        y = y * w.to(xf.dtype).reshape(shape) + b.to(xf.dtype).reshape(shape)
        if not getattr(_bn_state, "frozen", False):
            with torch.no_grad():
                self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                        self.momentum)
                self.running_var.lerp_(var.to(self.running_var.dtype),
                                       self.momentum)
                self.num_batches_tracked += 1
        return y.to(x.dtype)


def _process_group_size() -> int:
    from cobevt_tpu_torch.parallel.distributed import world_size
    return world_size()


class BatchNorm3d(nn.BatchNorm3d):
    """:class:`BatchNorm2d`'s flax statistics update over (N, C, D, H, W)."""

    forward = BatchNorm2d.forward
    _global_forward = BatchNorm2d._global_forward


def batch_norm(features: int, eps: float = 1e-5,
               momentum: float = 0.1) -> BatchNorm2d:
    return BatchNorm2d(features, eps=eps, momentum=momentum)


def bn_nhwc(bn: nn.BatchNorm2d, x):
    return bn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def layer_norm(features: int) -> nn.LayerNorm:
    return nn.LayerNorm(features, eps=1e-5)


def fused_conv_enabled(c_in: int, c_out: int) -> bool:
    """Eval BasicBlocks take K3 when both channel axes are >= 128, the
    JAX package's gate.  COBEVT_FUSED_CONV=0 turns it off.  The JAX gate's
    VMEM working-set term is TPU-only and has no counterpart here."""
    if os.environ.get("COBEVT_FUSED_CONV", "1") == "0":
        return False
    return c_in >= 128 and c_out >= 128


def int8_enabled() -> bool:
    """COBEVT_INT8=1: the lossy post-training-quantized serving mode, read
    at every call."""
    return os.environ.get("COBEVT_INT8", "0") == "1"


def _conv_hwio(conv: nn.Conv2d):
    return conv.weight.permute(2, 3, 1, 0)


def _bn_stats(bn: nn.BatchNorm2d):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


class BasicBlock(nn.Module):
    """ResNet v1 basic block (two 3x3 convs), torchvision-compatible.

    Eval runs K3 (conv + folded BN + residual + ReLU in one kernel) for
    stride-1 blocks that pass :func:`fused_conv_enabled`; training and the
    other blocks run the plain modules.  Under ``COBEVT_INT8=1`` those
    blocks take K7 (int8 products) when both channel axes are >= 256, the
    JAX package's gate, and the trunk may run a narrow block int8-resident
    (:meth:`int8_resident_eval`).  All paths share one state_dict."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.planes = planes
        self.stride = stride
        self.conv1 = torch_conv(inplanes, planes, 3, stride, 1, False)
        self.bn1 = batch_norm(planes)
        self.conv2 = torch_conv(planes, planes, 3, 1, 1, False)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if downsample:
            # torch names: downsample.0 (conv), downsample.1 (bn)
            self.downsample = nn.Sequential(
                torch_conv(inplanes, planes, 1, stride, 0, False),
                batch_norm(planes))
        # the kernels' prepared weights (K3's folded bf16 weights, the int8
        # paths' quantized ones), rebuilt when a parameter changes; holds no
        # parameter and is not part of the state_dict
        self._pack = PackCache()
        # clipped share of the last int8-resident forward that was asked
        # for it (a 0-d tensor), else None
        self.int8_sat_frac = None

    def _identity(self, x):
        if self.downsample is None:
            return x
        conv, bn = self.downsample
        return bn_nhwc(bn, conv_nhwc(conv, x))

    def takes_k7(self, c_in: int) -> bool:
        """Whether an eval forward of a ``c_in``-channel input runs both
        convs as K7: a stride-1 block that takes K3, under COBEVT_INT8=1,
        with both channel axes >= 256 (the dispatch of :meth:`forward`)."""
        return (not self.training and self.stride == 1
                and fused_conv_enabled(c_in, self.planes)
                and int8_enabled() and min(c_in, self.planes) >= 256)

    def forward(self, x):
        if not self.training and self.stride == 1 and \
                fused_conv_enabled(x.shape[-1], self.planes):
            return self._fused_eval(x)
        out = F.relu(bn_nhwc(self.bn1, conv_nhwc(self.conv1, x)))
        out = bn_nhwc(self.bn2, conv_nhwc(self.conv2, out))
        return F.relu(out + self._identity(x))

    def _fused_eval(self, x):
        """Both convs as K3, on weights folded, cast and transposed once
        per weight version and dtype."""
        x = x.contiguous()
        if self.takes_k7(x.shape[-1]):
            return self._fused_eval_int8(x)
        p1 = self._folded("k3_conv1", self.conv1, self.bn1,
                          pack_conv3x3_weight, x.dtype)
        out = fused_conv3x3(x, None, None, relu=True, packed=p1)
        identity = self._identity(x).contiguous()
        p2 = self._folded("k3_conv2", self.conv2, self.bn2,
                          pack_conv3x3_weight, x.dtype)
        return fused_conv3x3(out, None, None, residual=identity, relu=True,
                             packed=p2)

    def _folded(self, name, conv, bn, pack, *args):
        """``pack(*fold_bn(conv, bn), *args)``, cached per weight version
        and ``args``."""
        return self._pack.get(
            name, [conv.weight, *_bn_stats(bn)],
            lambda: pack(*fold_bn(_conv_hwio(conv), *_bn_stats(bn)), *args),
            *args)

    def _fused_eval_int8(self, x):
        """Both convs as K7: weights quantized per output channel once,
        activations per tensor inside the kernel; x's scale from one
        absmax, conv2's from conv1's epilogue."""
        slots = new_amax_slots(3, x.device)
        return self.int8_k7_eval(x, int8_absmax(x, slots[0:1]),
                                 slots[1:2], slots[2:3])

    def int8_k7_eval(self, x, amax, mid_slot, out_slot):
        """Both convs as K7 on device scale slots (``ops/conv2d.py``):
        ``amax`` holds x's |max|, ``mid_slot`` and ``out_slot`` (zeroed)
        receive conv1's and conv2's; conv2 reads ``mid_slot``, and the next
        K7 may read ``out_slot``.  No scale is reduced or computed outside
        the kernels."""
        p1 = self._folded("k7_conv1", self.conv1, self.bn1, pack_int8_weight)
        out = fused_conv3x3_int8(x, None, None, relu=True, packed=p1,
                                 amax=amax, out_amax=mid_slot)
        identity = self._identity(x).contiguous()
        p2 = self._folded("k7_conv2", self.conv2, self.bn2, pack_int8_weight)
        return fused_conv3x3_int8(out, None, None, residual=identity,
                                  relu=True, packed=p2, amax=mid_slot,
                                  out_amax=out_slot)

    def int8_resident_eval(self, xq, s_in, s_out, out_dtype,
                           with_sat: bool = False):
        """COBEVT_INT8=1 path of a narrow stride-1 block without downsample:
        activations arrive as int8 at scale ``s_in`` and leave as int8 at
        ``s_out``, or as ``out_dtype`` when ``s_out`` is None (region exit:
        the dequantization is conv2's epilogue).  The intermediate is int8
        at ``s_in * INTERMEDIATE_HEADROOM``.  ``with_sat`` keeps the larger
        clipped share of the two requantizations in ``self.int8_sat_frac``
        (one more reduction per conv, so off unless a gate asks)."""
        if self.stride != 1 or self.downsample is not None:
            raise ValueError("the int8-resident path covers stride-1 blocks "
                             "without downsample")
        p1 = self._folded("s8_conv1", self.conv1, self.bn1, pack_s8_weight)
        p2 = self._folded("s8_conv2", self.conv2, self.bn2, pack_s8_weight)
        s_mid = s_in * INTERMEDIATE_HEADROOM
        sats = []

        def conv(x, s_x, p, **kwargs):
            out = conv3x3_s8(x, s_x, p.w_q, p.s_w, p.shift, relu=True,
                             with_sat=with_sat, wt=p.wt, **kwargs)
            if with_sat:
                sats.append(out[1])
                return out[0]
            return out

        h = conv(xq, s_in, p1, out_scale=s_mid)
        out = conv(h, s_mid, p2, out_scale=s_out, residual_q=xq,
                   residual_scale=s_in, out_dtype=out_dtype)
        self.int8_sat_frac = torch.maximum(*sats) if with_sat else None
        return out


class Bottleneck(nn.Module):
    """ResNet bottleneck (1x1 -> 3x3 -> 1x1, expansion 4).  With
    ``planes = features // 4`` and no downsample this is the FAX
    ``ResNetBottleNeck``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        width = planes * self.expansion
        self.conv1 = torch_conv(inplanes, planes, 1, 1, 0, False)
        self.bn1 = batch_norm(planes)
        self.conv2 = torch_conv(planes, planes, 3, stride, 1, False)
        self.bn2 = batch_norm(planes)
        self.conv3 = torch_conv(planes, width, 1, 1, 0, False)
        self.bn3 = batch_norm(width)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                torch_conv(inplanes, width, 1, stride, 0, False),
                batch_norm(width))

    def forward(self, x):
        identity = x
        out = F.relu(bn_nhwc(self.bn1, conv_nhwc(self.conv1, x)))
        out = F.relu(bn_nhwc(self.bn2, conv_nhwc(self.conv2, out)))
        out = bn_nhwc(self.bn3, conv_nhwc(self.conv3, out))
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn_nhwc(bn, conv_nhwc(conv, x))
        return F.relu(out + identity)


def pixel_unshuffle(x, factor: int = 2):
    """NHWC pixel-unshuffle with torch channel ordering (output channel
    ``c*r*r + i*r + j`` for input offset (i, j))."""
    B, H, W, C = x.shape
    r = factor
    x = x.reshape(B, H // r, r, W // r, r, C)
    x = x.permute(0, 1, 3, 5, 2, 4)          # B, H/r, W/r, C, r, r
    return x.reshape(B, H // r, W // r, C * r * r)


def rank_uniform(shape, device, generator=None, agents=None, width=None):
    """U[0, 1) numbers of ``shape`` from ``generator`` (None: the device's
    global generator): every random draw of a training forward (dropout,
    drop-connect) is made here.

    Outside a multi-rank train step it is ``torch.rand(shape)``.  Inside one
    (``parallel/distributed.py:draw_layout``) ``shape`` is this rank's part
    of a global tensor: dim 0 holds its rows of the global batch, or with
    ``agents`` its rows of (batch x agents) flattened, ``agents`` per sample
    here (split over "model" on the agent axis of a mesh), and with
    ``width`` the last dim holds its columns of ``width`` (a column-parallel
    layer's output, ``parallel/mesh.py``).  The global tensor is drawn and
    this rank's part returned, so each rank reads the numbers one process
    draws on the global batch and every rank's generator moves alike.  The
    ranks' parts are equal in size, as the blocks of a sharded JAX batch
    are."""
    from cobevt_tpu_torch.parallel.distributed import current_draw_layout

    lay = current_draw_layout()
    if lay is None:
        return torch.rand(shape, device=device, generator=generator)
    shape = list(shape)
    rows, tail = shape[0], shape[1:]
    lead = [rows // agents, agents] if agents else [rows]
    full = [lead[0] * lay.n_data] + lead[1:]
    if agents and lay.agents_split:
        full[1] *= lay.n_model
    cols = tail[-1] if tail else None
    if width is not None and cols != width:
        tail = tail[:-1] + [width]
    u = torch.rand(full + tail, device=device, generator=generator)
    u = u.narrow(0, lay.data_index * lead[0], lead[0])
    if agents and lay.agents_split:
        u = u.narrow(1, lay.model_index * agents, agents)
    if width is not None and cols != width:
        u = u.narrow(-1, lay.model_index * cols, cols)
    return u.reshape(shape)


def keep_mask(shape, p: float, device, generator=None, **part):
    """The keep-mask of a dropout at rate ``p``: :func:`rank_uniform` >= p
    (``part``: its ``agents`` / ``width``)."""
    return rank_uniform(shape, device, generator, **part) >= p


def dropout(x, p: float, training: bool, generator=None, **part):
    """Inverted dropout whose keep-mask is drawn from ``generator`` (None:
    the device's global generator) by :func:`keep_mask`; the identity
    outside training or at ``p`` 0."""
    if not training or p == 0.0:
        return x
    keep = keep_mask(x.shape, p, x.device, generator, **part)
    return x * keep.to(x.dtype) / (1.0 - p)


def mlp_seq(dim: int, hidden: int, out: int) -> nn.Sequential:
    """Linear -> GELU -> Linear (the FAX MLP; torch names ``0`` / ``2``)."""
    return nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                         nn.Linear(hidden, out))
