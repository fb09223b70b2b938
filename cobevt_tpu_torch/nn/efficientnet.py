"""EfficientNet-b0..b4 feature extractor (NHWC, TF-SAME padding).

Counterpart of ``cobevt_tpu/nn/efficientnet.py`` (reference
``nuscenes/cross_view_transformer/model/backbones/efficientnet.py:24``):
the trunk up to the deepest requested ``reduction_k`` endpoint, returning
the map at each requested endpoint (``reduction_1`` the stem output,
``reduction_{k+1}`` the map right after the k-th stride-2 block).

Numerics the JAX package pins: flax ``padding="SAME"`` pads (total // 2,
total - total // 2) from the input's size, so a stride-2 conv pads one
more row and column after than before (the 3x3 stem and 3x3 stride-2
blocks 0/1, a 5x5 stride-2 block at an even size 1/2), which
``nn.Conv2d(padding=k // 2)`` does not do: :func:`same_pad` pads
explicitly.  BatchNorm eps 1e-3, momentum 0.01 (flax 0.99).  The
squeeze-excite width is a quarter of the block's *input* channels; its
two 1x1 convs carry biases.  Stochastic depth (drop-connect) acts in
training only, drawn from an explicit ``torch.Generator``; ``remat``
rematerialises each block in the backward pass
(``torch.utils.checkpoint``) in training only.

Attribute paths map onto the flax names through
``utils/weights.py:_default_rename``: ``layers.0.0`` / ``layers.0.1`` are
the stem conv and BN (``layers_0_0``, ``layers_0_1``), ``layers.{g}.{i}``
the i-th block of endpoint group g with children ``_expand_conv``,
``_bn0``, ``_depthwise_conv``, ``_bn1``, ``_se_reduce``, ``_se_expand``,
``_project_conv``, ``_bn2``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cobevt_tpu_torch.nn.layers import (
    batch_norm,
    bn_nhwc,
    conv_nhwc,
    frozen_bn_statistics,
    rank_uniform,
    torch_conv,
)

# (expand_ratio, channels, repeats, stride, kernel) for b0
_B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# width_mult, depth_mult
_SCALING = {
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
}
# efficientnet_pytorch's drop_connect_rate: block i drops at i * rate / n
_DROP_CONNECT = 0.2
_BN_EPS, _BN_MOMENTUM = 1e-3, 0.01


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    in_ch: int
    out_ch: int
    expand: int
    stride: int
    kernel: int
    drop_rate: float


def block_specs(model_name: str) -> List[BlockSpec]:
    w, d = _SCALING[model_name]
    specs: List[BlockSpec] = []
    in_ch = round_filters(32, w)
    total = sum(round_repeats(r, d) for (_, _, r, _, _) in _B0_STAGES)
    i = 0
    for expand, ch, repeats, stride, kernel in _B0_STAGES:
        out_ch = round_filters(ch, w)
        for j in range(round_repeats(repeats, d)):
            specs.append(BlockSpec(
                in_ch if j == 0 else out_ch, out_ch, expand,
                stride if j == 0 else 1, kernel,
                i * _DROP_CONNECT / total))
            i += 1
        in_ch = out_ch
    return specs


def reduction_boundaries(model_name: str) -> List[Tuple[str, Tuple[int, int]]]:
    """[(name, (first_block, last_block_exclusive))]: ``reduction_1`` is
    the stem (no block), ``reduction_{k+1}`` ends right after the k-th
    stride-2 block."""
    specs = block_specs(model_name)
    out = [("reduction_1", (0, 0))]
    start = 0
    k = 2
    for b in (i for i, s in enumerate(specs) if s.stride == 2):
        out.append((f"reduction_{k}", (start, b + 1)))
        start = b + 1
        k += 1
    return out


def same_pad(x, kernel: int, stride: int):
    """Zero-pad NHWC ``x`` as flax ``padding="SAME"`` does before a conv of
    this kernel and stride: (total // 2, total - total // 2) a side, total
    = max((ceil(n / stride) - 1) * stride + kernel - n, 0)."""
    pads = []
    for n in (x.shape[2], x.shape[1]):          # F.pad's order: W, then H
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, (0, 0, *pads))


def _bn(features: int):
    return batch_norm(features, eps=_BN_EPS, momentum=_BN_MOMENTUM)


class MBConvBlock(nn.Module):
    """MBConv: expand -> depthwise -> squeeze-excite -> project (+ skip with
    stochastic depth)."""

    def __init__(self, spec: BlockSpec):
        super().__init__()
        s = spec
        self.spec = s
        mid = s.in_ch * s.expand
        if s.expand != 1:
            self._expand_conv = torch_conv(s.in_ch, mid, 1, 1, 0, False)
            self._bn0 = _bn(mid)
        self._depthwise_conv = nn.Conv2d(mid, mid, s.kernel, s.stride, 0,
                                         groups=mid, bias=False)
        self._bn1 = _bn(mid)
        se_ch = max(1, int(s.in_ch * 0.25))
        self._se_reduce = torch_conv(mid, se_ch, 1, 1, 0, True)
        self._se_expand = torch_conv(se_ch, mid, 1, 1, 0, True)
        self._project_conv = torch_conv(mid, s.out_ch, 1, 1, 0, False)
        self._bn2 = _bn(s.out_ch)

    def drop_gate(self, x, generator=None):
        """The drop-connect gate of a training forward of ``x``: (N, 1, 1, 1)
        Bernoulli(1 - drop_rate) over 1 - drop_rate, drawn from
        ``generator`` (None: the device's global generator); None where the
        block has no skip or does not drop."""
        s = self.spec
        if not (self.training and s.drop_rate > 0 and s.stride == 1
                and s.in_ch == s.out_ch):
            return None
        keep = 1.0 - s.drop_rate
        draw = rank_uniform((x.shape[0], 1, 1, 1), x.device, generator)
        return (draw < keep).to(x.dtype) / keep

    def forward(self, x, gate=None):
        """x: (N, H, W, in_ch); ``gate``: the block's :meth:`drop_gate`, drawn
        outside so that a rematerialised forward sees the same one."""
        s = self.spec
        inp = x
        if s.expand != 1:
            x = F.silu(bn_nhwc(self._bn0, conv_nhwc(self._expand_conv, x)))
        x = conv_nhwc(self._depthwise_conv, same_pad(x, s.kernel, s.stride))
        x = F.silu(bn_nhwc(self._bn1, x))
        se = x.mean(dim=(1, 2), keepdim=True)
        se = F.silu(conv_nhwc(self._se_reduce, se))
        x = x * torch.sigmoid(conv_nhwc(self._se_expand, se))
        x = bn_nhwc(self._bn2, conv_nhwc(self._project_conv, x))
        if s.stride == 1 and s.in_ch == s.out_ch:
            if gate is not None:
                x = x * gate
            x = x + inp
        return x


def _remat_contexts():
    return contextlib.nullcontext(), frozen_bn_statistics()


class EfficientNetExtractor(nn.Module):
    """Trunk through the deepest requested reduction; returns one NHWC map
    per name in ``layer_names``."""

    def __init__(self, layer_names: Sequence[str] = ("reduction_2",
                                                     "reduction_3",
                                                     "reduction_4"),
                 model_name: str = "efficientnet-b4", remat: bool = False):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.remat = remat
        w_mult, _ = _SCALING[model_name]
        specs = block_specs(model_name)
        bounds = reduction_boundaries(model_name)
        self._group = {n: gi for gi, (n, _) in enumerate(bounds)}
        idx_max = max(self._group[n] for n in self.layer_names)
        stem = round_filters(32, w_mult)
        groups = [nn.ModuleList([torch_conv(3, stem, 3, 2, 0, False),
                                 _bn(stem)])]
        for gi in range(1, idx_max + 1):
            _, (lo, hi) = bounds[gi]
            groups.append(nn.ModuleList(
                MBConvBlock(specs[bi]) for bi in range(lo, hi)))
        self.layers = nn.ModuleList(groups)

    @staticmethod
    def output_shapes(layer_names, image_hw,
                      model_name: str = "efficientnet-b4"):
        """[(h, w, c)] of each requested endpoint at ``image_hw``."""
        w_mult, _ = _SCALING[model_name]
        specs = block_specs(model_name)
        bounds = dict(reduction_boundaries(model_name))
        H, W = image_hw
        shapes = []
        for name in layer_names:
            _, end = bounds[name]
            ch = (specs[end - 1].out_ch if end > 0
                  else round_filters(32, w_mult))
            red = 2  # stem stride
            for s in specs[:end]:
                red *= s.stride
            shapes.append((-(-H // red), -(-W // red), ch))
        return shapes

    def forward(self, images, generator=None):
        """images: (N, H, W, 3), already normalized; ``generator`` draws the
        drop-connect gates of a training forward.  Returns a list of
        (N, h_i, w_i, C_i), one per requested layer name."""
        conv, bn = self.layers[0]
        x = F.silu(bn_nhwc(bn, conv_nhwc(conv, same_pad(images, 3, 2))))
        results = [x]
        remat = self.remat and self.training and torch.is_grad_enabled()
        for group in self.layers[1:]:
            for block in group:
                gate = block.drop_gate(x, generator)
                # the second forward leaves the BN running statistics alone
                x = checkpoint(block, x, gate, use_reentrant=False,
                               context_fn=_remat_contexts) if remat \
                    else block(x, gate)
            results.append(x)
        return [results[self._group[n]] for n in self.layer_names]
