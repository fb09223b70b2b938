"""Multi-scale ResNet image encoder.

Counterpart of ``cobevt_tpu/nn/resnet.py`` (reference
``opv2v/opencood/models/backbones/resnet_ms.py:8``): a torchvision-style
ResNet over every camera of every agent, returning the stages selected by
``id_pick``.  NHWC in and out; all (B, L, M) axes are folded into one batch
axis.  ``remat`` rematerialises each trunk block's activations in the
backward pass (``torch.utils.checkpoint``), the JAX package's
``encoder_remat``.  Under ``COBEVT_INT8=1`` a basic-block trunk runs layer1
int8-resident at eval (``ops/int8_chain.py``); ``COBEVT_INT8_RESIDENT=0``
turns that off alone.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import contextlib
import os

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cobevt_tpu_torch.nn.layers import (
    BasicBlock,
    Bottleneck,
    batch_norm,
    bn_nhwc,
    conv_nhwc,
    frozen_bn_statistics,
    int8_enabled,
    torch_conv,
)
from cobevt_tpu_torch.ops.int8_chain import BLOCK_GROWTH, quantize_dynamic

# (block type, per-stage depths)
_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
_WIDTHS = (64, 128, 256, 512)


def _stage(inplanes, block, planes, depth, stride):
    """One ResNet stage as a Sequential (torch path ``layer<i>.<j>``)."""
    Block = BasicBlock if block == "basic" else Bottleneck
    expansion = 1 if block == "basic" else 4
    blocks = []
    for j in range(depth):
        s = stride if j == 0 else 1
        needs_down = j == 0 and (s != 1 or inplanes != planes * expansion)
        blocks.append(Block(inplanes, planes, s, downsample=needs_down))
        inplanes = planes * expansion
    return nn.Sequential(*blocks), inplanes


def _remat_contexts():
    return contextlib.nullcontext(), frozen_bn_statistics()


class ResNetTrunk(nn.Module):
    """Bare torchvision-style trunk on (N, H, W, 3); returns all 4 stages."""

    def __init__(self, num_layers: int = 34, remat: bool = False):
        super().__init__()
        self.remat = remat
        block, depths = _SPECS[num_layers]
        self.block = block
        # set True to keep each int8-resident block's clipped share in
        # ``int8_sat_fracs`` (the gate of tools/validate_kernels.py)
        self.collect_int8_sat = False
        self.int8_sat_fracs = []
        self.conv1 = torch_conv(3, 64, 7, 2, 3, False)
        self.bn1 = batch_norm(64)
        inplanes = 64
        for i in range(4):
            stage, inplanes = _stage(inplanes, block, _WIDTHS[i], depths[i],
                                     1 if i == 0 else 2)
            self.add_module(f"layer{i + 1}", stage)

    def forward(self, x):
        x = F.relu(bn_nhwc(self.bn1, conv_nhwc(self.conv1, x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(4):
            if i == 0 and self._int8_layer1_active():
                x = self._int8_layer1(x)
                outs.append(x)
                continue
            for block in getattr(self, f"layer{i + 1}"):
                # the second forward leaves the BN running statistics alone
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=_remat_contexts) if remat \
                    else block(x)
            outs.append(x)
        return outs

    def _int8_layer1_active(self) -> bool:
        """layer1 (C 64, the 1/4-resolution maps) runs int8-resident under
        COBEVT_INT8=1 at eval, for basic blocks only (a bottleneck layer1
        carries a downsample projection); COBEVT_INT8_RESIDENT=0 turns this
        off and leaves K7 on.  Both variables are read at every call."""
        return (not self.training and self.block == "basic"
                and int8_enabled()
                and os.environ.get("COBEVT_INT8_RESIDENT", "1") == "1")

    def _int8_layer1(self, x):
        """Quantize once, run every layer1 block int8-resident on the scale
        schedule ``s0 * BLOCK_GROWTH**j``, and let the last block's conv2
        epilogue dequantize back to x's dtype."""
        xq, s0 = quantize_dynamic(x)
        blocks = list(self.layer1)
        for j, block in enumerate(blocks):
            s_in = s0 * (BLOCK_GROWTH ** j)
            s_out = None if j == len(blocks) - 1 else s_in * BLOCK_GROWTH
            xq = block.int8_resident_eval(xq, s_in, s_out, x.dtype,
                                          with_sat=self.collect_int8_sat)
        self.int8_sat_fracs = [b.int8_sat_frac for b in blocks] \
            if self.collect_int8_sat else []
        return xq


class ResNetEncoder(nn.Module):
    """ResNet-{18,34,50,101,152} feature pyramid over multi-agent cameras.

    Input (B, L, M, H, W, 3); output a list of (B, L, M, h_i, w_i, C_i)
    for each stage in ``id_pick``.  The trunk sits at attribute
    ``encoder``, mirroring the reference's ``ResnetEncoder.encoder``."""

    def __init__(self, num_layers: int = 34,
                 id_pick: Sequence[int] = (1, 2, 3), remat: bool = False):
        super().__init__()
        self.id_pick = tuple(id_pick)
        self.encoder = ResNetTrunk(num_layers, remat)

    @staticmethod
    def output_shapes(num_layers: int, id_pick,
                      image_hw: Tuple[int, int]):
        block, _ = _SPECS[num_layers]
        expansion = 1 if block == "basic" else 4
        H, W = image_hw
        shapes = []
        for i in range(4):
            s = 4 * (2 ** i)
            shapes.append((H // s, W // s, _WIDTHS[i] * expansion))
        return [shapes[i] for i in id_pick]

    def forward(self, images):
        B, L, M, H, W, C = images.shape
        outs = self.encoder(images.reshape(B * L * M, H, W, C))
        return [outs[i].reshape(B, L, M, *outs[i].shape[1:])
                for i in self.id_pick]
