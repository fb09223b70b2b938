"""ConvGRU (NHWC) of the V2VNet fusion.

Counterpart of ``cobevt_tpu/models/fusion/convgru.py`` (reference
``opv2v/opencood/models/sub_modules/convgru.py:7`` ConvGRUCell, :73
ConvGRU); torch names ``cell_list.<i>.{conv_gates,conv_can}``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from cobevt_tpu_torch.nn.layers import conv_nhwc


class ConvGRUCell(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 kernel_size: Tuple[int, int] = (3, 3), bias: bool = True):
        super().__init__()
        pad = (kernel_size[0] // 2, kernel_size[1] // 2)
        self.conv_gates = nn.Conv2d(input_dim + hidden_dim, 2 * hidden_dim,
                                    kernel_size, 1, pad, bias=bias)
        self.conv_can = nn.Conv2d(input_dim + hidden_dim, hidden_dim,
                                  kernel_size, 1, pad, bias=bias)

    def forward(self, x, h):
        """x: (B, H, W, C_in); h: (B, H, W, hidden).  Returns the next h."""
        dtype = self.conv_gates.weight.dtype
        combined = torch.cat([x, h], dim=-1).to(dtype)
        gamma, beta = conv_nhwc(self.conv_gates, combined).chunk(2, dim=-1)
        reset, update = torch.sigmoid(gamma), torch.sigmoid(beta)
        cand_in = torch.cat([x, reset * h], dim=-1).to(dtype)
        cand = torch.tanh(conv_nhwc(self.conv_can, cand_in))
        return (1 - update) * h + update * cand


class ConvGRU(nn.Module):
    """Stacked cells run one step from a zero hidden state, as the fusion
    modules call the reference ConvGRU."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (64,),
                 kernel_size: Tuple[int, int] = (3, 3), bias: bool = True):
        super().__init__()
        dims = [input_dim, *hidden_dims]
        self.cell_list = nn.ModuleList([
            ConvGRUCell(dims[i], dims[i + 1], kernel_size, bias)
            for i in range(len(hidden_dims))])

    def forward(self, x):
        """x: (B, H, W, C).  The last layer's hidden state after one step
        from zero."""
        h = x
        for cell in self.cell_list:
            hidden = cell.conv_can.out_channels
            h = cell(h, torch.zeros((*h.shape[:-1], hidden), dtype=h.dtype,
                                    device=h.device))
        return h

