"""Fusion baselines.

Counterpart of ``cobevt_tpu/models/fusion/zoo.py``; only :func:`max_fusion`,
the ``fusion="max"`` baseline of the cooperative LiDAR model, is here.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def max_fusion(x, mask=None):
    """Elementwise max over the agents of (B, L, H, W, C).

    With ``mask`` (B, L): the max over valid agents only.  Without: the max
    over the padded stack, zero rows included."""
    if mask is None:
        return x.max(dim=1).values
    neg = torch.where(mask[:, :, None, None, None] > 0, x,
                      torch.full_like(x, NEG_INF))
    return neg.max(dim=1).values
