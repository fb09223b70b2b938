"""Bit-packed BEV label codec (nuScenes track).

Counterpart of ``cobevt_tpu/data/labels.py`` (reference
``nuscenes/cross_view_transformer/data/common.py:49/:69``): n binary channel
maps pack into one int32 image (bit k = channel k)."""

from __future__ import annotations

import numpy as np


def encode_binary_maps(x: np.ndarray) -> np.ndarray:
    """(h, w, c) uint8 {0, 255} -> (h, w) int32 bitfield."""
    assert x.ndim == 3 and x.dtype == np.uint8
    shift = np.arange(x.shape[2], dtype=np.int32)[None, None]
    return ((x > 0).astype(np.int32) << shift).sum(-1).astype(np.int32)


def decode_binary_maps(img, n: int) -> np.ndarray:
    """(h, w) int -> (h, w, n) int32 {0, 1}."""
    shift = np.arange(n, dtype=np.int32)[None, None]
    x = np.asarray(img, dtype=np.int32)[..., None]
    return (x >> shift) & 1
