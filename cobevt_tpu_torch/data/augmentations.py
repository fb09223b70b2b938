"""Image augmentations for the nuScenes track.

Counterpart of ``cobevt_tpu/data/augmentations.py`` (reference
``nuscenes/cross_view_transformer/data/augmentations.py``: imgaug's
``StrongAug`` photometric chain and ``GeometricAug`` affine jitter), a numpy
copy: the same draws from the same ``RandomState`` seed give the same bits.
Applied per camera image before normalization; the geometric jitter returns
the intrinsic that keeps the camera geometry consistent.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class StrongAug:
    """Photometric jitter: brightness, contrast, saturation, gaussian
    noise (each applied with probability p)."""

    def __init__(self, p: float = 0.5, seed: int = 0):
        self.p = p
        self.rng = np.random.RandomState(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img: float32 (H, W, 3) in [0, 1]."""
        out = img.astype(np.float32)
        if self.rng.rand() < self.p:          # brightness
            out = out + self.rng.uniform(-0.2, 0.2)
        if self.rng.rand() < self.p:          # contrast
            mean = out.mean()
            out = (out - mean) * self.rng.uniform(0.7, 1.3) + mean
        if self.rng.rand() < self.p:          # saturation
            gray = out.mean(axis=-1, keepdims=True)
            out = gray + (out - gray) * self.rng.uniform(0.7, 1.3)
        if self.rng.rand() < self.p:          # noise
            out = out + self.rng.normal(0, 0.02, out.shape)
        return np.clip(out, 0.0, 1.0).astype(np.float32)


class GeometricAug:
    """Small affine jitter (scale + translation) with the matching
    intrinsic correction."""

    def __init__(self, max_scale: float = 0.05, max_shift: float = 0.02,
                 p: float = 0.5, seed: int = 0):
        self.max_scale = max_scale
        self.max_shift = max_shift
        self.p = p
        self.rng = np.random.RandomState(seed)

    def __call__(self, img: np.ndarray, intrinsic: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """img: float32 (H, W, 3); intrinsic: (3, 3).
        Returns (augmented image, corrected intrinsic)."""
        if self.rng.rand() >= self.p:
            return img, intrinsic
        H, W = img.shape[:2]
        s = 1.0 + self.rng.uniform(-self.max_scale, self.max_scale)
        tx = self.rng.uniform(-self.max_shift, self.max_shift) * W
        ty = self.rng.uniform(-self.max_shift, self.max_shift) * H

        ys = np.clip(((np.arange(H) - ty) / s), 0, H - 1)
        xs = np.clip(((np.arange(W) - tx) / s), 0, W - 1)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        out = img[y0][:, x0]

        K = np.array(intrinsic, np.float32)
        K[0, 0] *= s
        K[1, 1] *= s
        K[0, 2] = K[0, 2] * s + tx
        K[1, 2] = K[1, 2] * s + ty
        return out.astype(np.float32), K


AUGMENTATIONS = {"none": None, "strong": StrongAug,
                 "geometric": GeometricAug}
