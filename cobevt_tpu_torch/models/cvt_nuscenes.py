"""Dense CVT encoder for the nuScenes track (the CVT ablation of SinBEVT).

Counterpart of ``cobevt_tpu/models/cvt_nuscenes.py`` (reference
``nuscenes/cross_view_transformer/model/encoder.py:281``, config
``nuscenes/config/model/cvt.yaml``): dense cross-view attention over
EfficientNet features at one fixed BEV resolution, the stages of
``models/cvt_dense.py``, behind the same ``CrossViewTransformer`` decoder
and head as the pyramid-axial encoder.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from cobevt_tpu_torch.models.cvt_dense import DenseStages
from cobevt_tpu_torch.nn.efficientnet import EfficientNetExtractor
from cobevt_tpu_torch.nn.layers import images_from_uint8, normalize_image


@dataclasses.dataclass(frozen=True)
class CVTNuScenesConfig:
    """``nuscenes/config/model/cvt.yaml`` (a copy of the JAX package's
    config)."""

    dim: int = 128
    middle: Tuple[int, ...] = (2, 2)
    image_height: int = 224
    image_width: int = 480
    backbone_model: str = "efficientnet-b4"
    backbone_layers: Tuple[str, ...] = ("reduction_2", "reduction_4")
    heads: int = 4
    dim_head: int = 32
    qkv_bias: bool = True
    no_image_features: bool = False
    skip: bool = True
    sigma: float = 1.0
    bev_height: int = 200
    bev_width: int = 200
    h_meters: float = 100.0
    w_meters: float = 100.0
    offset: float = 0.0
    decoder_blocks: int = 3
    remat_backbone: bool = True


class CVTNuScenesEncoder(DenseStages):
    """Normalize -> EfficientNet -> dense cross-view stages at a fixed BEV
    resolution."""

    def __init__(self, config: CVTNuScenesConfig = CVTNuScenesConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.backbone = EfficientNetExtractor(
            cfg.backbone_layers, cfg.backbone_model, remat=cfg.remat_backbone)
        shapes = EfficientNetExtractor.output_shapes(
            cfg.backbone_layers, (cfg.image_height, cfg.image_width),
            cfg.backbone_model)
        self._build_stages(cfg, shapes, (cfg.image_height, cfg.image_width))

    def forward(self, batch, generator=None):
        """batch: image (B, n, H, W, 3) in [0, 1] (or uint8); intrinsics
        (B, n, 3, 3); extrinsics (B, n, 4, 4).  Returns (B, H', W', dim) in
        the dtype of the model's parameters; ``generator`` draws the trunk's
        drop-connect gates in training."""
        dtype = self.bev_embedding.learned_features.dtype
        image = images_from_uint8(batch["image"], normalize=False)
        B, n, H, W, _ = image.shape
        # inverted in f32, without the host sync of torch.linalg.inv's check
        I_inv = torch.linalg.inv_ex(batch["intrinsics"].float())[0]
        E_inv = torch.linalg.inv_ex(batch["extrinsics"].float())[0]
        flat = normalize_image(image.reshape(B * n, H, W, 3).float())
        feats = self.backbone(flat.to(dtype), generator=generator)
        return self._run_stages([f.reshape(B, n, *f.shape[1:])
                                 for f in feats], I_inv, E_inv, dtype)
