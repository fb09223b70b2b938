"""Top-level camera-BEV graphs: the CVT baseline and its fusion variants,
and the string -> builder registry.

Counterpart of ``cobevt_tpu/models/camera_bev_models.py`` (the reference's
model zoo, selected by ``model.core_method`` in
``opv2v/opencood/tools/train_utils.py:102-135``):

  | registry key  | reference graph                                      |
  |---------------|------------------------------------------------------|
  | cvt           | ``models/cross_view_transformer.py:14``              |
  | cvt_att_fuse  | ``models/cross_view_transformer_att_fuse.py:63``     |
  | cvt_swap_fuse | ``models/cross_view_transformer_swap_fuse.py:64``    |
  | cvt_fcooper   | ``models/cross_view_transformer_fcooper.py:63``      |
  | cvt_v2vnet    | ``models/cross_view_transformer_v2vnet.py:13``       |
  | cvt_disconet  | ``models/cross_view_transformer_disconet.py:14``     |

All share one skeleton, encoder -> dense CVT -> (mask -> [STTF] -> fusion)
-> decoder -> head, which ``CameraBEVModel`` builds once with the fusion as
configuration.  V2VNet and DiscoNet skip STTF: their fusion reads the raw
pairwise transforms.  At eval the ResNet trunk takes K3 and the swap fusion
K4 (or K6), as in CorpBEVT; training runs the swap fusion's stock modules
over K1 and K5.  A model runs in the dtype of its parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.nn as nn

from cobevt_tpu_torch.geometry.warp import roi_and_agent_mask, sttf_warp
from cobevt_tpu_torch.models.corpbevt import CorpBEVT, CorpBEVTConfig, SinBEVT
from cobevt_tpu_torch.models.cvt_dense import CrossViewModule, CVTModuleConfig
from cobevt_tpu_torch.models.fusion.graph_fusion import (
    DiscoNetFusion,
    V2VNetFusion,
)
from cobevt_tpu_torch.models.fusion.swap_fusion import SwapFusionEncoder
from cobevt_tpu_torch.models.fusion.zoo import BaseTransformer, max_fusion
from cobevt_tpu_torch.models.heads import BevSegHead, NaiveDecoder
from cobevt_tpu_torch.nn.layers import images_from_uint8
from cobevt_tpu_torch.nn.resnet import ResNetEncoder

# registry key -> CameraBEVConfig.fusion of the six graphs: the one table
# that hypes, presets and export read.  Each key's long hypes core_method is
# ``zoo_core_method(key)``.
ZOO_FUSIONS = {"cvt": "none", "cvt_att_fuse": "att", "cvt_swap_fuse": "swap",
               "cvt_fcooper": "max", "cvt_v2vnet": "v2vnet",
               "cvt_disconet": "disconet"}


def zoo_core_method(key: str) -> str:
    """The reference's core_method of a zoo registry key ("cvt_v2vnet" ->
    "cross_view_transformer_v2vnet")."""
    return "cross_view_transformer" + key[len("cvt"):]


@dataclasses.dataclass(frozen=True)
class CameraBEVConfig:
    """The shared skeleton's config (a copy of the JAX package's)."""

    max_cav: int = 5
    target: str = "dynamic"
    encoder_num_layers: int = 34
    encoder_id_pick: Tuple[int, ...] = (1, 3)
    image_height: int = 512
    image_width: int = 512
    cvm: CVTModuleConfig = CVTModuleConfig()
    fusion: str = "none"   # none|att|swap|max|v2vnet|disconet
    sttf_resolution: float = 0.390625
    sttf_downsample_rate: int = 8
    use_roi_mask: bool = True
    # att fusion (BaseTransformer)
    att_depth: int = 1
    att_heads: int = 8
    att_dim_head: int = 32
    att_mlp_dim: int = 256
    att_dropout: float = 0.0
    # swap fusion
    swap_mlp_dim: int = 256
    swap_window_size: int = 8
    swap_dim_head: int = 32
    swap_dropout: float = 0.1
    swap_depth: int = 3
    swap_mask: bool = True
    # v2vnet / disconet
    graph_num_iteration: int = 2
    graph_gru_flag: bool = True
    graph_agg_operator: str = "avg"
    # decoder / head
    decoder_num_layer: int = 3
    decoder_num_ch: Tuple[int, ...] = (32, 64, 128)
    seg_head_dim: int = 32
    output_class: int = 2

    def resolved_cvm(self) -> CVTModuleConfig:
        if self.cvm.backbone_output_shape:
            return self.cvm
        shapes = ResNetEncoder.output_shapes(
            self.encoder_num_layers, self.encoder_id_pick,
            (self.image_height, self.image_width))
        return dataclasses.replace(
            self.cvm, backbone_output_shape=tuple(shapes),
            middle=self.cvm.middle or tuple([2] * len(shapes)),
            image_height=self.image_height, image_width=self.image_width)


class CameraBEVModel(nn.Module):
    """encoder -> dense CVT -> (mask -> fusion ->) decoder -> seg head.
    ``fusion="none"`` decodes every agent on its own (the plain CVT
    baseline)."""

    def __init__(self, config: CameraBEVConfig = CameraBEVConfig()):
        super().__init__()
        cfg = config
        if cfg.fusion not in ZOO_FUSIONS.values():
            raise ValueError(f"unknown fusion: {cfg.fusion}")
        self.config = cfg
        cvm = cfg.resolved_cvm()
        dim = cvm.dim
        self.encoder = ResNetEncoder(cfg.encoder_num_layers,
                                     cfg.encoder_id_pick)
        self.cvm = CrossViewModule(cvm)
        if cfg.fusion == "att":
            self.fusion_net = BaseTransformer(
                dim, cfg.att_depth, cfg.att_heads, cfg.att_dim_head,
                cfg.att_mlp_dim, cfg.att_dropout)
        elif cfg.fusion == "swap":
            self.fusion_net = SwapFusionEncoder(
                input_dim=dim, mlp_dim=cfg.swap_mlp_dim,
                agent_size=cfg.max_cav, window_size=cfg.swap_window_size,
                dim_head=cfg.swap_dim_head, dropout=cfg.swap_dropout,
                depth=cfg.swap_depth, mask=cfg.swap_mask)
        elif cfg.fusion == "v2vnet":
            self.fusion_net = V2VNetFusion(
                dim, cfg.graph_num_iteration, cfg.graph_gru_flag,
                cfg.graph_agg_operator, cfg.sttf_resolution,
                cfg.sttf_downsample_rate)
        elif cfg.fusion == "disconet":
            self.fusion_net = DiscoNetFusion(
                dim, cfg.graph_num_iteration,
                discrete_ratio=cfg.sttf_resolution,
                downsample_rate=cfg.sttf_downsample_rate)
        self.decoder = NaiveDecoder(dim, cfg.decoder_num_layer,
                                    cfg.decoder_num_ch)
        self.seg_head = BevSegHead(cfg.target, cfg.seg_head_dim,
                                   cfg.output_class)

    def forward(self, batch, generator=None):
        """batch: dict of tensors on the model's device
             inputs: (B, L, M, H, W, 3) uint8 or float images
             intrinsic: (B, L, M, 3, 3); extrinsic: (B, L, M, 4, 4)
             agent_mask: (B, L) (fusion graphs)
             transformation_matrix: (B, L, 4, 4) (att, swap, max)
             pairwise_t_matrix: (B, L, L, 4, 4) (v2vnet, disconet)
        Returns a dict of seg logits, (B, L, H, W, classes) for ``none`` and
        (B, 1, H, W, classes) for a fusion.  ``generator`` draws the CAV
        transformer's dropout masks in training."""
        cfg = self.config
        dtype = self.encoder.encoder.conv1.weight.dtype
        x = images_from_uint8(batch["inputs"]).to(dtype)
        x = self.cvm(self.encoder(x), batch["intrinsic"],
                     batch["extrinsic"])                  # (B, L, H, W, C)
        if cfg.fusion == "none":
            return self.seg_head(self.decoder(x))

        agent_mask = batch["agent_mask"]
        x = x * agent_mask[:, :, None, None, None].to(x.dtype)
        B, L, H, W = x.shape[:4]
        if cfg.fusion in ("v2vnet", "disconet"):
            fused = self.fusion_net(x, agent_mask,
                                    batch["pairwise_t_matrix"])
        else:
            tmat = batch["transformation_matrix"]
            x = sttf_warp(x, tmat, cfg.sttf_resolution,
                          cfg.sttf_downsample_rate)
            if cfg.use_roi_mask:
                com_mask = roi_and_agent_mask(
                    (B, L, H, W), agent_mask, tmat, cfg.sttf_resolution,
                    cfg.sttf_downsample_rate)
            else:
                com_mask = agent_mask[:, :, None, None].float().expand(
                    B, L, H, W)
            if cfg.fusion == "att":
                fused = self.fusion_net(
                    x, com_mask.permute(0, 2, 3, 1)[..., None, :],
                    generator)
            elif cfg.fusion == "swap":
                fused = self.fusion_net(x, com_mask, agent_mask=agent_mask,
                                        generator=generator)
            else:
                # the reference's F-Cooper maxes the zero-padded stack
                fused = max_fusion(x)
        return self.seg_head(self.decoder(fused[:, None]))


def _cvt_variant(fusion):
    def build(**overrides):
        return CameraBEVModel(CameraBEVConfig(fusion=fusion, **overrides))
    return build


MODEL_REGISTRY = {
    "corpbevt": lambda **kw: CorpBEVT(CorpBEVTConfig(**kw)),
    "fax": lambda **kw: SinBEVT(CorpBEVTConfig(**kw)),
    **{key: _cvt_variant(fusion) for key, fusion in ZOO_FUSIONS.items()},
}


def create_model(core_method: str, **kwargs) -> nn.Module:
    """String dispatch mirroring the reference's ``train_utils.create_model``
    (``opv2v/opencood/tools/train_utils.py:102-135``)."""
    if core_method not in MODEL_REGISTRY:
        raise KeyError(f"unknown core_method {core_method!r}; "
                       f"available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[core_method](**kwargs)

