"""Model configuration presets mirroring the reference hypes YAMLs
(counterpart of ``cobevt_tpu/configs/presets.py``): the 15 opcamera
configurations, CorpBEVT, SinBEVT and the six CVT graphs with their
``_static`` twins."""

from __future__ import annotations

import dataclasses

from cobevt_tpu_torch.models.camera_bev_models import (
    ZOO_FUSIONS,
    CameraBEVConfig,
)
from cobevt_tpu_torch.models.corpbevt import CorpBEVTConfig
from cobevt_tpu_torch.models.fax import FAXConfig


def corpbevt_fax_config() -> FAXConfig:
    """The ``fax:`` block of opv2v/opencood/hypes_yaml/opcamera/
    corpbevt.yaml:65-95."""
    return FAXConfig(
        dim=(128, 128, 128), middle=(2, 2, 2),
        image_height=512, image_width=512, qkv_bias=True,
        heads=(4, 4, 4), dim_head=(32, 32, 32),
        q_win_size=((16, 16), (16, 16), (32, 32)),
        feat_win_size=((8, 8), (8, 8), (16, 16)),
        bev_embedding_flag=(True, False, False),
        sigma=1.0, bev_height=256, bev_width=256,
        h_meters=100.0, w_meters=100.0, offset=0.0,
        upsample_scales=(2, 4, 8),
        self_attn_dim_head=32, self_attn_dropout=0.1, self_attn_window=32)


def corpbevt_default(max_cav: int = 5) -> CorpBEVTConfig:
    """corpbevt.yaml (dynamic head)."""
    return CorpBEVTConfig(
        max_cav=max_cav, target="dynamic",
        encoder_num_layers=34, encoder_id_pick=(1, 2, 3),
        image_height=512, image_width=512,
        fax=corpbevt_fax_config(), compression=0,
        sttf_resolution=0.390625, sttf_downsample_rate=8,
        use_roi_mask=True,
        fusion_mlp_dim=256, fusion_window_size=8, fusion_dim_head=32,
        fusion_dropout=0.1, fusion_depth=3, fusion_mask=True,
        decoder_num_layer=3, decoder_num_ch=(32, 64, 128),
        seg_head_dim=32, output_class=2)


def corpbevt_static(max_cav: int = 5) -> CorpBEVTConfig:
    """corpbevt_static.yaml: 3-class static head (road / lane / bg)."""
    return dataclasses.replace(corpbevt_default(max_cav), target="static",
                               output_class=3)


def sinbevt_opv2v() -> CorpBEVTConfig:
    """fax.yaml: single-agent SinBEVT on the OPV2V camera rig."""
    return corpbevt_default(max_cav=1)


# ---------------------------------------------------------------------------
# the six cross_view_transformer* graphs
# ---------------------------------------------------------------------------

def _camera_bev(fusion: str, static: bool = False,
                **overrides) -> CameraBEVConfig:
    base = dict(
        max_cav=5 if fusion != "none" else 1,
        target="static" if static else "dynamic",
        encoder_num_layers=34, encoder_id_pick=(1, 3),
        image_height=512, image_width=512,
        fusion=fusion,
        sttf_resolution=0.390625, sttf_downsample_rate=8,
        use_roi_mask=True,
        # base_transformer block, cvt_att_fuse.yaml:71-77
        att_depth=2, att_heads=8, att_dim_head=32, att_mlp_dim=256,
        att_dropout=0.1,
        # swap_fusion block, cvt_swap_fuse.yaml:66-74
        swap_mlp_dim=256, swap_window_size=8, swap_dim_head=32,
        swap_dropout=0.1, swap_depth=3, swap_mask=True,
        # v2vnet/disconet blocks, cvt_v2vnet.yaml:66-77
        graph_num_iteration=3, graph_gru_flag=True,
        graph_agg_operator="avg",
        decoder_num_layer=3, decoder_num_ch=(32, 64, 128),
        seg_head_dim=32, output_class=3 if static else 2)
    base.update(overrides)
    return CameraBEVConfig(**base)


def camera_bev_preset(name: str, **overrides) -> CameraBEVConfig:
    """Typed preset of a cvt opcamera config (reference
    hypes_yaml/opcamera/*.yaml): cvt / cvt_att_fuse / cvt_swap_fuse /
    cvt_fcooper / cvt_v2vnet / cvt_disconet, each with a ``_static``
    variant."""
    static = name.endswith("_static")
    key = name[:-len("_static")] if static else name
    return _camera_bev(ZOO_FUSIONS[key], static=static, **overrides)


def all_opcamera_presets():
    """name -> zero-argument builder of every opcamera config (15)."""
    out = {
        "corpbevt": corpbevt_default,
        "corpbevt_static": corpbevt_static,
        "fax": sinbevt_opv2v,
    }
    for name in ZOO_FUSIONS:
        for suffix in ("", "_static"):
            full = name + suffix
            out[full] = (lambda n: lambda: camera_bev_preset(n))(full)
    return out
