"""Model configuration presets mirroring the reference hypes YAMLs
(counterpart of ``cobevt_tpu/configs/presets.py``)."""

from __future__ import annotations

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
