"""Export a hypes dict for a preset model configuration.

Counterpart of ``cobevt_tpu/tools/export_config.py`` for the port's
presets: the typed config is the source of truth and the reference-schema
hypes are generated from it, so a full-width ``corpbevt.yaml`` needs no YAML
file in the repository.  Printed as YAML where PyYAML is installed, else as
JSON (which is YAML).

  python -m cobevt_tpu_torch.tools.export_config corpbevt > corpbevt.yaml
"""

from __future__ import annotations

import argparse
import json
import sys


def hypes_from_corpbevt(cfg, name: str) -> dict:
    fax = cfg.fax
    return {
        "name": name,
        "root_dir": "/data/opv2v/train",
        "validate_dir": "/data/opv2v/validate",
        "train_params": {"batch_size": 1, "epoches": 151, "eval_freq": 5,
                         "save_freq": 5, "max_cav": cfg.max_cav,
                         "visible": True},
        "fusion": {"core_method": "CamIntermediateFusionDataset",
                   "args": []},
        "add_data_extension": ["bev_dynamic.png", "bev_static.png",
                               "bev_lane.png", "bev_visibility.png",
                               "bev_visibility_corp.png"],
        "preprocess": {
            "core_method": "RgbPreprocessor",
            "args": {"bgr2rgb": True, "resize_x": cfg.image_width,
                     "resize_y": cfg.image_height,
                     "mean": [0.485, 0.456, 0.406],
                     "std": [0.229, 0.224, 0.225]},
            "cav_lidar_range": [-50, -50, -3, 50, 50, 1]},
        "model": {"core_method": "corpbevt", "args": {
            "target": cfg.target, "max_cav": cfg.max_cav,
            "encoder": {"num_layers": cfg.encoder_num_layers,
                        "pretrained": False,
                        "image_width": cfg.image_width,
                        "image_height": cfg.image_height,
                        "id_pick": list(cfg.encoder_id_pick)},
            "compression": cfg.compression,
            "decoder": {"input_dim": cfg.fax.dim[-1],
                        "num_layer": cfg.decoder_num_layer,
                        "num_ch_dec": list(cfg.decoder_num_ch)},
            "fax": {
                "dim": list(fax.dim), "middle": list(fax.middle),
                "bev_embedding": {
                    "sigma": fax.sigma, "bev_height": fax.bev_height,
                    "bev_width": fax.bev_width,
                    "h_meters": fax.h_meters, "w_meters": fax.w_meters,
                    "offset": fax.offset,
                    "upsample_scales": list(fax.upsample_scales)},
                "cross_view": {
                    "image_height": cfg.image_height,
                    "image_width": cfg.image_width,
                    "no_image_features": fax.no_image_features,
                    "skip": fax.skip, "heads": list(fax.heads),
                    "dim_head": list(fax.dim_head),
                    "qkv_bias": fax.qkv_bias},
                "cross_view_swap": {
                    "rel_pos_emb": False,
                    "q_win_size": [list(w) for w in fax.q_win_size],
                    "feat_win_size": [list(w) for w in
                                      fax.feat_win_size],
                    "bev_embedding_flag": list(fax.bev_embedding_flag)},
                "self_attn": {"dim_head": fax.self_attn_dim_head,
                              "dropout": fax.self_attn_dropout,
                              "window_size": fax.self_attn_window}},
            "sttf": {"resolution": cfg.sttf_resolution,
                     "downsample_rate": cfg.sttf_downsample_rate,
                     "use_roi_mask": cfg.use_roi_mask},
            "fax_fusion": {"input_dim": cfg.fax.dim[-1],
                           "mlp_dim": cfg.fusion_mlp_dim,
                           "agent_size": cfg.max_cav,
                           "window_size": cfg.fusion_window_size,
                           "dim_head": cfg.fusion_dim_head,
                           "drop_out": cfg.fusion_dropout,
                           "depth": cfg.fusion_depth,
                           "mask": cfg.fusion_mask},
            "seg_head_dim": cfg.seg_head_dim,
            "output_class": cfg.output_class}},
        "loss": {"core_method": "vanilla_seg_loss",
                 "args": {"target": cfg.target, "d_weights": 75.0,
                          "s_weights": 15.0, "d_coe": 2.0,
                          "s_coe": 0.0 if cfg.target == "dynamic"
                          else 1.0}},
        "optimizer": {"core_method": "AdamW", "lr": 2e-4,
                      "args": {"eps": 1e-10, "weight_decay": 1e-2}},
        "lr_scheduler": {"core_method": "cosineannealwarm",
                         "epoches": 151, "warmup_lr": 2e-5,
                         "warmup_epoches": 10, "lr_min": 5e-6},
    }


PRESETS = ("corpbevt",)


def export_preset(name: str) -> dict:
    from cobevt_tpu_torch.configs.presets import corpbevt_default

    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; the port has {PRESETS}")
    return hypes_from_corpbevt(corpbevt_default(), name)


def main(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch export_config")
    p.add_argument("preset", choices=PRESETS)
    opt = p.parse_args(argv)
    out = export_preset(opt.preset)
    from cobevt_tpu_torch.configs.hypes import yaml
    if yaml is not None:
        yaml.safe_dump(out, sys.stdout, sort_keys=False)
    else:
        json.dump(out, sys.stdout, indent=1)
        sys.stdout.write("\n")


if __name__ == "__main__":
    main()
