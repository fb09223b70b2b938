"""Export a hypes dict for a preset model configuration.

Counterpart of ``cobevt_tpu/tools/export_config.py``: the typed config of
each of the 15 opcamera presets (``configs/presets.py``) is the source of
truth and the reference-schema hypes are generated from it, so a full-width
``corpbevt.yaml`` or ``cvt_swap_fuse.yaml`` needs no YAML file in the
repository; a nuScenes experiment name exports the composed experiment
(``configs/nuscenes_experiments.py:experiment_to_dict``).  Printed as YAML
where PyYAML is installed, else as JSON (which is YAML).

  python -m cobevt_tpu_torch.tools.export_config corpbevt > corpbevt.yaml
  python -m cobevt_tpu_torch.tools.export_config cvt_swap_fuse > cvt.yaml
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


def hypes_from_camera_bev(cfg, name: str) -> dict:
    """Reference-schema hypes of a CameraBEVConfig (the six cvt graphs;
    reference hypes_yaml/opcamera/cvt*.yaml)."""
    from cobevt_tpu_torch.models.camera_bev_models import (
        ZOO_FUSIONS,
        zoo_core_method,
    )

    core_method = next(zoo_core_method(key) for key, fusion
                       in ZOO_FUSIONS.items() if fusion == cfg.fusion)
    cvm = cfg.resolved_cvm()
    static = cfg.target == "static"
    args = {
        "target": cfg.target,
        "encoder": {"num_layers": cfg.encoder_num_layers,
                    "pretrained": False,
                    "image_width": cfg.image_width,
                    "image_height": cfg.image_height,
                    "id_pick": list(cfg.encoder_id_pick)},
        "decoder": {"input_dim": cvm.dim,
                    "num_layer": cfg.decoder_num_layer,
                    "num_ch_dec": list(cfg.decoder_num_ch)},
        "cvm": {
            "dim": cvm.dim, "middle": list(cvm.middle),
            "bev_embedding": {
                "sigma": cvm.sigma, "bev_height": cvm.bev_height,
                "bev_width": cvm.bev_width, "h_meters": cvm.h_meters,
                "w_meters": cvm.w_meters, "offset": cvm.offset,
                "decoder_blocks": list(cfg.decoder_num_ch)},
            "cross_view": {
                "image_height": cfg.image_height,
                "image_width": cfg.image_width,
                "no_image_features": cvm.no_image_features,
                "skip": cvm.skip, "heads": cvm.heads,
                "dim_head": cvm.dim_head, "qkv_bias": cvm.qkv_bias}},
        "seg_head_dim": cfg.seg_head_dim,
        "output_class": cfg.output_class,
    }
    if cfg.fusion != "none":
        args["max_cav"] = cfg.max_cav
        args["sttf"] = {"resolution": cfg.sttf_resolution,
                        "downsample_rate": cfg.sttf_downsample_rate,
                        "use_roi_mask": cfg.use_roi_mask}
    if cfg.fusion == "att":
        args["base_transformer"] = {
            "dim": cvm.dim, "depth": cfg.att_depth,
            "heads": cfg.att_heads, "dim_head": cfg.att_dim_head,
            "mlp_dim": cfg.att_mlp_dim, "dropout": cfg.att_dropout}
    elif cfg.fusion == "swap":
        args["swap_fusion"] = {
            "input_dim": cvm.dim, "mlp_dim": cfg.swap_mlp_dim,
            "agent_size": cfg.max_cav,
            "window_size": cfg.swap_window_size,
            "dim_head": cfg.swap_dim_head,
            "drop_out": cfg.swap_dropout, "depth": cfg.swap_depth,
            "mask": cfg.swap_mask}
    elif cfg.fusion in ("v2vnet", "disconet"):
        args[f"{cfg.fusion}_fusion"] = {
            "resolution": cfg.sttf_resolution,
            "downsample_rate": cfg.sttf_downsample_rate,
            "num_iteration": cfg.graph_num_iteration,
            "in_channels": cvm.dim,
            "gru_flag": cfg.graph_gru_flag,
            "agg_operator": cfg.graph_agg_operator,
            "conv_gru": {"H": 32, "W": 32, "num_layers": 1,
                         "kernel_size": [[3, 3]]}}

    dataset = ("CamLateFusionDataset" if cfg.fusion == "none"
               else "CamIntermediateFusionDataset")
    return {
        "name": name,
        "root_dir": "/data/opv2v/train",
        "validate_dir": "/data/opv2v/validate",
        "train_params": {"batch_size": 1, "epoches": 151, "eval_freq": 5,
                         "save_freq": 5, "max_cav": cfg.max_cav,
                         "visible": True},
        "fusion": {"core_method": dataset, "args": []},
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
        "model": {"core_method": core_method,
                  "args": args},
        "loss": {"core_method": "vanilla_seg_loss",
                 "args": ({"target": cfg.target, "d_weights": 75.0,
                           "s_weights": 2.0, "l_weights": 4.0,
                           "d_coe": 2.0, "s_coe": 1.0} if static else
                          {"target": cfg.target, "d_weights": 75.0,
                           "s_weights": 15.0, "d_coe": 2.0,
                           "s_coe": 0.0})},
        "optimizer": {"core_method": "AdamW", "lr": 2e-4,
                      "args": {"eps": 1e-10, "weight_decay": 1e-2}},
        "lr_scheduler": {"core_method": "cosineannealwarm",
                         "epoches": 151, "warmup_lr": 2e-5,
                         "warmup_epoches": 10, "lr_min": 5e-6},
    }


def export_preset(name: str) -> dict:
    """Hypes dict of any opcamera preset (15 names,
    ``configs/presets.py:all_opcamera_presets``)."""
    from cobevt_tpu_torch.configs.presets import all_opcamera_presets

    presets = all_opcamera_presets()
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(presets)}")
    cfg = presets[name]()
    if name in ("corpbevt", "corpbevt_static", "fax"):
        hypes = hypes_from_corpbevt(cfg, name)
        if name == "fax":
            hypes["model"]["core_method"] = "fax_fused_transformer"
            # the fusion-free graph has no fax_fusion/sttf/max_cav blocks
            for k in ("fax_fusion", "sttf", "max_cav"):
                hypes["model"]["args"].pop(k, None)
        if name == "corpbevt_static":
            hypes["loss"]["args"].update(s_weights=2.0, l_weights=4.0,
                                         s_coe=1.0)
        return hypes
    return hypes_from_camera_bev(cfg, name)


def main(argv=None):
    from cobevt_tpu_torch.configs.nuscenes_experiments import (
        all_nuscenes_experiments,
        experiment_to_dict,
        nuscenes_experiment,
    )
    from cobevt_tpu_torch.configs.presets import all_opcamera_presets

    p = argparse.ArgumentParser("cobevt_tpu_torch export_config")
    p.add_argument("preset", choices=sorted(all_opcamera_presets())
                   + sorted(all_nuscenes_experiments()))
    opt = p.parse_args(argv)
    if opt.preset in all_nuscenes_experiments():
        out = experiment_to_dict(nuscenes_experiment(opt.preset))
    else:
        out = export_preset(opt.preset)
    from cobevt_tpu_torch.configs.hypes import yaml
    if yaml is not None:
        yaml.safe_dump(out, sys.stdout, sort_keys=False)
    else:
        json.dump(out, sys.stdout, indent=1)
        sys.stdout.write("\n")


if __name__ == "__main__":
    main()
