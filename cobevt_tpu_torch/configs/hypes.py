"""YAML "hypes" configuration loading, compatible with the reference's
config files.

Counterpart of ``cobevt_tpu/configs/hypes.py`` for the OPV2V camera track:

  * the scientific-notation float resolver (reference
    ``yaml_utils.py:29-38``);
  * derived-geometry post hooks as a registry, not ``eval``;
  * the checkpoint dir's ``config.yaml`` taking priority on resume;
  * ``load_bev_params`` and the LiDAR parsers ``load_voxel_params``,
    ``load_second_params`` and ``load_point_pillar_params`` (the last with
    the JAX package's fix of the reference's undefined ``vw/vh/vd``);
  * hypes -> the port's typed model configs for all eight camera graphs:
    ``corpbevt``, ``fax`` (SinBEVT-OPV2V) and the six of the CVT zoo
    (SECOND's is ``models/lidar/second_models.py:
    second_config_from_hypes``).

PyYAML is optional.  JSON is YAML, so where ``yaml`` cannot be imported a
hypes file or a per-timestamp file is read as JSON, and
:func:`save_config_snapshot` writes JSON text into ``config.yaml`` (still a
valid YAML file for the JAX package and the reference).  A file that is not
JSON, read where ``yaml`` is missing, raises an error naming PyYAML.

The model modules are imported inside the functions that build configs, so
a dataset that reads its YAML through this module, unpickled in a loader's
worker, loads none of the model zoo.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Callable, Dict, Optional

import numpy as np

try:
    import yaml
except ImportError:
    yaml = None

_FLOAT_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)

PARSER_REGISTRY: Dict[str, Callable] = {}


def register_parser(name):
    def deco(fn):
        PARSER_REGISTRY[name] = fn
        return fn
    return deco


def _hypes_loader():
    class _Loader(yaml.SafeLoader):
        pass

    _Loader.add_implicit_resolver(
        "tag:yaml.org,2002:float", _FLOAT_RE, list("-+0123456789."))
    return _Loader


def read_yaml(path: str, hypes: bool = False) -> dict:
    """One YAML file as a dict: with the hypes float resolver when
    ``hypes``, else with libyaml's safe loader where it is built (the
    per-timestamp files).  Without PyYAML the file must be JSON."""
    with open(path) as f:
        text = f.read()
    if yaml is not None:
        loader = _hypes_loader() if hypes else getattr(
            yaml, "CSafeLoader", yaml.SafeLoader)
        return yaml.load(text, Loader=loader)
    try:
        return json.loads(text)
    except ValueError as e:
        raise ValueError(
            f"{path} is not JSON, and reading other YAML needs PyYAML, "
            "which is not installed") from e


def write_yaml(params: dict, path: str) -> None:
    """``params`` as YAML text, or as JSON text (a YAML subset) where
    PyYAML is not installed."""
    with open(path, "w") as f:
        if yaml is not None:
            yaml.safe_dump(params, f)
        else:
            json.dump(params, f, indent=1)


def load_hypes(path: str, model_dir: Optional[str] = None) -> dict:
    """Load a hypes yaml; a checkpoint dir's config.yaml takes priority."""
    if model_dir:
        snapshot = os.path.join(model_dir, "config.yaml")
        if os.path.exists(snapshot):
            path = snapshot
    params = read_yaml(path, hypes=True)

    parser_name = params.get("yaml_parser")
    if parser_name:
        if parser_name not in PARSER_REGISTRY:
            raise KeyError(
                f"unknown yaml_parser {parser_name!r}; "
                f"registered: {sorted(PARSER_REGISTRY)}")
        params = PARSER_REGISTRY[parser_name](params)
    return params


def save_config_snapshot(params: dict, save_dir: str):
    """Write config.yaml next to checkpoints (reference
    ``train_utils.setup_train`` :94-97)."""
    os.makedirs(save_dir, exist_ok=True)
    write_yaml(params, os.path.join(save_dir, "config.yaml"))


@register_parser("load_bev_params")
def load_bev_params(param: dict) -> dict:
    """BEV geometry: input/label grid shapes from lidar range + res."""
    res = param["preprocess"]["args"]["res"]
    L1, W1, H1, L2, W2, H2 = param["preprocess"]["cav_lidar_range"]
    downsample_rate = param["preprocess"]["args"]["downsample_rate"]
    input_shape = (int((L2 - L1) / res), int((W2 - W1) / res),
                   int((H2 - H1) / res) + 1)
    param["preprocess"]["geometry_param"] = {
        "L1": L1, "L2": L2, "W1": W1, "W2": W2, "H1": H1, "H2": H2,
        "downsample_rate": downsample_rate, "input_shape": input_shape,
        "label_shape": (input_shape[0] // downsample_rate,
                        input_shape[1] // downsample_rate, 7),
        "res": res,
    }
    if "model" in param:
        param["model"]["args"]["geometry_param"] = \
            param["preprocess"]["geometry_param"]
    if "postprocess" in param:
        param["postprocess"]["geometry_param"] = \
            param["preprocess"]["geometry_param"]
    return param


@register_parser("load_voxel_params")
def load_voxel_params(param: dict) -> dict:
    """Anchor grid ``W/H/D`` (truncated) from the anchor range and the
    voxel size, copied into the model args."""
    anchor_args = param["postprocess"]["anchor_args"]
    lr = anchor_args["cav_lidar_range"]
    vw, vh, vd = param["preprocess"]["args"]["voxel_size"]
    anchor_args.update({"vw": vw, "vh": vh, "vd": vd,
                        "W": int((lr[3] - lr[0]) / vw),
                        "H": int((lr[4] - lr[1]) / vh),
                        "D": int((lr[5] - lr[2]) / vd)})
    if "model" in param:
        for k in ("W", "H", "D"):
            param["model"]["args"][k] = anchor_args[k]
    return param


def _grid_size(param: dict):
    """(W, H, D) voxels of the lidar range, rounded to nearest."""
    lr = param["preprocess"]["cav_lidar_range"]
    voxel_size = param["preprocess"]["args"]["voxel_size"]
    return np.round((np.array(lr[3:6]) - np.array(lr[0:3])) /
                    np.array(voxel_size)).astype(np.int64).tolist()


def _anchor_grid(param: dict) -> None:
    """Anchor grid ``W/H/D`` of the lidar range, rounded up (the reference
    rounds the voxel grid and the anchor grid differently)."""
    lr = param["preprocess"]["cav_lidar_range"]
    vw, vh, vd = param["preprocess"]["args"]["voxel_size"]
    param["postprocess"]["anchor_args"].update({
        "vw": vw, "vh": vh, "vd": vd,
        "W": math.ceil((lr[3] - lr[0]) / vw),
        "H": math.ceil((lr[4] - lr[1]) / vh),
        "D": math.ceil((lr[5] - lr[2]) / vd)})


@register_parser("load_second_params")
def load_second_params(param: dict) -> dict:
    """SECOND geometry: the voxel grid into ``model.args.grid_size``, the
    anchor grid into the postprocess args."""
    param["model"]["args"]["grid_size"] = _grid_size(param)
    _anchor_grid(param)
    return param


@register_parser("load_point_pillar_params")
def load_point_pillar_params(param: dict) -> dict:
    """PointPillar geometry: the pillar grid into
    ``model.args.point_pillar_scatter.grid_size``, the anchor grid into the
    postprocess args."""
    param["model"]["args"].setdefault("point_pillar_scatter", {})
    param["model"]["args"]["point_pillar_scatter"]["grid_size"] = \
        _grid_size(param)
    _anchor_grid(param)
    return param


# ---------------------------------------------------------------------------
# hypes -> typed configs
# ---------------------------------------------------------------------------

def corpbevt_config_from_hypes(hypes: dict) -> CorpBEVTConfig:
    """Map a corpbevt-style hypes dict (reference
    opv2v/opencood/hypes_yaml/opcamera/corpbevt.yaml) onto
    CorpBEVTConfig."""
    from cobevt_tpu_torch.models.corpbevt import CorpBEVTConfig
    from cobevt_tpu_torch.models.fax import FAXConfig

    args = hypes["model"]["args"]
    fax_a = args["fax"]
    bev = fax_a["bev_embedding"]
    cv = fax_a["cross_view"]
    cvs = fax_a["cross_view_swap"]
    sa = fax_a["self_attn"]
    enc = args["encoder"]
    # fax.yaml (the fusion-free SinBEVT config) has no fax_fusion/sttf/
    # max_cav blocks; the corpbevt defaults stand there
    fusion = args.get("fax_fusion", {})
    sttf = args.get("sttf", {})
    dec = args["decoder"]

    fax = FAXConfig(
        dim=tuple(fax_a["dim"]), middle=tuple(fax_a["middle"]),
        image_height=cv["image_height"], image_width=cv["image_width"],
        qkv_bias=cv["qkv_bias"], heads=tuple(cv["heads"]),
        dim_head=tuple(cv["dim_head"]),
        q_win_size=tuple(tuple(w) for w in cvs["q_win_size"]),
        feat_win_size=tuple(tuple(w) for w in cvs["feat_win_size"]),
        bev_embedding_flag=tuple(cvs["bev_embedding_flag"]),
        no_image_features=cv.get("no_image_features", False),
        skip=cv.get("skip", True),
        sigma=bev["sigma"], bev_height=bev["bev_height"],
        bev_width=bev["bev_width"], h_meters=bev["h_meters"],
        w_meters=bev["w_meters"], offset=bev["offset"],
        upsample_scales=tuple(bev["upsample_scales"]),
        self_attn_dim_head=sa["dim_head"],
        self_attn_dropout=sa["dropout"],
        self_attn_window=sa["window_size"])

    return CorpBEVTConfig(
        max_cav=args.get("max_cav", 1), target=args["target"],
        encoder_num_layers=enc["num_layers"],
        encoder_id_pick=tuple(enc["id_pick"]),
        encoder_remat=bool(enc.get("remat", False)),
        image_height=enc["image_height"], image_width=enc["image_width"],
        fax=fax, compression=args.get("compression", 0),
        sttf_resolution=sttf.get("resolution", 0.390625),
        sttf_downsample_rate=sttf.get("downsample_rate", 8),
        use_roi_mask=sttf.get("use_roi_mask", True),
        fusion_mlp_dim=fusion.get("mlp_dim", 256),
        fusion_window_size=fusion.get("window_size", 8),
        fusion_dim_head=fusion.get("dim_head", 32),
        fusion_dropout=fusion.get("drop_out", 0.1),
        fusion_depth=fusion.get("depth", 3),
        fusion_mask=fusion.get("mask", True),
        decoder_num_layer=dec["num_layer"],
        decoder_num_ch=tuple(dec["num_ch_dec"]),
        seg_head_dim=args["seg_head_dim"],
        output_class=args["output_class"])


def _zoo_core_methods() -> Dict[str, str]:
    """Every zoo core_method, short and long, -> its registry key."""
    from cobevt_tpu_torch.models.camera_bev_models import (
        ZOO_FUSIONS,
        zoo_core_method,
    )

    return {name: key for key in ZOO_FUSIONS
            for name in (key, zoo_core_method(key))}


def camera_bev_config_from_hypes(hypes: dict) -> CameraBEVConfig:
    """Map a cvt-variant hypes dict (reference
    opv2v/opencood/hypes_yaml/opcamera/cvt*.yaml) onto CameraBEVConfig."""
    from cobevt_tpu_torch.models.camera_bev_models import (
        ZOO_FUSIONS,
        CameraBEVConfig,
    )
    from cobevt_tpu_torch.models.cvt_dense import CVTModuleConfig

    fusion = ZOO_FUSIONS[_zoo_core_methods()[hypes["model"]["core_method"]]]
    args = hypes["model"]["args"]
    enc = args["encoder"]
    dec = args["decoder"]
    cvm_a = args["cvm"]
    bev = cvm_a["bev_embedding"]
    cv = cvm_a["cross_view"]

    cvm = CVTModuleConfig(
        dim=cvm_a["dim"], middle=tuple(cvm_a["middle"]),
        image_height=cv["image_height"], image_width=cv["image_width"],
        heads=cv["heads"], dim_head=cv["dim_head"],
        qkv_bias=cv["qkv_bias"],
        no_image_features=cv.get("no_image_features", False),
        skip=cv.get("skip", True),
        sigma=bev["sigma"], bev_height=bev["bev_height"],
        bev_width=bev["bev_width"], h_meters=bev["h_meters"],
        w_meters=bev["w_meters"], offset=bev["offset"],
        decoder_blocks=len(bev["decoder_blocks"]))

    kw = dict(
        max_cav=args.get("max_cav", 1), target=args["target"],
        encoder_num_layers=enc["num_layers"],
        encoder_id_pick=tuple(enc["id_pick"]),
        image_height=enc["image_height"], image_width=enc["image_width"],
        cvm=cvm, fusion=fusion,
        decoder_num_layer=dec["num_layer"],
        decoder_num_ch=tuple(dec["num_ch_dec"]),
        seg_head_dim=args["seg_head_dim"],
        output_class=args["output_class"])
    if "sttf" in args:
        kw.update(sttf_resolution=args["sttf"]["resolution"],
                  sttf_downsample_rate=args["sttf"]["downsample_rate"],
                  use_roi_mask=args["sttf"].get("use_roi_mask", True))
    if fusion == "att":
        bt = args["base_transformer"]
        kw.update(att_depth=bt["depth"], att_heads=bt["heads"],
                  att_dim_head=bt["dim_head"], att_mlp_dim=bt["mlp_dim"],
                  att_dropout=bt["dropout"])
    elif fusion == "swap":
        sf = args["swap_fusion"]
        kw.update(swap_mlp_dim=sf["mlp_dim"],
                  swap_window_size=sf["window_size"],
                  swap_dim_head=sf["dim_head"],
                  swap_dropout=sf["drop_out"], swap_depth=sf["depth"],
                  swap_mask=sf.get("mask", True))
    elif fusion in ("v2vnet", "disconet"):
        gf = args.get("v2vnet_fusion") or args["disconet_fusion"]
        kw.update(graph_num_iteration=gf["num_iteration"],
                  graph_gru_flag=gf.get("gru_flag", True),
                  graph_agg_operator=gf.get("agg_operator", "avg"))
    return CameraBEVConfig(**kw)


def model_config_from_hypes(hypes: dict):
    """(registry_key, typed config) for any opcamera hypes dict: the eight
    graphs of the reference ``create_model`` dispatch
    (``train_utils.py:102-135``)."""
    core = hypes["model"]["core_method"]
    if core == "corpbevt":
        return "corpbevt", corpbevt_config_from_hypes(hypes)
    if core in ("fax_fused_transformer", "fax"):
        return "fax", corpbevt_config_from_hypes(hypes)
    zoo = _zoo_core_methods()
    if core in zoo:
        return zoo[core], camera_bev_config_from_hypes(hypes)
    raise KeyError(f"unknown model core_method {core!r}")


def build_from_hypes(hypes: dict):
    """Hypes dict -> (config, the f32 module on the CPU), built through
    ``create_model``: CorpBEVT for ``corpbevt``, SinBEVT for ``fax``, a
    ``CameraBEVModel`` for the zoo."""
    from cobevt_tpu_torch.models.camera_bev_models import (
        ZOO_FUSIONS,
        create_model,
    )

    key, cfg = model_config_from_hypes(hypes)
    # the registry's builder sets a zoo graph's fusion from its key
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if not (f.name == "fusion" and key in ZOO_FUSIONS)}
    return cfg, create_model(key, **kw)
