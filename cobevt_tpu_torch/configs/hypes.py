"""YAML "hypes" configuration loading, compatible with the reference's
config files.

Counterpart of ``cobevt_tpu/configs/hypes.py`` for the OPV2V camera track:

  * the scientific-notation float resolver (reference
    ``yaml_utils.py:29-38``);
  * derived-geometry post hooks as a registry, not ``eval``;
  * the checkpoint dir's ``config.yaml`` taking priority on resume;
  * ``load_bev_params``, and hypes -> the port's typed model configs for
    ``corpbevt`` and ``fax`` (SinBEVT-OPV2V).

PyYAML is optional.  JSON is YAML, so where ``yaml`` cannot be imported a
hypes file or a per-timestamp file is read as JSON, and
:func:`save_config_snapshot` writes JSON text into ``config.yaml`` (still a
valid YAML file for the JAX package and the reference).  A file that is not
JSON, read where ``yaml`` is missing, raises an error naming PyYAML.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Optional

from cobevt_tpu_torch.models.corpbevt import CorpBEVTConfig
from cobevt_tpu_torch.models.fax import FAXConfig

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


# ---------------------------------------------------------------------------
# hypes -> typed configs
# ---------------------------------------------------------------------------

def corpbevt_config_from_hypes(hypes: dict) -> CorpBEVTConfig:
    """Map a corpbevt-style hypes dict (reference
    opv2v/opencood/hypes_yaml/opcamera/corpbevt.yaml) onto
    CorpBEVTConfig."""
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


# the camera zoo's core methods (the JAX ``_CORE_METHOD_TO_FUSION``): their
# graphs are not ported yet
ZOO_CORE_METHODS = (
    "cross_view_transformer", "cvt",
    "cross_view_transformer_att_fuse", "cvt_att_fuse",
    "cross_view_transformer_swap_fuse", "cvt_swap_fuse",
    "cross_view_transformer_fcooper", "cvt_fcooper",
    "cross_view_transformer_v2vnet", "cvt_v2vnet",
    "cross_view_transformer_disconet", "cvt_disconet",
)


def model_config_from_hypes(hypes: dict):
    """(registry_key, typed config) for an opcamera hypes dict: the
    ``corpbevt`` and ``fax`` graphs of the reference ``create_model``
    dispatch (``train_utils.py:102-135``)."""
    core = hypes["model"]["core_method"]
    if core == "corpbevt":
        return "corpbevt", corpbevt_config_from_hypes(hypes)
    if core in ("fax_fused_transformer", "fax"):
        return "fax", corpbevt_config_from_hypes(hypes)
    if core in ZOO_CORE_METHODS:
        raise NotImplementedError(
            f"core_method {core!r} is a graph of the camera model zoo, which "
            "the port does not have yet (ROADMAP item 14)")
    raise KeyError(f"unknown model core_method {core!r}")


def build_from_hypes(hypes: dict):
    """Hypes dict -> (config, the f32 module on the CPU): CorpBEVT for
    ``corpbevt``, SinBEVT for ``fax``."""
    from cobevt_tpu_torch.models.corpbevt import CorpBEVT, SinBEVT

    key, cfg = model_config_from_hypes(hypes)
    return cfg, (CorpBEVT(cfg) if key == "corpbevt" else SinBEVT(cfg))
