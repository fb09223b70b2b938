"""nuScenes experiment presets (the reference's Hydra composition).

Counterpart of ``cobevt_tpu/configs/nuscenes_experiments.py``: each
experiment is one frozen dataclass bundling encoder, output slices, loss
composition, label grouping and trainer hyperparameters
(``config/experiment/*.yaml``); :func:`experiment_to_dict` exports it in the
reference's flattened schema, and :func:`build_criterion` composes its
loss.  The encoder is the pyramid-axial FAX (``PyramidAxialConfig``) or,
in the ``cvt_nuscenes_vehicle`` ablation, the dense CVT
(``CVTNuScenesConfig``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from cobevt_tpu_torch.losses import (
    BinarySegmentationLoss,
    CenterLoss,
    MultipleLoss,
)
from cobevt_tpu_torch.models.cvt_nuscenes import CVTNuScenesConfig
from cobevt_tpu_torch.models.sinbevt_nuscenes import (
    CrossViewTransformer,
    PyramidAxialConfig,
)

# label groupings of config/data/nuscenes_vehicle.yaml / nuscenes_road.yaml
VEHICLE_LABELS: Tuple[Tuple[int, ...], ...] = ((4, 5, 6, 7, 8, 10, 11),)
ROAD_LABELS: Tuple[Tuple[int, ...], ...] = ((0, 1),)


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """One entry of the loss config group (``config/loss/*.yaml``): a focal
    seg loss or a centerness loss with its weight."""

    kind: str                  # "binary_seg" | "center"
    weight: float = 1.0
    gamma: float = 2.0
    alpha: float = -1.0
    min_visibility: Optional[int] = None
    use_label_indices: bool = True


@dataclasses.dataclass(frozen=True)
class NuScenesExperiment:
    """A composed nuScenes experiment (model + data + loss + trainer), one
    ``config/experiment/*.yaml``."""

    name: str
    encoder: Any = PyramidAxialConfig()
    decoder_blocks: Tuple[int, ...] = (128, 128, 64)
    dim_last: int = 64
    outputs: Tuple[Tuple[str, Tuple[int, int]], ...] = (("bev", (0, 1)),)
    losses: Tuple[Tuple[str, LossSpec], ...] = (
        ("focal", LossSpec("binary_seg")),)
    label_indices: Tuple[Tuple[int, ...], ...] = VEHICLE_LABELS
    # trainer block (config/config.yaml:20-54)
    lr: float = 5e-3
    weight_decay: float = 1e-7
    grad_clip: float = 5.0
    steps: int = 50001
    batch_size: int = 8
    checkpoint_interval: int = 1000
    seed: int = 2022
    min_visibility_metric: int = 2


def _pyramid_axial_vehicle() -> NuScenesExperiment:
    """``cvt_pyramid_axial_nuscenes_vehicle.yaml``, the SinBEVT flagship:
    bev + center outputs, visibility-masked focal + 0.1 * center loss."""
    return NuScenesExperiment(
        name="cvt_pyramid_axial_nuscenes_vehicle",
        encoder=PyramidAxialConfig(),
        outputs=(("bev", (0, 1)), ("center", (1, 2))),
        losses=(
            ("visible", LossSpec("binary_seg", weight=1.0,
                                 min_visibility=2)),
            ("center", LossSpec("center", weight=0.1, min_visibility=2,
                                use_label_indices=False)),
        ),
        label_indices=VEHICLE_LABELS)


def _cvt_vehicle() -> NuScenesExperiment:
    """The dense-CVT ablation of the flagship: model group ``cvt``
    (``config/model/cvt.yaml``, bev output only), data nuscenes_vehicle and
    default_loss (unmasked focal, ``config/loss/default_loss.yaml``)."""
    return NuScenesExperiment(
        name="cvt_nuscenes_vehicle",
        encoder=CVTNuScenesConfig(),
        outputs=(("bev", (0, 1)),),
        losses=(("focal", LossSpec("binary_seg", weight=1.0)),),
        label_indices=VEHICLE_LABELS)


def _pyramid_axial_road() -> NuScenesExperiment:
    """Pyramid-axial on the static road task: bev output, unmasked focal."""
    return dataclasses.replace(
        _pyramid_axial_vehicle(),
        name="cvt_pyramid_axial_nuscenes_road",
        outputs=(("bev", (0, 1)),),
        losses=(("focal", LossSpec("binary_seg", weight=1.0)),),
        label_indices=ROAD_LABELS)


_EXPERIMENTS = {
    "cvt_pyramid_axial_nuscenes_vehicle": _pyramid_axial_vehicle,
    "cvt_nuscenes_vehicle": _cvt_vehicle,
    "cvt_pyramid_axial_nuscenes_road": _pyramid_axial_road,
}


def all_nuscenes_experiments():
    """name -> zero-argument constructor of every nuScenes experiment."""
    return dict(_EXPERIMENTS)


def nuscenes_experiment(name: str) -> NuScenesExperiment:
    try:
        return _EXPERIMENTS[name]()
    except KeyError:
        raise KeyError(
            f"unknown nuScenes experiment {name!r}; available: "
            f"{sorted(_EXPERIMENTS)}") from None


def build_model(exp: NuScenesExperiment, half: bool = False):
    """The CrossViewTransformer of an experiment, in bf16 with ``half``."""
    model = CrossViewTransformer(
        exp.encoder, decoder_blocks=exp.decoder_blocks,
        dim_last=exp.dim_last, outputs=exp.outputs)
    return model.to(torch.bfloat16) if half else model


def build_criterion(exp: NuScenesExperiment) -> MultipleLoss:
    """The experiment's ``MultipleLoss`` (reference ``common.py:31``): the
    vehicle preset's visibility-masked focal loss on ``bev`` (labels folded
    by ``label_indices``) plus 0.1 x the masked center loss, the road
    preset's unmasked focal loss."""
    losses, weights = [], []
    for name, spec in exp.losses:
        if spec.kind == "binary_seg":
            fn = BinarySegmentationLoss(
                label_indices=(exp.label_indices
                               if spec.use_label_indices else None),
                min_visibility=spec.min_visibility,
                alpha=spec.alpha, gamma=spec.gamma)
        elif spec.kind == "center":
            fn = CenterLoss(min_visibility=spec.min_visibility,
                            alpha=spec.alpha, gamma=spec.gamma)
        else:
            raise ValueError(f"unknown loss kind {spec.kind!r}")
        losses.append((name, fn))
        weights.append((name, spec.weight))
    return MultipleLoss(losses=tuple(losses), weights=tuple(weights))


def experiment_to_dict(exp: NuScenesExperiment) -> dict:
    """Flattened reference-schema export of the composed experiment."""
    enc = exp.encoder
    if isinstance(enc, PyramidAxialConfig):
        model = {
            "_target_": "cvt_pyramid_axial",
            "dim": list(enc.dim), "middle": list(enc.middle),
            "scale": enc.scale,
            "backbone": {"model_name": enc.backbone_model,
                         "layer_names": list(enc.backbone_layers),
                         "image_height": enc.image_height,
                         "image_width": enc.image_width},
            "cross_view": {"heads": list(enc.heads),
                           "dim_head": list(enc.dim_head),
                           "qkv_bias": enc.qkv_bias,
                           "skip": enc.skip,
                           "no_image_features": enc.no_image_features},
            "cross_view_swap": {
                "q_win_size": [list(w) for w in enc.q_win_size],
                "feat_win_size": [list(w) for w in enc.feat_win_size],
                "bev_embedding_flag": list(enc.bev_embedding_flag)},
            "bev_embedding": {
                "sigma": enc.sigma, "bev_height": enc.bev_height,
                "bev_width": enc.bev_width, "h_meters": enc.h_meters,
                "w_meters": enc.w_meters, "offset": enc.offset,
                "upsample_scales": list(enc.upsample_scales)},
        }
    else:
        model = {
            "_target_": "cvt",
            "dim": enc.dim, "middle": list(enc.middle),
            "backbone": {"model_name": enc.backbone_model,
                         "layer_names": list(enc.backbone_layers),
                         "image_height": enc.image_height,
                         "image_width": enc.image_width},
            "cross_view": {"heads": enc.heads, "dim_head": enc.dim_head,
                           "qkv_bias": enc.qkv_bias, "skip": enc.skip,
                           "no_image_features": enc.no_image_features},
            "bev_embedding": {
                "sigma": enc.sigma, "bev_height": enc.bev_height,
                "bev_width": enc.bev_width, "h_meters": enc.h_meters,
                "w_meters": enc.w_meters, "offset": enc.offset},
        }
    model["decoder"] = {"blocks": list(exp.decoder_blocks),
                        "residual": True, "factor": 2}
    model["dim_last"] = exp.dim_last
    model["outputs"] = {k: list(v) for k, v in exp.outputs}
    return {
        "experiment": {"name": exp.name, "seed": exp.seed,
                       "checkpoint_interval": exp.checkpoint_interval},
        "model": model,
        "data": {"label_indices": [list(g) for g in exp.label_indices],
                 "image": {"h": enc.image_height, "w": enc.image_width},
                 "bev": {"h": enc.bev_height, "w": enc.bev_width,
                         "h_meters": enc.h_meters,
                         "w_meters": enc.w_meters,
                         "offset": enc.offset}},
        "loss": {name: {"kind": spec.kind, "weight": spec.weight,
                        "gamma": spec.gamma, "alpha": spec.alpha,
                        "min_visibility": spec.min_visibility}
                 for name, spec in exp.losses},
        "optimizer": {"lr": exp.lr, "weight_decay": exp.weight_decay},
        "trainer": {"max_steps": exp.steps,
                    "gradient_clip_val": exp.grad_clip,
                    "batch_size": exp.batch_size},
    }
