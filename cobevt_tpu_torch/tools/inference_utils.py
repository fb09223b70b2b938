"""Inference dispatch helpers: intermediate vs late camera fusion.

Counterpart of ``cobevt_tpu/tools/inference_utils.py`` (reference
``opv2v/opencood/tools/infrence_utils.py`` :12, :46): intermediate fusion
runs the cooperative model once per frame; late fusion runs the single-agent
model (SinBEVT-OPV2V) per CAV, warps each agent's BEV probabilities into the
ego frame with its cav->ego transform and max-merges them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cobevt_tpu_torch.geometry.warp import sttf_warp
from cobevt_tpu_torch.train.loop import batch_to_device


def inference_intermediate_fusion(eval_step, state, batch):
    """One cooperative forward; returns the output dict."""
    out, _ = eval_step(state, batch)
    return out


def inference_late_fusion(eval_step, state, per_cav_samples: Dict,
                          sttf_resolution: float,
                          sttf_downsample_rate: float):
    """Run the single-agent model per CAV and fuse predictions in ego
    space.

    per_cav_samples: {cav_id: sample} from
    ``OPV2VLateFusionDataset.test_samples``.  Returns the fused output dict
    (probabilities max-merged over agents, on the model's device) plus the
    ego GT (numpy)."""
    device = next(state.model.parameters()).device
    fused = {}
    ego = list(per_cav_samples.values())[0]
    for sample in per_cav_samples.values():
        batch = batch_to_device(
            {k: np.stack([v]) for k, v in sample.items()}, device)
        out, _ = eval_step(state, batch)
        tmat = batch["transformation_matrix"]          # (1, 1, 4, 4)
        for key in ("dynamic_seg", "static_seg"):
            prob = torch.softmax(out[key].float(), dim=-1)
            warped = sttf_warp(prob, tmat, sttf_resolution,
                               sttf_downsample_rate)
            fused[key] = (warped if key not in fused
                          else torch.maximum(fused[key], warped))
    result = dict(fused)
    result["gt_dynamic"] = ego["gt_dynamic"][None]
    result["gt_static"] = ego["gt_static"][None]
    return result
