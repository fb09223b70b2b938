"""Serving helpers: exact agent-count bucketing for CorpBEVT.

Counterpart of ``cobevt_tpu/utils/serving.py:StagedBucketedRunner``.  At
inference most cooperative frames carry fewer agents than the ``max_cav``
pad, so the per-agent stages (encoder -> FAX -> compressor, most of the
FLOPs) run on the live agents only; their BEV maps are zero-padded back to
``max_cav`` and the cooperative tail (warp -> mask -> fusion -> decoder ->
head) runs at full width with the padded transforms and mask.  The fusion
input is then the same as in a full padded forward, so the output is exact
for any fusion-mean semantics, the reference's mean over ``max_cav``
included.  PyTorch runs eagerly, so no per-bucket compile is needed.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# agent axis of every per-agent entry of a batch
BATCH_AGENT_AXES = {
    "inputs": 1, "intrinsic": 1, "extrinsic": 1,
    "transformation_matrix": 1, "agent_mask": 1,
}


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: dict, device) -> dict:
    """numpy batch -> dict of tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def live_agents(batch: dict) -> int:
    """Live agents of the fullest sample of a host-side batch (at least 1)."""
    return max(int(np.asarray(batch["agent_mask"]).sum(axis=-1).max()), 1)


def slice_agents(batch: dict, n: int) -> dict:
    """The first ``n`` agents of every per-agent entry (host side)."""
    out = {}
    for key, value in batch.items():
        axis = BATCH_AGENT_AXES.get(key)
        value = np.asarray(value)
        out[key] = value if axis is None else np.take(value, np.arange(n),
                                                      axis=axis)
    return out


def save_prediction(out_dir: str, i: int, n: int, out: dict) -> None:
    """Frame ``i``'s argmax map (``dynamic_seg`` where present) as
    ``frame_{i:06d}.npz`` with its live-agent count ``n`` (the format of the
    JAX package's ``serve_camera --out_dir``)."""
    key = "dynamic_seg" if "dynamic_seg" in out else sorted(out)[0]
    seg = out[key].argmax(-1).cpu().numpy()
    np.savez_compressed(os.path.join(out_dir, f"frame_{i:06d}.npz"),
                        seg=seg.astype(np.uint8), n_agents=n)


class StagedBucketedRunner:
    """Runs a CorpBEVT frame as encode on the live agents, zero-pad to
    ``max_cav``, fuse.  Takes host (numpy) batches, returns the model's
    output dict on the model's device without waiting for it."""

    def __init__(self, model: torch.nn.Module, max_cav: int):
        self.model = model.eval()
        self.max_cav = max_cav
        self.device = model_device(model)

    @torch.inference_mode()
    def __call__(self, batch: dict) -> dict:
        n = live_agents(batch)
        agent_bev = self.model(
            to_device(slice_agents(batch, n), self.device), stage="encode")
        pad = self.max_cav - n
        if pad:
            agent_bev = F.pad(agent_bev, (0, 0, 0, 0, 0, 0, 0, pad))
        fuse_batch = to_device(
            {k: batch[k] for k in ("transformation_matrix", "agent_mask")},
            self.device)
        return self.model(fuse_batch, stage="fuse", agent_bev=agent_bev)


class FullRunner:
    """The full padded forward (no bucketing)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model.eval()
        self.device = model_device(model)

    @torch.inference_mode()
    def __call__(self, batch: dict) -> dict:
        return self.model(to_device(batch, self.device))
