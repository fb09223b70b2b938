"""Serving helpers: agent-count bucketing.

Counterpart of ``cobevt_tpu/utils/serving.py``.  At inference most
cooperative frames carry fewer agents than the ``max_cav`` pad, so the
runners compute on the live agents only.  PyTorch runs eagerly, so no
bucket needs a compile of its own.

* ``BucketedRunner`` slices every per-agent entry to the live agents and
  runs the whole graph on them.  The reference's fusion heads average over
  ``max_cav`` rows, and padded rows are not zero after masked attention,
  so this equals the padded forward only where the fusion runs over the
  valid agents (``fusion_mean_over_valid``, or graphs that mask their
  padding away); ``tools/serve_camera.py`` takes it for every graph without
  CorpBEVT's ``stage=`` contract, as the JAX tool does.
* ``StagedBucketedRunner`` (CorpBEVT) runs the per-agent stages (encoder ->
  FAX -> compressor, most of the FLOPs) on the live agents, zero-pads their
  BEV maps back to ``max_cav`` and runs the cooperative tail (warp -> mask
  -> fusion -> decoder -> head) at full width with the padded transforms
  and mask: the fusion input is that of a full padded forward, so the
  output is exact for any fusion-mean semantics.

Given a ("data", "model") ``mesh`` (``parallel/mesh.py``; the JAX runners'
``data_sharding``), every rank is handed the whole batch, serves its rows
over "data" on its whole model, and the outputs are gathered over "data":
each rank returns the whole batch's, as the JAX runner returns one global
array.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from cobevt_tpu_torch.parallel.mesh import (
    batch_sharding,
    gather_plain,
    local_part,
    mesh_axis,
)

# agent axis of every per-agent entry of a batch; ``pairwise_t_matrix``
# (B, L, L, 4, 4) is sliced on the next axis too
BATCH_AGENT_AXES = {
    "inputs": 1, "intrinsic": 1, "extrinsic": 1,
    "transformation_matrix": 1, "pairwise_t_matrix": 1, "agent_mask": 1,
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
        if axis is not None:
            value = np.take(value, np.arange(n), axis=axis)
            if key == "pairwise_t_matrix":
                value = np.take(value, np.arange(n), axis=axis + 1)
        out[key] = value
    return out


def save_prediction(out_dir: str, i: int, n: int, out: dict) -> None:
    """Frame ``i``'s argmax map (``dynamic_seg`` where present) as
    ``frame_{i:06d}.npz`` with its live-agent count ``n`` (the format of the
    JAX package's ``serve_camera --out_dir``)."""
    key = "dynamic_seg" if "dynamic_seg" in out else sorted(out)[0]
    seg = out[key].argmax(-1).cpu().numpy()
    np.savez_compressed(os.path.join(out_dir, f"frame_{i:06d}.npz"),
                        seg=seg.astype(np.uint8), n_agents=n)


class BucketedRunner:
    """Runs a frame on its live agents alone: every per-agent entry sliced
    to the fullest sample's live count, then the whole graph.  Takes host
    (numpy) batches, returns the model's output dict on the model's device
    without waiting for it (with a ``mesh``: after the gather)."""

    def __init__(self, model: torch.nn.Module, mesh=None):
        self.model = model.eval()
        self.device = model_device(model)
        self.mesh = mesh

    def _rows(self, batch: dict) -> dict:
        """This rank's rows over "data" of a host batch (all without a
        mesh)."""
        if self.mesh is None:
            return batch
        return {k: local_part(v, self.mesh, batch_sharding(self.mesh))
                for k, v in batch.items()}

    def _whole(self, out: dict) -> dict:
        """The outputs of every "data" rank, in batch order."""
        if self.mesh is None:
            return out
        axis = mesh_axis(self.mesh, "data")
        return {k: gather_plain(v.contiguous(), 0, axis)
                for k, v in out.items()}

    @torch.inference_mode()
    def __call__(self, batch: dict) -> dict:
        batch = slice_agents(batch, live_agents(batch))
        return self._whole(self.model(to_device(self._rows(batch),
                                                self.device)))


class StagedBucketedRunner(BucketedRunner):
    """Runs a CorpBEVT frame as encode on the live agents, zero-pad to
    ``max_cav``, fuse."""

    def __init__(self, model: torch.nn.Module, max_cav: int, mesh=None):
        super().__init__(model, mesh)
        self.max_cav = max_cav

    @torch.inference_mode()
    def __call__(self, batch: dict) -> dict:
        n = live_agents(batch)
        rows = self._rows(batch)
        agent_bev = self.model(
            to_device(slice_agents(rows, n), self.device), stage="encode")
        pad = self.max_cav - n
        if pad:
            agent_bev = F.pad(agent_bev, (0, 0, 0, 0, 0, 0, 0, pad))
        fuse_batch = to_device(
            {k: rows[k] for k in ("transformation_matrix", "agent_mask")},
            self.device)
        return self._whole(self.model(fuse_batch, stage="fuse",
                                      agent_bev=agent_bev))


class FullRunner:
    """The full padded forward (no bucketing)."""

    def __init__(self, model: torch.nn.Module):
        self.model = model.eval()
        self.device = model_device(model)

    @torch.inference_mode()
    def __call__(self, batch: dict) -> dict:
        return self.model(to_device(batch, self.device))
