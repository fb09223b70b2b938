"""Visualization utilities: colorized BEV panels and training dumps.

Counterpart of ``cobevt_tpu/utils/visualization.py``: the per-epoch BEV
segmentation dumps (reference ``train_utils.py:275``
``save_bev_seg_binary``), inference panels (``infrence_utils.py:107``) and
colorized GT/prediction maps.  Panels are numpy on the host; images are
written through ``data/image_io.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from cobevt_tpu_torch.data.image_io import imwrite

# class color tables (BGR uint8): background, road, lane / vehicle
STATIC_COLORS = np.array([[255, 255, 255],
                          [110, 110, 110],
                          [0, 0, 255]], np.uint8)
DYNAMIC_COLORS = np.array([[255, 255, 255],
                           [0, 200, 0]], np.uint8)


def colorize_map(class_map: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """(H, W) int class map -> (H, W, 3) uint8."""
    return colors[np.clip(class_map.astype(np.int64), 0,
                          len(colors) - 1)]


def seg_panel(output: Dict, batch: Dict, index: int = 0) -> np.ndarray:
    """Side-by-side GT | prediction panel for one sample (numpy dicts)."""
    panels = []
    if "gt_dynamic" in batch:
        gt = np.asarray(batch["gt_dynamic"])[index, 0]
        pred = np.asarray(output["dynamic_seg"])[index, 0].argmax(-1)
        panels.append(np.concatenate(
            [colorize_map(gt, DYNAMIC_COLORS),
             colorize_map(pred, DYNAMIC_COLORS)], axis=1))
    if "gt_static" in batch and "static_seg" in output:
        gt = np.asarray(batch["gt_static"])[index, 0]
        pred = np.asarray(output["static_seg"])[index, 0].argmax(-1)
        panels.append(np.concatenate(
            [colorize_map(gt, STATIC_COLORS),
             colorize_map(pred, STATIC_COLORS)], axis=1))
    return np.concatenate(panels, axis=0) if panels else np.zeros(
        (2, 2, 3), np.uint8)


def save_image(path: str, image: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imwrite(path, np.ascontiguousarray(image))


def save_prediction_panels(state, loader, out_dir: str,
                           max_samples: Optional[int] = 20):
    """Dump GT|prediction panels for up to ``max_samples`` batches of the
    state's compute model."""
    from cobevt_tpu_torch.train.loop import _to_numpy, batch_to_device
    from cobevt_tpu_torch.train.step import make_eval_step

    eval_step = make_eval_step(state.model)
    device = next(state.model.parameters()).device
    for i, batch in enumerate(loader):
        if max_samples is not None and i >= max_samples:
            break
        batch = batch_to_device(batch, device)
        out, _ = eval_step(state, batch)
        panel = seg_panel(_to_numpy(out), _to_numpy(batch))
        save_image(os.path.join(out_dir, f"panel_{i:05d}.png"), panel)
