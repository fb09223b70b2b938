"""nuScenes BEV label generation: the rasterization core and the writer.

Counterpart of ``cobevt_tpu/data/nuscenes_labelgen.py`` (reference
``nuscenes/cross_view_transformer/data/nuscenes_dataset.py``): polygons and
box footprints filled into the 200 x 200 BEV grid, the per-object
centerness and visibility targets, and :func:`save_scene_labels`, which
writes one scene in the layout ``data/nuscenes_gen.py`` reads (the
reference's ``SaveDataTransform``, ``data/transforms.py:46-97``).

The fills are OpenCV's ``fillPoly`` / ``polylines`` and raise where cv2 is
not installed.  The writer needs neither cv2 nor PIL: the bit-packed
``bev`` map (a 16-bit grayscale PNG, as PIL writes an int32 image) and the
8-bit ``visibility`` map go through ``data/image_io.py``'s codec.  The
nuScenes devkit walk (the JAX package's ``DevkitAdapter``) is not here: it
needs the devkit and ``pyquaternion``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Sequence

import numpy as np

from cobevt_tpu_torch.data.image_io import write_png
from cobevt_tpu_torch.data.labels import encode_binary_maps

try:
    import cv2
except ImportError:
    cv2 = None


def _cv2():
    if cv2 is None:
        raise RuntimeError("the BEV rasterizers fill polygons with OpenCV "
                           "(cv2), which is not installed")
    return cv2


def rasterize_polygons(polygons: Sequence[np.ndarray], view: np.ndarray,
                       hw=(200, 200), thickness: int = -1) -> np.ndarray:
    """Fill (or draw, ``thickness`` > 0) ego-frame polygons into a BEV mask.
    ``polygons``: (P, 2) ego-frame xy vertices each; ``view``: the 3 x 3
    ego-metres -> BEV-pixels matrix."""
    cv = _cv2()
    canvas = np.zeros(hw, np.uint8)
    for poly in polygons:
        pts = np.concatenate([poly, np.ones((len(poly), 1))], axis=1)
        pix = np.round((view @ pts.T).T[:, :2]).astype(np.int32)
        if thickness < 0:
            cv.fillPoly(canvas, [pix], 255)
        else:
            cv.polylines(canvas, [pix], False, 255, thickness)
    return canvas


def project_box_footprints(corners_world: np.ndarray, view: np.ndarray,
                           world_to_ego: np.ndarray) -> np.ndarray:
    """(N, 4, 3) world bottom corners -> (N, 4, 2) BEV pixel polygons (the
    reference's ``V @ S @ M_inv`` chain, ``nuscenes_dataset.py:245-269``)."""
    N = corners_world.shape[0]
    hom = np.concatenate([corners_world, np.ones((N, 4, 1))], axis=-1)
    ego = np.einsum("ij,nkj->nki", world_to_ego, hom)[..., :3]
    pts = np.concatenate([ego[..., :2], np.ones((N, 4, 1))], axis=-1)
    return np.einsum("ij,nkj->nki", view, pts)[..., :2]


def render_dynamic_layers(footprints_pix: np.ndarray, hw=(200, 200)):
    """(N, 4, 2) BEV pixel footprints -> binary vehicle mask."""
    cv = _cv2()
    canvas = np.zeros(hw, np.uint8)
    for quad in np.round(footprints_pix).astype(np.int32):
        cv.fillPoly(canvas, [quad], 255)
    return canvas


def render_center_offset(footprints_pix: np.ndarray, hw=(200, 200),
                         sigma: float = 4.0):
    """Per-object aux targets: channel 0 the offset magnitude (zeros, as in
    the JAX package), channel 1 the Gaussian centerness the center head
    trains on (reference ``:199-243``)."""
    H, W = hw
    center = np.zeros(hw, np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for quad in footprints_pix:
        cx, cy = quad.mean(axis=0)
        if not (0 <= cx < W and 0 <= cy < H):
            continue
        g = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma ** 2))
        center = np.maximum(center, g.astype(np.float32))
    return np.stack([np.zeros(hw, np.float32), center], axis=-1)


def render_visibility(footprints_pix: np.ndarray,
                      visibility_tokens: Sequence[int],
                      hw=(200, 200)) -> np.ndarray:
    """Per-pixel visibility levels, 255 on the background (reference
    ``:218-231``)."""
    cv = _cv2()
    canvas = np.full(hw, 255, np.uint8)
    for quad, vis in zip(np.round(footprints_pix).astype(np.int32),
                         visibility_tokens):
        cv.fillPoly(canvas, [quad], int(vis))
    return canvas


def save_scene_labels(scene_name: str, samples: Iterable[Dict],
                      labels_dir: str) -> str:
    """Write one scene: per sample a bit-packed ``bev_<token>.png``, and
    where given ``aux_<token>.npz`` and ``visibility_<token>.png``, then the
    JSON index ``<labels_dir>/<scene_name>.json``; returns its path.

    Each sample holds token, images, intrinsics, extrinsics, view, pose
    (identity where absent), bev (H, W, C) uint8 {0, 255}, and optionally
    aux (H, W, 2) float and visibility (H, W) uint8."""
    scene_dir = Path(labels_dir) / scene_name
    scene_dir.mkdir(parents=True, exist_ok=True)
    index = []
    for s in samples:
        rec = {"scene": scene_name, "token": s["token"],
               "images": s["images"], "intrinsics": s["intrinsics"],
               "extrinsics": s["extrinsics"], "view": s["view"],
               "pose": s.get("pose", np.eye(4).tolist())}
        packed = encode_binary_maps(np.asarray(s["bev"], np.uint8))
        if packed.max(initial=0) >= 1 << 16:
            raise ValueError(f"{s['token']}: more than 16 BEV classes do "
                             f"not fit a 16-bit label PNG")
        rec["bev"] = f"bev_{s['token']}.png"
        write_png(str(scene_dir / rec["bev"]), packed.astype(np.uint16))
        if "aux" in s:
            rec["aux"] = f"aux_{s['token']}.npz"
            np.savez_compressed(scene_dir / rec["aux"],
                                aux=np.asarray(s["aux"], np.float32))
        if "visibility" in s:
            rec["visibility"] = f"visibility_{s['token']}.png"
            write_png(str(scene_dir / rec["visibility"]),
                      np.asarray(s["visibility"], np.uint8))
        index.append(rec)
    out = Path(labels_dir) / f"{scene_name}.json"
    with open(out, "w") as f:
        json.dump(index, f)
    return str(out)
