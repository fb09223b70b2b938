"""3D LiDAR visualization: point clouds and oriented boxes, frames and
sequences.

Counterpart of ``cobevt_tpu/utils/lidar_viz.py`` (reference
``visualization/vis_utils.py``: ``bbx2linset`` :18, ``bbx2oabb`` :68,
``color_encoding`` :195, single frames :244/:501, sequences :315/:553,
``visualize_bev`` :635).  The geometry (box edges, colors) is numpy; it is
drawn with matplotlib (headless: PNG frames, a BEV grid) or with open3d
where that is installed, and ``export_html`` writes a self-contained
interactive viewer.  Host only: no device is used.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from cobevt_tpu_torch.geometry.boxes import (
    boxes_to_corners_3d,
    project_points,
)

try:                                    # pragma: no cover - optional dep
    import open3d as o3d
    HAVE_OPEN3D = True
except Exception:                       # pragma: no cover
    o3d = None
    HAVE_OPEN3D = False

# the 12 edges of a box, indexing the boxes_to_corners_3d corner order
BOX_EDGES = np.array([[0, 1], [1, 2], [2, 3], [0, 3],
                      [4, 5], [5, 6], [6, 7], [4, 7],
                      [0, 4], [1, 5], [2, 6], [3, 7]])

PRED_COLOR = (1.0, 0.0, 0.0)
GT_COLOR = (0.0, 1.0, 0.0)


def _as_corners(boxes, order: str) -> np.ndarray:
    boxes = np.asarray(boxes)
    if boxes.size == 0:
        return np.zeros((0, 8, 3), np.float32)
    if boxes.ndim == 2 and boxes.shape[-1] == 7:
        return np.asarray(boxes_to_corners_3d(boxes, order))
    return boxes.reshape(-1, 8, 3)


def box_edge_segments(boxes, order: str = "hwl") -> np.ndarray:
    """(n, 7) center boxes or (n, 8, 3) corners -> (n, 12, 2, 3) line
    segments (reference bbx2linset geometry, backend-free)."""
    corners = _as_corners(boxes, order)
    return corners[:, BOX_EDGES]                  # (n, 12, 2, 3)


def color_encoding(intensity, mode: str = "intensity") -> np.ndarray:
    """(n,) scalar -> (n, 3) rgb in [0,1] (reference vis_utils.py:195:
    'intensity' log-viridis, 'z-value' jet over [-1.5, 0.5],
    'constant' warm white)."""
    import matplotlib.cm as cm
    import matplotlib.colors as mcolors

    intensity = np.asarray(intensity, np.float64)
    if mode not in ("intensity", "z-value", "constant"):
        raise ValueError(f"color mode {mode!r}")
    if mode == "intensity":
        import matplotlib
        viridis = matplotlib.colormaps["viridis"](
            np.linspace(0, 1, 256))[:, :3]
        vid_range = np.linspace(0, 1, 256)
        col = 1.0 - np.log(np.maximum(intensity, 1e-6)) / \
            np.log(np.exp(-0.004 * 100))
        return np.c_[np.interp(col, vid_range, viridis[:, 0]),
                     np.interp(col, vid_range, viridis[:, 1]),
                     np.interp(col, vid_range, viridis[:, 2])]
    if mode == "z-value":
        norm = mcolors.Normalize(vmin=-1.5, vmax=0.5)
        colors = cm.ScalarMappable(norm=norm, cmap=cm.jet).to_rgba(
            intensity)
        colors[:, [2, 1, 0, 3]] = colors[:, [0, 1, 2, 3]]
        return colors[:, :3]
    out = np.ones((intensity.shape[0], 3))
    out[:, 0] *= 247 / 255
    out[:, 1] *= 244 / 255
    out[:, 2] *= 237 / 255
    return out


# ---------------------------------------------------------------------------
# open3d builders (parity with bbx2linset / bbx2oabb / bbx2aabb)
# ---------------------------------------------------------------------------

def bbx2linset(boxes, order: str = "hwl", color=GT_COLOR):
    """List of o3d.geometry.LineSet (reference vis_utils.py:18; flips x
    for open3d's right-handed frame)."""
    assert HAVE_OPEN3D, "open3d not installed"
    corners = _as_corners(boxes, order).copy()
    corners[..., 0] = -corners[..., 0]
    linesets = []
    for bbx in corners:
        ls = o3d.geometry.LineSet()
        ls.points = o3d.utility.Vector3dVector(bbx)
        ls.lines = o3d.utility.Vector2iVector(BOX_EDGES)
        ls.colors = o3d.utility.Vector3dVector(
            [list(color)] * len(BOX_EDGES))
        linesets.append(ls)
    return linesets


def bbx2oabb(boxes, order: str = "hwl", color=(0, 0, 1)):
    """List of o3d oriented bounding boxes (reference vis_utils.py:68)."""
    assert HAVE_OPEN3D, "open3d not installed"
    corners = _as_corners(boxes, order).copy()
    corners[..., 0] = -corners[..., 0]
    oabbs = []
    for bbx in corners:
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(bbx)
        oabb = pcd.get_oriented_bounding_box()
        oabb.color = color
        oabbs.append(oabb)
    return oabbs


def pointcloud_to_o3d(pcd_np, mode: str = "intensity"):
    """(n, 4) xyz+intensity -> colored o3d point cloud (flips x)."""
    assert HAVE_OPEN3D, "open3d not installed"
    pts = np.asarray(pcd_np)[:, :3].copy()
    pts[:, 0] = -pts[:, 0]
    cloud = o3d.geometry.PointCloud()
    cloud.points = o3d.utility.Vector3dVector(pts)
    intensity = (np.asarray(pcd_np)[:, 3] if pcd_np.shape[1] > 3
                 else pts[:, 2])
    cloud.colors = o3d.utility.Vector3dVector(
        color_encoding(intensity if mode == "intensity" else pts[:, 2],
                       mode=mode))
    return cloud


# ---------------------------------------------------------------------------
# headless rendering (matplotlib)
# ---------------------------------------------------------------------------

def visualize_frame(pcd, pred_boxes=None, gt_boxes=None,
                    order: str = "hwl", mode: str = "constant",
                    save_path: Optional[str] = None, view: str = "3d",
                    transformation=None, point_size: float = 0.3):
    """Render one frame: point cloud + red pred / green GT boxes.

    Parity with visualize_single_sample_output_gt (vis_utils.py:244) and
    visualize_inference_sample_dataloader (:501 — pass
    ``transformation`` to project the cloud into the ego frame first).
    ``view``: '3d' (matplotlib 3D axes) or 'bev' (top-down scatter,
    reference visualize_single_sample_output_bev :365).
    Returns the matplotlib figure; writes ``save_path`` if given."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pcd = np.asarray(pcd)
    if transformation is not None:
        pcd = np.concatenate(
            [np.asarray(project_points(pcd[:, :3], transformation)),
             pcd[:, 3:]], axis=-1)
    intensity = pcd[:, 3] if pcd.shape[1] > 3 else pcd[:, 2]
    colors = color_encoding(
        intensity if mode == "intensity" else pcd[:, 2], mode=mode)

    fig = plt.figure(figsize=(10, 8), facecolor="black")
    if view == "3d":
        ax = fig.add_subplot(projection="3d", facecolor="black")
        ax.scatter(pcd[:, 0], pcd[:, 1], pcd[:, 2], s=point_size,
                   c=colors)
        for boxes, color in ((gt_boxes, GT_COLOR), (pred_boxes,
                                                    PRED_COLOR)):
            if boxes is None:
                continue
            for seg in box_edge_segments(boxes, order).reshape(-1, 2, 3):
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c=color,
                        linewidth=1.0)
        ax.set_axis_off()
        ax.view_init(elev=40, azim=180)
        # keep metric proportions (matplotlib autoscale would stretch
        # the shallow z range)
        spans = pcd[:, :3].max(axis=0) - pcd[:, :3].min(axis=0)
        ax.set_box_aspect(np.maximum(spans, 1e-3))
    else:
        ax = fig.add_subplot(facecolor="black")
        ax.scatter(pcd[:, 0], pcd[:, 1], s=point_size, c=colors)
        for boxes, color in ((gt_boxes, GT_COLOR), (pred_boxes,
                                                    PRED_COLOR)):
            if boxes is None:
                continue
            # bottom face edges only in top-down view
            for seg in box_edge_segments(boxes, order)[:, :4].reshape(
                    -1, 2, 3):
                ax.plot(seg[:, 0], seg[:, 1], c=color, linewidth=1.0)
        ax.set_aspect("equal")
        ax.set_axis_off()
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, facecolor="black")
        plt.close(fig)
    return fig


def visualize_sequence(frames: Sequence[dict], save_dir: str,
                       order: str = "hwl", mode: str = "constant",
                       view: str = "bev"):
    """Render a frame sequence to numbered PNGs (reference
    visualize_sequence_sample_output :315 / visualize_sequence_dataloader
    :553 — the interactive o3d loop becomes a headless image sequence).

    frames: iterable of dicts with keys 'pcd' and optional
    'pred_boxes'/'gt_boxes'."""
    paths = []
    for i, frame in enumerate(frames):
        path = os.path.join(save_dir, f"frame_{i:05d}.png")
        visualize_frame(frame["pcd"], frame.get("pred_boxes"),
                        frame.get("gt_boxes"), order=order, mode=mode,
                        save_path=path, view=view)
        paths.append(path)
    return paths


def visualize_bev(bev_grid, save_path: Optional[str] = None):
    """(H, W, C) BEV occupancy/intensity grid -> image (reference
    visualize_bev :635: sums the non-intensity channels)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = np.asarray(bev_grid)
    if grid.ndim == 4:
        grid = grid[0]
    occupancy = grid[..., :-1].sum(-1) if grid.shape[-1] > 1 \
        else grid[..., 0]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.matshow(occupancy)
    ax.set_axis_off()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100)
        plt.close(fig)
    return fig


def o3d_visualize_frames(frames, order: str = "hwl",
                         mode: str = "intensity"):   # pragma: no cover
    """Interactive open3d viewer over a frame sequence (reference
    visualize_sequence_dataloader :553).  Requires a display."""
    assert HAVE_OPEN3D, "open3d not installed"
    vis = o3d.visualization.Visualizer()
    vis.create_window()
    opt = vis.get_render_option()
    opt.background_color = np.asarray([0, 0, 0])
    opt.point_size = 1.0
    for i, frame in enumerate(frames):
        vis.clear_geometries()
        vis.add_geometry(pointcloud_to_o3d(frame["pcd"], mode))
        for boxes, color in ((frame.get("gt_boxes"), GT_COLOR),
                             (frame.get("pred_boxes"), PRED_COLOR)):
            if boxes is not None:
                for ls in bbx2linset(boxes, order, color):
                    vis.add_geometry(ls)
        vis.poll_events()
        vis.update_renderer()
    vis.destroy_window()


# ---------------------------------------------------------------------------
# self-contained interactive HTML viewer (no open3d, no network)
# ---------------------------------------------------------------------------

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>cobevt_tpu_torch lidar viewer</title>
<style>
 body {{ margin: 0; background: #000; color: #ccc;
        font: 12px monospace; overflow: hidden; }}
 #hud {{ position: fixed; top: 6px; left: 8px; z-index: 2; }}
 #frame {{ width: 320px; vertical-align: middle; }}
 canvas {{ display: block; }}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan
 &nbsp; <input type="range" id="frame" min="0" max="{nmax}" value="0">
 <span id="label"></span></div>
<canvas id="c"></canvas>
<script>
const FRAMES = {frames_json};
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let yaw = -0.7, pitch = 0.9, zoom = 6.0, panX = 0, panY = 0, fi = 0;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight;
  draw(); }}
function proj(x, y, z, cy, sy, cp, sp, s, w2, h2) {{
  const x1 = cy * x - sy * y, y1 = sy * x + cy * y;
  const y2 = cp * y1 - sp * z, z2 = sp * y1 + cp * z;
  return [w2 + panX + x1 * s, h2 + panY + y2 * s, z2];
}}
function draw() {{
  const f = FRAMES[fi], w2 = cv.width / 2, h2 = cv.height / 2;
  const s = Math.min(cv.width, cv.height) / (2 * zoom * f.scale);
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  ctx.fillStyle = "#000"; ctx.fillRect(0, 0, cv.width, cv.height);
  const P = f.pts, C = f.col, img = ctx.getImageData(0, 0, cv.width,
                                                     cv.height);
  const d = img.data, W = cv.width, H = cv.height;
  for (let i = 0; i < P.length; i += 3) {{
    const p = proj(P[i], P[i+1], P[i+2], cy, sy, cp, sp, s, w2, h2);
    const px = p[0] | 0, py = p[1] | 0;
    if (px < 0 || px >= W || py < 0 || py >= H) continue;
    const o = 4 * (py * W + px), ci = i;
    d[o] = C[ci]; d[o+1] = C[ci+1]; d[o+2] = C[ci+2]; d[o+3] = 255;
  }}
  ctx.putImageData(img, 0, 0);
  for (const [segs, color] of [[f.gt, "#0f0"], [f.pred, "#f00"]]) {{
    if (!segs) continue;
    ctx.strokeStyle = color; ctx.beginPath();
    for (let i = 0; i < segs.length; i += 6) {{
      const a = proj(segs[i], segs[i+1], segs[i+2], cy, sy, cp, sp, s,
                     w2, h2);
      const b = proj(segs[i+3], segs[i+4], segs[i+5], cy, sy, cp, sp,
                     s, w2, h2);
      ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    }}
    ctx.stroke();
  }}
  document.getElementById("label").textContent =
    "frame " + fi + "/" + (FRAMES.length - 1) + "  pts " +
    (P.length / 3);
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{ panX += dx; panY += dy; }}
  else {{ yaw += dx * 0.01; pitch += dy * 0.01; }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}};
onwheel = e => {{ zoom *= Math.exp(e.deltaY * 0.001); draw(); }};
document.getElementById("frame").oninput = e => {{
  fi = +e.target.value; draw(); }};
onresize = resize; resize();
</script></body></html>
"""


def export_html(frames, save_path: str, order: str = "hwl",
                mode: str = "intensity", max_points: int = 60000):
    """Write a SELF-CONTAINED interactive HTML viewer (orbit / zoom /
    pan / frame slider) for a LiDAR frame sequence — the headless
    answer to the reference's open3d interactive visualizer
    (opv2v/opencood/visualization/vis_utils.py:244/:553): no display,
    no open3d, no network; open the file in any browser.

    frames: sequence of dicts with "pcd" (N, 3|4) and optional
    "gt_boxes" / "pred_boxes" ((n, 7) center-order or (n, 8, 3)
    corners).  Points beyond ``max_points`` are uniformly subsampled to
    bound the file size.
    """
    import json

    payload = []
    for frame in frames:
        pcd = np.asarray(frame["pcd"], np.float32)
        if len(pcd) > max_points:
            sel = np.linspace(0, len(pcd) - 1, max_points).astype(int)
            pcd = pcd[sel]
        cols = (color_encoding(
            pcd[:, 3] if pcd.shape[1] > 3 else pcd[:, 2],
            mode) * 255).astype(np.uint8)
        entry = {
            "pts": np.round(pcd[:, :3], 2).reshape(-1).tolist(),
            "col": cols.reshape(-1).tolist(),
            "scale": float(max(1.0, np.percentile(
                np.abs(pcd[:, :2]), 95) / 4.0)),
        }
        for key, name in (("gt_boxes", "gt"), ("pred_boxes", "pred")):
            if frame.get(key) is not None:
                segs = box_edge_segments(frame[key], order)
                entry[name] = np.round(
                    segs.astype(np.float32), 2).reshape(-1).tolist()
        payload.append(entry)

    html = _HTML_TEMPLATE.format(
        nmax=len(payload) - 1,
        frames_json=json.dumps(payload, separators=(",", ":")))
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "w") as f:
        f.write(html)
    return save_path
