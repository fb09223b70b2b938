"""Render OPV2V LiDAR frames (point cloud + ground-truth boxes) to images.

Counterpart of ``cobevt_tpu/tools/view_lidar.py`` (reference
``visualization/vis_utils.py:553`` ``visualize_sequence_dataloader``), with
the same flags: every timestamp becomes a PNG (3D or top-down) of the
merged ego-frame cloud of every in-range agent with green ground-truth
boxes.  Host only: no device is used.

  python -m cobevt_tpu_torch.tools.view_lidar --root <opv2v_dir> \\
      --out viz/ [--view bev|3d] [--mode constant|intensity|z-value] \\
      [--max_frames N] [--max_cav N] [--html]

``--html`` also writes ``<out>/viewer.html``, a self-contained interactive
viewer (orbit / zoom / pan and a frame slider; no open3d, display or
network).
"""

from __future__ import annotations

import argparse
import math
import os


def main(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch view_lidar")
    p.add_argument("--root", required=True, help="OPV2V scenario root")
    p.add_argument("--out", default="lidar_viz")
    p.add_argument("--view", default="bev", choices=["bev", "3d"])
    p.add_argument("--mode", default="constant",
                   choices=["constant", "intensity", "z-value"])
    p.add_argument("--max_frames", type=int, default=20)
    p.add_argument("--max_cav", type=int, default=5)
    p.add_argument("--html", action="store_true",
                   help="also write <out>/viewer.html, a self-contained "
                        "interactive sequence viewer")
    opt = p.parse_args(argv)

    import numpy as np

    from cobevt_tpu_torch.data import COM_RANGE
    from cobevt_tpu_torch.data.lidar_preprocess import (
        load_pcd,
        mask_ego_points,
    )
    from cobevt_tpu_torch.data.objects import generate_object_center
    from cobevt_tpu_torch.data.opv2v import (
        OPV2VScenarioDatabase,
        load_scenario_yaml,
    )
    from cobevt_tpu_torch.geometry.boxes import project_points
    from cobevt_tpu_torch.geometry.transforms import x1_to_x2
    from cobevt_tpu_torch.utils.lidar_viz import export_html, visualize_frame

    db = OPV2VScenarioDatabase(opt.root, max_cav=opt.max_cav)
    os.makedirs(opt.out, exist_ok=True)
    html_frames, paths = [], []
    n = min(len(db), opt.max_frames)
    for idx in range(n):
        scenario, t_index = db.locate(idx)
        cav_ids = list(scenario.keys())
        ego_entries = scenario[cav_ids[0]]["entries"]
        ts = list(ego_entries.keys())[t_index]
        ego_params = load_scenario_yaml(ego_entries[ts]["yaml"])
        ego_pose = ego_params["lidar_pose"]

        clouds, params_list = [], []
        for cav_id in cav_ids:
            entries = scenario[cav_id]["entries"]
            if ts not in entries:
                continue
            params = load_scenario_yaml(entries[ts]["yaml"])
            pose = params["lidar_pose"]
            if math.hypot(pose[0] - ego_pose[0],
                          pose[1] - ego_pose[1]) > COM_RANGE:
                continue
            try:
                points = mask_ego_points(load_pcd(entries[ts]["lidar"]))
            except (FileNotFoundError, OSError, ValueError):
                continue
            tmat = x1_to_x2(pose, ego_pose)
            xyz = np.asarray(project_points(points[:, :3], tmat))
            clouds.append(np.concatenate([xyz, points[:, 3:4]], axis=-1))
            params_list.append(params)
        if not clouds:
            continue
        pcd = np.concatenate(clouds, axis=0)
        boxes, mask, _ = generate_object_center(
            params_list, ego_pose, max_num=100, order="hwl")
        gt = boxes[mask > 0] if boxes.size else None

        paths.append(os.path.join(opt.out, f"frame_{idx:05d}.png"))
        visualize_frame(pcd, gt_boxes=gt, order="hwl", mode=opt.mode,
                        view=opt.view, save_path=paths[-1])
        if opt.html:
            html_frames.append({"pcd": pcd, "gt_boxes": gt})
    if opt.html and html_frames:
        paths.append(export_html(html_frames,
                                 os.path.join(opt.out, "viewer.html"),
                                 order="hwl", mode=opt.mode))
    print(f"wrote {n} frames to {opt.out}")
    return paths


if __name__ == "__main__":
    main()
