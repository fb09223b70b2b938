"""Generated nuScenes labels as stitched panels.

Counterpart of ``cobevt_tpu/tools/view_data.py`` (reference
``nuscenes/scripts/view_data.py:25``): walk the generated dataset and write
a camera-strip + BEV panel PNG a sample (``utils/nuscenes_viz.py``) for
visual checks.  Host only: no device is used.

  python -m cobevt_tpu_torch.tools.view_data --dataset_dir ... \\
      --labels_dir ... --out viz/ [--max_samples 20]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch view_data")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--labels_dir", required=True)
    p.add_argument("--out", default="viz")
    p.add_argument("--max_samples", type=int, default=20)
    opt = p.parse_args(argv)

    import numpy as np

    from cobevt_tpu_torch.data.nuscenes_gen import concat_scene_datasets
    from cobevt_tpu_torch.utils.nuscenes_viz import sample_panel
    from cobevt_tpu_torch.utils.visualization import save_image

    scenes = sorted(f[:-5] for f in os.listdir(opt.labels_dir)
                    if f.endswith(".json"))
    dataset = concat_scene_datasets(scenes, opt.dataset_dir,
                                    opt.labels_dir)
    os.makedirs(opt.out, exist_ok=True)
    paths = []
    for i in range(min(len(dataset), opt.max_samples)):
        batch = {k: np.stack([v]) for k, v in dataset[i].items()}
        paths.append(os.path.join(opt.out, f"sample_{i:05d}.png"))
        save_image(paths[-1], sample_panel(batch)[..., ::-1])
    print(f"wrote {len(paths)} panels to {opt.out}")
    return paths


if __name__ == "__main__":
    main()
