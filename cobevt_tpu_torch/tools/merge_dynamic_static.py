"""Merge the outputs of a dynamic-head model and a static-head model into
combined BEV images.

Counterpart of ``cobevt_tpu/tools/merge_dynamic_static.py`` (reference
``opv2v/opencood/tools/merge_dynamic_static.py:24``): the dynamic (vehicle)
and static (road / lane) CorpBEVT variants are trained apart, and their
predicted class maps are composited into one image a frame.  Host only: no
device is used.

  python -m cobevt_tpu_torch.tools.merge_dynamic_static \\
      --dynamic_dir runs/dyn --static_dir runs/static --out merged/
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cobevt_tpu_torch.utils.visualization import (
    DYNAMIC_COLORS,
    STATIC_COLORS,
    colorize_map,
    save_image,
)


def merge_maps(dynamic_map: np.ndarray, static_map: np.ndarray):
    """(H, W) class maps -> (H, W, 3) composite: static colors below,
    vehicles painted on top."""
    img = colorize_map(static_map, STATIC_COLORS)
    img[dynamic_map > 0] = DYNAMIC_COLORS[1]
    return img


def main(argv=None) -> int:
    """Merge every ``.npy`` map the two directories share; returns the
    number of frames written."""
    p = argparse.ArgumentParser("cobevt_tpu_torch merge_dynamic_static")
    p.add_argument("--dynamic_dir", required=True,
                   help="dir of dynamic-head prediction .npy maps")
    p.add_argument("--static_dir", required=True)
    p.add_argument("--out", required=True)
    opt = p.parse_args(argv)

    names = sorted(set(os.listdir(opt.dynamic_dir)) &
                   set(os.listdir(opt.static_dir)))
    os.makedirs(opt.out, exist_ok=True)
    for name in names:
        dyn = np.load(os.path.join(opt.dynamic_dir, name))
        sta = np.load(os.path.join(opt.static_dir, name))
        save_image(os.path.join(opt.out, name.replace(".npy", ".png")),
                   merge_maps(dyn, sta))
    print(f"merged {len(names)} frames -> {opt.out}")
    return len(names)


if __name__ == "__main__":
    main()
