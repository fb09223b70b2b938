"""OPV2V cooperative camera inference/eval CLI.

Counterpart of ``cobevt_tpu/tools/inference_camera.py`` (reference
``opv2v/opencood/tools/inference_camera.py``):

  python -m cobevt_tpu_torch.tools.inference_camera --model_dir <run_dir>

Loads ``config.yaml`` and the latest ``net_epoch{N}.pth`` of the run
directory, runs the validation set through the trainer's eval step, prints
the mean IoU of each class and, with ``--save_vis``, dumps GT|prediction
panels (``--out_dir``: each frame's argmax map).  The model computes in the
dtype it was trained in (bf16 after a ``--half`` run, as its train-state
file records), so the IoU is the trainer's own for the same checkpoint.  Runs on the
CUDA card unless ``--device cpu`` is given; ``main(argv)`` returns the IoU
dict.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("cobevt_tpu_torch camera inference")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--save_vis", action="store_true")
    p.add_argument("--out_dir", default=None,
                   help="write per-frame argmax seg maps (npz) here, as "
                        "tools/serve_camera.py --out_dir does")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num_workers", type=int, default=2)
    return p.parse_args(argv)


def restore_for_eval(model_dir: str, device):
    """(hypes, config, criterion, TrainState) of the latest checkpoint of a
    run directory, its compute twin in the training run's dtype."""
    from cobevt_tpu_torch.configs.hypes import load_hypes
    from cobevt_tpu_torch.tools.train_camera import build_from_hypes
    from cobevt_tpu_torch.train import create_train_state, make_optimizer
    from cobevt_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        read_train_state,
        restore_checkpoint,
    )
    from cobevt_tpu_torch.train.optim import constant_schedule

    epoch = latest_checkpoint(model_dir)
    if epoch is None:
        raise FileNotFoundError(f"no net_epoch*.pth under {model_dir}")
    hypes = load_hypes(os.path.join(model_dir, "config.yaml"))
    cfg, model, criterion = build_from_hypes(hypes, device)
    half = read_train_state(model_dir, epoch)["compute_dtype"] == "bfloat16"
    schedule = constant_schedule(0.0)
    state = create_train_state(
        model, make_optimizer(model.parameters(), schedule), schedule,
        compute_dtype=torch.bfloat16 if half else None)
    state, _ = restore_checkpoint(model_dir, state, epoch)
    return hypes, cfg, criterion, state


def main(argv=None):
    opt = parse_args(argv)
    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.data.opv2v import (
        OPV2VCameraDataset,
        OPV2VScenarioDatabase,
    )
    from cobevt_tpu_torch.tools.train_camera import image_hw, require_device
    from cobevt_tpu_torch.train.loop import Trainer, TrainerConfig

    device = require_device(opt.device)
    hypes, cfg, criterion, state = restore_for_eval(opt.model_dir, device)

    tp = hypes["train_params"]
    db = OPV2VScenarioDatabase(hypes["validate_dir"],
                               max_cav=tp["max_cav"])
    ds = OPV2VCameraDataset(db, image_hw=image_hw(hypes),
                            visible=tp.get("visible", True), train=False)
    loader = DataLoader(ds, 1, shuffle=False, drop_last=False,
                        num_workers=opt.num_workers, device=device)

    trainer = Trainer(state.model, criterion, state,
                      TrainerConfig(seg_target=cfg.target,
                                    pred_dir=opt.out_dir))
    ious = trainer.evaluate(loader)
    for k, v in sorted(ious.items()):
        print(f"{k}: {v:.4f}")
    if opt.save_vis:
        from cobevt_tpu_torch.utils.visualization import (
            save_prediction_panels,
        )
        save_prediction_panels(state, loader,
                               os.path.join(opt.model_dir, "vis"))
    return ious


if __name__ == "__main__":
    main()
