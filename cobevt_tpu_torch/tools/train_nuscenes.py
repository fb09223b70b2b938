"""nuScenes SinBEVT training CLI.

Counterpart of ``cobevt_tpu/tools/train_nuscenes.py`` (reference
``nuscenes/scripts/train.py:37``, ``model_module.py:5`` and
``config/config.yaml``): one-cycle AdamW counted in steps with a global-norm
clip of 5.0, the experiment's visibility-masked focal + center losses,
checkpoints every ``checkpoint_interval`` steps and at the end, a resume
from the latest one, and a closing IoU pass at thresholds 0.4 and 0.5, on
pixels of visibility >= 2 and on all pixels.

  python -m cobevt_tpu_torch.tools.train_nuscenes \\
      --dataset_dir /data/nuscenes --labels_dir /data/cvt_labels \\
      --save_dir runs/sinbevt [--steps 50001] [--batch 8] [--half]

``--labels_dir`` holds what ``data/nuscenes_labelgen.py:save_scene_labels``
writes (one ``<scene>.json`` each, every one by default); camera paths in it
resolve under ``--dataset_dir``.  Cameras are resized to the experiment's
image size.  ``--half`` computes in bf16 on a twin of the f32 master
weights (``train/state.py``).  The weights start from seed 0
(``utils/weights.py:seeded_init_``).

Checkpoints are ``<save_dir>/ckpt/net_step{N}.pth`` and its train-state
file (``train/checkpoint.py``).  A resume is the JAX CLI's: model, AdamW
state and step come from the latest checkpoint, while the loader starts
again at epoch 0 and the dropout generator again from the experiment's
seed, so a resumed run does not replay the batches and draws an unbroken
run would have seen.

One process on one device: the JAX CLI's multi-host rendezvous has no
counterpart here yet.  Runs on the CUDA card; ``main(argv, device="cpu")``
runs on the CPU.  ``main`` returns a :class:`NuScenesRun`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from cobevt_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    onecycle_schedule,
)
from cobevt_tpu_torch.utils.weights import seeded_init_

LOG_EVERY = 50
IOU_THRESHOLDS = (0.4, 0.5)


def parse_args(argv=None):
    from cobevt_tpu_torch.configs.nuscenes_experiments import (
        all_nuscenes_experiments,
    )

    p = argparse.ArgumentParser("cobevt_tpu_torch nuScenes training")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--labels_dir", required=True)
    p.add_argument("--save_dir", default="runs/sinbevt_nuscenes")
    p.add_argument("--experiment",
                   default="cvt_pyramid_axial_nuscenes_vehicle",
                   choices=sorted(all_nuscenes_experiments()),
                   help="composed experiment preset (reference "
                        "config/experiment/*.yaml equivalent)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--ckpt_every", type=int, default=None)
    p.add_argument("--half", action="store_true")
    p.add_argument("--scenes", nargs="*", default=None,
                   help="scene names; defaults to every labels json")
    p.add_argument("--label_indices", type=int, nargs="*", default=None,
                   help="override the experiment's label grouping")
    return p.parse_args(argv)


def experiment(opt):
    """The preset of ``--experiment`` with the command line's overrides, in
    the JAX CLI's order: the label grouping, then the trainer block."""
    from cobevt_tpu_torch.configs.nuscenes_experiments import (
        nuscenes_experiment,
    )

    exp = nuscenes_experiment(opt.experiment)
    if opt.label_indices is not None:
        exp = dataclasses.replace(
            exp, label_indices=(tuple(opt.label_indices),))
    overrides = {k: getattr(opt, a) for k, a in
                 [("lr", "lr"), ("weight_decay", "weight_decay"),
                  ("grad_clip", "grad_clip"), ("steps", "steps"),
                  ("batch_size", "batch"),
                  ("checkpoint_interval", "ckpt_every")]
                 if getattr(opt, a) is not None}
    return dataclasses.replace(exp, **overrides) if overrides else exp


@dataclasses.dataclass
class NuScenesRun:
    """What a run leaves: the train state, one record a step taken in this
    run (``step``; on the host clock ``loader_s``, the wait for the batch,
    ``step_s``, the copy to the device and the step's launches, which do not
    wait for the device, and ``save_s``, a checkpoint's save or 0), the step
    it resumed from (None for a fresh run), and the IoU pass's (1, 2)
    arrays."""

    state: object
    records: List[dict]
    resumed_from: Optional[int]
    iou_visible: np.ndarray
    iou_all: np.ndarray
    ckpt_dir: str


def iou_pass(state, dataset, label_indices, device, num_workers: int = 2):
    """The closing IoU pass at batch 1 over ``dataset``: threshold IoU at
    0.4 and 0.5 on pixels of visibility >= 2 and on all pixels, counted on
    the device and read once.  Returns the two (1, 2) arrays."""
    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.metrics.iou import (
        IoUState,
        iou_compute,
        iou_update,
    )
    from cobevt_tpu_torch.train.loop import batch_to_device

    eval_step = make_eval_step(state.model)
    visible = IoUState.create(2, 1, device)
    every = IoUState.create(2, 1, device)
    loader = DataLoader(dataset, 1, shuffle=False, drop_last=False,
                        num_workers=num_workers, device=device)
    for batch in loader:
        batch = batch_to_device(batch, device)
        out, _ = eval_step(state, batch)
        visible = iou_update(visible, out["bev"], batch["bev"],
                             IOU_THRESHOLDS, batch["visibility"], 2,
                             label_indices)
        every = iou_update(every, out["bev"], batch["bev"], IOU_THRESHOLDS,
                           None, None, label_indices)
    loader.close()
    return (iou_compute(visible).cpu().numpy(),
            iou_compute(every).cpu().numpy())


def main(argv=None, device: str = "cuda", num_workers: int = 2):
    """Train, save, resume and evaluate as the command line says.
    ``device``: where the run goes (a CUDA device needs a card);
    ``num_workers``: loader worker processes (0 decodes in this one)."""
    opt = parse_args(argv)
    from cobevt_tpu_torch.tools.train_camera import require_device
    device = require_device(device)

    from cobevt_tpu_torch.configs.nuscenes_experiments import (
        build_criterion,
        build_model,
    )
    from cobevt_tpu_torch.data.loader import DataLoader
    from cobevt_tpu_torch.data.nuscenes_gen import (
        ImageConfig,
        concat_scene_datasets,
    )
    from cobevt_tpu_torch.train.checkpoint import (
        restore_step_checkpoint,
        save_step_checkpoint,
    )
    from cobevt_tpu_torch.train.loop import MetricLogger, batch_to_device

    exp = experiment(opt)
    scenes = opt.scenes
    if scenes is None:
        scenes = sorted(f[:-5] for f in os.listdir(opt.labels_dir)
                        if f.endswith(".json"))
    dataset = concat_scene_datasets(
        scenes, opt.dataset_dir, opt.labels_dir,
        ImageConfig(h=exp.encoder.image_height, w=exp.encoder.image_width))
    loader = DataLoader(dataset, exp.batch_size, shuffle=True,
                        num_workers=num_workers, device=device)
    if len(loader) == 0:
        raise ValueError(f"{len(dataset)} samples make no batch of "
                         f"{exp.batch_size}")

    model = build_model(exp)
    seeded_init_(model, 0)
    model = model.to(device)
    criterion = build_criterion(exp)
    schedule = onecycle_schedule(exp.lr, exp.steps)
    optimizer = make_optimizer(model.parameters(), schedule,
                               weight_decay=exp.weight_decay, eps=1e-8)
    state = create_train_state(
        model, optimizer, schedule,
        compute_dtype=torch.bfloat16 if opt.half else None,
        grad_clip=exp.grad_clip)
    ckpt_dir = os.path.join(opt.save_dir, "ckpt")
    state, resumed = restore_step_checkpoint(ckpt_dir, state)

    train_step = make_train_step(model, criterion)
    logger = MetricLogger(os.path.join(opt.save_dir, "logs"))
    generator = torch.Generator(device=device).manual_seed(exp.seed)

    records = []
    step = state.step
    epoch = 0
    while step < exp.steps:
        loader.set_epoch(epoch)
        waited = time.perf_counter()
        for batch in loader:
            began = time.perf_counter()
            logs = train_step(state, batch_to_device(batch, device),
                              generator)
            stepped = time.perf_counter()
            step += 1
            if step % LOG_EVERY == 0:
                scalars = {k: float(v) for k, v in logs.items()}
                logger.log(step, scalars)
                print(f"step {step} loss {scalars['loss']:.4f}")
            saved = time.perf_counter()
            if step % exp.checkpoint_interval == 0:
                save_step_checkpoint(ckpt_dir, state, step)
            records.append({"step": step, "loader_s": began - waited,
                            "step_s": stepped - began,
                            "save_s": time.perf_counter() - saved})
            if step >= exp.steps:
                break
            waited = time.perf_counter()
        epoch += 1
    loader.close()
    save_step_checkpoint(ckpt_dir, state, step)
    logger.close()

    visible, every = iou_pass(state, dataset, exp.label_indices, device,
                              num_workers)
    print("IoU (vis>=2):", visible)
    print("IoU (with occlusions):", every)
    return NuScenesRun(state, records, resumed, visible, every, ckpt_dir)


if __name__ == "__main__":
    main()
