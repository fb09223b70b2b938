"""Training and evaluation loops.

Counterpart of ``cobevt_tpu/train/loop.py`` (reference
``opv2v/opencood/tools/train_camera.py:133-237``): the epoch loop, periodic
validation with per-class IoU, periodic checkpoints, the LR schedule per
global step, the dataset's CAV reshuffle between epochs and scalar logs to
JSONL and, where installed, tensorboard.

The step runs eagerly on one device a process (``train/step.py``); under
a process group of several ranks (``parallel/distributed.py``) each rank
trains on its shard of the batches (every rank as many steps an epoch as
the shortest shard gives: the loader gives the last shard the remainder),
only rank 0 writes the logs and the checkpoints (the others wait for it),
and a validation pass sums every rank's confusion counts.  Its logs are 0-d
device tensors; they are read to floats only on ``log_every`` steps, since a
read is a wait for the device.  The dropout masks of every step come from one
``torch.Generator`` on the model's device, saved with each checkpoint: every
rank keeps the same generator state, draws the global batch's masks and takes
its own rows (``nn/layers.py:rank_uniform``).  The
confusion counts of a validation pass add up on the device and are read
once at its end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cobevt_tpu_torch.metrics.iou import confusion_counts, per_class_iou
from cobevt_tpu_torch.parallel.distributed import (
    barrier,
    is_main_process,
    min_over_ranks,
    world_size,
)
from cobevt_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from cobevt_tpu_torch.train.step import make_eval_step, make_train_step
from cobevt_tpu_torch.utils.serving import save_prediction


def snapshot_git_state(log_dir: str):
    """Record HEAD and the working-tree diff at train start (reference
    ``nuscenes/.../callbacks/gitdiff_callback.py:23``)."""
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"],
                              capture_output=True, text=True).stdout
        diff = subprocess.run(["git", "diff"], capture_output=True,
                              text=True).stdout
        with open(os.path.join(log_dir, "git_state.txt"), "w") as f:
            f.write(f"HEAD: {head}\n{diff}")
    except OSError:
        pass


class MetricLogger:
    """Scalar logging: JSONL, and tensorboard where installed."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            snapshot_git_state(log_dir)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float]):
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"step": step, **{k: float(v) for k, v in
                                  scalars.items()}}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb:
            self._tb.close()
        if self._jsonl:
            self._jsonl.close()


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 1
    eval_freq: int = 5          # epochs between validations
    save_freq: int = 5          # epochs between checkpoints
    log_every: int = 10         # steps between scalar logs
    ckpt_dir: Optional[str] = None
    log_dir: Optional[str] = None
    seg_target: str = "dynamic"
    vis_dir: Optional[str] = None   # dump GT|pred panels at validation
    vis_samples: int = 4
    # write each validation frame's argmax map here (frame_{i:06d}.npz, the
    # format of tools/serve_camera.py --out_dir; one wait a frame)
    pred_dir: Optional[str] = None
    # trace this many train steps after the first with torch.profiler
    # (a CUDA device only): ``Trainer.profile`` then holds their device
    # time, device operations and idle share
    profile_steps: int = 0
    # the JAX config's ``donate`` has no counterpart: the eager step
    # updates the state in place


def batch_to_device(batch: dict, device) -> dict:
    """Host batch (tensors, pinned where the loader pinned them, or numpy)
    -> tensors on ``device``; the copies from pinned memory are
    asynchronous."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))).to(device, non_blocking=True)
        for k, v in batch.items()}


class Trainer:
    """``state``: the port's ``TrainState``; ``generator``: the dropout
    generator (a new one on the model's device, seeded 0, by default)."""

    def __init__(self, model, criterion, state, config: TrainerConfig,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.criterion = criterion
        self.state = state
        self.cfg = config
        self.device = next(state.model.parameters()).device
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.train_step = make_train_step(model, criterion)
        self.eval_step = make_eval_step(model, criterion)
        self.logger = MetricLogger(config.log_dir if is_main_process()
                                   else None)
        self.global_step = int(self.state.step)
        self.start_epoch = 0
        # one record per train step: host seconds spent waiting on the
        # loader and in the whole step, and the scalars read on log steps
        self.records: List[dict] = []
        self.profile: Optional[dict] = None
        self._prof = None

    def maybe_resume(self):
        """Restore the latest checkpoint of ``ckpt_dir``, if any; the next
        ``fit`` starts at the epoch after it."""
        if self.cfg.ckpt_dir:
            self.state, epoch = restore_checkpoint(
                self.cfg.ckpt_dir, self.state, generator=self.generator)
            if epoch is not None:
                self.global_step = int(self.state.step)
                self.start_epoch = epoch
                print(f"resumed from epoch {epoch} (step {self.global_step})")

    def fit(self, train_loader, val_loader=None,
            on_epoch_end: Optional[Callable] = None):
        for epoch in range(self.start_epoch, self.cfg.epochs):
            train_loader.set_epoch(epoch)
            t_epoch = time.perf_counter()
            # every rank takes as many steps as the shortest shard gives,
            # so each step's collectives pair with the same step's
            steps = min_over_ranks(len(train_loader))
            batches = iter(train_loader)
            for _ in range(steps):
                self._profile_boundary()
                t0 = time.perf_counter()
                batch = next(batches)
                waited = time.perf_counter() - t0
                logs = self.train_step(
                    self.state, batch_to_device(batch, self.device),
                    self.generator)
                self.global_step += 1
                record = {"step": self.global_step, "loader_s": waited}
                if self.global_step % self.cfg.log_every == 0:
                    scalars = {k: float(v) for k, v in logs.items()}
                    scalars["epoch"] = epoch
                    self.logger.log(self.global_step, scalars)
                    record["scalars"] = scalars
                    print(f"[epoch {epoch}] step {self.global_step} "
                          f"loss {scalars['loss']:.4f}")
                record["step_s"] = time.perf_counter() - t0
                self.records.append(record)
            # a longer shard's last batches are read, not trained on
            for _ in batches:
                pass

            self._profile_boundary(last=True)
            print(f"epoch {epoch} done in "
                  f"{time.perf_counter() - t_epoch:.1f}s")

            if val_loader is not None and \
                    (epoch + 1) % self.cfg.eval_freq == 0:
                ious = self.evaluate(val_loader)
                self.logger.log(self.global_step,
                                {f"val_{k}": v for k, v in ious.items()})
                print(f"[epoch {epoch}] val IoU: {ious}")

            if self.cfg.ckpt_dir and (epoch + 1) % self.cfg.save_freq == 0:
                if is_main_process():
                    save_checkpoint(self.cfg.ckpt_dir, self.state, epoch + 1,
                                    self.generator)
                barrier()

            self.start_epoch = epoch + 1
            if on_epoch_end is not None:
                on_epoch_end(epoch)
        return self.state

    def _profile_boundary(self, last: bool = False):
        """Start the trace after the first step; stop it after
        ``profile_steps`` more (or at the epoch's end) and keep its
        summary, the idle share against the traced steps' own wall time."""
        n = self.cfg.profile_steps
        if not n or self.profile is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        if self._prof is None:
            if len(self.records) == 1 and not last:
                torch.cuda.synchronize(self.device)
                self._prof = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._prof_t0 = time.perf_counter()
            return
        traced = len(self.records) - 1
        if traced < n and not last:
            return
        torch.cuda.synchronize(self.device)
        wall_ms = (time.perf_counter() - self._prof_t0) * 1e3
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        if traced:
            from cobevt_tpu_torch.tools.timing import device_profile
            self.profile = device_profile(prof, traced, wall_ms / traced)
            self.profile["traced_ms_per_step"] = wall_ms / traced

    def evaluate(self, val_loader) -> Dict[str, float]:
        """Mean per-class IoU over the validation set (reference
        ``seg_utils.cal_iou_training`` / ``inference_camera.py:78-84``).
        The counts are exact in f64; the IoU divides in f32, as the JAX
        package's does."""
        conf_dyn = torch.zeros((2, 2), dtype=torch.float64,
                               device=self.device)
        conf_static = torch.zeros((3, 3), dtype=torch.float64,
                                  device=self.device)
        dumped = 0
        if self.cfg.pred_dir:
            os.makedirs(self.cfg.pred_dir, exist_ok=True)
        for i, batch in enumerate(val_loader):
            batch = batch_to_device(batch, self.device)
            out, _ = self.eval_step(self.state, batch)
            if self.cfg.pred_dir:
                save_prediction(self.cfg.pred_dir, i,
                                int(batch["agent_mask"][0].sum()), out)
            if self.cfg.vis_dir and dumped < self.cfg.vis_samples:
                # per-epoch image dumps (reference
                # train_utils.save_bev_seg_binary :275)
                from cobevt_tpu_torch.utils.visualization import (
                    save_image,
                    seg_panel,
                )
                panel = seg_panel(_to_numpy(out), _to_numpy(batch))
                save_image(os.path.join(
                    self.cfg.vis_dir,
                    f"step{self.global_step}_{dumped}.png"), panel)
                dumped += 1
            if "gt_dynamic" in batch:
                pred = out["dynamic_seg"].argmax(-1)
                conf_dyn += confusion_counts(
                    pred.reshape(-1), batch["gt_dynamic"].reshape(-1),
                    2).double()
            if "gt_static" in batch and self.cfg.seg_target != "dynamic":
                pred = out["static_seg"].argmax(-1)
                conf_static += confusion_counts(
                    pred.reshape(-1), batch["gt_static"].reshape(-1),
                    3).double()
        if world_size() > 1:
            import torch.distributed as dist
            dist.all_reduce(conf_dyn)
            dist.all_reduce(conf_static)
        ious = {}
        dyn = per_class_iou(conf_dyn.float()).cpu()
        ious["iou_dynamic"] = float(dyn[1])
        if float(conf_static.sum()) > 0:
            st = per_class_iou(conf_static.float()).cpu()
            ious["iou_road"] = float(st[1])
            ious["iou_lane"] = float(st[2])
        return ious


def _to_numpy(tree: dict) -> dict:
    return {k: v.detach().float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in tree.items()}
